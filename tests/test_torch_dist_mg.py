"""The port's distributed multigrid (``repro_torch.mg.dist``) on the CPU.

At P = 1 the distributed V-cycle is JAX's single-device ``repro.mg.v_cycle``
(and JAX's ``build_dist_hierarchy`` runs on a one-device mesh, so its depth
is compared directly). At P > 1, where JAX's ``shard_map`` path does not
run under the installed JAX, the cycle is held to a numpy float64 oracle
written here from ``repro/mg/dist.py``: per sweep the halo term frozen
into the right-hand side, then the colored forward and backward
Gauss-Seidel sweeps of each shard's local block in slab-local colors;
shard-local injection between levels.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core.hpcg as jhpcg
import repro.mg as jmg
from repro.mg.cycle import MIN_COARSE_ROWS as JMIN_COARSE_ROWS
from repro_torch.core import hpcg
from repro_torch.core.formats import Format
from repro_torch.core.solvers import cg, operator, pcg
from repro_torch.mg import build_dist_hierarchy, v_cycle_dist
from repro_torch.tuning import FormatPolicy
from torch_parity import DEV

CYCLE_TOL = 1e-5  # max |z - z_ref| / max |z_ref|


@pytest.fixture(autouse=True)
def _private_selection_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "selections.json"))


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max())


def _jax_depth_rule(dims, nshards, nlevels=None) -> int:
    """Levels by ``repro/mg/dist.py::build_dist_hierarchy``'s stopping rule."""
    n = 1
    while True:
        nx, ny, nz = dims
        if ((nlevels is not None and n >= nlevels) or any(d % 2 for d in dims)
                or (nz // 2) % nshards or (nx * ny * nz) // 8 < JMIN_COARSE_ROWS):
            return n
        dims, n = (nx // 2, ny // 2, nz // 2), n + 1


# ---------------------------------------------------------------------------
# The numpy float64 oracle of the frozen-halo colored SymGS V-cycle
# ---------------------------------------------------------------------------


def _oracle_level(dims, nshards):
    p = jhpcg.generate_problem(*dims)
    n = p.shape[0]
    a = np.zeros((n, n))
    np.add.at(a, (p.row, p.col), p.val.astype(np.float64))
    mp = n // nshards
    shard = np.arange(n) // mp
    local = shard[:, None] == shard[None, :]
    nx, ny, nz = dims
    colors = np.tile(jmg.color_grid(nx, ny, nz // nshards), nshards)  # slab-local colors
    idx = np.arange(n)
    x, y, z = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    coarse = (x % 2 == 0) & (y % 2 == 0) & (z % 2 == 0)
    return {"A": a, "local": np.where(local, a, 0.0), "remote": np.where(local, 0.0, a),
            "diag": np.diag(a).copy(), "colors": colors, "f2c": idx[coarse]}


def _oracle_smooth(lev, b, x, sweeps, x_is_zero):
    x = np.zeros_like(b) if x is None else x.copy()
    for s in range(sweeps):
        beff = b if (x_is_zero and s == 0) else b - lev["remote"] @ x
        for order in (range(8), range(7, -1, -1)):
            for c in order:
                rows = np.nonzero(lev["colors"] == c)[0]
                y = lev["local"][rows] @ x
                x[rows] += (beff[rows] - y) / lev["diag"][rows]
    return x


def _oracle_cycle(levels, r, i=0, pre=1, post=1, coarse_sweeps=4):
    lev = levels[i]
    if i == len(levels) - 1:
        return _oracle_smooth(lev, r, None, coarse_sweeps, True)
    x = _oracle_smooth(lev, r, None, pre, True)
    rc = (r - lev["A"] @ x)[lev["f2c"]]
    xc = _oracle_cycle(levels, rc, i + 1, pre, post, coarse_sweeps)
    xf = np.zeros_like(x)
    xf[lev["f2c"]] = xc
    return _oracle_smooth(lev, r, x + xf, post, False)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", [(8, 8, 8), (8, 8, 16)])
def test_one_shard_cycle_is_jax_single_device_v_cycle(grid):
    prob = hpcg.generate_problem(*grid)
    ht = build_dist_hierarchy(prob, 1, device=DEV, local_format=Format.CSR)
    hj = jmg.build_hierarchy(jhpcg.generate_problem(*grid), backend="ref")
    assert ht.nlevels == hj.nlevels and ht.levels[0].A.remote_empty
    assert not ht.levels[0].A.split
    r = np.random.default_rng(0).standard_normal(prob.shape[0]).astype(np.float32)
    z = v_cycle_dist(ht, torch.from_numpy(r)).numpy()
    want = np.asarray(jmg.v_cycle(hj, jnp.asarray(r)))
    assert _rel(z, want) < CYCLE_TOL


@pytest.mark.parametrize("nshards", [2, 4])
@pytest.mark.parametrize("mode", ["uniform", "multiformat"])
def test_cycle_matches_the_frozen_halo_oracle(nshards, mode):
    grid = (8, 8, 16)
    prob = hpcg.generate_problem(*grid)
    h = build_dist_hierarchy(prob, nshards, device=DEV, mode=mode, tune="ml")
    dims = [lev.dims for lev in h.levels]
    assert len(dims) == _jax_depth_rule(grid, nshards)
    levels = [_oracle_level(d, nshards) for d in dims]
    r = np.random.default_rng(1).standard_normal(prob.shape[0]).astype(np.float32)
    r_t = torch.from_numpy(r)
    z = v_cycle_dist(h, r_t)
    np.testing.assert_array_equal(r_t.numpy(), r)  # the cycle leaves r alone
    assert _rel(z.numpy(), _oracle_cycle(levels, r.astype(np.float64))) < CYCLE_TOL
    assert torch.equal(z, v_cycle_dist(h, r_t))


def test_cycle_with_a_smoother_policy_matches_the_oracle():
    prob = hpcg.generate_problem(8, 8, 16)
    h = build_dist_hierarchy(prob, 2, device=DEV, smoother_policy=FormatPolicy("ml"),
                             local_format=Format.CSR, remote_format=Format.CSR)
    fmts = h.formats()[0]["colors"]
    assert all(isinstance(f, list) and f for f in fmts)
    levels = [_oracle_level(lev.dims, 2) for lev in h.levels]
    r = np.random.default_rng(2).standard_normal(prob.shape[0]).astype(np.float32)
    z = v_cycle_dist(h, torch.from_numpy(r)).numpy()
    assert _rel(z, _oracle_cycle(levels, r.astype(np.float64))) < CYCLE_TOL


@pytest.mark.parametrize("grid,nshards", [((16, 16, 16), 2), ((16, 16, 16), 4),
                                          ((8, 8, 32), 8)])
def test_dist_mg_pcg_beats_cg(grid, nshards):
    prob = hpcg.generate_problem(*grid)
    h = build_dist_hierarchy(prob, nshards, device=DEV, mode="multiformat", tune="ml")
    A = h.levels[0].A
    b = torch.from_numpy(hpcg.rhs_for_ones(prob))
    res = pcg(operator(A), b, tol=1e-7, maxiter=200, apply_M=h.apply_M())
    ref = cg(operator(A), b, tol=1e-7, maxiter=500)
    assert float((res.x - 1).abs().max()) < 1e-3 and res.iters < ref.iters
    assert h.nlevels == _jax_depth_rule(grid, nshards) and h.nshards == nshards
    rec = h.formats()[0]
    assert len(rec["local"]) == len(rec["boundary"]) == len(rec["remote"]) == nshards


@pytest.mark.parametrize("grid,nlevels", [((8, 8, 16), None), ((16, 16, 16), None),
                                          ((16, 16, 16), 2)])
def test_depth_rule_gives_jax_level_count(grid, nlevels):
    """At P = 1 JAX's own builder runs (a one-device mesh); at P > 1 its rule."""
    mesh = jax.make_mesh((1,), ("rows",))
    hj = jmg.build_dist_hierarchy(jhpcg.generate_problem(*grid), mesh, "rows",
                                  nlevels=nlevels, backend="ref")
    prob = hpcg.generate_problem(*grid)
    ht = build_dist_hierarchy(prob, 1, device=DEV, nlevels=nlevels)
    assert [lev.dims for lev in ht.levels] == [lev.dims for lev in hj.levels]
    assert repr(ht) == repr(hj)
    for nshards in (2, 4, 8):
        if grid[2] % nshards == 0:
            ht = build_dist_hierarchy(prob, nshards, device=DEV, nlevels=nlevels)
            assert ht.nlevels == _jax_depth_rule(grid, nshards, nlevels)
    with pytest.raises(ValueError, match="not divisible"):
        build_dist_hierarchy(prob, 3, device=DEV)
