"""The port's distributed multigrid (``repro_torch.mg.dist``) on the CPU.

At P > 1, where JAX's ``shard_map`` path does not run under the installed
JAX, the cycle is held to a numpy float64 oracle
written here from ``repro/mg/dist.py``: per sweep the halo term frozen
into the right-hand side, then the colored forward and backward
Gauss-Seidel sweeps of each shard's local block in slab-local colors;
shard-local injection between levels. At P = 1 it is held to JAX itself
(``tests/test_torch_dist_mg_jax.py``).
"""
import numpy as np
import pytest
import torch

import repro.core.hpcg as jhpcg
import repro.mg as jmg
from repro_torch.core import hpcg
from repro_torch.core.formats import Format
from repro_torch.core.solvers import cg, operator, pcg
from repro_torch.mg import build_dist_hierarchy, v_cycle_dist
from repro_torch.tuning import FormatPolicy
from torch_parity import DEV, jax_dist_depth_rule as _jax_depth_rule
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

CYCLE_TOL = 1e-5  # max |z - z_ref| / max |z_ref|


@pytest.fixture(autouse=True)
def _private_selection_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "selections.json"))


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max())


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
