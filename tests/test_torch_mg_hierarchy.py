"""The port's multigrid hierarchy and V-cycle against the JAX package:
``apply_M`` at 8^3 in each cycle configuration, its symmetry, and the
per-level format picks of the ``ml`` and ``analytic`` policies. MG-PCG and
the entry points: ``tests/test_torch_mg_solve.py``.

JAX runs on the CPU through its jnp reference (``backend="ref"``); the
port on its CPU path. Inputs are HPCG grids and numpy vectors from fixed
seeds.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.hpcg as jhpcg
import repro.mg as jmg
from repro.tuning import FormatPolicy as JPolicy
from repro_torch.core import hpcg
from repro_torch.mg import build_hierarchy
from repro_torch.tuning import FormatPolicy
from torch_parity import DEV
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

CONFIGS = {
    "default": {},
    "trilinear_galerkin": {"prolong": "trilinear", "coarse_op": "galerkin"},
    "jacobi": {"smoother": "jacobi", "pre": 2, "post": 2},
}


@pytest.fixture(autouse=True)
def _private_selection_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "selections.json"))


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_apply_M_matches_jax_at_8_cubed(config):
    kw = CONFIGS[config]
    hj = jmg.build_hierarchy(jhpcg.generate_problem(8, 8, 8), backend="ref", **kw)
    ht = build_hierarchy(hpcg.generate_problem(8, 8, 8), device=DEV, **kw)
    assert repr(ht) == repr(hj) and ht.nlevels == hj.nlevels == 3
    r = np.random.default_rng(0).standard_normal(512).astype(np.float32)
    r_t = torch.from_numpy(r)
    z = ht.apply_M()(r_t)
    np.testing.assert_array_equal(r_t.numpy(), r)  # the cycle leaves r alone
    want = np.asarray(hj.apply_M()(jnp.asarray(r)))
    rel = np.abs(z.numpy() - want).max() / np.abs(want).max()
    assert rel < 1e-5, rel


def test_apply_M_is_symmetric_positive_definite_at_4_cubed():
    hier = build_hierarchy(hpcg.generate_problem(4, 4, 4), device=DEV)
    apply_M = hier.apply_M()
    M = torch.stack([apply_M(e) for e in torch.eye(64)], dim=1).double().numpy()
    assert np.abs(M - M.T).max() / np.abs(M).max() < 1e-5
    assert np.linalg.eigvalsh((M + M.T) / 2).min() > 0


@pytest.mark.parametrize("mode", ["ml", "analytic"])
@pytest.mark.parametrize("grid", [8, 16])
def test_hierarchy_formats_equal_jax(grid, mode):
    g = (grid, grid, grid)
    hj = jmg.build_hierarchy(jhpcg.generate_problem(*g), policy=JPolicy(mode), backend="ref")
    ht = build_hierarchy(hpcg.generate_problem(*g), policy=FormatPolicy(mode), device=DEV)
    fj, ft = hj.formats(), ht.formats()
    assert ft == fj
    if grid == 16 and mode == "ml":  # every level DIA; SELL, COO, COO, DIA blocks
        assert [lev["colors"][0] for lev in ft] == ["SELL", "COO", "COO", "DIA"]
    if (grid, mode) != (8, "ml"):
        return
    # the picks run: one V-cycle agrees with JAX's on the same hierarchy
    r = np.random.default_rng(3).standard_normal(ht.levels[0].n).astype(np.float32)
    z = ht.apply_M()(torch.from_numpy(r)).numpy()
    want = np.asarray(hj.apply_M()(jnp.asarray(r)))
    assert np.abs(z - want).max() / np.abs(want).max() < 1e-5
