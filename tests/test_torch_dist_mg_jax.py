"""The port's distributed multigrid (``repro_torch.mg.dist``) at P = 1
against JAX on the CPU: the V-cycle is JAX's single-device
``repro.mg.v_cycle``, and JAX's ``build_dist_hierarchy`` runs on a
one-device mesh, so its depth is compared directly (at P > 1 by its rule).
The P > 1 cycle's oracle tests are ``tests/test_torch_dist_mg.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core.hpcg as jhpcg
import repro.mg as jmg
from repro_torch.core import hpcg
from repro_torch.core.formats import Format
from repro_torch.mg import build_dist_hierarchy, v_cycle_dist
from torch_parity import DEV, jax_dist_depth_rule as _jax_depth_rule
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

CYCLE_TOL = 1e-5  # max |z - z_ref| / max |z_ref|


@pytest.fixture(autouse=True)
def _private_selection_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "selections.json"))


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max())


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
