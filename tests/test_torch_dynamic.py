"""The port's DynamicMatrix and SwitchDynamicMatrix against the JAX package.

``activate`` / ``plan`` / ``auto`` must build the same containers as JAX's;
``SwitchDynamicMatrix`` keeps every candidate resident and dispatches on a
host-side id where JAX uses ``lax.switch``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.dynamic as jdyn
import repro.core.ops as jops
import repro_torch.core.formats as tf
from repro.core import Format as JFormat
from repro_torch.core import ops as tops
from repro_torch.core.dynamic import (DEFAULT_CANDIDATES, DynamicMatrix,
                                      SwitchDynamicMatrix)
from repro_torch.core.formats import Format
from torch_parity import PATTERNS, assert_same_container, coo_pair, tol


@pytest.fixture(autouse=True)
def _private_selection_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "selections.json"))


def _x(n, seed=3):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("fmt", ["CSR", "DIA", "ELL", "SELL", "HYB"])
def test_activate_and_plan_match_jax(fmt):
    a = PATTERNS["powerlaw"]()
    Aj, At = coo_pair(a)
    Mj, Mt = jdyn.DynamicMatrix(Aj), DynamicMatrix(At)
    Nj, Nt = Mj.activate(JFormat[fmt]), Mt.activate(Format[fmt])
    assert Nt.active == Format[fmt] and Nt.shape == a.shape and Nt.nnz == Aj.nnz
    assert_same_container(Nj.concrete, Nt.concrete)
    plan = Mt.plan(Format[fmt])
    assert plan.to_json() == Mj.plan(JFormat[fmt]).to_json()
    assert_same_container(Nj.concrete, Mt.activate(Format[fmt], plan=plan).concrete)
    assert_same_container(Nj.concrete, Mt.convert(Format[fmt]).concrete)
    xj, xt = _x(a.shape[1])
    np.testing.assert_allclose(Nt.spmv(xt).numpy(), np.asarray(Nj.spmv(xj)),
                               **tol("float32"))
    np.testing.assert_allclose(tops.spmv(Nt, xt).numpy(), a @ xt.numpy(), **tol("float32"))
    assert repr(Nt) == f"DynamicMatrix<{fmt}>{a.shape}"


def test_dynamic_diagonal_and_auto_match_jax():
    a = PATTERNS["stencil"]()
    Aj, At = coo_pair(a, capacity=None)
    Mj, Mt = jdyn.DynamicMatrix.auto(Aj, "ml"), DynamicMatrix.auto(At, "ml")
    assert int(Mt.active) == int(Mj.active)
    assert_same_container(Mj.concrete, Mt.concrete)
    np.testing.assert_array_equal(Mt.extract_diagonal().numpy(),
                                  np.asarray(Mj.extract_diagonal()))
    d = np.full(a.shape[0], 30.0, np.float32)
    Uj, Ut = Mj.update_diagonal(jnp.asarray(d)), Mt.update_diagonal(torch.from_numpy(d))
    assert isinstance(Ut, DynamicMatrix) and Ut.dtype == torch.float32
    assert_same_container(Uj.concrete, Ut.concrete)
    assert DynamicMatrix(Mt).concrete is Mt.concrete


def test_switch_matrix_dispatches_on_host_id():
    a = PATTERNS["random"]()
    Aj, At = coo_pair(a)
    Sj = jdyn.SwitchDynamicMatrix.build(Aj, active=JFormat.ELL)
    St = SwitchDynamicMatrix.build(At, active=Format.ELL)
    assert St.candidates == DEFAULT_CANDIDATES and St.active == Format.ELL
    for vj, vt in zip(Sj.variants, St.variants):
        assert_same_container(vj, vt)
    xj, xt = _x(a.shape[1])
    for fmt in DEFAULT_CANDIDATES:
        Tt = St.activate(fmt)
        assert Tt.active == fmt and Tt.variants is St.variants  # O(1): nothing converted
        yj = jops.spmv(Sj.activate(JFormat(int(fmt))), xj)
        np.testing.assert_allclose(Tt.spmv(xt).numpy(), np.asarray(yj), **tol("float32"))
    assert St.activate_id(1).active == St.candidates[1]
    F = SwitchDynamicMatrix.from_matrix(DynamicMatrix(At), candidates=(Format.CSR, Format.DIA))
    assert F.active == Format.CSR and F.shape == a.shape
    assert repr(F) == f"SwitchDynamicMatrix<['CSR', 'DIA']>{a.shape}"


def test_switch_matrix_takes_given_plans():
    a = PATTERNS["banded"]()
    Aj, At = coo_pair(a)
    plan = DynamicMatrix(At).plan(Format.DIA, offsets=[-7, -1, 0, 2, 9, 11])
    S = SwitchDynamicMatrix.build(At, candidates=(Format.DIA, Format.CSR),
                                  plans={Format.DIA: plan})
    assert S.variants[0].offsets.tolist() == [-7, -1, 0, 2, 9, 11]
    np.testing.assert_array_equal(tf.to_dense_np(S.variants[0]), a)
    with pytest.raises(ValueError, match="targets DIA"):
        SwitchDynamicMatrix.build(At, candidates=(Format.CSR,), plans={Format.CSR: plan})
