"""The PyTorch port's plan/execute conversions against the JAX package.

Every ``coo_to_*`` (through ``convert``) and every ``*_to_coo`` must build
bit-identical containers from the same numpy input; a plan written by the
JAX package (``SwitchPlan.to_json``) must execute in the port to the same
container; both packages count the same planned pulls.
"""
import json

import numpy as np
import pytest
import torch

import repro.core.formats as jf
import repro_torch.core.formats as tf
from repro.core import Format as JFormat
from torch_parity import (DEV, PATTERNS, assert_same_container, coo_pair, jconv,
                          port_from_jax, tconv)

TARGETS = ["COO", "CSR", "DIA", "ELL", "HYB", "SELL", "DENSE", "BSR"]
PARITY_PATTERNS = ["stencil", "random", "powerlaw"]


def _kw(fmt, a):
    """BSR needs a block edge that divides the shape."""
    if fmt != "BSR":
        return {}
    m, n = a.shape
    return {"block_size": 4 if m % 4 == 0 and n % 4 == 0 else 1}


@pytest.mark.parametrize("fmt", TARGETS)
@pytest.mark.parametrize("pattern", PARITY_PATTERNS)
def test_convert_matches_jax(pattern, fmt):
    a = PATTERNS[pattern]()
    Aj, At = coo_pair(a)
    kw = _kw(fmt, a)
    pj = jconv.plan_switch(Aj, JFormat[fmt], **kw)
    pt = tconv.plan_switch(At, tf.Format[fmt], **kw)
    assert pt.to_json() == pj.to_json()
    Bt = tconv.convert(At, tf.Format[fmt], **kw)
    assert_same_container(jconv.convert(Aj, JFormat[fmt], **kw), Bt)
    np.testing.assert_array_equal(tf.to_dense_np(Bt), a)


@pytest.mark.parametrize("fmt", TARGETS)
def test_to_coo_matches_jax(fmt):
    """Each ``*_to_coo`` on a container carried across from JAX."""
    a = PATTERNS["powerlaw"]()
    Bj = jconv.convert(coo_pair(a)[0], JFormat[fmt], **_kw(fmt, a))
    Ct = tconv.to_coo(port_from_jax(Bj))
    assert_same_container(jconv.to_coo(Bj), Ct)
    np.testing.assert_array_equal(tf.to_dense_np(Ct), a)


def test_dense_to_coo_with_capacity_matches_jax():
    a = PATTERNS["random"]()
    Dj = jf.dense_from_array(a)
    Dt = tf.dense_from_array(a, device=DEV)
    cap = int((a != 0).sum()) + 5
    assert_same_container(jconv.dense_to_coo(Dj, capacity=cap),
                          tconv.dense_to_coo(Dt, capacity=cap))
    pj, pt = jconv.plan_switch(Dj, JFormat.CSR), tconv.plan_switch(Dt, tf.Format.CSR)
    assert pt.to_json() == pj.to_json() and pt.capacity == int((a != 0).sum())
    assert_same_container(jconv.convert_execute(Dj, pj), tconv.convert_execute(Dt, pt))
    with pytest.raises(ValueError, match="capacity"):
        tconv.plan_switch(Dt, tf.Format.CSR, capacity=3)


@pytest.mark.parametrize("fmt", ["CSR", "DIA", "ELL", "HYB", "SELL", "BSR"])
def test_jax_plan_json_executes_in_port(fmt):
    """A plan serialised by the JAX package loads with ``from_json`` and
    runs the port's numeric phase with no planned pull."""
    a = PATTERNS["powerlaw"]()
    Aj, At = coo_pair(a)
    pj = jconv.plan_switch(Aj, JFormat[fmt], **_kw(fmt, a))
    doc = json.loads(json.dumps(pj.to_json()))
    pt = tconv.SwitchPlan.from_json(doc)
    assert pt.target == tf.Format[fmt] and pt.to_json() == doc
    assert tconv.SwitchPlan.from_json(pt.to_json()) == pt and hash(pt) == hash(pt)
    with tconv.planned_pulls_scope() as s:
        Bt = tconv.convert_execute(At, pt)
        Bt2 = tconv.convert(At, tf.Format[fmt], plan=pt)
    assert s.count == 0
    Bj = jconv.convert_execute(Aj, pj)
    assert_same_container(Bj, Bt)
    assert_same_container(Bj, Bt2)
    np.testing.assert_array_equal(tf.to_dense_np(Bt), jf.to_dense_np(Bj))


@pytest.mark.parametrize("fmt", ["CSR", "DIA", "ELL", "HYB", "SELL", "BSR"])
def test_planned_pulls_match_jax(fmt):
    """The symbolic phase pulls the same artifacts in both packages; for
    HYB the port also counts the overflow-capacity scalar, which the JAX
    package syncs without counting (one more pull)."""
    a = PATTERNS["random"]()
    Aj, At = coo_pair(a)
    kw = _kw(fmt, a)
    with jconv.planned_pulls_scope() as sj:
        jconv.plan_switch(Aj, JFormat[fmt], **kw)
    before = tconv.planned_pull_count()
    with tconv.planned_pulls_scope() as st:
        tconv.plan_switch(At, tf.Format[fmt], **kw)
    assert st.count == tconv.planned_pull_count() - before
    assert st.count == sj.count + (1 if fmt == "HYB" else 0)
    assert (st.count > 0) == (fmt != "CSR")


def test_plan_hints_and_validation():
    a = PATTERNS["banded"]()
    Aj, At = coo_pair(a)
    p = tconv.plan_switch(At, tf.Format.DIA, offsets=[2, -1, 0, 0])
    assert p.dia_offsets == (-1, 0, 2)  # deduped, ascending: the JAX rule
    assert p == tconv.SwitchPlan.from_json(
        jconv.plan_switch(Aj, JFormat.DIA, offsets=[2, -1, 0, 0]).to_json())
    with pytest.raises(ValueError, match="k=1"):
        tconv.plan_switch(At, tf.Format.ELL, k=1)
    assert tconv.coo_to_ell(At, k=1, check=False).k == 1
    plan = tconv.plan_switch(At, tf.Format.DIA)
    with pytest.raises(ValueError, match="plan targets DIA"):
        tconv.convert(At, tf.Format.ELL, plan=plan)
    with pytest.raises(TypeError):
        tconv.convert(At, tf.Format.DIA, plan={"target": "DIA"})
    assert tconv.convert(At, tf.Format.COO) is At
    with pytest.raises(ValueError, match="block size"):
        tconv.plan_switch(At, tf.Format.BSR, block_size=5)


def test_one_shot_helpers_match_jax():
    a = PATTERNS["powerlaw"]()
    Aj, At = coo_pair(a)
    assert_same_container(jconv.coo_to_hyb(Aj, k=2), tconv.coo_to_hyb(At, k=2))
    assert_same_container(jconv.coo_to_sell(Aj, c=4, sigma=16),
                          tconv.coo_to_sell(At, c=4, sigma=16))
    assert_same_container(jconv.coo_to_dia(Aj), tconv.coo_to_dia(At))
    assert_same_container(jconv.coo_to_bsr(Aj, block_size=8),
                          tconv.coo_to_bsr(At, block_size=8))
    assert_same_container(jconv.coo_to_dense(Aj), tconv.coo_to_dense(At))


def test_conversion_keeps_bfloat16():
    a = PATTERNS["stencil"]()
    At = tf.coo_from_dense_np(a, dtype=torch.bfloat16, device=DEV)
    for fmt in (tf.Format.CSR, tf.Format.DIA):
        B = tconv.convert(At, fmt)
        assert B.dtype == torch.bfloat16
        np.testing.assert_array_equal(tf.to_dense_np(B), a)  # stencil values are exact in bf16
