"""The port's MoE layer (``repro_torch.models.moe``) on the CPU against the JAX
package's ``repro.models.moe``.

Two smoke configurations: deepseek-moe-16b's (top-2 of 8 experts, 1 shared)
and llama4-scout's (top-1 of 4, 1 shared), in float32 and bfloat16, at a
capacity that drops nothing (``capacity_factor = 2 * E / k``, so C >= 2T)
and at one that drops most assignments (0.25). The same numpy inputs and
JAX's initialised weights go through both packages; JAX routes each
sequence row under ``vmap``, the port all rows at once. Tolerances are
``torch_parity.tol``; the dispatches are held against each other at JAX's
own bounds (``tests/test_archs.py``).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as jconfigs
import repro.models.moe as jmoe
import repro.models.spec as jspec
from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe
from repro_torch.models import weights
from torch_parity import tol
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

DEV = "cpu"
ARCHS = ["deepseek_moe_16b", "llama4_scout_17b_a16e"]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, T = 3, 32
# capacity factors: C >= 2T (no assignment can drop) and 0.25 (most drop)
CAPS = {"nodrop": None, "drop": 0.25}


def _cfgs(arch, dtype_name, cap):
    j = jconfigs.get_config(arch, smoke=True)
    cf = 2 * j.n_experts / j.top_k if CAPS[cap] is None else CAPS[cap]
    j = dataclasses.replace(j, dtype=dtype_name, capacity_factor=cf)
    t = dataclasses.replace(tconfigs.get_config(arch, smoke=True), dtype=dtype_name,
                            capacity_factor=cf)
    return j, t


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _jax_refs(jp, xj, cfg):
    """JAX's route, assignments and every dispatch's output (one jit)."""
    gates, idx, aux = jax.vmap(lambda r: jmoe._route(jp, r, cfg))(xj)
    asg = jax.vmap(lambda r, g, i: jmoe._assignments(r, g, i, cfg)[:4])(xj, gates, idx)
    outs = {d: jax.vmap(lambda r, g, i, d=d: jmoe.DISPATCH[d](jp, r, g, i, cfg))(
        xj, gates, idx) for d in tmoe.DISPATCH}
    full = {d: jmoe.moe_apply(jp, xj, cfg, dispatch=d) for d in tmoe.DISPATCH}
    return dict(gates=gates, idx=idx, aux=aux, asg=asg, outs=outs, full=full)


@pytest.fixture(scope="module")
def moe_case():
    """Per architecture: JAX's initialised MoE weights (numpy, f32), the
    input rows, and JAX's route, assignments and every dispatch's output,
    computed once for each (dtype, capacity)."""
    out = {}
    for a, arch in enumerate(ARCHS):
        jcfg, _ = _cfgs(arch, "float32", "nodrop")
        p = jax.tree.map(np.asarray, jspec.init_params(jmoe.moe_specs(jcfg),
                                                       jax.random.PRNGKey(a)))
        # a router of the init's scale routes near-uniformly: widen it so the
        # top-k choice is decided by the input
        p["router"] = p["router"] * 30
        x = np.random.default_rng(a).standard_normal((B, T, jcfg.d_model)).astype(np.float32)
        refs = {}
        for dtype_name in DTYPES:
            for cap in CAPS:
                jcfg, _ = _cfgs(arch, dtype_name, cap)
                xj = jnp.asarray(x, DTYPES[dtype_name][0])
                res = jax.jit(functools.partial(_jax_refs, cfg=jcfg))(
                    jax.tree.map(jnp.asarray, p), xj)
                refs[dtype_name, cap] = jax.tree.map(
                    lambda v: np.array(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                                       else v), res)
        out[arch] = dict(p=p, x=x, refs=refs)
    return out


def _port(case, arch, dtype_name, cap):
    _, tcfg = _cfgs(arch, dtype_name, cap)
    p = weights.params_from_numpy(case[arch]["p"], DEV)
    x = torch.from_numpy(case[arch]["x"]).to(DTYPES[dtype_name][1])
    return tcfg, p, x, case[arch]["refs"][dtype_name, cap]


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(moe_case, arch, dtype_name):
    tcfg, p, x, ref = _port(moe_case, arch, dtype_name, "nodrop")
    gates, idx, aux = tmoe._route(p, x, tcfg)
    assert gates.dtype == torch.float32 and tuple(idx.shape) == (B, T, tcfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), ref["idx"])
    np.testing.assert_allclose(gates.numpy(), ref["gates"], **tol("float32"))
    np.testing.assert_allclose(aux.numpy(), ref["aux"], **tol("float32"))


def test_route_ties_take_the_lower_expert_first():
    """Equal probabilities: ``lax.top_k`` returns the lower index first."""
    jcfg, tcfg = _cfgs("deepseek_moe_16b", "float32", "nodrop")
    e, d = tcfg.n_experts, tcfg.d_model
    router = np.zeros((d, e), np.float32)
    router[0, 5] = router[0, 2] = 1.0  # experts 2 and 5 tie above the rest
    x = np.zeros((2, 4, d), np.float32)
    x[:, :2, 0] = 1.0  # tokens 2, 3 of each row: every expert ties
    gates, idx, _ = tmoe._route({"router": torch.from_numpy(router)}, torch.from_numpy(x), tcfg)
    jg, ji, _ = jax.vmap(lambda r: jmoe._route({"router": jnp.asarray(router)}, r, jcfg))(
        jnp.asarray(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    assert idx[0, 0].tolist() == [2, 5] and idx[0, 3].tolist() == [0, 1]
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), rtol=1e-6)


@pytest.mark.parametrize("cap", list(CAPS))
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_assignments_match_jax(moe_case, arch, dtype_name, cap):
    tcfg, p, x, ref = _port(moe_case, arch, dtype_name, cap)
    gates = torch.from_numpy(ref["gates"])
    idx = torch.from_numpy(ref["idx"].astype(np.int64))
    slot, token, gate, keep, c = tmoe._assignments(x, gates, idx, tcfg)
    assert c == tmoe._capacity(tcfg, T)
    for got, want in zip((slot, token, gate, keep), ref["asg"]):
        np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    dropped = 1 - float(keep.float().mean())
    assert (dropped == 0) if cap == "nodrop" else (dropped > 0.3), dropped


@pytest.mark.parametrize("cap", list(CAPS))
@pytest.mark.parametrize("dispatch", list(tmoe.DISPATCH))
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_matches_jax(moe_case, arch, dtype_name, dispatch, cap):
    """Each dispatch on JAX's own routing, then moe_apply end to end."""
    tcfg, p, x, ref = _port(moe_case, arch, dtype_name, cap)
    gates = torch.from_numpy(ref["gates"])
    idx = torch.from_numpy(ref["idx"].astype(np.int64))
    y = tmoe.DISPATCH[dispatch](p, x, gates, idx, tcfg)
    assert y.dtype == x.dtype and tuple(y.shape) == (B, T, tcfg.d_model)
    np.testing.assert_allclose(_np(y), ref["outs"][dispatch], **tol(dtype_name))
    out, aux = tmoe.moe_apply(p, x, tcfg, dispatch=dispatch)
    want_out, want_aux = ref["full"][dispatch]
    np.testing.assert_allclose(_np(out), want_out, **tol(dtype_name))
    np.testing.assert_allclose(float(aux), float(want_aux), **tol("float32"))


@pytest.mark.parametrize("cap", list(CAPS))
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatches_agree_at_jax_bounds(moe_case, arch, cap):
    """dense vs sort within 1e-4 and sort vs coo within 1e-6 (float32), the
    bounds of ``tests/test_archs.py::test_moe_dispatch_impls_agree``."""
    tcfg, p, x, _ = _port(moe_case, arch, "float32", cap)
    outs = {d: tmoe.moe_apply(p, x, tcfg, dispatch=d)[0].numpy() for d in tmoe.DISPATCH}
    np.testing.assert_allclose(outs["dense"], outs["sort"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(outs["sort"], outs["coo"], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_sort_combine_is_jaxs_sum_order(moe_case, dtype_name):
    """bf16 rounds at every add: the sort dispatch adds each token's k
    contributions in JAX's order (ascending expert), so it equals JAX's
    result bitwise where the expert outputs are equal bitwise; the check
    feeds both the same ye through a stand-in FFN."""
    arch = "deepseek_moe_16b"
    tcfg, p, x, ref = _port(moe_case, arch, dtype_name, "drop")
    jcfg, _ = _cfgs(arch, dtype_name, "drop")
    gates = torch.from_numpy(ref["gates"])
    idx = torch.from_numpy(ref["idx"].astype(np.int64))
    # expert FFN replaced by a per-expert scale: exact in both packages
    scale = np.linspace(0.5, 2.0, tcfg.n_experts).astype(np.float32)

    def t_ffn(pe, xe, dtype):
        return xe * torch.from_numpy(scale).to(dtype)[:, None, None]

    def j_ffn(pe, xe, dtype):
        return xe * jnp.asarray(scale, dtype)[:, None, None]

    orig_t, orig_j = tmoe._expert_ffn, jmoe._expert_ffn
    tmoe._expert_ffn, jmoe._expert_ffn = t_ffn, j_ffn
    try:
        y = tmoe._dispatch_sort(p, x, gates, idx, tcfg)
        xj = jnp.asarray(moe_case[arch]["x"], DTYPES[dtype_name][0])
        jp = jax.tree.map(jnp.asarray, moe_case[arch]["p"])
        yj = jax.vmap(lambda r, g, i: jmoe._dispatch_sort(jp, r, g, i, jcfg))(
            xj, jnp.asarray(ref["gates"]), jnp.asarray(ref["idx"]))
    finally:
        tmoe._expert_ffn, jmoe._expert_ffn = orig_t, orig_j
    np.testing.assert_array_equal(_np(y), np.asarray(yj.astype(jnp.float32)))


@pytest.mark.parametrize("dispatch", ["sort", "coo"])
def test_reruns_are_bitwise_equal(moe_case, dispatch):
    tcfg, p, x, _ = _port(moe_case, "deepseek_moe_16b", "bfloat16", "drop")
    a = tmoe.moe_apply(p, x, tcfg, dispatch=dispatch)[0]
    b = tmoe.moe_apply(p, x, tcfg, dispatch=dispatch)[0]
    assert torch.equal(a, b)


def test_capacity_matches_jax():
    for arch in ARCHS + ["deepseek_moe_16b"]:
        for cf in (0.25, 1.0, 1.25, 2.0, 21.3):
            j = dataclasses.replace(jconfigs.get_config(arch), capacity_factor=cf)
            t = dataclasses.replace(tconfigs.get_config(arch), capacity_factor=cf)
            for n in (1, 7, 64, 512, 4096):
                assert tmoe._capacity(t, n) == jmoe._capacity(j, n)
    deep = tconfigs.get_config("deepseek_moe_16b")
    assert [tmoe._capacity(deep, n) for n in (1, 64, 512)] == [4, 8, 60]


def test_specs_match_jax():
    for arch in ARCHS:
        j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
        js = jax.tree.leaves(jmoe.moe_specs(j), is_leaf=lambda s: isinstance(s, jspec.P))
        from repro_torch.models.spec import tree_leaves
        ts = tree_leaves(tmoe.moe_specs(t))
        assert [(s.shape, s.axes, s.init, s.fan_in_dims) for s in ts] == \
            [(s.shape, s.axes, s.init, s.fan_in_dims) for s in js]
