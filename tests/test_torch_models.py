"""The port's dense decoder (``repro_torch.configs`` and ``repro_torch.models``)
on the CPU against the JAX package.

Configs are compared field by field for all ten architectures; parameter
counts and abstract params at full size allocate nothing (meta tensors).
Every layer, the attention block, the cached decode step (f32, bf16 and
int8 caches), the whole forward and the batched cache prefill are held
against JAX on the same inputs (flash attention is in
``tests/test_torch_flash.py``): numpy arrays from fixed seeds, JAX's own
initialised weights carried across with ``weights.params_from_numpy``.
Tolerances are ``torch_parity.tol``: float32 1e-4, bfloat16 2e-2; an int8
cache entry may differ by one step where the two packages' float32 k/v
straddle a rounding boundary.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as jconfigs
import repro.models.attention as jattn
import repro.models.layers as jlayers
import repro.models.spec as jspec
from repro.models import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch.models import Model, build_model
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import sharding_ctx, spec as tspec
from repro_torch.models import weights
from torch_parity import tol
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

DEV = "cpu"
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
DENSE_ARCHS = ["qwen1_5_32b", "command_r_plus_104b", "stablelm_1_6b", "minitron_8b"]
# the smoke configs the forward and decode tests run: MHA, GQA (4 heads over
# 2 kv heads, head_dim 16) and MHA with the qkv bias
FWD_ARCHS = ["stablelm_1_6b", "minitron_8b", "qwen1_5_32b"]


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(t, j, dtype_name, what=""):
    np.testing.assert_allclose(_np(t), _np(j), err_msg=what, **tol(dtype_name))


def _pair(x: np.ndarray, dtype_name: str):
    jd, td = DTYPES[dtype_name]
    return jnp.asarray(x, jd), torch.from_numpy(np.asarray(x, np.float32)).to(td)


def _cfgs(arch, dtype_name="float32"):
    j = dataclasses.replace(jconfigs.get_config(arch, smoke=True), dtype=dtype_name)
    t = dataclasses.replace(tconfigs.get_config(arch, smoke=True), dtype=dtype_name)
    return j, t


@pytest.fixture(scope="module")
def smoke_params():
    """JAX's initialised smoke weights (f32) per architecture, as numpy."""
    out = {}
    for arch in FWD_ARCHS:
        jcfg, _ = _cfgs(arch)
        out[arch] = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
        if jcfg.qkv_bias:  # zeros at init: make the bias path carry values
            rng = np.random.default_rng(5)
            blocks = out[arch]["blocks"]["attn"]
            for name in ("bq", "bk", "bv"):
                blocks[name] = rng.standard_normal(blocks[name].shape).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------


def test_registry_tables_match():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert tconfigs.ALIASES == jconfigs.ALIASES
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_config_fields_match(arch, smoke):
    j = jconfigs.get_config(arch, smoke=smoke)
    t = tconfigs.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("hd", "padded_vocab", "d_inner", "ssm_heads"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.n_params() == j.n_params() and t.n_active_params() == j.n_active_params()
    for shape in tconfigs.SHAPES:
        assert tconfigs.skip_reason(t, shape) == jconfigs.skip_reason(j, shape)
    alias = [k for k, v in tconfigs.ALIASES.items() if v == arch][0]
    assert tconfigs.get_config(alias, smoke=smoke) == t


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_full_size_specs_count_and_allocate_nothing(arch):
    """At full width: n_params() = the analytic count = JAX's spec count;
    abstract params are meta tensors of JAX's shapes and axes."""
    cfg = tconfigs.get_config(arch)
    jm = jbuild(jconfigs.get_config(arch))
    m = build_model(cfg)
    assert m.n_params() == cfg.n_params() == jm.n_params()
    abstract = m.abstract_params(torch.bfloat16)
    leaves = tspec.tree_leaves(abstract)
    assert all(t.is_meta and t.dtype == torch.bfloat16 for t in leaves)
    jshapes = [s.shape for s in jax.tree.leaves(jm.abstract_params())]
    assert [tuple(t.shape) for t in leaves] == [tuple(s) for s in jshapes]
    jaxes = jax.tree.leaves(jm.logical_axes(), is_leaf=lambda x: isinstance(x, tuple))
    assert tspec.tree_leaves(m.logical_axes()) == list(jaxes)
    cache = m.cache_specs(4, 1024, kv_quant=True)
    assert all(t.is_meta for t in cache.values())
    jcache = jm.cache_specs(4, 1024, kv_quant=True)
    assert {k: tuple(t.shape) for k, t in cache.items()} == \
        {k: tuple(s.shape) for k, s in jcache.items()}


def test_minitron_full_size_numbers():
    """The configuration the card serves: 9,882,046,464 parameters."""
    cfg = tconfigs.get_config("minitron-8b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, cfg.d_ff,
            cfg.vocab) == (32, 4096, 32, 8, 128, 16384, 256000)
    assert build_model(cfg).n_params() == 9_882_046_464


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "llama4_scout_17b_a16e",
                                  "internvl2_26b", "hubert_xlarge", "mamba2_2_7b",
                                  "zamba2_2_7b"])
def test_unported_family_raises(arch):
    """Every family builds, serves (tests/test_torch_families.py) and now
    trains, so nothing is left to raise: ``loss`` is the CE of
    ``forward``'s logits plus 0.01 * the MoE aux loss (the gradients are
    held against JAX in tests/test_torch_training_*.py)."""
    from repro_torch.models.model import lm_loss
    from torch_families import batch_to_torch, make_batch
    cfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True), dtype="float32")
    m = build_model(cfg)
    assert m == Model(cfg) and "blocks" in m.specs()
    params = m.init(0, device=DEV)
    batch = batch_to_torch(make_batch(cfg, 3), torch.float32)
    logits, aux = m.forward(params, batch, q_chunk=8, kv_chunk=8)
    labels = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, logits.shape[:2]))
    loss = m.loss(params, dict(batch, labels=labels), q_chunk=8, kv_chunk=8)
    assert loss.shape == () and torch.isfinite(loss)
    assert torch.equal(loss, lm_loss(logits, labels, cfg.padded_vocab) + 0.01 * aux)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: device=None is valid here")
    m = build_model(tconfigs.get_config("stablelm_1_6b", smoke=True))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        m.init(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        m.init_cache(2, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        weights.params_from_numpy({"w": np.zeros(3, np.float32)})


def test_init_is_seeded_leaf_by_leaf_with_jax_scales():
    cfg = tconfigs.get_config("minitron_8b", smoke=True)
    m = build_model(cfg)
    a, b = m.init(0, device=DEV), m.init(0, device=DEV)
    c = m.init(1, device=DEV)
    la, lb, lc = (tspec.tree_leaves(p) for p in (a, b, c))
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert not torch.equal(a["blocks"]["mlp"]["up"], c["blocks"]["mlp"]["up"])
    specs = tspec.tree_leaves(m.specs())
    for s, t in zip(specs, la):
        assert tuple(t.shape) == s.shape and t.dtype == torch.float32
    assert torch.all(a["final_ln"] == 1) and torch.all(a["blocks"]["ln1"] == 1)
    # normal: 1/sqrt(fan_in) over every dim but the last; small_normal x0.1
    up = a["blocks"]["mlp"]["up"]  # (L, d, ff): fan_in L * d
    assert abs(float(up.std()) * np.sqrt(cfg.n_layers * cfg.d_model) - 1) < 0.05
    emb = a["embed"]["tokens"]  # (V, d): fan_in V
    assert abs(float(emb.std()) * np.sqrt(cfg.padded_vocab) / 0.1 - 1) < 0.05
    half = m.init(0, param_dtype=torch.bfloat16, device=DEV)
    assert all(t.dtype == torch.bfloat16 for t in tspec.tree_leaves(half))
    assert torch.equal(half["blocks"]["mlp"]["up"], up.to(torch.bfloat16))


def test_spec_helpers_match_jax():
    js = jspec.P((4, 6), ("embed", "mlp"), init="small_normal", fan_in_dims=(1,))
    ts = tspec.P((4, 6), ("embed", "mlp"), init="small_normal", fan_in_dims=(1,))
    tree_j = {"a": js, "b": {"c": jspec.P((3,), (None,), init="ones")}}
    tree_t = {"a": ts, "b": {"c": tspec.P((3,), (None,), init="ones")}}
    assert tspec.param_count(tree_t) == jspec.param_count(tree_j) == 27
    assert tspec.logical_axes(tree_t) == jspec.logical_axes(tree_j)
    cast = tspec.cast_dtype(tree_t, torch.bfloat16)
    assert cast["a"].dtype == torch.bfloat16 and cast["b"]["c"].dtype == torch.bfloat16
    w = tspec.init_params(tree_t, 3, DEV)["a"]
    assert w.shape == (4, 6) and float(w.abs().max()) < 0.1  # 0.1/sqrt(6) * ~4 sigma


def test_sharding_policy_is_a_noop_without_a_mesh():
    x = torch.ones(2, 3, 4)
    assert sharding_ctx.get_policy() == sharding_ctx.Policy()
    with sharding_ctx.policy(dp="data", tp="model"):
        assert sharding_ctx.get_policy().tp == "model"
        for kind in ("act", "logits", "logits_chunk", "expert_rows", "batch"):
            assert sharding_ctx.constrain(x, kind) is x
    assert sharding_ctx.get_policy() == sharding_ctx.Policy()
    sharding_ctx.set_policy(dp="data")
    assert sharding_ctx.constrain(x, "act") is x
    sharding_ctx.set_policy()


def test_weights_round_trip(smoke_params):
    tree = smoke_params["minitron_8b"]
    t = weights.params_from_numpy(tree, DEV)
    back = weights.params_to_numpy(t)
    jl, tl = jax.tree.leaves(tree), jax.tree.leaves(back)
    assert all(np.array_equal(a, b) for a, b in zip(jl, tl))
    half = weights.params_from_numpy(tree, DEV, dtype=torch.bfloat16)
    assert half["blocks"]["mlp"]["up"].dtype == torch.bfloat16
    jcfg, _ = _cfgs("minitron_8b")
    jcache = jax.tree.map(np.asarray, jbuild(jcfg).init_cache(2, 8, kv_quant=True))
    jcache["k_scale"] = np.asarray(jnp.full(jcache["k_scale"].shape, 0.375, jnp.bfloat16))
    tc = weights.cache_from_numpy(jcache, DEV)
    assert tc["k"].dtype == torch.int8 and tc["k_scale"].dtype == torch.bfloat16
    assert float(tc["k_scale"][0, 0, 0, 0]) == 0.375
    assert np.array_equal(weights.cache_to_numpy(tc)["k_scale"],
                          np.asarray(jcache["k_scale"], np.float32))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_rms_norm(dtype_name):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    xj, xt = _pair(x, dtype_name)
    out_t = tlayers.rms_norm(xt, torch.from_numpy(w), 1e-5)
    assert out_t.dtype == xt.dtype
    _close(out_t, jlayers.rms_norm(xj, jnp.asarray(w), 1e-5), dtype_name)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos_shape", [(1, 5), (3, 1)], ids=["prefill", "decode"])
def test_apply_rope(dtype_name, pos_shape):
    rng = np.random.default_rng(1)
    b, s = 3, pos_shape[1]
    x = rng.standard_normal((b, s, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 900, pos_shape).astype(np.int32)
    xj, xt = _pair(x, dtype_name)
    out_t = tlayers.apply_rope(xt, torch.from_numpy(pos), 10000.0)
    assert out_t.dtype == xt.dtype
    _close(out_t, jlayers.apply_rope(xj, jnp.asarray(pos), 10000.0), dtype_name)
    np.testing.assert_allclose(tlayers.rope_freqs(16, 10000.0).numpy(),
                               np.asarray(jlayers.rope_freqs(16, 10000.0)), rtol=1e-6)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_apply(act, dtype_name):
    rng = np.random.default_rng(2)
    specs = jlayers.mlp_specs(64, 160, act)
    p = {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
         for k, s in specs.items()}
    assert set(p) == set(tlayers.mlp_specs(64, 160, act))
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    xj, xt = _pair(x, dtype_name)
    out_t = tlayers.mlp_apply(weights.params_from_numpy(p, DEV), xt, act)
    assert out_t.dtype == xt.dtype
    _close(out_t, jlayers.mlp_apply(jax.tree.map(jnp.asarray, p), xj, act), dtype_name)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_embed_and_unembed(dtype_name):
    rng = np.random.default_rng(3)
    table = rng.standard_normal((256, 64)).astype(np.float32)
    out = (rng.standard_normal((64, 256)) / 8).astype(np.float32)
    tokens = rng.integers(0, 256, (2, 5)).astype(np.int32)
    jd, td = DTYPES[dtype_name]
    e_t = tlayers.embed_apply({"tokens": torch.from_numpy(table)}, torch.from_numpy(tokens), td)
    e_j = jlayers.embed_apply({"tokens": jnp.asarray(table)}, jnp.asarray(tokens), jd)
    assert e_t.dtype == td
    np.testing.assert_array_equal(_np(e_t), _np(e_j))
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    xj, xt = _pair(x, dtype_name)
    u_t = tlayers.unembed_apply({"out": torch.from_numpy(out)}, xt)
    assert u_t.dtype == torch.float32
    _close(u_t, jlayers.unembed_apply({"out": jnp.asarray(out)}, xj), dtype_name)


# ---------------------------------------------------------------------------
# attention block and cached decode
# ---------------------------------------------------------------------------


def _attn_params(smoke_params, arch):
    p = smoke_params[arch]["blocks"]["attn"]
    return {k: a[0] for k, a in p.items()}  # layer 0


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["minitron_8b", "qwen1_5_32b"])
def test_attention_block(smoke_params, arch, dtype_name):
    jcfg, tcfg = _cfgs(arch, dtype_name)
    p = _attn_params(smoke_params, arch)
    x = np.random.default_rng(6).standard_normal((2, 16, tcfg.d_model)).astype(np.float32)
    xj, xt = _pair(x, dtype_name)
    out_t, (k_t, v_t) = tattn.attention_block(weights.params_from_numpy(p, DEV), xt, tcfg,
                                              causal=True, q_chunk=8, kv_chunk=4,
                                              return_kv=True)
    block_j = jax.jit(functools.partial(jattn.attention_block, cfg=jcfg, causal=True,
                                        q_chunk=8, kv_chunk=4, return_kv=True))
    out_j, (k_j, v_j) = block_j(jax.tree.map(jnp.asarray, p), xj)
    for a, b, what in ((out_t, out_j, "out"), (k_t, k_j, "k"), (v_t, v_j, "v")):
        assert a.dtype == xt.dtype
        _close(a, b, dtype_name, what)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_cache", "int8_cache"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["minitron_8b", "qwen1_5_32b"])
def test_decode_attention(smoke_params, arch, dtype_name, quant):
    jcfg, tcfg = _cfgs(arch, dtype_name)
    p = _attn_params(smoke_params, arch)
    rng = np.random.default_rng(7)
    b, s_max, kv, hd = 3, 16, tcfg.n_kv, tcfg.hd
    x = rng.standard_normal((b, 1, tcfg.d_model)).astype(np.float32)
    pos = np.array([0, 5, 15], np.int32)
    xj, xt = _pair(x, dtype_name)
    if quant:
        kc = rng.integers(-127, 128, (b, s_max, kv, hd)).astype(np.int8)
        vc = rng.integers(-127, 128, (b, s_max, kv, hd)).astype(np.int8)
        ks = np.asarray(jnp.asarray(rng.random((b, s_max, kv)) / 50 + 1e-3, jnp.bfloat16))
        vs = np.asarray(jnp.asarray(rng.random((b, s_max, kv)) / 50 + 1e-3, jnp.bfloat16))
        cache = {"k": kc, "v": vc, "k_scale": ks, "v_scale": vs}
    else:
        cache = {n: np.asarray(jnp.asarray(rng.standard_normal((b, s_max, kv, hd)),
                                           jnp.bfloat16)) for n in ("k", "v")}
    tc = weights.cache_from_numpy(cache, DEV)
    jargs = [jnp.asarray(cache[n]) for n in ("k", "v")]
    targs = [tc["k"], tc["v"]]
    if quant:
        jargs += [jnp.asarray(cache["k_scale"]), jnp.asarray(cache["v_scale"])]
        targs += [tc["k_scale"], tc["v_scale"]]
    step_j = jax.jit(functools.partial(jattn.decode_attention, cfg=jcfg))
    scales_j = dict(zip(("k_scale", "v_scale"), jargs[2:]))
    res_j = step_j(jax.tree.map(jnp.asarray, p), xj, *jargs[:2], jnp.asarray(pos), **scales_j)
    res_t = tattn.decode_attention(weights.params_from_numpy(p, DEV), xt, targs[0], targs[1],
                                   torch.from_numpy(pos), tcfg, *targs[2:])
    assert res_t[0].dtype == xt.dtype
    _close(res_t[0], res_j[0], dtype_name, "out")
    for name, got, t_in in zip(("k", "v", "k_scale", "v_scale"), res_t[1:], targs):
        assert got is t_in  # written in place
        want = np.asarray(res_j[1 + ("k", "v", "k_scale", "v_scale").index(name)], np.float32)
        if got.dtype == torch.int8:
            assert np.abs(_np(got) - want).max() <= 1, name
        else:
            _close(got, want, dtype_name, name)


def test_quantize_kv_matches():
    x = np.random.default_rng(8).standard_normal((3, 7, 2, 16)).astype(np.float32) * 4
    x[0, 0, 0] = 0.0  # an all-zero row: scale 0, values 0
    qj, sj = jattn._quantize_kv(jnp.asarray(x))
    qt, st = tattn._quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_np(st), np.asarray(sj, np.float32))


# Stated bound of the int8 cache against the same step on an f32 cache of the
# same k/v: a dequantised entry is off by at most 0.5 * scale (rounding) plus
# 127 * scale * 2^-9 (the bf16 scale), 0.75 / 127 < 0.6% of its row's largest
# |entry|; through the softmax weights and the output projection the step
# output stays within INT8_REL of its largest |entry|. chip_smoke.py holds
# minitron-8b's full width to the same bound.
INT8_REL = 2.0 ** -6


@pytest.mark.parametrize("arch", ["minitron_8b", "qwen1_5_32b"])
def test_int8_cache_step_within_stated_bound(smoke_params, arch):
    _, tcfg = _cfgs(arch)
    p = weights.params_from_numpy(_attn_params(smoke_params, arch), DEV)
    rng = np.random.default_rng(9)
    b, s = 2, 64
    ctx = torch.from_numpy(rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((b, 1, tcfg.d_model)).astype(np.float32))
    _, (k, v) = tattn.attention_block(p, ctx, tcfg, causal=True, return_kv=True)
    pos = torch.full((b,), s - 1, dtype=torch.int32)
    out = tattn.decode_attention(p, x, k.clone(), v.clone(), pos, tcfg)[0]
    kq, ks = tattn._quantize_kv(k)
    vq, vs = tattn._quantize_kv(v)
    out_q = tattn.decode_attention(p, x, kq, vq, pos, tcfg, ks, vs)[0]
    rel = float((out_q - out).abs().max() / out.abs().max())
    assert 0 < rel <= INT8_REL, rel


# ---------------------------------------------------------------------------
# forward, decode_step, prefill_cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["all", "last", "none"])
@pytest.mark.parametrize("arch", FWD_ARCHS)
def test_forward_modes_with_collect_kv(smoke_params, arch, mode):
    jcfg, tcfg = _cfgs(arch)
    tokens = np.random.default_rng(10).integers(0, tcfg.vocab, (2, 16)).astype(np.int32)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    fwd_j = jax.jit(functools.partial(jm.forward, q_chunk=8, kv_chunk=4, logits_mode=mode,
                                      collect_kv=True))
    out_j, aux_j, (k_j, v_j) = fwd_j(jax.tree.map(jnp.asarray, smoke_params[arch]),
                                     {"tokens": jnp.asarray(tokens)})
    out_t, aux_t, (k_t, v_t) = tm.forward(weights.params_from_numpy(smoke_params[arch], DEV),
                                          {"tokens": torch.from_numpy(tokens)}, q_chunk=8,
                                          kv_chunk=4, logits_mode=mode, collect_kv=True)
    assert tuple(out_t.shape) == tuple(out_j.shape)
    assert tuple(k_t.shape) == tuple(k_j.shape) == (tcfg.n_layers, 2, 16, tcfg.n_kv, tcfg.hd)
    for a, b, what in ((out_t, out_j, "out"), (k_t, k_j, "k"), (v_t, v_j, "v")):
        _close(a, b, "float32", what)
    assert float(aux_t) == float(aux_j) == 0.0


@pytest.mark.parametrize("arch", ["minitron_8b", "qwen1_5_32b"])
def test_forward_bf16(smoke_params, arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    tokens = np.random.default_rng(11).integers(0, tcfg.vocab, (2, 16)).astype(np.int32)
    out_j, _ = jbuild(jcfg).forward(jax.tree.map(jnp.asarray, smoke_params[arch]),
                                    {"tokens": jnp.asarray(tokens)}, q_chunk=8, kv_chunk=4)
    out_t, _ = build_model(tcfg).forward(weights.params_from_numpy(smoke_params[arch], DEV),
                                         {"tokens": torch.from_numpy(tokens)},
                                         q_chunk=8, kv_chunk=4)
    assert out_t.dtype == torch.float32
    # Two layers of bf16 products: where the two packages' f32 accumulators
    # round one bf16 intermediate to neighbouring values, every logit moves
    # by up to about one bf16 ulp of the logits' scale, so the bf16
    # tolerance's absolute term is taken at that scale.
    ref = _np(out_j)
    np.testing.assert_allclose(_np(out_t), ref, rtol=2e-2, atol=2e-2 * np.abs(ref).max())
    pre_t, _ = build_model(tcfg).prefill(weights.params_from_numpy(smoke_params[arch], DEV),
                                         {"tokens": torch.from_numpy(tokens)},
                                         q_chunk=8, kv_chunk=4)
    _close(pre_t, out_t[:, -1:], "float32")


# cache kinds of the decode chain: (kv_quant, cache dtype, tolerance of the
# logits). A float32 model writes f32 k/v that differ from JAX's in the last
# bits; a bf16 or int8 cache entry whose value lies that close to a rounding
# boundary rounds the other way in one package, and the next steps read it:
# their logits are held at the cache type's tolerance (bf16 2e-2; an int8
# step is coarser than a bf16 one, each step is also rounded to bf16 scales).
CACHES = {"f32_cache": (False, "float32", "float32"),
          "bf16_cache": (False, "bfloat16", "bfloat16"),
          "int8_cache": (True, "bfloat16", "bfloat16")}


@pytest.mark.parametrize("cache_kind", list(CACHES))
@pytest.mark.parametrize("arch", ["minitron_8b", "qwen1_5_32b"])
def test_decode_step_chain(smoke_params, arch, cache_kind):
    """Five decode steps from an empty cache, rows at different positions."""
    quant, cache_dt, logit_tol = CACHES[cache_kind]
    jcfg, tcfg = _cfgs(arch)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jax.tree.map(jnp.asarray, smoke_params[arch])
    tp = weights.params_from_numpy(smoke_params[arch], DEV)
    jc = jm.init_cache(2, 12, DTYPES[cache_dt][0], kv_quant=quant)
    tc = tm.init_cache(2, 12, DTYPES[cache_dt][1], kv_quant=quant, device=DEV)
    rng = np.random.default_rng(12)
    pos = np.array([0, 3], np.int32)
    step = jax.jit(jm.decode_step)
    for _ in range(5):
        tok = rng.integers(0, tcfg.vocab, (2,)).astype(np.int32)
        lj, jc = step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        lt, tc2 = tm.decode_step(tp, tc, torch.from_numpy(tok), torch.from_numpy(pos))
        assert tc2 is tc
        _close(lt, lj, logit_tol, f"logits at {pos}")
        pos = pos + 1
    for name in tc:
        got, want = _np(tc[name]), np.asarray(jc[name], np.float32)
        if tc[name].dtype == torch.int8:
            assert np.abs(got - want).max() <= 1, name
            assert (got == want).mean() > 0.99, name
        else:
            _close(tc[name], want, cache_dt, name)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_cache", "int8_cache"])
@pytest.mark.parametrize("arch", ["stablelm_1_6b", "minitron_8b"])
def test_prefill_cache(smoke_params, arch, quant):
    """Two ragged rows into slots 2 and 0 of a 3-row cache: last-token logits
    and every written cache row; slot 1 stays untouched (zeros)."""
    jcfg, tcfg = _cfgs(arch)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    tokens = np.random.default_rng(13).integers(0, tcfg.vocab, (2, 8)).astype(np.int32)
    slots = np.array([2, 0], np.int32)
    lengths = np.array([5, 8], np.int32)
    lj, jc = jax.jit(jm.prefill_cache)(jax.tree.map(jnp.asarray, smoke_params[arch]),
                              jm.init_cache(3, 16, kv_quant=quant), jnp.asarray(tokens),
                              jnp.asarray(slots), jnp.asarray(lengths))
    tc = tm.init_cache(3, 16, kv_quant=quant, device=DEV)
    lt, tc2 = tm.prefill_cache(weights.params_from_numpy(smoke_params[arch], DEV), tc,
                               torch.from_numpy(tokens), torch.from_numpy(slots),
                               torch.from_numpy(lengths))
    assert tc2 is tc and lt.shape == (2, tcfg.padded_vocab)
    _close(lt, lj, "float32", "last logits")
    for name in tc:
        got, want = _np(tc[name]), np.asarray(jc[name], np.float32)
        assert not got[:, 1].any(), name
        if tc[name].dtype == torch.int8:
            assert np.abs(got - want).max() <= 1, name
        else:
            _close(tc[name], want, "bfloat16", name)
