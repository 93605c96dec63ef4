"""The port's Mamba2 / SSD block (``repro_torch.models.mamba2``) and the serving
engine on the recurrent families, on the CPU against the JAX package.

Block: ``ssd_chunked`` (with chunk invariance), ``_causal_conv``,
``mamba_apply`` with its final state, and a ``mamba_decode`` chain, on
numpy inputs and JAX's initialised weights (mamba2-2.7b's smoke config),
within ``torch_parity.tol``.

Engine: mamba2's and zamba2's smoke configs in float32 with float32 caches,
2 slots and 5 ragged requests (slots reused, a refill while the other slot
decodes). Every logit the port's ``DecodeEngine`` computes for a request
must equal JAX's single-request ``decode_step`` chain fed the same tokens
(the prompt, then the port's own greedy tokens), within 1e-4 * max|logit|.
JAX's own engine does not meet this on these families: its prefill steps
every slot and never resets one (``ROADMAP.md`` Queue 3).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as jconfigs
import repro.models.mamba2 as jm2
import repro.models.spec as jspec
from repro.models import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models import mamba2 as tm2
from repro_torch.models import weights
from torch_parity import tol
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

DEV = "cpu"
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# 5 requests through 2 slots; at max_len 14 the 9-token prompt retires
# after 5 tokens, so its slot is refilled while the other request decodes
ENGINE_LENGTHS = (5, 9, 3, 7, 4)
ENGINE_NEW, ENGINE_MAX_LEN, ENGINE_SLOTS = 6, 14, 2
LOGIT_REL = 1e-4


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _cfgs(arch="mamba2_2_7b", dtype_name="float32"):
    j = dataclasses.replace(jconfigs.get_config(arch, smoke=True), dtype=dtype_name)
    t = dataclasses.replace(tconfigs.get_config(arch, smoke=True), dtype=dtype_name)
    return j, t


@pytest.fixture(scope="module")
def mixer():
    """JAX's initialised mixer weights (mamba2 smoke), with A_log, dt_bias,
    D and conv_b given values (zeros or ones at init)."""
    jcfg, _ = _cfgs()
    p = jax.tree.map(np.asarray, jspec.init_params(jm2.mamba_specs(jcfg), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    nh = jcfg.ssm_heads
    p["A_log"] = rng.uniform(-1, 1, nh).astype(np.float32)
    p["dt_bias"] = rng.uniform(-2, 0, nh).astype(np.float32)
    p["D"] = rng.uniform(0.5, 1.5, nh).astype(np.float32)
    p["conv_b"] = (rng.standard_normal(p["conv_b"].shape) * 0.1).astype(np.float32)
    return p


def _ssd_inputs(seed, b=2, t=64, h=4, p=8, n=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, t, h)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, h).astype(np.float32)
    B = rng.standard_normal((b, t, n)).astype(np.float32)
    C = rng.standard_normal((b, t, n)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("chunk", [16, 64, 256])
def test_ssd_chunked_matches_jax(chunk, dtype_name):
    x, dt, A, B, C = _ssd_inputs(1)
    jd, td = DTYPES[dtype_name]
    y_j, s_j = jax.jit(functools.partial(jm2.ssd_chunked, chunk=chunk))(
        jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(B, jd),
        jnp.asarray(C, jd))
    y_t, s_t = tm2.ssd_chunked(torch.from_numpy(x).to(td), torch.from_numpy(dt),
                               torch.from_numpy(A), torch.from_numpy(B).to(td),
                               torch.from_numpy(C).to(td), chunk)
    assert y_t.dtype == td and s_t.dtype == torch.float32
    np.testing.assert_allclose(_np(y_t), _np(y_j), **tol(dtype_name))
    np.testing.assert_allclose(_np(s_t), _np(s_j), **tol(dtype_name))


def test_ssd_chunk_invariance_and_float64():
    """The output must not depend on the chunk size; float64 runs the same
    algorithm without float32 rounding."""
    x, dt, A, B, C = (torch.from_numpy(a) for a in _ssd_inputs(2, t=128))
    y16, s16 = tm2.ssd_chunked(x, dt, A, B, C, 16)
    y128, s128 = tm2.ssd_chunked(x, dt, A, B, C, 128)
    np.testing.assert_allclose(y16.numpy(), y128.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s16.numpy(), s128.numpy(), rtol=1e-4, atol=1e-4)
    y64, s64 = tm2.ssd_chunked(*(a.double() for a in (x, dt, A, B, C)), 32)
    assert y64.dtype == s64.dtype == torch.float64
    np.testing.assert_allclose(y16.numpy(), y64.numpy(), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tm2.ssd_chunked(x[:, :100], dt[:, :100], A, B[:, :100], C[:, :100], 64)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_causal_conv_matches_jax(dtype_name):
    rng = np.random.default_rng(3)
    xbc = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    jd, td = DTYPES[dtype_name]
    out_j = jm2._causal_conv(jnp.asarray(xbc, jd), jnp.asarray(w, jd), jnp.asarray(bias, jd))
    out_t = tm2._causal_conv(*(torch.from_numpy(a).to(td) for a in (xbc, w, bias)))
    assert out_t.dtype == td
    np.testing.assert_allclose(_np(out_t), _np(out_j), **tol(dtype_name))


@pytest.mark.parametrize("t", [2, 64], ids=["shorter_than_the_window", "two_chunks"])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_mamba_apply_with_state_matches_jax(mixer, dtype_name, t):
    jcfg, tcfg = _cfgs(dtype_name=dtype_name)
    jd, td = DTYPES[dtype_name]
    x = np.random.default_rng(4).standard_normal((2, t, tcfg.d_model)).astype(np.float32)
    fn = jax.jit(functools.partial(jm2.mamba_apply, cfg=jcfg, return_state=True))
    out_j, (conv_j, ssm_j) = fn(jax.tree.map(jnp.asarray, mixer), jnp.asarray(x, jd))
    out_t, (conv_t, ssm_t) = tm2.mamba_apply(weights.params_from_numpy(mixer, DEV),
                                             torch.from_numpy(x).to(td), tcfg,
                                             return_state=True)
    assert out_t.dtype == td and tuple(conv_t.shape) == tuple(conv_j.shape)
    for a, b, what in ((out_t, out_j, "out"), (conv_t, conv_j, "conv"), (ssm_t, ssm_j, "ssm")):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=what, **tol(dtype_name))


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_mamba_decode_chain_matches_jax_and_apply(mixer, dtype_name):
    """Eight one-token steps from a zero state, in place; the final state is
    mamba_apply's over the same eight tokens."""
    jcfg, tcfg = _cfgs(dtype_name=dtype_name)
    jd, td = DTYPES[dtype_name]
    b, steps = 2, 8
    conv_dim = tcfg.d_inner + 2 * tcfg.ssm_state
    x = np.random.default_rng(5).standard_normal((b, steps, tcfg.d_model)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, mixer)
    tp = weights.params_from_numpy(mixer, DEV)
    conv_j = jnp.zeros((b, tcfg.ssm_conv - 1, conv_dim), jd)
    ssm_j = jnp.zeros((b, tcfg.ssm_heads, tcfg.ssm_state, tcfg.ssm_head_dim), jnp.float32)
    conv_t = torch.zeros(tuple(conv_j.shape), dtype=td)
    ssm_t = torch.zeros(tuple(ssm_j.shape))
    step_j = jax.jit(functools.partial(jm2.mamba_decode, cfg=jcfg))
    for i in range(steps):
        out_j, conv_j, ssm_j = step_j(jp, jnp.asarray(x[:, i:i + 1], jd), conv_j, ssm_j)
        out_t, c2, s2 = tm2.mamba_decode(tp, torch.from_numpy(x[:, i:i + 1]).to(td),
                                         conv_t, ssm_t, tcfg)
        assert c2 is conv_t and s2 is ssm_t and out_t.dtype == td
        np.testing.assert_allclose(_np(out_t), _np(out_j), err_msg=f"step {i}",
                                   **tol(dtype_name))
    np.testing.assert_allclose(_np(conv_t), _np(conv_j), **tol(dtype_name))
    np.testing.assert_allclose(_np(ssm_t), _np(ssm_j), **tol(dtype_name))
    _, (conv_a, ssm_a) = tm2.mamba_apply(tp, torch.from_numpy(x).to(td), tcfg,
                                         return_state=True)
    np.testing.assert_allclose(_np(conv_a), _np(conv_t), **tol(dtype_name))
    np.testing.assert_allclose(_np(ssm_a), _np(ssm_t), **tol(dtype_name))


def test_softplus_is_logaddexp():
    """No threshold: softplus(30) is 30 + log1p(exp(-30)), as in JAX. (XLA
    flushes the subnormal softplus(-100) to zero; torch keeps it: atol is
    float32's smallest normal.)"""
    x = torch.tensor([-100.0, -20.0, -1.0, 0.0, 1.0, 20.0, 30.0, 100.0])
    np.testing.assert_allclose(tm2._softplus(x).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x.numpy()))),
                               rtol=1e-7, atol=np.finfo(np.float32).tiny)


# ---------------------------------------------------------------------------
# the engine on the recurrent families
# ---------------------------------------------------------------------------


def _requests(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, (n,)).astype(np.int32))
            for i, n in enumerate(ENGINE_LENGTHS)]


@pytest.fixture(scope="module", params=["mamba2_2_7b", "zamba2_2_7b"])
def engine_run(request):
    """The port's engine over the float32 smoke model (float32 cache), then
    JAX's single-request decode chain of each request fed the tokens the
    port produced: logits at every position of both."""
    arch = request.param
    jcfg, tcfg = _cfgs(arch)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(1))
    tp = weights.params_from_numpy(jax.tree.map(np.asarray, jp), DEV)
    reqs = _requests(tcfg.vocab)
    engine = tserve.DecodeEngine(tm, tp, ENGINE_SLOTS, ENGINE_MAX_LEN, device=DEV,
                                 record_logits=True)
    engine.cache = tm.init_cache(ENGINE_SLOTS, ENGINE_MAX_LEN, torch.float32, device=DEV)
    admits, refill = [], engine.refill

    def counted_refill():  # (admitted, slots busy decoding at the time)
        busy = int(engine.active.sum())
        n = refill()
        if n:
            admits.append((n, busy))
        return n
    engine.refill = counted_refill
    done, steps = tserve.serve(engine, reqs, ENGINE_NEW)
    step = jax.jit(jm.decode_step)
    refs = {}
    for rid, prompt in reqs:
        fed = list(prompt) + dict(done)[rid][:-1]
        cache = jm.init_cache(1, ENGINE_MAX_LEN, jnp.float32)
        rows = []
        for i, tok in enumerate(fed):
            lg, cache = step(jp, cache, jnp.asarray([tok], jnp.int32),
                             jnp.asarray([i], jnp.int32))
            rows.append(np.asarray(lg[0]))
        refs[rid] = np.stack(rows)
    return dict(arch=arch, tm=tm, tp=tp, engine=engine, done=dict(done), steps=steps,
                reqs=reqs, refs=refs, admits=admits)


def test_engine_logits_match_the_single_request_chain(engine_run):
    engine = engine_run["engine"]
    assert engine.prefill_calls == len(ENGINE_LENGTHS)
    assert sorted(engine_run["done"]) == list(range(len(ENGINE_LENGTHS)))
    for rid, prompt in engine_run["reqs"]:
        out = engine_run["done"][rid]
        assert len(out) == min(ENGINE_NEW, ENGINE_MAX_LEN - len(prompt))
        got = torch.stack(engine.logits_log[rid]).numpy()
        ref = engine_run["refs"][rid]
        assert got.shape == ref.shape == (len(prompt) + len(out) - 1, ref.shape[1])
        scale = np.abs(ref).max()
        err = np.abs(got - ref).max()
        assert err <= LOGIT_REL * scale, (rid, err / scale)
        assert out == [int(np.argmax(r)) for r in ref[len(prompt) - 1:]]


def test_engine_reuses_slots_with_a_refill_while_decoding(engine_run):
    """5 requests, 2 slots: slots are reused, and a request is admitted
    while the other slot holds a request mid-decode."""
    admits = engine_run["admits"]
    assert sum(n for n, _ in admits) == len(ENGINE_LENGTHS) and len(admits) >= 3
    assert any(busy > 0 for _, busy in admits), admits


def test_stepping_one_slot_leaves_the_others_bitwise(engine_run):
    """A prefill on slot 1 zeroes that slot's conv/ssm rows and steps it
    alone: slot 0's conv, ssm (and k/v) rows stay bitwise as they were."""
    tm, tp = engine_run["tm"], engine_run["tp"]
    engine = tserve.DecodeEngine(tm, tp, ENGINE_SLOTS, ENGINE_MAX_LEN, device=DEV)
    g = torch.Generator().manual_seed(0)
    for t in engine.cache.values():
        t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    before = {k: v.clone() for k, v in engine.cache.items()}
    engine._prefill_by_decode(engine_run["reqs"][0][1], 1)
    for name, t in engine.cache.items():
        assert torch.equal(t[:, 0], before[name][:, 0]), name
        assert not torch.equal(t[:, 1], before[name][:, 1]), name
    # the slot's state is what a fresh single-request chain leaves
    fresh = tm.init_cache(1, ENGINE_MAX_LEN, device=DEV)
    for i, tok in enumerate(engine_run["reqs"][0][1]):
        tm.decode_step(tp, fresh, torch.tensor([int(tok)]), torch.tensor([i]))
    for name in ("conv", "ssm"):
        assert torch.equal(engine.cache[name][:, 1:2], fresh[name]), name
