"""The port's flash-attention backward (``repro_torch.models.flash``, the
``torch.autograd.Function`` whose backward is JAX's ``_flash_bwd``) on the
CPU: dq/dk/dv against ``jax.grad`` of the JAX package's ``flash_attention``
(its ``custom_vjp``) in float32, within 1e-5 * max|g|, over
``tests/test_flash.py``'s (causal, q_chunk, kv_chunk) grid, GQA (8 heads
over 4 kv heads) and MHA; against autograd of the unchunked float64 softmax
attention; and the tensors autograd saves (only q, k, v, out, lse).
Inputs are numpy arrays from fixed seeds; the cotangent is a fixed random
projection of the output.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models.flash as jflash
from repro_torch.models import flash as tflash
from torch_training import one_torch_thread  # noqa: F401 (autouse)

GRAD_REL = 1e-5  # |g_port - g_jax| <= GRAD_REL * max|g_jax|, float32
F64_REL = 1e-5  # float32 chunked backward vs float64 unchunked autograd


def _inputs(heads, seed=4, s=128, d=32):
    h, kvh = heads
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, s, h, d)).astype(np.float32)
    k = rng.standard_normal((2, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((2, s, kvh, d)).astype(np.float32)
    w = rng.standard_normal((2, s, h, d)).astype(np.float32)  # cotangent
    return q, k, v, w


def _torch_grads(q, k, v, w, causal, qc, kc, dtype=torch.float32, fn=None):
    ts = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in (q, k, v)]
    out = (fn or (lambda a, b, c: tflash.flash_attention(a, b, c, causal, qc, kc)))(*ts)
    (out * torch.from_numpy(w).to(dtype)).sum().backward()
    return [t.grad for t in ts]


def _jax_grads(q, k, v, w, causal, qc, kc):
    f = lambda a, b, c: jnp.sum(jflash.flash_attention(a, b, c, causal, qc, kc, False) * w)
    return [np.asarray(g) for g in jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)]


def _assert_rel(got, want, rel, what):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    want = want.detach().double().numpy() if isinstance(want, torch.Tensor) else want
    bound = rel * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max|diff| {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("heads", [(8, 4), (4, 4)], ids=["gqa", "mha"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("qc,kc", [(32, 64), (128, 128), (64, 32), (16, 16)])
def test_flash_grads_match_jax(qc, kc, causal, heads):
    q, k, v, w = _inputs(heads)
    got = _torch_grads(q, k, v, w, causal, qc, kc)
    want = _jax_grads(q, k, v, w, causal, qc, kc)
    for name, g, j in zip("qkv", got, want):
        assert g.shape == j.shape and g.dtype == torch.float32
        _assert_rel(g, j, GRAD_REL, f"d{name}")


def _softmax_attention(q, k, v, causal):
    """Unchunked softmax attention (the oracle), GQA by repeating kv heads."""
    g = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        n = q.shape[1]
        s = s.masked_fill(~torch.tril(torch.ones(n, n, dtype=torch.bool)), float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


@pytest.mark.parametrize("heads", [(8, 4), (4, 4)], ids=["gqa", "mha"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_match_float64_oracle(causal, heads):
    q, k, v, w = _inputs(heads, seed=5)
    got = _torch_grads(q, k, v, w, causal, 32, 64)
    oracle = _torch_grads(q, k, v, w, causal, 0, 0, torch.float64,
                          fn=lambda a, b, c: _softmax_attention(a, b, c, causal))
    for name, g, o in zip("qkv", got, oracle):
        _assert_rel(g, o, F64_REL, f"d{name} vs float64")
    # the chunked backward in float64 is the oracle's within float64 rounding
    got64 = _torch_grads(q, k, v, w, causal, 32, 64, torch.float64)
    for name, g, o in zip("qkv", got64, oracle):
        assert g.dtype == torch.float64
        _assert_rel(g, o, 1e-12, f"d{name} float64 chunked vs unchunked")


def test_flash_saves_only_its_five_residuals():
    q, k, v, _ = _inputs((8, 4))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    packed = []

    def pack(t):
        packed.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tflash.flash_attention(*ts, True, 32, 32)
    b, s, h, d = q.shape
    kvh = k.shape[2]
    assert packed == [q.shape, k.shape, v.shape, out.shape, (b, s // 32, kvh, h // kvh, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_grads_keep_input_dtypes(dtype):
    q, k, v, w = _inputs((8, 4))
    got = _torch_grads(q, k, v, w, True, 64, 32, dtype)
    assert all(g.dtype == dtype and torch.isfinite(g.float()).all() for g in got)
