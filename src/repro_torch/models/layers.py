"""Common model layers (port of ``repro.models.layers``): norms, RoPE, MLPs,
embeddings.

Functional style: ``*_specs(cfg)`` returns the P-spec tree, ``*_apply``
consumes the matching params subtree. Compute dtype follows the input
activations; params are cast at the call site (mixed precision). Every cast
is the JAX package's: a product of two activation-dtype tensors stays in
that dtype, a bf16 tensor times an f32 one promotes to f32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.spec import P


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type JAX's ``astype(float32)`` and ``preferred_element_type=f32``
    give a bf16 or f32 input: float32. A float64 input (the port's float64
    witness; JAX runs without x64) keeps float64."""
    return torch.promote_types(dtype, torch.float32)


def rms_norm(x, w, eps: float):
    # f32 only for the per-token statistics: the (B,S,D)-sized products
    # stay in the activation dtype.
    ms = x.to(acc_dtype(x.dtype)).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(ms + eps).to(x.dtype)
    return (x * inv) * w.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None, dtype=torch.float32):
    exps = torch.arange(0, head_dim, 2, dtype=dtype, device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: (..., S) integer."""
    d = x.shape[-1]
    adt = acc_dtype(x.dtype)
    freqs = rope_freqs(d, theta, x.device, adt)  # (D/2,)
    angles = positions[..., None].to(adt) * freqs  # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------


def mlp_specs(d: int, ff: int, act: str) -> dict:
    if act == "swiglu":
        return {
            "gate": P((d, ff), ("embed", "mlp")),
            "up": P((d, ff), ("embed", "mlp")),
            "down": P((ff, d), ("mlp", "embed")),
        }
    return {
        "up": P((d, ff), ("embed", "mlp")),
        "up_b": P((ff,), ("mlp",), init="zeros"),
        "down": P((ff, d), ("mlp", "embed")),
        "down_b": P((d,), ("embed",), init="zeros"),
    }


def _silu(x):
    # jax.nn.silu as XLA lowers it: x * 1 / (1 + exp(-x)), each op rounded to
    # the activation dtype
    return x * (1 / (1 + torch.exp(-x)))


def _gelu_tanh(x):
    # jax.nn.gelu(approximate=True), op by op, its constants in x's dtype
    c = torch.full((), math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    a = torch.full((), 0.044715, dtype=x.dtype, device=x.device)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + a * (x * x * x))))
    return x * cdf


def mlp_apply(p, x, act: str):
    dt = x.dtype
    if act == "swiglu":
        h = _silu(x @ p["gate"].to(dt)) * (x @ p["up"].to(dt))
        return h @ p["down"].to(dt)
    h = _gelu_tanh(x @ p["up"].to(dt) + p["up_b"].to(dt))
    return h @ p["down"].to(dt) + p["down_b"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_specs(vocab: int, d: int) -> dict:
    return {"tokens": P((vocab, d), ("vocab", "embed"), init="small_normal")}


def embed_apply(p, tokens, dtype):
    table = p["tokens"]
    rows = torch.index_select(table, 0, tokens.reshape(-1))
    return rows.reshape(*tokens.shape, table.shape[-1]).to(dtype)


def unembed_specs(d: int, vocab: int) -> dict:
    return {"out": P((d, vocab), ("embed", "vocab"))}


def unembed_apply(p, x):
    # logits in f32 for numerically-stable CE (f64 for a float64 witness);
    # the product in x's dtype
    return (x @ p["out"].to(x.dtype)).to(acc_dtype(x.dtype))
