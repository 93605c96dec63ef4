"""GQA attention (port of ``repro.models.attention``): flash-style chunked
softmax (prefill) + cached decode.

The decode cache is written in place: ``decode_attention`` stores the new
token's k/v into the caller's cache tensors (JAX returns updated copies) and
returns the same tensors, so a layer's cache slice may be a view of the
stacked (L, B, S_max, KV, hd) cache.
"""
from __future__ import annotations

import torch

from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import P, acc_dtype, apply_rope

NEG_INF = -1e30


def attn_specs(cfg) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    s = {
        "wq": P((d, h * hd), ("embed", "heads")),
        "wk": P((d, kv * hd), ("embed", "kv")),
        "wv": P((d, kv * hd), ("embed", "kv")),
        "wo": P((h * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = P((h * hd,), ("heads",), init="zeros")
        s["bk"] = P((kv * hd,), ("kv",), init="zeros")
        s["bv"] = P((kv * hd,), ("kv",), init="zeros")
    return s


def _project_qkv(p, x, cfg, positions):
    dt = x.dtype
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.n_heads > 0 and cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(p, x, cfg, *, causal: bool, positions=None,
                    q_chunk: int = 512, kv_chunk: int = 1024,
                    unroll: bool = False, return_kv: bool = False):
    """Full attention over x. Returns (out, (k, v) | None)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = flash_attention(q, k, v, causal, q_chunk, kv_chunk, unroll)
    out = out.reshape(b, s, -1) @ p["wo"].to(x.dtype)
    return (out, (k, v)) if return_kv else (out, None)


def _quantize_kv(vec):
    """Per-(token, head) int8 quantization: vec (..., D) -> (int8, bf16 scale)."""
    v32 = vec.float()
    scale = v32.abs().amax(dim=-1) / 127.0
    q = torch.round(v32 / torch.clamp(scale, min=1e-12)[..., None]).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def decode_attention(p, x, k_cache, v_cache, pos, cfg,
                     k_scale=None, v_scale=None):
    """One-token cached decode. x: (B,1,d); caches: (B,S_max,KV,D); pos: (B,)
    index of the slot the new token writes.

    int8 cache mode: caches are int8 with bf16 per-(token, head)
    ``k_scale``/``v_scale``; dequantisation is a per-layer transient. The
    new k/v (and scales) are written into the given tensors in place.
    Returns (out, k_cache, v_cache[, k_scale, v_scale]).
    """
    b = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    g = h // kvh
    quant = k_scale is not None
    positions = pos[:, None].to(torch.int32)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)

    # write the new kv at pos (per batch row)
    bidx = torch.arange(b, device=x.device)
    pidx = pos.long()
    if quant:
        kq, ks = _quantize_kv(k_new[:, 0])
        vq, vs = _quantize_kv(v_new[:, 0])
        k_cache[bidx, pidx] = kq
        v_cache[bidx, pidx] = vq
        k_scale[bidx, pidx] = ks
        v_scale[bidx, pidx] = vs
        k_eff = k_cache.to(q.dtype) * k_scale.to(q.dtype)[..., None]
        v_eff = v_cache.to(q.dtype) * v_scale.to(q.dtype)[..., None]
    else:
        k_cache[bidx, pidx] = k_new[:, 0].to(k_cache.dtype)
        v_cache[bidx, pidx] = v_new[:, 0].to(v_cache.dtype)
        k_eff = k_cache.to(q.dtype)
        v_eff = v_cache.to(q.dtype)

    adt = acc_dtype(q.dtype)
    qh = q.reshape(b, kvh, g, hd)
    scores = torch.einsum("bhgd,bshd->bhgs", qh.to(adt), k_eff.to(adt)) * (hd ** -0.5)
    valid = torch.arange(k_cache.shape[1], device=x.device)[None, :] <= pos[:, None]
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", w.to(q.dtype).to(adt), v_eff.to(adt))
    out = out.reshape(b, 1, h * hd).to(x.dtype) @ p["wo"].to(x.dtype)
    if quant:
        return out, k_cache, v_cache, k_scale, v_scale
    return out, k_cache, v_cache
