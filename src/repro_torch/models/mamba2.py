"""Mamba2 / SSD (state-space duality) block (port of ``repro.models.mamba2``),
arXiv:2405.21060.

Chunked SSD path (quadratic within a chunk, linear across chunks, the
state carried from chunk to chunk) and the O(1)-state cached decode step.
Single B/C group (ngroups=1, the released-model configuration). Internals
are float32 where the JAX package's are (float64 for a float64 input).

The decode step writes its conv window and SSM state into the caller's
tensors in place (JAX returns new ones), so a layer's state may be a view
of the stacked (L, B, ...) cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import P, _silu, acc_dtype, rms_norm


def mamba_specs(cfg) -> dict:
    d = cfg.d_model
    di = cfg.d_inner
    ds = cfg.ssm_state
    nh = cfg.ssm_heads
    w = cfg.ssm_conv
    conv_dim = di + 2 * ds
    return {
        # fused in_proj -> [z (di), xBC (di+2ds), dt (nh)]
        "in_proj": P((d, 2 * di + 2 * ds + nh), ("embed", "mlp")),
        "conv_w": P((w, conv_dim), (None, "mlp")),
        "conv_b": P((conv_dim,), ("mlp",), init="zeros"),
        "A_log": P((nh,), (None,), init="zeros"),
        "D": P((nh,), (None,), init="ones"),
        "dt_bias": P((nh,), (None,), init="zeros"),
        "norm_w": P((di,), ("mlp",), init="ones"),
        "out_proj": P((di, d), ("mlp", "embed")),
    }


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0), with no threshold
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _segsum_decay(dA):
    """dA: (..., Q) per-step log-decay -> (..., Q, Q) lower-tri decay matrix
    L[q, s] = exp(sum_{s < i <= q} dA_i), 0 for s > q.

    The mask is applied before ``exp``: above the diagonal ``diff`` is a
    sum of positive terms, and over a long chunk its ``exp`` overflows
    float32; the JAX package masks after ``exp``, so its backward multiplies
    the masked zero cotangent by inf and its gradient is NaN at mamba2's
    chunk 256. ``exp(-inf) = 0`` keeps the forward bitwise JAX's."""
    q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # (..., q, s)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dA.device))
    return torch.exp(torch.where(mask, diff, float("-inf")))


def _ssd_step(hs, x_i, dt_i, A, B_i, C_i):
    """One chunk of the SSD scan (inputs already in the f32/f64 internal
    dtype): the chunk's output and the state carried past it."""
    dA = dt_i * A  # (b,q,h) log decay (A negative)
    dA_cum = torch.cumsum(dA, dim=1)  # inclusive over q
    xdt = x_i * dt_i[..., None]
    # intra-chunk (quadratic within the chunk only)
    L = _segsum_decay(dA.transpose(1, 2))  # (b,h,q,s)
    scores = torch.einsum("bqn,bsn->bqs", C_i, B_i)
    y_diag = torch.einsum("bhqs,bshp->bqhp", scores[:, None] * L, xdt)
    # contribution of the carried state
    in_decay = torch.exp(dA_cum)  # (b,q,h)
    y_off = torch.einsum("bqn,bhnp->bqhp", C_i, hs) * in_decay[..., None]
    # state update
    decay_to_end = torch.exp(dA_cum[:, -1:, :] - dA_cum)  # (b,q,h)
    S = torch.einsum("bsn,bshp->bhnp", B_i, decay_to_end[..., None] * xdt)
    chunk_decay = torch.exp(dA_cum[:, -1, :])  # (b,h)
    return y_diag + y_off, hs * chunk_decay[..., None, None] + S


def ssd_chunked(x, dt, A, B, C, chunk: int, unroll: bool = False):
    """SSD scan. x: (b,T,H,P); dt: (b,T,H); A: (H,); B,C: (b,T,N).
    Returns (y (b,T,H,P) in x's dtype, final_state (b,H,N,P) in float32).

    A Python loop over chunks: each step does the quadratic intra-chunk work
    of its own chunk and carries the inter-chunk state, so one chunk's
    (Q x Q) decay matrices exist at a time (b*h*Q^2, not b*nc*h*Q^2). Under
    autograd each step is remat'd (``checkpoint``), as the JAX package's
    ``jax.checkpoint`` step is. ``unroll`` is accepted for the JAX
    signature: the loop is unrolled."""
    del unroll
    b, t, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, t)
    if t % q:
        raise ValueError(f"ssd_chunked: T = {t} is not a multiple of the chunk {q}")
    adt = acc_dtype(x.dtype)
    A = A.to(adt)
    hs = torch.zeros((b, h, n, p), dtype=adt, device=x.device)
    step = _ssd_step
    if torch.is_grad_enabled():
        step = lambda *args: checkpoint(_ssd_step, *args, use_reentrant=False)  # noqa: E731
    ys = []
    for i in range(t // q):
        sl = slice(i * q, (i + 1) * q)
        y_i, hs = step(hs, *(a[:, sl].to(adt) for a in (x, dt)), A,
                       *(a[:, sl].to(adt) for a in (B, C)))
        ys.append(y_i.to(x.dtype))
    return torch.cat(ys, dim=1), hs


def _causal_conv(xbc, w, bias):
    """Depthwise causal conv. xbc: (b,T,C); w: (W,C). The taps are summed
    from tap 0, in xbc's dtype, as the JAX package sums them."""
    wlen = w.shape[0]
    t = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, wlen - 1, 0))
    out = sum(pad[:, i:i + t, :] * w[i][None, None, :] for i in range(wlen))
    return out + bias[None, None, :]


def mamba_apply(p, x, cfg, *, return_state: bool = False, unroll: bool = False):
    """Full-sequence Mamba2 mixer. x: (b,T,d). With ``return_state`` also
    (conv tail (b, W-1, conv_dim), SSM state (b, H, N, P)): what the decode
    step carries after the sequence."""
    dt_ = x.dtype
    b, t, d = x.shape
    di, ds, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim

    zxbcdt = x @ p["in_proj"].to(dt_)
    z, xBC_raw, dt = torch.split(zxbcdt, [di, di + 2 * ds, nh], dim=-1)
    xBC = _silu(_causal_conv(xBC_raw, p["conv_w"].to(dt_), p["conv_b"].to(dt_)))
    xin, B, C = torch.split(xBC, [di, ds, ds], dim=-1)

    adt = acc_dtype(dt_)
    dt = _softplus(dt.to(adt) + p["dt_bias"].to(adt))
    A = -torch.exp(p["A_log"].to(adt))

    y, state = ssd_chunked(xin.reshape(b, t, nh, hd), dt, A, B, C, cfg.ssm_chunk)
    y = y + xin.reshape(b, t, nh, hd) * p["D"].to(dt_)[None, None, :, None]
    y = y.reshape(b, t, di)
    y = rms_norm(y * _silu(z), p["norm_w"], cfg.norm_eps)
    out = y @ p["out_proj"].to(dt_)
    if return_state:
        w1 = cfg.ssm_conv - 1
        conv_tail = F.pad(xBC_raw, (0, 0, max(0, w1 - t), 0))[:, -w1:, :]
        return out, (conv_tail, state)
    return out, None


def mamba_decode(p, x, conv_state, ssm_state, cfg):
    """One-token decode. x: (b,1,d); conv_state: (b,W-1,conv_dim) in the cache
    dtype; ssm_state: (b,H,N,P) float32. Both are updated in place. Returns
    (out, conv_state, ssm_state)."""
    dt_ = x.dtype
    b = x.shape[0]
    di, ds, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    adt = acc_dtype(dt_)

    zxbcdt = x[:, 0] @ p["in_proj"].to(dt_)  # (b, ...)
    z, xBC_new, dt = torch.split(zxbcdt, [di, di + 2 * ds, nh], dim=-1)

    window = torch.cat([conv_state, xBC_new[:, None, :]], dim=1)  # (b,W,C)
    wf, cw = window.to(adt), p["conv_w"].to(adt)
    conv_out = sum(wf[:, i] * cw[i] for i in range(cw.shape[0])) + p["conv_b"].to(adt)
    xBC = _silu(conv_out).to(dt_)
    xin, B, C = torch.split(xBC, [di, ds, ds], dim=-1)

    dt = _softplus(dt.to(adt) + p["dt_bias"].to(adt))  # (b,nh)
    A = -torch.exp(p["A_log"].to(adt))
    dA = torch.exp(dt * A)  # (b,nh)

    xh = xin.reshape(b, nh, hd).to(adt)
    Bf = B.to(adt)
    Cf = C.to(adt)
    # state <- state * dA + dt * (B outer x)
    upd = Bf[:, None, :, None] * (dt[..., None] * xh)[:, :, None, :]  # (b,h,n,p)
    ssm_state.copy_(ssm_state * dA[..., None, None] + upd)
    conv_state.copy_(window[:, 1:])
    y = torch.einsum("bn,bhnp->bhp", Cf, ssm_state.to(adt))
    y = y + xh * p["D"].to(adt)[None, :, None]
    y = y.reshape(b, di).to(dt_)
    y = rms_norm(y * _silu(z), p["norm_w"], cfg.norm_eps)
    out = (y @ p["out_proj"].to(dt_))[:, None, :]
    return out, conv_state, ssm_state
