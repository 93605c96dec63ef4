"""Flash attention with a hand-derived chunked backward (port of
``repro.models.flash``).

Forward: chunked attention with an online (max, sum, acc) softmax in f32:
query chunks are a reshape, key/value chunks a Python loop, so the full
(S x S) score matrix is never held. Plain torch, not a fused attention
call, so its sums follow the JAX package's: scores are f32 products of the
inputs (``preferred_element_type=f32``), each chunk's probabilities are
cast to ``v``'s dtype before the PV product, which accumulates in f32.

Backward (a ``torch.autograd.Function``, JAX's ``custom_vjp``): autograd
through the online softmax would save every chunk's score tiles; the
flash backward recomputes them from (q, k, v, out, lse), so the residuals
are O(S * D). Math (per q-chunk i, kv-chunk j, per head; scale s = d^-1/2):
    S_ij = s * Q_i K_j^T          P_ij = exp(S_ij - lse_i)
    dV_j += P_ij^T dO_i
    dP_ij = dO_i V_j^T            D_i = rowsum(dO_i * O_i)
    dS_ij = P_ij * (dP_ij - D_i)
    dQ_i += s * dS_ij K_j         dK_j += s * dS_ij^T Q_i
q chunks in the outer loop, kv chunks inside it, dK/dV accumulated in that
order in f32 (JAX's scan order), then cast to the inputs' dtypes.

Shapes: q (B,Sq,H,D); k,v (B,Skv,KV,D); GQA via H = KV * G, query head
``h = kv * G + g``.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import acc_dtype

NEG_INF = -1e30


def _chunks(q, k, q_chunk, kv_chunk):
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qc, kc = min(q_chunk, sq), min(kv_chunk, skv)
    return b, sq, h, d, skv, kvh, h // kvh, qc, kc, sq // qc, skv // kc


def _fwd_impl(q, k, v, causal, q_chunk, kv_chunk):
    """(out (B,Sq,H,D) in q's dtype, lse (B, nq, KV, G, qc) in f32). All
    query chunks go through each kv step together (JAX vmaps them)."""
    b, sq, h, d, skv, kvh, g, qc, kc, nq, nk = _chunks(q, k, q_chunk, kv_chunk)
    scale = d ** -0.5
    adt = acc_dtype(q.dtype)

    qr = q.reshape(b, nq, qc, kvh, g, d).to(adt)
    kr = k.reshape(b, nk, kc, kvh, d)
    vr = v.reshape(b, nk, kc, kvh, d)
    q_pos = torch.arange(sq, device=q.device).reshape(nq, qc)
    k_pos = torch.arange(skv, device=q.device).reshape(nk, kc)

    m = torch.full((b, nq, kvh, g, qc), NEG_INF, dtype=adt, device=q.device)
    l = torch.zeros((b, nq, kvh, g, qc), dtype=adt, device=q.device)
    acc = torch.zeros((b, nq, kvh, g, qc, d), dtype=adt, device=q.device)
    for j in range(nk):
        k_j, v_j = kr[:, j], vr[:, j]
        s_ij = torch.einsum("bnqhgd,bkhd->bnhgqk", qr, k_j.to(adt)) * scale
        if causal:
            mask = q_pos[:, :, None] >= k_pos[j][None, None, :]  # (nq, qc, kc)
            s_ij = torch.where(mask[None, :, None, None], s_ij, NEG_INF)
        m_new = torch.maximum(m, s_ij.amax(dim=-1))
        p_ij = torch.exp(s_ij - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p_ij.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bnhgqk,bkhd->bnhgqd", p_ij.to(v_j.dtype).to(adt), v_j.to(adt))
        m = m_new
    l = torch.clamp(l, min=1e-30)
    out = acc / l[..., None]
    lse = m + torch.log(l)
    # (b, nq, kvh, g, qc, d) -> (b, sq, h, d)
    return out.permute(0, 1, 4, 2, 3, 5).reshape(b, sq, h, d).to(q.dtype), lse


def _flash_bwd(q, k, v, out, lse, dout, causal, q_chunk, kv_chunk):
    b, sq, h, d, skv, kvh, g, qc, kc, nq, nk = _chunks(q, k, q_chunk, kv_chunk)
    scale = d ** -0.5
    adt = acc_dtype(q.dtype)

    qr = q.reshape(b, nq, qc, kvh, g, d)
    dor = dout.reshape(b, nq, qc, kvh, g, d).to(adt)
    kr = k.reshape(b, nk, kc, kvh, d)
    vr = v.reshape(b, nk, kc, kvh, d)
    q_pos = torch.arange(sq, device=q.device).reshape(nq, qc)
    k_pos = torch.arange(skv, device=q.device).reshape(nk, kc)
    # D_i = rowsum(dO * O): (b, nq, kvh, g, qc)
    delta = torch.einsum("bnqhgd,bnqhgd->bnhgq", dor, out.reshape(b, nq, qc, kvh, g, d).to(adt))

    dk_acc = torch.zeros((b, nk, kc, kvh, d), dtype=adt, device=q.device)
    dv_acc = torch.zeros((b, nk, kc, kvh, d), dtype=adt, device=q.device)
    dqs = []
    for i in range(nq):
        q_i, do_i = qr[:, i].to(adt), dor[:, i]
        lse_i, delta_i = lse[:, i], delta[:, i]
        dq_i = torch.zeros((b, qc, kvh, g, d), dtype=adt, device=q.device)
        for j in range(nk):
            k_j, v_j = kr[:, j].to(adt), vr[:, j].to(adt)
            s_ij = torch.einsum("bqhgd,bkhd->bhgqk", q_i, k_j) * scale
            if causal:
                mask = q_pos[i][:, None] >= k_pos[j][None, :]
                s_ij = torch.where(mask[None, None, None], s_ij, NEG_INF)
            p_ij = torch.exp(s_ij - lse_i[..., None])
            dv_j = torch.einsum("bhgqk,bqhgd->bkhd", p_ij, do_i)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", do_i, v_j)
            ds = p_ij * (dp - delta_i[..., None]) * scale
            dq_i = dq_i + torch.einsum("bhgqk,bkhd->bqhgd", ds, k_j)
            dk_acc[:, j] += torch.einsum("bhgqk,bqhgd->bkhd", ds, q_i)
            dv_acc[:, j] += dv_j
        dqs.append(dq_i)
    dq = torch.stack(dqs, dim=1).reshape(b, sq, h, d).to(q.dtype)
    return (dq, dk_acc.reshape(b, skv, kvh, d).to(k.dtype),
            dv_acc.reshape(b, skv, kvh, d).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """Saves (q, k, v, out, lse) and nothing else."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_chunk, kv_chunk):
        out, lse = _fwd_impl(q, k, v, causal, q_chunk, kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return _flash_bwd(q, k, v, out, lse, dout, *ctx.cfg) + (None, None, None)


def flash_attention(q, k, v, causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 1024, unroll: bool = False):
    """Softmax attention of q over (k, v), differentiable by the chunked
    backward. ``unroll`` is accepted for the JAX signature and changes
    nothing: the loops are Python loops."""
    del unroll
    return _FlashAttention.apply(q, k, v, causal, q_chunk, kv_chunk)
