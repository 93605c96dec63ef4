"""Flash attention, forward (port of ``repro.models.flash``'s ``_fwd_impl``).

Chunked attention with an online (max, sum, acc) softmax in f32: query
chunks are a reshape, key/value chunks a Python loop, so the full (S x S)
score matrix is never held. Plain torch, not a fused attention call, so its
sums follow the JAX package's: scores are f32 products of the inputs
(``preferred_element_type=f32``), each chunk's probabilities are cast to
``v``'s dtype before the PV product, which accumulates in f32.

Shapes: q (B,Sq,H,D); k,v (B,Skv,KV,D); GQA via H = KV * G, query head
``h = kv * G + g``. The chunked backward (``_flash_bwd``) comes with training.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import acc_dtype

NEG_INF = -1e30


def flash_attention(q, k, v, causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 1024, unroll: bool = False):
    """Softmax attention of q over (k, v). ``unroll`` is accepted for the
    JAX signature and changes nothing: the kv loop is already a Python loop.
    All query chunks go through each kv step together (JAX vmaps them)."""
    del unroll
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = d ** -0.5
    qc, kc = min(q_chunk, sq), min(kv_chunk, skv)
    nq, nk = sq // qc, skv // kc
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
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    # (b, nq, kvh, g, qc, d) -> (b, sq, h, d)
    return out.permute(0, 1, 4, 2, 3, 5).reshape(b, sq, h, d).to(q.dtype)
