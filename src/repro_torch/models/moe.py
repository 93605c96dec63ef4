"""Mixture-of-Experts layer with dynamic-format dispatch (port of
``repro.models.moe``).

The token->expert dispatch/combine operator is a dynamic sparse matrix (one
nonzero per (token, routed expert) pair). Three interchangeable
implementations, the JAX package's:

  dense  one-hot einsum dispatch (reference; O(T*E*C) memory)
  sort   sort/scatter dispatch (the production path)
  coo    the dispatch matrix built as a ``repro_torch.core`` COO container
         and applied with the library's ``spmm`` (the paper's technique in
         the model stack; COO has no kernel, so this is the plain path on
         the card too, as it is in the JAX package)

All paths are capacity-based: per-expert capacity
C = ceil(T * top_k / E * capacity_factor) (at least 4, a multiple of 4);
assignments past it are dropped.

Routing is per sequence row, as JAX's ``vmap`` over the batch makes it:
capacity and ranks are local to each row. The port does it for all rows at
once: one stable sort of the key ``row * E + expert``, and an expert-major
buffer in which row ``r``'s slot ``j`` of expert ``e`` lies at
``(e * B + r) * C + j``, so the experts run as one batched product over
every row's slots.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.formats import COO
from repro_torch.core.ops import spmm
from repro_torch.models.layers import P, _silu, acc_dtype, mlp_apply, mlp_specs


def moe_specs(cfg) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = {
        "router": P((d, e), ("embed", None), init="small_normal"),
        "experts": {
            "gate": P((e, d, ff), ("expert", "embed", "mlp"), fan_in_dims=(1,)),
            "up": P((e, d, ff), ("expert", "embed", "mlp"), fan_in_dims=(1,)),
            "down": P((e, ff, d), ("expert", "mlp", "embed"), fan_in_dims=(1,)),
        },
    }
    for i in range(cfg.n_shared_experts):
        s[f"shared_{i}"] = mlp_specs(d, ff, "swiglu")
    return s


def _route(p, x, cfg):
    """Router of every row: x (B, T, d) -> top-k gates (B, T, k),
    renormalised, their experts (B, T, k), and each row's Switch-style
    load-balance loss (B,).

    ``jax.lax.top_k`` puts the lower expert first among equal
    probabilities; a stable descending sort does the same."""
    b, t, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    adt = acc_dtype(x.dtype)
    logits = x.to(adt) @ p["router"].to(adt)
    probs = torch.softmax(logits, dim=-1)  # (B, T, E)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top.values[..., :k], top.indices[..., :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    me = probs.mean(dim=1)  # (B, E)
    ce = torch.zeros((b, e), dtype=adt, device=x.device).scatter_add_(
        1, idx.reshape(b, t * k), torch.ones((b, t * k), dtype=adt, device=x.device)) / (t * k)
    aux = e * torch.sum(me * ce, dim=-1)
    return gates, idx, aux


def _capacity(cfg, t: int) -> int:
    c = int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(4, -(-c // 4) * 4)


def _expert_ffn(pe, xe, dtype):
    """Batched expert SwiGLU: xe (E, N, d) -> (E, N, d)."""
    g = torch.bmm(xe, pe["gate"].to(dtype))
    u = torch.bmm(xe, pe["up"].to(dtype))
    return torch.bmm(_silu(g) * u, pe["down"].to(dtype))


# ---------------------------------------------------------------------------
# dispatch impls: x (B, T, d), gates/idx (B, T, k) -> (B, T, d)
# ---------------------------------------------------------------------------


def _one_hot(i, n: int, dtype):
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros."""
    return (i[..., None] == torch.arange(n, device=i.device)).to(dtype)


def _dispatch_dense(p, x, gates, idx, cfg):
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = _capacity(cfg, t)
    # position of each assignment within its expert, per row
    onehot = _one_hot(idx, e, torch.int64)  # (B, T, k, E)
    pos = torch.cumsum(onehot.reshape(b, t * k, e), dim=1).reshape(b, t, k, e) - 1
    pos = torch.sum(pos * onehot, dim=-1)  # (B, T, k)
    keep = pos < c
    oh_e = _one_hot(idx, e, x.dtype)
    oh_c = _one_hot(pos, c, x.dtype)
    disp = torch.einsum("btke,btkc->btec", oh_e * keep[..., None].to(x.dtype), oh_c)
    xe = torch.einsum("btec,btd->ebcd", disp, x).reshape(e, b * c, d)
    ye = _expert_ffn(p["experts"], xe, x.dtype).reshape(e, b, c, d)
    comb = torch.einsum("btke,btkc,btk->btec", oh_e, oh_c * keep[..., None].to(x.dtype),
                        gates.to(x.dtype))
    return torch.einsum("btec,ebcd->btd", comb, ye)


def _assignments(x, gates, idx, cfg):
    """The sort-based symbolic step of every row: slot, token, gate and keep
    of each assignment in sorted order, (B, T*k) each, and the capacity.
    Row ``r`` of each is what JAX's per-row ``_assignments`` returns for
    that row: slot ``expert * C + rank`` (``E * C`` where dropped) and the
    token's index within the row."""
    b, t, k = idx.shape
    e = cfg.n_experts
    c = _capacity(cfg, t)
    dev = idx.device
    key = (torch.arange(b, device=dev)[:, None] * e + idx.reshape(b, t * k)).reshape(-1)
    skey, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(skey, torch.arange(b * e, dtype=skey.dtype, device=dev))
    rank = torch.arange(b * t * k, device=dev) - starts[skey]
    keep = rank < c
    slot = torch.where(keep, (skey % e) * c + rank, torch.full_like(rank, e * c))
    token = (order % (t * k)) // k
    gate = gates.reshape(-1)[order]
    return (slot.view(b, t * k), token.view(b, t * k), gate.view(b, t * k),
            keep.view(b, t * k), c)


def _expert_major(slot, c: int, b: int):
    """Row-local slots ``expert * C + j`` (B, n) -> their rows in the
    expert-major buffer of all rows, ``(expert * B + row) * C + j``."""
    rows = torch.arange(b, device=slot.device)[:, None]
    return ((slot // c) * b + rows) * c + slot % c


def _dispatch_sort(p, x, gates, idx, cfg):
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    slot, token, gate, keep, c = _assignments(x, gates, idx, cfg)
    n = e * b * c
    gslot = torch.where(keep, _expert_major(slot, c, b), torch.full_like(slot, n)).reshape(-1)
    gtok = (torch.arange(b, device=x.device)[:, None] * t + token).reshape(-1)
    xf = x.reshape(b * t, d)
    xe = x.new_zeros((n + 1, d))
    xe[gslot] = xf[gtok]  # dropped assignments all land in the spare last row
    ye = _expert_ffn(p["experts"], xe[:-1].view(e, b * c, d), x.dtype).reshape(n, d)
    contrib = ye[gslot.clamp(max=n - 1)] * (gate * keep).reshape(-1, 1).to(x.dtype)
    # JAX's .at[token].add(contrib) adds a token's k contributions in sorted
    # order (ascending expert), rounding at every add; the same sum here, in
    # that order, without atomics, so reruns are bitwise equal.
    mine = torch.sort(gtok, stable=True).indices.view(b * t, k)
    out = torch.zeros_like(xf)
    for j in range(k):
        out = out + contrib[mine[:, j]]
    return out.view(b, t, d)


def _dispatch_coo(p, x, gates, idx, cfg):
    """Dispatch through the paper's library: COO containers applied with
    ``repro_torch.core.ops.spmm``. JAX builds one (E*C, T) dispatch matrix and
    one (T, E*C) combine matrix a row; here the rows' matrices sit side by
    side in one (B*E*C, B*T) and one (B*T, B*E*C) container, block-diagonal
    up to the expert-major order of the slots. A dropped assignment keeps
    JAX's clipped slot ``E*C - 1`` of its row and the value 0."""
    b, t, d = x.shape
    e = cfg.n_experts
    slot, token, gate, keep, c = _assignments(x, gates, idx, cfg)
    n = e * b * c
    rows = _expert_major(slot.clamp(max=e * c - 1), c, b).reshape(-1).to(torch.int32)
    cols = (torch.arange(b, device=x.device)[:, None] * t + token).reshape(-1).to(torch.int32)
    nnz = int(rows.shape[0])
    disp = COO(row=rows, col=cols, data=keep.reshape(-1).to(x.dtype), shape=(n, b * t),
               nnz=nnz)
    xe = spmm(disp, x.reshape(b * t, d))  # (B*E*C, d)
    ye = _expert_ffn(p["experts"], xe.view(e, b * c, d), x.dtype).reshape(n, d)
    comb = COO(row=cols, col=rows, data=(gate * keep).reshape(-1).to(x.dtype),
               shape=(b * t, n), nnz=nnz)
    return spmm(comb, ye).view(b, t, d)


DISPATCH = {"dense": _dispatch_dense, "sort": _dispatch_sort, "coo": _dispatch_coo}


def moe_apply(p, x, cfg, dispatch: str = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss).

    Routing and dispatch are per sequence row (JAX vmaps them over the
    batch dim): each row's capacity and ranks are its own. The shared
    experts see every token."""
    b, s, d = x.shape
    impl = DISPATCH[dispatch or cfg.moe_dispatch]
    gates, idx, aux = _route(p, x, cfg)
    y = impl(p, x, gates, idx, cfg)
    xf = x.reshape(b * s, d)
    yf = y.reshape(b * s, d)
    for i in range(cfg.n_shared_experts):
        yf = yf + mlp_apply(p[f"shared_{i}"], xf, "swiglu")
    return yf.reshape(b, s, d), torch.mean(aux)
