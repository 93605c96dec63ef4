"""Plain torch versions of the hand-written CUDA kernels.

Each function is the specification its kernel reproduces, ported from the
JAX package's ``repro.kernels.ref``: accumulate in float32, return in x's
dtype. The CPU path runs these; ``chip_smoke.py`` holds each kernel against
its plain version on the card. The SpMM versions walk the rhs in column
chunks (``repro_torch.core.ops.by_columns``) so that their per-entry
product stays small at serving widths; each output's sum is unchanged.
"""
from __future__ import annotations

import torch

from repro_torch.core.ops import by_columns, segment_sum, take_clip


def dia_spmv_ref(offsets: torch.Tensor, data: torch.Tensor, x: torch.Tensor,
                 n: int) -> torch.Tensor:
    """y[i] = sum_d data[d, i] * x[i + offsets[d]]  (zero outside [0, n))."""
    m = data.shape[1]
    i = torch.arange(m, dtype=torch.int32, device=data.device)[None, :]
    cols = i + offsets.to(torch.int32)[:, None]
    valid = (cols >= 0) & (cols < n)
    xv = take_clip(x, cols).float()
    prod = torch.where(valid, data.float() * xv, torch.zeros((), device=data.device))
    return prod.sum(dim=0).to(x.dtype)


def csr_spmv_ref(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor,
                 x: torch.Tensor, m: int) -> torch.Tensor:
    """y[i] = sum_{p in [indptr[i], indptr[i+1])} data[p] * x[indices[p]]
    (capacity padding past indptr[-1] is inert)."""
    cap = data.shape[0]
    k = torch.arange(cap, dtype=indptr.dtype, device=data.device)
    rows = torch.searchsorted(indptr, k, right=True).to(torch.int32) - 1
    live = (rows >= 0) & (k < indptr[-1])
    contrib = data.float() * take_clip(x, indices).float()
    contrib = torch.where(live, contrib, torch.zeros((), device=data.device))
    return segment_sum(contrib, rows.clamp(0, m - 1), m).to(x.dtype)


def ell_spmv_ref(cols: torch.Tensor, data: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_k data[i, k] * x[cols[i, k]]; columns clamp into [0, n)
    (padding slots col=-1/val=0 read x[0] and add nothing); K = 0 gives
    zeros."""
    acc = (data.float() * take_clip(x, cols).float()).sum(dim=1)
    return acc.to(x.dtype)


def sell_spmv_ref(slice_ptrs: torch.Tensor, cols: torch.Tensor, data: torch.Tensor,
                  perm: torch.Tensor, x: torch.Tensor, m: int, c: int) -> torch.Tensor:
    """SELL-C-sigma: each width plane of a slice is C lanes, one sorted row
    per lane; the sorted sums scatter to ``y[perm]`` and ghost lanes
    (``perm`` outside [0, m)) are dropped. Port of
    ``repro.core.ops._spmv_sell`` with float32 accumulation."""
    nslices = slice_ptrs.shape[0] - 1
    t = data.shape[0] // c
    q = torch.arange(t, dtype=slice_ptrs.dtype, device=data.device) * c
    plane = torch.searchsorted(slice_ptrs, q, right=True).to(torch.int32) - 1
    contrib = data.float().reshape(t, c) * take_clip(x, cols.reshape(t, c)).float()
    y_sorted = segment_sum(contrib, plane.clamp(0, nslices - 1), nslices).reshape(-1)
    return segment_sum(y_sorted, perm, m).to(x.dtype)


def bsr_spmm_ref(indptr: torch.Tensor, indices: torch.Tensor, blocks: torch.Tensor,
                 B: torch.Tensor, m: int) -> torch.Tensor:
    """Y = A @ B for block-CSR A with (bs, bs) blocks; B is (N, K). Block
    columns clamp into range; blocks past ``indptr[-1]`` (capacity padding)
    are inert, as the kernel never reads them. Port of
    ``repro.kernels.ref.bsr_spmm_ref``."""
    nblk, bs, _ = blocks.shape
    kb = B.shape[1]
    Bb = B.reshape(B.shape[0] // bs, bs, kb)
    prod = torch.einsum("nij,njk->nik", blocks.float(), take_clip(Bb, indices).float())
    k = torch.arange(nblk, dtype=indptr.dtype, device=blocks.device)
    brow = torch.searchsorted(indptr, k, right=True).to(torch.int32) - 1
    live = (k < indptr[-1]).reshape(nblk, 1, 1)
    prod = torch.where(live, prod, torch.zeros((), device=blocks.device))
    yb = segment_sum(prod, brow.clamp(0, max(m // bs - 1, 0)), m // bs)
    return yb.reshape(m, kb).to(B.dtype)


def csr_spmm_ref(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor,
                 B: torch.Tensor, m: int) -> torch.Tensor:
    """Y[i, :] = sum_{p in [indptr[i], indptr[i+1])} data[p] * B[indices[p], :]
    for B (N, K); capacity padding past indptr[-1] is inert, columns clamp."""
    cap = data.shape[0]
    k = torch.arange(cap, dtype=indptr.dtype, device=data.device)
    rows = torch.searchsorted(indptr, k, right=True).to(torch.int32) - 1
    live = ((rows >= 0) & (k < indptr[-1]))[:, None]
    rows = rows.clamp(0, max(m - 1, 0))

    def part(Bc):
        contrib = data.float()[:, None] * take_clip(Bc, indices).float()
        contrib = torch.where(live, contrib, torch.zeros((), device=data.device))
        return segment_sum(contrib, rows, m)
    return by_columns(part, B, cap).to(B.dtype)


def csr_spmm_t_ref(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor,
                   X: torch.Tensor, m: int) -> torch.Tensor:
    """Y = X @ A^T for activations X (T, N): Y[t, i] = sum_p data[p] *
    X[t, indices[p]] over row i's entries; (T, M) in X's dtype."""
    return csr_spmm_ref(indptr, indices, data, X.T, m).T


def ell_spmm_ref(cols: torch.Tensor, data: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Y[i, :] = sum_k data[i, k] * B[cols[i, k], :] for B (N, Kb); columns
    clamp into [0, N) (padding slots col=-1/val=0 read row 0 of B and add
    nothing); K = 0 gives zeros. (M, Kb) in B's dtype."""
    def part(Bc):
        return (data.float()[..., None] * take_clip(Bc, cols).float()).sum(dim=1)
    return by_columns(part, B, cols.numel()).to(B.dtype)


def ell_spmm_t_ref(cols: torch.Tensor, data: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Y[t, i] = sum_k data[i, k] * X[t, cols[i, k]]; columns clamp into
    [0, N) (padding slots col=-1/val=0 read column 0 and add nothing);
    K = 0 gives zeros. (T, M) in X's dtype."""
    return ell_spmm_ref(cols, data, X.T).T


def sell_spmm_ref(slice_ptrs: torch.Tensor, cols: torch.Tensor, data: torch.Tensor,
                  perm: torch.Tensor, B: torch.Tensor, m: int, c: int) -> torch.Tensor:
    """Y = A @ B for SELL-C-sigma A and B (N, Kb): each sorted lane's sums
    scatter to row ``perm[lane]`` of Y; ghost lanes (``perm`` outside
    [0, m)) are dropped. (M, Kb) in B's dtype."""
    nslices = slice_ptrs.shape[0] - 1
    t = data.shape[0] // c
    q = torch.arange(t, dtype=slice_ptrs.dtype, device=data.device) * c
    plane = (torch.searchsorted(slice_ptrs, q, right=True).to(torch.int32) - 1)
    plane = plane.clamp(0, nslices - 1)

    def part(Bc):
        contrib = data.float().reshape(t, c)[..., None] * take_clip(
            Bc, cols.reshape(t, c)).float()
        y_sorted = segment_sum(contrib, plane, nslices).reshape(nslices * c, -1)
        return segment_sum(y_sorted, perm, m)
    return by_columns(part, B, data.shape[0]).to(B.dtype)


def sell_spmm_t_ref(slice_ptrs: torch.Tensor, cols: torch.Tensor, data: torch.Tensor,
                    perm: torch.Tensor, X: torch.Tensor, m: int, c: int) -> torch.Tensor:
    """Y = X @ A^T for SELL-C-sigma A and activations X (T, N): each sorted
    lane's sums scatter to column ``perm[lane]`` of Y; ghost lanes (``perm``
    outside [0, m)) are dropped. (T, M) in X's dtype."""
    return sell_spmm_ref(slice_ptrs, cols, data, perm, X.T, m, c).T
