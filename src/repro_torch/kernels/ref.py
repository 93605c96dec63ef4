"""Plain torch versions of the hand-written CUDA kernels.

Each function is the specification its kernel reproduces, ported from the
JAX package's ``repro.kernels.ref``: accumulate in float32, return in x's
dtype. The CPU path runs these; ``chip_smoke.py`` holds each kernel against
its plain version on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.ops import segment_sum, take_clip


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
