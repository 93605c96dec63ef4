"""Sparsity-pattern features for format selection (port of ``repro.tuning.features``).

* ``PatternStats`` — the minimal statistics driving the analytic byte model.
* ``PatternFeatures`` — the feature vector consumed by the ML classifier.
* ``batch_features`` — ``PatternFeatures`` of every part of a stacked
  ``(P, capacity)`` COO batch (the colored smoother's eight color blocks)
  in one device pass and one planned pull.

The JAX package computes the first two in numpy on the host. Here ``from_coo`` runs
on the device of the matrix and pulls one small vector of statistics
(one counted planned pull): distinct diagonals and blocks are counted by
sort-and-compare, which needs no data-dependent output shape. Row-length
moments are taken in float64, so the vector agrees with numpy's to
~1e-15 relative.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.core.convert import _planned_pull
from repro_torch.core.formats import COO
from repro_torch.core.ops import segment_sum

# Order matters: this is the layout of ``PatternFeatures.vector()`` and the
# feature ids stored inside serialized decision trees.
FEATURE_NAMES = (
    "log_m",           # log10 rows
    "log_n",           # log10 cols
    "log_nnz",         # log10 stored non-zeros
    "density",         # nnz / (m*n)
    "row_nnz_mean",    # mean row length
    "row_nnz_std",     # row length standard deviation
    "row_nnz_max",     # longest row
    "row_cv",          # std / mean row length (irregularity)
    "row_max_frac",    # max row length / n  (ELL padding risk)
    "ndiag",           # occupied diagonals
    "ndiag_frac",      # ndiag / (m + n - 1)
    "diag_fill",       # nnz / (ndiag * min(m, n))  (DIA efficiency)
    "bandwidth_frac",  # max |col - row| / n
    "block_density",   # nnz / touched 8x8 blocks' capacity (BSR efficiency)
    "ell_efficiency",  # nnz / (m * row_nnz_max)  (ELL payload utilisation)
)

_SENTINEL = int(np.iinfo(np.int64).max)


def _distinct_live(vals: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """(P,) number of distinct live values in each row of ``vals`` (P, cap):
    sort pushes the dead entries (the sentinel) to the tail, transitions
    count the distinct live values."""
    s = torch.sort(torch.where(live, vals, torch.full_like(vals, _SENTINEL)), dim=1).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    return (first & (s != _SENTINEL)).sum(dim=1)


def _raw_stats(A: COO, block: int):
    """(nnz, row_max, ndiag, bandwidth, nblocks, row_mean, row_std) on the
    host, from one planned pull of a float64 vector (ints below 2**53)."""
    m, n = A.shape
    live = A.data != 0
    r, c = A.row.long(), A.col.long()
    counts = segment_sum(live.long(), A.row, m)
    cf = counts.double()
    diffs = c - r
    zero = torch.zeros((), dtype=torch.long, device=r.device)
    nbc = (n + block - 1) // block
    stats = torch.stack([
        live.sum().double(),
        counts.max().double() if m else zero.double(),
        _distinct_live(diffs[None], live[None])[0].double(),
        torch.where(live, diffs.abs(), zero).max().double() if live.numel() else zero.double(),
        _distinct_live(((r // block) * nbc + (c // block))[None], live[None])[0].double(),
        cf.mean() if m else zero.double(),
        cf.std(unbiased=False) if m else zero.double(),
    ])
    raw = _planned_pull(stats)
    ints = [int(v) for v in raw[:5]]
    return (*ints, float(raw[5]), float(raw[6]))


@dataclasses.dataclass
class PatternStats:
    """Sparsity-pattern statistics driving the analytic model."""

    m: int
    n: int
    nnz: int
    max_row_nnz: int
    ndiag: int
    itemsize: int = 4
    row_cv: float = 0.0  # std / mean row length (drives the SELL byte model)

    @classmethod
    def from_coo(cls, A: COO) -> "PatternStats":
        nnz, row_max, ndiag, _bw, _nb, mean, std = _raw_stats(A, 8)
        if nnz == 0:
            return cls(A.shape[0], A.shape[1], 0, 1, 1, A.data.element_size(), 0.0)
        return cls(A.shape[0], A.shape[1], nnz, max(1, row_max), max(1, ndiag),
                   A.data.element_size(), std / max(mean, 1e-12))


@dataclasses.dataclass
class PatternFeatures:
    """Rich pattern features (superset of ``PatternStats``)."""

    m: int
    n: int
    nnz: int
    itemsize: int
    row_nnz_mean: float
    row_nnz_std: float
    row_nnz_max: int
    ndiag: int
    bandwidth: int
    diag_fill: float
    block_density: float
    ell_efficiency: float

    BLOCK_PROBE = 8  # block grid used for the block_density feature

    @classmethod
    def from_coo(cls, A: COO) -> "PatternFeatures":
        m, n = A.shape
        bs = cls.BLOCK_PROBE
        nnz, row_max, ndiag, bandwidth, nblocks, mean, std = _raw_stats(A, bs)
        itemsize = A.data.element_size()
        if nnz == 0:
            return cls(m, n, 0, itemsize, 0.0, 0.0, 1, 1, 0, 0.0, 0.0, 0.0)
        return cls(
            m=m, n=n, nnz=nnz, itemsize=itemsize,
            row_nnz_mean=mean,
            row_nnz_std=std,
            row_nnz_max=row_max,
            ndiag=ndiag,
            bandwidth=bandwidth,
            diag_fill=nnz / (ndiag * min(m, n)),
            block_density=nnz / (nblocks * bs * bs),
            ell_efficiency=nnz / (m * row_max),
        )

    def vector(self) -> np.ndarray:
        """Feature vector in ``FEATURE_NAMES`` order (float64)."""
        m, n, nnz = self.m, self.n, max(self.nnz, 1)
        mean = max(self.row_nnz_mean, 1e-12)
        return np.array([
            np.log10(max(m, 1)),
            np.log10(max(n, 1)),
            np.log10(nnz),
            self.nnz / (m * n),
            self.row_nnz_mean,
            self.row_nnz_std,
            float(self.row_nnz_max),
            self.row_nnz_std / mean,
            self.row_nnz_max / max(n, 1),
            float(self.ndiag),
            self.ndiag / (m + n - 1),
            self.diag_fill,
            self.bandwidth / max(n, 1),
            self.block_density,
            self.ell_efficiency,
        ], dtype=np.float64)

    def to_stats(self) -> PatternStats:
        """Project down to the analytic model's statistics."""
        return PatternStats(self.m, self.n, max(self.nnz, 1),
                            max(1, self.row_nnz_max), max(1, self.ndiag),
                            self.itemsize,
                            self.row_nnz_std / max(self.row_nnz_mean, 1e-12))


# ---------------------------------------------------------------------------
# Batched featurisation of a stacked COO batch
# ---------------------------------------------------------------------------

def _batch_stats(C: COO, block: int) -> torch.Tensor:
    """(P, 7) statistics of the parts, float64 on the device, in the JAX
    package's order: nnz, row mean, row std, row max, distinct diagonals,
    bandwidth, touched blocks. The row moments are taken in float32, as
    JAX takes them; the counts are exact (float64 holds ints below 2**53)."""
    m, n = C.shape
    p = C.data.shape[0]
    live = C.data != 0
    r, c = C.row.long(), C.col.long()
    # per-part row counts in one (P * m,) segment sum; rows outside [0, m)
    # are dropped, as jax.ops.segment_sum drops them
    part = torch.arange(p, device=r.device)[:, None] * m
    ok = live & (r >= 0) & (r < m)
    counts = segment_sum(ok.long().reshape(-1), torch.where(ok, part + r, -1).reshape(-1),
                         p * m).view(p, m)
    nnz = live.sum(dim=1)
    mean = nnz.float() / m
    std = torch.sqrt(torch.clamp(((counts.float() - mean[:, None]) ** 2).mean(dim=1), min=0.0))
    diffs = c - r
    zero = torch.zeros((), dtype=torch.long, device=r.device)
    nbc = (n + block - 1) // block
    return torch.stack([
        nnz.double(), mean.double(), std.double(), counts.amax(dim=1).double(),
        _distinct_live(diffs, live).double(),
        torch.where(live, diffs.abs(), zero).amax(dim=1).double(),
        _distinct_live((r // block) * nbc + (c // block), live).double(),
    ], dim=1)


def batch_features(C: COO) -> List[PatternFeatures]:
    """``PatternFeatures`` of every part of a stacked batch of same-shape
    COO parts (``(P, capacity)`` arrays), from one device pass and one
    (P, 7) planned pull: no per-part index array crosses to
    the host and no Python loop runs device work. The ints equal
    :meth:`PatternFeatures.from_coo` of the part; the row-length moments
    are float32, as JAX computes them."""
    if not isinstance(C, COO) or C.data.dim() != 2:
        raise TypeError("batch_features expects a stacked COO container "
                        "with (P, capacity) arrays")
    m, n = C.shape
    bs = PatternFeatures.BLOCK_PROBE
    raw = _planned_pull(_batch_stats(C, bs))
    itemsize = C.data.element_size()
    out = []
    for nnz_f, mean, std, row_max_f, ndiag_f, bw_f, nblocks_f in raw:
        nnz, row_max = int(nnz_f), int(row_max_f)
        ndiag, nblocks = int(ndiag_f), int(nblocks_f)
        if nnz == 0:
            out.append(PatternFeatures(m, n, 0, itemsize, 0.0, 0.0, 1, 1, 0, 0.0, 0.0, 0.0))
            continue
        out.append(PatternFeatures(
            m=m, n=n, nnz=nnz, itemsize=itemsize,
            row_nnz_mean=float(mean), row_nnz_std=float(std),
            row_nnz_max=row_max, ndiag=ndiag, bandwidth=int(bw_f),
            diag_fill=nnz / (ndiag * min(m, n)),
            block_density=nnz / (nblocks * bs * bs),
            ell_efficiency=nnz / (m * row_max),
        ))
    return out
