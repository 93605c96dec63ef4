"""Selection engines: the analytic byte model (port of part of
``repro.tuning.engines``).

SpMV is memory-bandwidth bound, so predicted time = bytes touched / HBM
bandwidth, with a penalty on gathered x accesses. The profiling tuner
(``profile_select``, ``time_fn``) and the measured gather penalty come with
the kernel-tuning slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from repro_torch.core.formats import Format
from repro_torch.tuning.features import PatternStats

# H100 SXM data-sheet HBM bandwidth. The ranking of formats does not depend
# on it: it scales every predicted time alike.
HBM_BW = 3.35e12  # bytes/s
GATHER_PENALTY = 4.0  # effective-bandwidth derate for data-dependent gathers


@dataclasses.dataclass
class TuneReport:
    """A selection decision: the winning format and the time each candidate
    was predicted (or measured) to take. The kernel backend and launch
    config that the JAX report may carry come with the kernel-tuning slice."""

    best: Format
    times: Dict[Format, float]  # seconds (measured or predicted)
    mode: str

    def __repr__(self):
        rows = ", ".join(f"{f.name}={t:.3e}s" for f, t in self.times.items())
        return f"TuneReport(best={self.best.name}, mode={self.mode}, {rows})"


def predicted_bytes(stats: PatternStats, fmt: Format) -> float:
    """Bytes touched by one SpMV in ``fmt`` (matrix + x-access cost model)."""
    GATHER = GATHER_PENALTY
    w, m, n = stats.itemsize, stats.m, stats.n
    ii = 4  # index itemsize
    if fmt == Format.COO:
        mat = stats.nnz * (2 * ii + w)
        x = stats.nnz * w * GATHER
    elif fmt == Format.CSR:
        mat = stats.nnz * (ii + w) + (m + 1) * ii
        x = stats.nnz * w * GATHER
    elif fmt == Format.DIA:
        mat = stats.ndiag * m * w + stats.ndiag * ii
        x = stats.ndiag * m * w  # contiguous shifted reads: NO penalty
    elif fmt == Format.ELL:
        mat = stats.max_row_nnz * m * (ii + w)
        x = stats.max_row_nnz * m * w * GATHER
    elif fmt == Format.SELL:
        # slots = nnz inflated by a cv-scaled factor, clamped to the ELL
        # ceiling; the permutation adds one index read per row.
        cv = float(getattr(stats, "row_cv", 0.0))
        slots = min(float(stats.max_row_nnz * m),
                    stats.nnz * (1.0 + 0.35 * min(cv, 4.0)) + m)
        mat = slots * (ii + w) + m * ii
        x = slots * w * GATHER
    elif fmt == Format.BSR:
        bs = 128
        blocks = max(1, int(np.ceil(stats.nnz / (bs * bs))))  # lower bound
        mat = blocks * bs * bs * w + blocks * ii
        x = blocks * bs * w
    elif fmt == Format.HYB:
        k = min(stats.max_row_nnz, max(1, stats.nnz // max(1, stats.m)))
        ell_n = min(stats.nnz, k * stats.m)
        coo_n = stats.nnz - ell_n
        mat = ell_n * (ii + w) + coo_n * (2 * ii + w)
        x = (ell_n + coo_n) * w * GATHER
    elif fmt == Format.DENSE:
        mat = m * n * w
        x = n * w * max(1, m // 1024)
    else:
        raise ValueError(fmt)
    y = m * w
    return float(mat + x + y)


def analytic_select(stats: PatternStats,
                    candidates: Sequence[Format] = (Format.COO, Format.CSR, Format.DIA,
                                                    Format.ELL, Format.SELL)) -> TuneReport:
    times = {Format(f): predicted_bytes(stats, Format(f)) / HBM_BW
             for f in candidates}
    best = min(times, key=times.get)
    return TuneReport(best, times, "analytic")
