"""Selection engines (port of ``repro.tuning.engines``).

  * the analytic byte model: SpMV is memory-bandwidth bound, so predicted
    time = bytes touched / HBM bandwidth, with a penalty on gathered x
    accesses: the fixed ``GATHER_PENALTY`` (the JAX package's v5e value),
    or with ``calibrate=True`` the gather-vs-stream time ratio measured on
    the device (:func:`calibrate_gather_penalty`, once per device);
  * the paper's profiling tuner: :func:`profile_select` converts ``A`` into
    each candidate format, times one SpMV, SpMM or SpMM_T with
    :func:`time_fn` (CUDA events on the card, the host clock on the CPU)
    and picks the fastest.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import ops as _ops
from repro_torch.core.convert import convert_execute, plan_switch
from repro_torch.core.dynamic import DynamicMatrix
from repro_torch.core.formats import Format
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.tuning.features import PatternStats

# H100 SXM data-sheet HBM bandwidth. The ranking of formats does not depend
# on it: it scales every predicted time alike.
HBM_BW = 3.35e12  # bytes/s
GATHER_PENALTY = 4.0  # effective-bandwidth derate for data-dependent gathers

# Measured gather penalties, keyed by (device type, device name): a process
# that runs on the CPU and on the card must not reuse the other's number.
_CALIBRATED_PENALTY: Dict[tuple, float] = {}


def _device_key(dev: torch.device) -> tuple:
    if dev.type != "cuda":
        return (dev.type, dev.type)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return (dev.type, torch.cuda.get_device_name(index))


def calibrate_gather_penalty(n: int = 1 << 18, iters: int = 5,
                             device: DeviceLike = None) -> float:
    """The gather-vs-stream time ratio of ``device`` (``None``: the card),
    used as the analytic model's gather penalty (the fixed 4.0 is the JAX
    package's TPU v5e value). Times ``v * 2 + 1`` against a gather
    ``v[idx]`` of ``n`` float32 values at random indices (numpy seed 0)
    with :func:`time_fn`; at least 1. Measured once per (device type,
    device name) and process."""
    dev = resolve_device(device)
    key = _device_key(dev)
    if key in _CALIBRATED_PENALTY:
        return _CALIBRATED_PENALTY[key]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, n, n).astype(np.int32)).to(dev)
    t_s = time_fn(lambda v: v * 2.0 + 1.0, x, iters=iters)
    t_g = time_fn(lambda v, i: v.index_select(0, i), x, idx, iters=iters)
    penalty = float(max(1.0, t_g / max(t_s, 1e-9)))
    _CALIBRATED_PENALTY[key] = penalty
    return penalty


@dataclasses.dataclass
class TuneReport:
    """A selection decision: the winning format, the time each candidate
    was predicted (or measured) to take and, when :func:`profile_select`
    searched more than one backend or a cached decision pins a kernel, the
    backend (and, pinned, the kernel's launch knobs)."""

    best: Format
    times: Dict[Format, float]  # seconds (measured or predicted)
    mode: str
    backend: Optional[str] = None  # "ref" | "cuda" | None (not searched, not pinned)
    cfg: Optional[dict] = None  # the pinned kernel's launch knobs

    def __repr__(self):
        rows = ", ".join(f"{f.name}={t:.3e}s" for f, t in self.times.items())
        extra = f", backend={self.backend}" if self.backend else ""
        return f"TuneReport(best={self.best.name}, mode={self.mode}{extra}, {rows})"


def predicted_bytes(stats: PatternStats, fmt: Format,
                    gather_penalty: Optional[float] = None) -> float:
    """Bytes touched by one SpMV in ``fmt`` (matrix + x-access cost model);
    gathered x reads count ``gather_penalty`` times (default
    ``GATHER_PENALTY``)."""
    GATHER = gather_penalty if gather_penalty is not None else GATHER_PENALTY
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
                                                    Format.ELL, Format.SELL),
                    hbm_bw: float = HBM_BW, calibrate: bool = False,
                    device: DeviceLike = None) -> TuneReport:
    """The analytic pick: predicted bytes over ``hbm_bw`` for each
    candidate. ``calibrate=True`` takes the gather penalty measured on
    ``device`` (``None``: the card) and reports the tier
    ``"analytic-calibrated"``; the default keeps the fixed penalty."""
    pen = calibrate_gather_penalty(device=device) if calibrate else None
    times = {Format(f): predicted_bytes(stats, Format(f), pen) / hbm_bw
             for f in candidates}
    best = min(times, key=times.get)
    return TuneReport(best, times, "analytic-calibrated" if calibrate else "analytic")


def time_fn(fn, *args, iters: int = 10, warmup: int = 2, inner: int = 1) -> float:
    """Best-of-``iters`` seconds of one call ``fn(*args)``.

    A call whose result lies on the card is timed with CUDA events on the
    current stream; on the CPU with the host clock. ``inner`` > 1 times a
    block of back-to-back calls and divides, which amortises the per-call
    dispatch jitter that rivals a microsecond-scale op.
    """
    out = None
    for _ in range(max(1, warmup)):
        out = fn(*args)
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(iters)]
        for start, end in pairs:
            start.record()
            for _ in range(inner):
                fn(*args)
            end.record()
        torch.cuda.synchronize(out.device)
        return min(s.elapsed_time(e) for s, e in pairs) / 1e3 / inner
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn(*args)
        best = min(best, (time.perf_counter() - t0) / inner)
    return best


# Conversion failures that skip a candidate instead of failing the tuner
# (e.g. BSR on a shape that is no multiple of the block size, or a
# container that does not fit the card).
_SKIP = (ValueError, MemoryError, torch.cuda.OutOfMemoryError)


_OPS = {"spmv": _ops.spmv, "spmm": _ops.spmm, "spmm_t": _ops.spmm_t}


def profile_select(A, x,
                   candidates: Sequence[Format] = (Format.COO, Format.CSR, Format.DIA,
                                                   Format.ELL, Format.SELL),
                   iters: int = 10, conv_kwargs: Optional[dict] = None,
                   inner: int = 4,
                   backends: Optional[Sequence[str]] = None,
                   op: str = "spmv") -> TuneReport:
    """The paper's profiling auto-tuner: convert, time, pick the fastest.

    ``op`` is the computation timed: ``"spmv"`` with a vector ``x``,
    ``"spmm"`` with a rhs ``x`` of shape (N, K), or ``"spmm_t"`` with
    activations ``x`` of shape (T, N); the rhs width comes from ``x``, so
    the pick is made at the width the caller will run. Each candidate is
    planned (one small sync) and converted on the device of ``A``, then one
    ``op(Af, x, backend=...)`` is timed with :func:`time_fn`, through the
    route ``backend=None`` takes on that device: the CUDA kernel on the
    card, the torch reference on the CPU. ``backends`` extends the search to (format,
    backend) pairs, e.g. ``("ref", "cuda")``; ``times`` then holds each
    format's best time and the report's ``backend`` names the winning pair's
    backend. ``"cuda"`` is timed only for formats with a kernel in the op's
    registry (COO and Dense would time the reference under the kernel's
    name). Each candidate is freed before the next one is built, so peak
    memory is ``A`` plus one candidate.
    """
    A = A.concrete if isinstance(A, DynamicMatrix) else A
    conv_kwargs = conv_kwargs or {}
    searched = tuple(backends) if backends is not None else (None,)
    op_fn = _OPS[op]
    registry = kops.cuda_registry(op)
    times: Dict[Format, float] = {}
    winner: Dict[Format, Optional[str]] = {}
    skipped: Dict[str, str] = {}
    for fmt in candidates:
        fmt = Format(fmt)
        try:
            Af = convert_execute(A, plan_switch(A, fmt, **conv_kwargs.get(fmt, {})))
        except _SKIP as e:
            skipped[fmt.name] = f"{type(e).__name__}: {e}"
            continue
        for b in searched:
            if b == "cuda" and type(Af) not in registry:
                continue
            t = time_fn(lambda a, v, b=b: op_fn(a, v, backend=b), Af, x,
                        iters=iters, inner=inner)
            if fmt not in times or t < times[fmt]:
                times[fmt], winner[fmt] = t, b
        del Af  # free this candidate before the next conversion
    if not times:
        raise ValueError(
            f"profile_select: every candidate format failed conversion for "
            f"matrix of shape {tuple(A.shape)}; skipped candidates: {skipped}")
    best = min(times, key=times.get)
    return TuneReport(best, times, "profile", backend=winner[best])
