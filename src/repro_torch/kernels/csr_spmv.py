"""CSR-format SpMV: wrapper of the hand-written CUDA kernel ``csrc/csr_spmv.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/csr_spmv.py::csr_spmv``. On a
CUDA tensor the wrapper launches the kernel (or raises); on a CPU tensor it
runs the plain version, ``repro_torch.kernels.ref.csr_spmv_ref``.
``launches`` counts kernel launches and nothing else.

One launch runs two schedules. A row of at most :func:`long_threshold`
entries is reduced by a sub-warp of ``vec`` lanes; a longer row is cut into
``CHUNK``-entry chunks that warps of the grid's first blocks reduce, listed
by a :class:`LongRowPlan` that :func:`long_row_plan` builds on the device
with torch ops and no device->host read.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import csr_spmv_ref

NAME = "csr_spmv"
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
VEC_WIDTHS = (2, 4, 8, 16, 32)
# A row is long above LONG_STEPS steps of its vec lanes and above
# LONG_OVER_AVG times the average row (long_threshold); a long row is reduced
# in chunks of CHUNK entries (kChunk in the source), one warp a chunk.
LONG_STEPS = 32
LONG_OVER_AVG = 4
CHUNK = 256
# Blocks a multiprocessor that walk the chunk list (8 warps each): as many
# as fit at once (2048 threads). Where no row is long they exit at once.
LONG_CTAS_PER_SM = 8
_WARPS = 8  # warps a block (256 threads)
launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    return _build.entry_point(NAME, f"{NAME}_{DTYPES[dtype]}", _ARGTYPES)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def long_threshold(vec: int, capacity: int, m: int) -> int:
    """Entries above which a row of an ``m``-row pattern with ``capacity``
    stored entries leaves the ``vec``-lane schedule: more than
    ``LONG_STEPS`` steps of its lanes, and more than ``LONG_OVER_AVG`` times
    the average row. The first keeps every lane's walk short; the second
    keeps rows that are all alike on the one-row schedule: at ``vec`` 32
    (average rows above 256 entries) a row over 1,024 entries is long only
    when its neighbours are much shorter. Host ints only."""
    avg = -(-int(capacity) // max(int(m), 1))
    return min(max(LONG_STEPS * vec, LONG_OVER_AVG * avg), 2 ** 31 - 1)


@dataclasses.dataclass(frozen=True, eq=False)
class LongRowPlan:
    """Where the long rows of one CSR pattern are and how they are cut.

    A row of more than ``threshold`` entries (:func:`long_threshold`) is
    long and has ceil(len / ``CHUNK``) chunks; a short row has none.
    ``chunk_end[i]`` counts the chunks of rows 0..i, so row i's chunks are
    ``chunk_end[i] - chunks(i) .. chunk_end[i] - 1`` and ``chunk_end[m - 1]``
    is their number, which stays on the device; ``chunk_row[q]`` is chunk
    q's row (entries past the last chunk are never read). ``k_max`` is a
    host-known bound on the chunks, 0 where no row can be long. ``arrive``
    (zeros) and ``partials`` are the kernel's workspace: the plan serves one
    call at a time, on one stream.
    """

    indptr: torch.Tensor      # the pattern's row pointers (kept alive with it)
    capacity: int             # stored entries the bounds were taken over
    vec: int                  # lanes a short row
    threshold: int            # long_threshold(vec, capacity, m)
    k_max: int
    chunk_end: torch.Tensor   # (m,) int32
    chunk_row: torch.Tensor   # (k_max,) int32
    arrive: torch.Tensor      # (m,) int32 zeros
    partials: torch.Tensor    # (k_max,) float32


def long_row_plan(indptr: torch.Tensor, capacity: int, vec: int) -> LongRowPlan:
    """The long-row plan of ``indptr`` (M+1 row pointers into ``capacity``
    stored entries) for ``vec`` lanes a short row: torch ops on indptr's
    device, none of which reads a count back to the host (a cumsum of the
    chunk counts, each chunk's row by ``searchsorted``; no ``nonzero``, no
    ``bincount``). Host bound: at most ``capacity // (threshold + 1)`` rows
    are long, and they hold at most ``capacity // CHUNK`` chunks more than
    that."""
    dev = indptr.device
    m = indptr.shape[0] - 1
    thr = long_threshold(vec, capacity, m)
    long_max = min(max(m, 0), int(capacity) // (thr + 1))
    k_max = int(capacity) // CHUNK + long_max if long_max else 0
    i32 = dict(dtype=torch.int32, device=dev)
    if not k_max:  # no row can be long: the kernel reads none of the plan
        none = torch.zeros((0,), **i32)
        return LongRowPlan(indptr, int(capacity), vec, thr, 0, none, none, none,
                           torch.zeros((0,), dtype=torch.float32, device=dev))
    lens = indptr[1:] - indptr[:-1]
    chunks = torch.where(lens > thr, lens + (CHUNK - 1), 0) // CHUNK
    chunk_end = torch.cumsum(chunks, 0, dtype=torch.int32)
    chunk_row = torch.searchsorted(chunk_end, torch.arange(k_max, **i32), right=True,
                                   out_int32=True)
    return LongRowPlan(indptr, int(capacity), vec, thr, k_max, chunk_end, chunk_row,
                       torch.zeros((m,), **i32),
                       torch.empty((k_max,), dtype=torch.float32, device=dev))


def _check(indptr, indices, data, x, m, vec):
    dev = x.device
    for name, t in (("indptr", indptr), ("indices", indices), ("data", data)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, x on {dev}")
        if not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"{name} must be 1-D and contiguous")
    if indptr.dtype != torch.int32 or indices.dtype != torch.int32:
        raise ValueError(f"indptr/indices must be int32, got {indptr.dtype}/{indices.dtype}")
    if indptr.shape[0] != m + 1:
        raise ValueError(f"indptr must have m+1={m + 1} entries, got {indptr.shape[0]}")
    if indices.shape[0] != data.shape[0]:
        raise ValueError(f"indices ({indices.shape[0]}) and data ({data.shape[0]}) differ")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be 1-D and contiguous")
    if x.shape[0] >= 2 ** 31:
        raise ValueError("x longer than int32 column indices can address")
    if x.dtype not in DTYPES or data.dtype != x.dtype:
        raise ValueError(f"data and x must share dtype float32 or bfloat16, "
                         f"got {data.dtype} and {x.dtype}")
    if vec not in VEC_WIDTHS:
        raise ValueError(f"vec must be one of {VEC_WIDTHS}, got {vec}")


def _check_plan(plan: LongRowPlan, indptr, data, vec):
    if (plan.indptr.device != indptr.device or plan.indptr.data_ptr() != indptr.data_ptr()
            or plan.indptr.shape != indptr.shape):
        raise ValueError("the long-row plan was built for another indptr")
    if plan.vec != vec:
        raise ValueError(f"the long-row plan was built for vec={plan.vec}, not vec={vec}")
    if plan.capacity < data.shape[0]:
        raise ValueError(f"the long-row plan bounds {plan.capacity} entries, data holds "
                         f"{data.shape[0]}")


def csr_spmv(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor,
             x: torch.Tensor, m: int, vec: int,
             plan: Optional[LongRowPlan] = None) -> torch.Tensor:
    """y = A @ x for CSR A given as (indptr[M+1], indices[cap], data[cap]);
    ``vec`` lanes reduce each short row (``kernels.ops.default_config``
    picks it); ``plan``, :func:`long_row_plan` of indptr at ``vec``, lists
    the long rows (built here when not given). f32 accumulation; y in x's
    dtype."""
    global launches
    if x.device.type == "cpu":
        return csr_spmv_ref(indptr, indices, data, x, m)
    if x.device.type != "cuda":
        raise ValueError(f"csr_spmv runs on cuda or cpu tensors, got {x.device}")
    _check(indptr, indices, data, x, m, vec)
    n = x.shape[0]
    if m == 0 or n == 0:  # nothing to launch: every row (if any) sums nothing
        return torch.zeros((m,), dtype=x.dtype, device=x.device)
    if plan is None:
        plan = long_row_plan(indptr, data.shape[0], vec)
    _check_plan(plan, indptr, data, vec)
    long_ctas = min(LONG_CTAS_PER_SM * _sm_count(x.device.index), -(-plan.k_max // _WARPS))
    y = torch.empty((m,), dtype=x.dtype, device=x.device)
    fn, err_str = _fn(x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(indptr.data_ptr(), indices.data_ptr(), data.data_ptr(), x.data_ptr(),
             y.data_ptr(), m, n, vec, plan.chunk_end.data_ptr(), plan.chunk_row.data_ptr(),
             plan.arrive.data_ptr(), plan.partials.data_ptr(), plan.threshold, long_ctas,
             x.device.index, stream)
    if err:
        raise RuntimeError(f"csr_spmv launch failed: {err_str(err).decode()} ({err})")
    launches += 1
    return y
