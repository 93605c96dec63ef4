"""SELL-C-sigma SpMM: wrappers of the hand-written CUDA kernels ``csrc/sell_spmm.cu``.

Two kernels in one source: ``sell_spmm`` (Y = A @ B, B (N, Kb)) replaces the
Pallas TPU kernel ``repro/kernels/sell_spmv.py::sell_spmm``, and
``sell_spmm_t`` (Y = X @ A^T, X (T, N)) replaces
``repro/kernels/sell_spmv.py::sell_spmm_t``. On a CUDA tensor each wrapper
launches its kernel (or raises); on a CPU tensor it runs the plain version,
``repro_torch.kernels.ref.sell_spmm_ref`` / ``sell_spmm_t_ref``. The kernels
write each lane's sums straight to row (or column) ``perm[lane]`` of Y, so
``perm`` must be a permutation of the rows plus ghost lanes (``perm == M``),
as every SELL container is: every row is then written once and Y needs no
zero fill. Each kernel has its own count: ``launches`` (sell_spmm) and
``launches_t`` (sell_spmm_t), raised where the kernel launches and nowhere
else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.csr_spmm import TOKEN_TILES, token_tile
from repro_torch.kernels.ref import sell_spmm_ref, sell_spmm_t_ref

NAME = "sell_spmm"
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_C = 1024  # a slice's lanes share one block of 1024 threads
launches = 0
launches_t = 0

_P, _I64, _I32, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I64, _I32, _I64, _I32, _I64, _INT, _P]
_ARGTYPES_T = [_P, _P, _P, _P, _P, _P, _I64, _I32, _I64, _I32, _I64, _INT, _INT, _P]


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    return _build.entry_point(NAME, f"sell_spmm_{DTYPES[dtype]}", _ARGTYPES)


@functools.lru_cache(maxsize=None)
def _fn_t(dtype: torch.dtype):
    return _build.entry_point(NAME, f"sell_spmm_t_{DTYPES[dtype]}", _ARGTYPES_T)


def _check(slice_ptrs, cols, data, perm, X, m, c, tt, what="X", n_axis=1):
    """``X`` is the rhs: X (T, N) (N on axis 1) or B (N, Kb) (N on axis 0)."""
    dev = X.device
    for name, t in (("slice_ptrs", slice_ptrs), ("cols", cols), ("data", data),
                    ("perm", perm)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, {what} on {dev}")
        if not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"{name} must be 1-D and contiguous")
    for name, t in (("slice_ptrs", slice_ptrs), ("cols", cols), ("perm", perm)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if not 0 < c <= MAX_C:
        raise ValueError(f"slice height c must be in [1, {MAX_C}], got {c}")
    nslices = slice_ptrs.shape[0] - 1
    if perm.shape[0] != nslices * c or perm.shape[0] < m:
        raise ValueError(f"perm must have nslices*c={nslices * c} >= m={m} entries, "
                         f"got {perm.shape[0]}")
    if cols.shape != data.shape or data.shape[0] % c:
        raise ValueError(f"cols {tuple(cols.shape)} and data {tuple(data.shape)} must "
                         f"match and hold whole planes of c={c}")
    if X.dim() != 2 or not X.is_contiguous():
        shape = "(T, N)" if n_axis else "(N, Kb)"
        raise ValueError(f"{what} must be 2-D {shape} and contiguous")
    if X.shape[n_axis] >= 2 ** 31:
        raise ValueError(f"{what} wider than int32 column indices can address")
    if X.dtype not in DTYPES or data.dtype != X.dtype:
        raise ValueError(f"data and X must share dtype float32 or bfloat16, "
                         f"got {data.dtype} and {X.dtype}")
    if tt not in TOKEN_TILES:
        raise ValueError(f"tt must be one of {TOKEN_TILES}, got {tt}")


def sell_spmm(slice_ptrs: torch.Tensor, cols: torch.Tensor, data: torch.Tensor,
              perm: torch.Tensor, B: torch.Tensor, m: int, c: int) -> torch.Tensor:
    """Y = A @ B for SELL-C-sigma A given as flat (slice_ptrs, cols, data,
    perm) with slice height ``c``, and B (N, Kb); returns (M, Kb). For
    Kb <= 8 a block of 1024 threads sums a slice's planes (``c`` at most
    ``MAX_C``); wider Kb runs lanes along Kb, one group a sorted row. f32
    accumulation; Y in B's dtype."""
    global launches
    if B.device.type == "cpu":
        return sell_spmm_ref(slice_ptrs, cols, data, perm, B, m, c)
    if B.device.type != "cuda":
        raise ValueError(f"sell_spmm runs on cuda or cpu tensors, got {B.device}")
    _check(slice_ptrs, cols, data, perm, B, m, c, 1, "B", 0)
    n, kb = B.shape
    if m == 0 or kb == 0 or n == 0:  # nothing to launch: every output sums nothing
        return torch.zeros((m, kb), dtype=B.dtype, device=B.device)
    y = torch.empty((m, kb), dtype=B.dtype, device=B.device)
    fn, err_str = _fn(B.dtype)
    stream = torch.cuda.current_stream(B.device).cuda_stream
    err = fn(slice_ptrs.data_ptr(), cols.data_ptr(), data.data_ptr(), perm.data_ptr(),
             B.data_ptr(), y.data_ptr(), perm.shape[0], c, m, n, kb, B.device.index, stream)
    if err:
        raise RuntimeError(f"sell_spmm launch failed: {err_str(err).decode()} ({err})")
    launches += 1
    return y


def sell_spmm_t(slice_ptrs: torch.Tensor, cols: torch.Tensor, data: torch.Tensor,
                perm: torch.Tensor, X: torch.Tensor, m: int, c: int,
                tt: int | None = None) -> torch.Tensor:
    """Y = X @ A^T for SELL-C-sigma A given as flat (slice_ptrs, cols, data,
    perm) with slice height ``c``, and activations X (T, N); returns (T, M).
    ``tt`` tokens a block (default ``csr_spmm.token_tile`` of T), their rows
    of X copied into shared memory for ``tt`` > 1 where they fit. f32
    accumulation; Y in X's dtype."""
    global launches_t
    if X.device.type == "cpu":
        return sell_spmm_t_ref(slice_ptrs, cols, data, perm, X, m, c)
    if X.device.type != "cuda":
        raise ValueError(f"sell_spmm_t runs on cuda or cpu tensors, got {X.device}")
    tt = token_tile(X.shape[0]) if tt is None else tt
    _check(slice_ptrs, cols, data, perm, X, m, c, tt)
    t, n = X.shape
    if m == 0 or t == 0 or n == 0:  # nothing to launch: every output sums nothing
        return torch.zeros((t, m), dtype=X.dtype, device=X.device)
    y = torch.empty((t, m), dtype=X.dtype, device=X.device)
    fn, err_str = _fn_t(X.dtype)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = fn(slice_ptrs.data_ptr(), cols.data_ptr(), data.data_ptr(), perm.data_ptr(),
             X.data_ptr(), y.data_ptr(), perm.shape[0], c, m, n, t, tt,
             X.device.index, stream)
    if err:
        raise RuntimeError(f"sell_spmm_t launch failed: {err_str(err).decode()} ({err})")
    launches_t += 1
    return y
