"""CSR-format SpMM: wrappers of the hand-written CUDA kernels ``csrc/csr_spmm.cu``.

Two kernels in one source: ``csr_spmm`` (Y = A @ B, B (N, K)) replaces the
Pallas TPU kernel ``repro/kernels/csr_spmm.py::csr_spmm``, and
``csr_spmm_t`` (Y = X @ A^T, X (T, N)) replaces
``repro/kernels/csr_spmm.py::csr_spmm_t``. On a CUDA tensor each wrapper
launches its kernel (or raises); on a CPU tensor it runs the plain version,
``repro_torch.kernels.ref.csr_spmm_ref`` / ``csr_spmm_t_ref``. Each kernel
has its own count: ``launches`` (csr_spmm) and ``launches_t``
(csr_spmm_t), raised where the kernel launches and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import csr_spmm_ref, csr_spmm_t_ref

NAME = "csr_spmm"
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
VEC_WIDTHS = (2, 4, 8, 16, 32)
TOKEN_TILES = (1, 2, 4, 8)
# Tokens a transposed-rhs block takes at once: each stored entry, loaded
# once, feeds this many multiply-adds. On an H100 at the minitron-8b MLP
# shapes (T = 256, f32; chip_smoke.py's token-tile sweep, PERF.md) 8 tokens
# ran fastest for the CSR kernel on both weights and for the SELL kernel on
# the down weight; the SELL kernel on the up weight ran 2.13 ms at 4 tokens
# against 2.29 ms at 8.
MAX_TOKEN_TILE = 8
launches = 0
launches_t = 0

_P, _I64, _I32, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I64, _I32, _I64, _INT, _INT, _P]
_ARGTYPES_T = [_P, _P, _P, _P, _P, _I64, _I32, _I64, _INT, _INT, _INT, _P]


def token_tile(t: int) -> int:
    """Tokens a block takes for ``t`` tokens: the smallest power of two
    >= ``t``, at most ``MAX_TOKEN_TILE``."""
    tt = 1
    while tt < min(t, MAX_TOKEN_TILE):
        tt *= 2
    return tt


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    return _build.entry_point(NAME, f"csr_spmm_{DTYPES[dtype]}", _ARGTYPES)


@functools.lru_cache(maxsize=None)
def _fn_t(dtype: torch.dtype):
    return _build.entry_point(NAME, f"csr_spmm_t_{DTYPES[dtype]}", _ARGTYPES_T)


def _check(indptr, indices, data, rhs, m, what, n_axis):
    """``rhs`` is B (N on axis 0) or X (N on axis 1)."""
    dev = rhs.device
    for name, t in (("indptr", indptr), ("indices", indices), ("data", data)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, {what} on {dev}")
        if not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"{name} must be 1-D and contiguous")
    if indptr.dtype != torch.int32 or indices.dtype != torch.int32:
        raise ValueError(f"indptr/indices must be int32, got {indptr.dtype}/{indices.dtype}")
    if indptr.shape[0] != m + 1:
        raise ValueError(f"indptr must have m+1={m + 1} entries, got {indptr.shape[0]}")
    if indices.shape[0] != data.shape[0]:
        raise ValueError(f"indices ({indices.shape[0]}) and data ({data.shape[0]}) differ")
    if rhs.dim() != 2 or not rhs.is_contiguous():
        raise ValueError(f"{what} must be 2-D and contiguous")
    if rhs.shape[n_axis] >= 2 ** 31:
        raise ValueError(f"{what} wider than int32 column indices can address")
    if rhs.dtype not in DTYPES or data.dtype != rhs.dtype:
        raise ValueError(f"data and {what} must share dtype float32 or bfloat16, "
                         f"got {data.dtype} and {rhs.dtype}")


def csr_spmm(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor,
             B: torch.Tensor, m: int, vec: int) -> torch.Tensor:
    """Y = A @ B for CSR A given as (indptr[M+1], indices[cap], data[cap])
    and B (N, K); returns (M, K). For K <= 8 ``vec`` lanes reduce each row
    (``kernels.ops.default_config`` picks it); wider K runs lanes along K.
    f32 accumulation; Y in B's dtype."""
    global launches
    if B.device.type == "cpu":
        return csr_spmm_ref(indptr, indices, data, B, m)
    if B.device.type != "cuda":
        raise ValueError(f"csr_spmm runs on cuda or cpu tensors, got {B.device}")
    _check(indptr, indices, data, B, m, "B", 0)
    if vec not in VEC_WIDTHS:
        raise ValueError(f"vec must be one of {VEC_WIDTHS}, got {vec}")
    n, k = B.shape
    if m == 0 or k == 0 or n == 0:  # nothing to launch: every output sums nothing
        return torch.zeros((m, k), dtype=B.dtype, device=B.device)
    y = torch.empty((m, k), dtype=B.dtype, device=B.device)
    fn, err_str = _fn(B.dtype)
    stream = torch.cuda.current_stream(B.device).cuda_stream
    err = fn(indptr.data_ptr(), indices.data_ptr(), data.data_ptr(), B.data_ptr(),
             y.data_ptr(), m, n, k, vec, B.device.index, stream)
    if err:
        raise RuntimeError(f"csr_spmm launch failed: {err_str(err).decode()} ({err})")
    launches += 1
    return y


def csr_spmm_t(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor,
               X: torch.Tensor, m: int, vec: int, tt: int | None = None) -> torch.Tensor:
    """Y = X @ A^T for CSR A and activations X (T, N); returns (T, M).
    ``vec`` lanes reduce each row (``kernels.ops.default_config`` picks it)
    and a block takes ``tt`` tokens at once (default :func:`token_tile` of
    T). f32 accumulation; Y in X's dtype."""
    global launches_t
    if X.device.type == "cpu":
        return csr_spmm_t_ref(indptr, indices, data, X, m)
    if X.device.type != "cuda":
        raise ValueError(f"csr_spmm_t runs on cuda or cpu tensors, got {X.device}")
    _check(indptr, indices, data, X, m, "X", 1)
    tt = token_tile(X.shape[0]) if tt is None else tt
    if vec not in VEC_WIDTHS or tt not in TOKEN_TILES:
        raise ValueError(f"vec must be one of {VEC_WIDTHS} and tt one of {TOKEN_TILES}, "
                         f"got {vec}, {tt}")
    t, n = X.shape
    if m == 0 or t == 0 or n == 0:  # nothing to launch: every output sums nothing
        return torch.zeros((t, m), dtype=X.dtype, device=X.device)
    y = torch.empty((t, m), dtype=X.dtype, device=X.device)
    fn, err_str = _fn_t(X.dtype)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = fn(indptr.data_ptr(), indices.data_ptr(), data.data_ptr(), X.data_ptr(),
             y.data_ptr(), m, n, t, vec, tt, X.device.index, stream)
    if err:
        raise RuntimeError(f"csr_spmm_t launch failed: {err_str(err).decode()} ({err})")
    launches_t += 1
    return y
