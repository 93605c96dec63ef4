"""ELL-format SpMM: wrappers of the hand-written CUDA kernels ``csrc/ell_spmm.cu``.

Two kernels in one source: ``ell_spmm`` (Y = A @ B, B (N, Kb)) replaces the
Pallas TPU kernel ``repro/kernels/ell_spmv.py::ell_spmm``, and
``ell_spmm_t`` (Y = X @ A^T, X (T, N)) replaces
``repro/kernels/ell_spmv.py::ell_spmm_t``. On a CUDA tensor each wrapper
launches its kernel (or raises); on a CPU tensor it runs the plain version,
``repro_torch.kernels.ref.ell_spmm_ref`` / ``ell_spmm_t_ref``. K = 0 returns
zeros and launches nothing, as the JAX kernels do. Each kernel has its own
count: ``launches`` (ell_spmm) and ``launches_t`` (ell_spmm_t), raised where
the kernel launches and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.csr_spmm import TOKEN_TILES, VEC_WIDTHS, token_tile
from repro_torch.kernels.ref import ell_spmm_ref, ell_spmm_t_ref

NAME = "ell_spmm"
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
launches = 0
launches_t = 0

_P, _I64, _I32, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I64, _I32, _I32, _I64, _INT, _INT, _P]
_ARGTYPES_T = [_P, _P, _P, _P, _I64, _I32, _I32, _I64, _INT, _INT, _INT, _P]


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    return _build.entry_point(NAME, f"ell_spmm_{DTYPES[dtype]}", _ARGTYPES)


@functools.lru_cache(maxsize=None)
def _fn_t(dtype: torch.dtype):
    return _build.entry_point(NAME, f"ell_spmm_t_{DTYPES[dtype]}", _ARGTYPES_T)


def _check(cols, data, X, vec, tt, what="X", n_axis=1):
    """``X`` is the rhs: X (T, N) (N on axis 1) or B (N, Kb) (N on axis 0)."""
    dev = X.device
    for name, t in (("cols", cols), ("data", data)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, {what} on {dev}")
        if not t.is_contiguous() or t.dim() != 2:
            raise ValueError(f"{name} must be 2-D (M, K) and contiguous")
    if cols.dtype != torch.int32:
        raise ValueError(f"cols must be int32, got {cols.dtype}")
    if cols.shape != data.shape:
        raise ValueError(f"cols {tuple(cols.shape)} and data {tuple(data.shape)} differ")
    if data.shape[1] >= 2 ** 31:
        raise ValueError("K too large for the kernel's int32 slot count")
    if X.dim() != 2 or not X.is_contiguous():
        shape = "(T, N)" if n_axis else "(N, Kb)"
        raise ValueError(f"{what} must be 2-D {shape} and contiguous")
    if X.shape[n_axis] >= 2 ** 31:
        raise ValueError(f"{what} wider than int32 column indices can address")
    if X.dtype not in DTYPES or data.dtype != X.dtype:
        raise ValueError(f"data and X must share dtype float32 or bfloat16, "
                         f"got {data.dtype} and {X.dtype}")
    if vec not in VEC_WIDTHS or tt not in TOKEN_TILES:
        raise ValueError(f"vec must be one of {VEC_WIDTHS} and tt one of {TOKEN_TILES}, "
                         f"got {vec}, {tt}")


def ell_spmm(cols: torch.Tensor, data: torch.Tensor, B: torch.Tensor,
             vec: int) -> torch.Tensor:
    """Y = A @ B for ELL A given as (cols[M, K], data[M, K]) and B (N, Kb);
    returns (M, Kb). Columns clamp into [0, N); for Kb <= 8 ``vec`` lanes
    reduce each row (``kernels.ops.default_config``), wider Kb runs lanes
    along Kb. f32 accumulation; Y in B's dtype."""
    global launches
    if B.device.type == "cpu":
        return ell_spmm_ref(cols, data, B)
    if B.device.type != "cuda":
        raise ValueError(f"ell_spmm runs on cuda or cpu tensors, got {B.device}")
    _check(cols, data, B, vec, 1, "B", 0)
    m, k = data.shape
    n, kb = B.shape
    if m == 0 or k == 0 or kb == 0 or n == 0:  # nothing to launch: every row sums nothing
        return torch.zeros((m, kb), dtype=B.dtype, device=B.device)
    y = torch.empty((m, kb), dtype=B.dtype, device=B.device)
    fn, err_str = _fn(B.dtype)
    stream = torch.cuda.current_stream(B.device).cuda_stream
    err = fn(cols.data_ptr(), data.data_ptr(), B.data_ptr(), y.data_ptr(), m, n, k, kb,
             vec, B.device.index, stream)
    if err:
        raise RuntimeError(f"ell_spmm launch failed: {err_str(err).decode()} ({err})")
    launches += 1
    return y


def ell_spmm_t(cols: torch.Tensor, data: torch.Tensor, X: torch.Tensor, vec: int,
               tt: int | None = None) -> torch.Tensor:
    """Y = X @ A^T for ELL A given as (cols[M, K], data[M, K]) and
    activations X (T, N); returns (T, M). Columns clamp into [0, N); ``vec``
    lanes a row (``kernels.ops.default_config``), ``tt`` tokens a block
    (default ``csr_spmm.token_tile`` of T). f32 accumulation; Y in X's
    dtype."""
    global launches_t
    if X.device.type == "cpu":
        return ell_spmm_t_ref(cols, data, X)
    if X.device.type != "cuda":
        raise ValueError(f"ell_spmm_t runs on cuda or cpu tensors, got {X.device}")
    tt = token_tile(X.shape[0]) if tt is None else tt
    _check(cols, data, X, vec, tt)
    m, k = data.shape
    t, n = X.shape
    if m == 0 or k == 0 or t == 0 or n == 0:  # nothing to launch: every row sums nothing
        return torch.zeros((t, m), dtype=X.dtype, device=X.device)
    y = torch.empty((t, m), dtype=X.dtype, device=X.device)
    fn, err_str = _fn_t(X.dtype)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = fn(cols.data_ptr(), data.data_ptr(), X.data_ptr(), y.data_ptr(), m, n, k, t,
             vec, tt, X.device.index, stream)
    if err:
        raise RuntimeError(f"ell_spmm_t launch failed: {err_str(err).decode()} ({err})")
    launches_t += 1
    return y
