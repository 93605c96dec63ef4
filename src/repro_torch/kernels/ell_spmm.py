"""ELL-format SpMM: wrapper of the hand-written CUDA kernel ``csrc/ell_spmm.cu``.

``ell_spmm_t`` (Y = X @ A^T, X (T, N)) replaces the Pallas TPU kernel
``repro/kernels/ell_spmv.py::ell_spmm_t``. On a CUDA tensor the wrapper
launches the kernel (or raises); on a CPU tensor it runs the plain version,
``repro_torch.kernels.ref.ell_spmm_t_ref``. K = 0 returns zeros and launches
nothing, as the JAX kernel does. ``launches`` counts kernel launches and
nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.csr_spmm import TOKEN_TILES, VEC_WIDTHS, token_tile
from repro_torch.kernels.ref import ell_spmm_t_ref

NAME = "ell_spmm"
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
launches = 0

_P, _I64, _I32, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I64, _I32, _I32, _I64, _INT, _INT, _INT, _P]


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    return _build.entry_point(NAME, f"ell_spmm_t_{DTYPES[dtype]}", _ARGTYPES)


def _check(cols, data, X, vec, tt):
    dev = X.device
    for name, t in (("cols", cols), ("data", data)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, X on {dev}")
        if not t.is_contiguous() or t.dim() != 2:
            raise ValueError(f"{name} must be 2-D (M, K) and contiguous")
    if cols.dtype != torch.int32:
        raise ValueError(f"cols must be int32, got {cols.dtype}")
    if cols.shape != data.shape:
        raise ValueError(f"cols {tuple(cols.shape)} and data {tuple(data.shape)} differ")
    if data.shape[1] >= 2 ** 31:
        raise ValueError("K too large for the kernel's int32 slot count")
    if X.dim() != 2 or not X.is_contiguous():
        raise ValueError("X must be 2-D (T, N) and contiguous")
    if X.shape[1] >= 2 ** 31:
        raise ValueError("X wider than int32 column indices can address")
    if X.dtype not in DTYPES or data.dtype != X.dtype:
        raise ValueError(f"data and X must share dtype float32 or bfloat16, "
                         f"got {data.dtype} and {X.dtype}")
    if vec not in VEC_WIDTHS or tt not in TOKEN_TILES:
        raise ValueError(f"vec must be one of {VEC_WIDTHS} and tt one of {TOKEN_TILES}, "
                         f"got {vec}, {tt}")


def ell_spmm_t(cols: torch.Tensor, data: torch.Tensor, X: torch.Tensor, vec: int,
               tt: int | None = None) -> torch.Tensor:
    """Y = X @ A^T for ELL A given as (cols[M, K], data[M, K]) and
    activations X (T, N); returns (T, M). Columns clamp into [0, N); ``vec``
    lanes a row (``kernels.ops.spmm_t_config``), ``tt`` tokens a block
    (default ``csr_spmm.token_tile`` of T). f32 accumulation; Y in X's
    dtype."""
    global launches
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
    fn, err_str = _fn(X.dtype)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = fn(cols.data_ptr(), data.data_ptr(), X.data_ptr(), y.data_ptr(), m, n, k, t,
             vec, tt, X.device.index, stream)
    if err:
        raise RuntimeError(f"ell_spmm_t launch failed: {err_str(err).decode()} ({err})")
    launches += 1
    return y
