"""ELL-format SpMV: wrapper of the hand-written CUDA kernel ``csrc/ell_spmv.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ell_spmv.py::ell_spmv``. On a
CUDA tensor the wrapper launches the kernel (or raises); on a CPU tensor it
runs the plain version, ``repro_torch.kernels.ref.ell_spmv_ref``. K = 0
returns zeros and launches nothing, as the JAX kernel does.
``launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ell_spmv_ref

NAME = "ell_spmv"
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int,
             ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    return _build.entry_point(NAME, f"{NAME}_{DTYPES[dtype]}", _ARGTYPES)


def _check(cols, data, x):
    dev = x.device
    for name, t in (("cols", cols), ("data", data)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, x on {dev}")
        if not t.is_contiguous() or t.dim() != 2:
            raise ValueError(f"{name} must be 2-D (M, K) and contiguous")
    if cols.dtype != torch.int32:
        raise ValueError(f"cols must be int32, got {cols.dtype}")
    if cols.shape != data.shape:
        raise ValueError(f"cols {tuple(cols.shape)} and data {tuple(data.shape)} differ")
    if data.shape[1] >= 2 ** 31:
        raise ValueError("K too large for the kernel's int32 slot count")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be 1-D and contiguous")
    if x.shape[0] >= 2 ** 31:
        raise ValueError("x longer than int32 column indices can address")
    if x.dtype not in DTYPES or data.dtype != x.dtype:
        raise ValueError(f"data and x must share dtype float32 or bfloat16, "
                         f"got {data.dtype} and {x.dtype}")


def ell_spmv(cols: torch.Tensor, data: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for ELL A given as (cols[M, K], data[M, K]); columns clamp
    into [0, N). f32 accumulation; y in x's dtype."""
    global launches
    if x.device.type == "cpu":
        return ell_spmv_ref(cols, data, x)
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmv runs on cuda or cpu tensors, got {x.device}")
    _check(cols, data, x)
    m, k = data.shape
    n = x.shape[0]
    if m == 0 or k == 0 or n == 0:  # nothing to launch: every row sums nothing
        return torch.zeros((m,), dtype=x.dtype, device=x.device)
    y = torch.empty((m,), dtype=x.dtype, device=x.device)
    fn, err_str = _fn(x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(cols.data_ptr(), data.data_ptr(), x.data_ptr(), y.data_ptr(), m, n, k,
             x.device.index, stream)
    if err:
        raise RuntimeError(f"ell_spmv launch failed: {err_str(err).decode()} ({err})")
    launches += 1
    return y
