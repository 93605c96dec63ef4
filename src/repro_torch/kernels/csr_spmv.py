"""CSR-format SpMV: wrapper of the hand-written CUDA kernel ``csrc/csr_spmv.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/csr_spmv.py::csr_spmv``. On a
CUDA tensor the wrapper launches the kernel (or raises); on a CPU tensor it
runs the plain version, ``repro_torch.kernels.ref.csr_spmv_ref``.
``launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import csr_spmv_ref

NAME = "csr_spmv"
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
VEC_WIDTHS = (2, 4, 8, 16, 32)
launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    return _build.entry_point(NAME, f"{NAME}_{DTYPES[dtype]}", _ARGTYPES)


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


def csr_spmv(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor,
             x: torch.Tensor, m: int, vec: int) -> torch.Tensor:
    """y = A @ x for CSR A given as (indptr[M+1], indices[cap], data[cap]);
    ``vec`` lanes reduce each row (``kernels.ops.default_config`` picks it).
    f32 accumulation; y in x's dtype."""
    global launches
    if x.device.type == "cpu":
        return csr_spmv_ref(indptr, indices, data, x, m)
    if x.device.type != "cuda":
        raise ValueError(f"csr_spmv runs on cuda or cpu tensors, got {x.device}")
    _check(indptr, indices, data, x, m, vec)
    n = x.shape[0]
    if m == 0 or n == 0:  # nothing to launch: every row (if any) sums nothing
        return torch.zeros((m,), dtype=x.dtype, device=x.device)
    y = torch.empty((m,), dtype=x.dtype, device=x.device)
    fn, err_str = _fn(x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(indptr.data_ptr(), indices.data_ptr(), data.data_ptr(), x.data_ptr(),
             y.data_ptr(), m, n, vec, x.device.index, stream)
    if err:
        raise RuntimeError(f"csr_spmv launch failed: {err_str(err).decode()} ({err})")
    launches += 1
    return y
