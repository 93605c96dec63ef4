"""DIA-format SpMV: wrapper of the hand-written CUDA kernel ``csrc/dia_spmv.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/dia_spmv.py::dia_spmv``. On a
CUDA tensor the wrapper launches the kernel (or raises); on a CPU tensor it
runs the plain version, ``repro_torch.kernels.ref.dia_spmv_ref``.
``launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dia_spmv_ref

NAME = "dia_spmv"
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    return _build.entry_point(NAME, f"{NAME}_{DTYPES[dtype]}", _ARGTYPES)


def _check(offsets, data, x, n, block):
    dev = x.device
    for name, t in (("offsets", offsets), ("data", data)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, x on {dev}")
    if offsets.dtype != torch.int32 or offsets.dim() != 1:
        raise ValueError(f"offsets must be 1-D int32, got {offsets.dtype} {tuple(offsets.shape)}")
    if data.dim() != 2 or data.shape[0] != offsets.shape[0]:
        raise ValueError(f"data must be (ndiag={offsets.shape[0]}, M), got {tuple(data.shape)}")
    if x.dim() != 1 or x.shape[0] != n:
        raise ValueError(f"x must be 1-D of length n={n}, got {tuple(x.shape)}")
    if x.dtype not in DTYPES or data.dtype != x.dtype:
        raise ValueError(f"data and x must share dtype float32 or bfloat16, "
                         f"got {data.dtype} and {x.dtype}")
    if not (offsets.is_contiguous() and data.is_contiguous() and x.is_contiguous()):
        raise ValueError("offsets, data and x must be contiguous")
    if block <= 0 or block > 1024 or block % 32:
        raise ValueError(f"block must be a multiple of 32 in [32, 1024], got {block}")


def dia_spmv(offsets: torch.Tensor, data: torch.Tensor, x: torch.Tensor, n: int,
             block: int = 256) -> torch.Tensor:
    """y = A @ x for DIA A given as (offsets[ndiag], data[ndiag, M]); x has
    length ``n``. f32 accumulation; y in x's dtype."""
    global launches
    if x.device.type == "cpu":
        return dia_spmv_ref(offsets, data, x, n)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv runs on cuda or cpu tensors, got {x.device}")
    _check(offsets, data, x, n, block)
    ndiag, m = data.shape
    y = torch.empty((m,), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    fn, err_str = _fn(x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(offsets.data_ptr(), data.data_ptr(), x.data_ptr(), y.data_ptr(),
             ndiag, m, n, block, x.device.index, stream)
    if err:
        raise RuntimeError(f"dia_spmv launch failed: {err_str(err).decode()} ({err})")
    launches += 1
    return y
