"""SELL-C-sigma SpMV: wrapper of the hand-written CUDA kernel ``csrc/sell_spmv.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/sell_spmv.py::sell_spmv``. On
a CUDA tensor the wrapper launches the kernel (or raises); on a CPU tensor
it runs the plain version, ``repro_torch.kernels.ref.sell_spmv_ref``. The
kernel writes each lane's sum straight to ``y[perm[lane]]``, so ``perm``
must be a permutation of the rows plus ghost lanes (``perm == M``), as
every SELL container is. ``launches`` counts kernel launches and nothing
else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import sell_spmv_ref

NAME = "sell_spmv"
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
             ctypes.c_int64, ctypes.c_int32, ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    return _build.entry_point(NAME, f"{NAME}_{DTYPES[dtype]}", _ARGTYPES)


def _check(slice_ptrs, cols, data, perm, x, m, c):
    dev = x.device
    for name, t in (("slice_ptrs", slice_ptrs), ("cols", cols), ("data", data),
                    ("perm", perm)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, x on {dev}")
        if not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"{name} must be 1-D and contiguous")
    for name, t in (("slice_ptrs", slice_ptrs), ("cols", cols), ("perm", perm)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if c <= 0:
        raise ValueError(f"slice height c must be positive, got {c}")
    nslices = slice_ptrs.shape[0] - 1
    if perm.shape[0] != nslices * c or perm.shape[0] < m:
        raise ValueError(f"perm must have nslices*c={nslices * c} >= m={m} entries, "
                         f"got {perm.shape[0]}")
    if cols.shape != data.shape or data.shape[0] % c:
        raise ValueError(f"cols {tuple(cols.shape)} and data {tuple(data.shape)} must "
                         f"match and hold whole planes of c={c}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be 1-D and contiguous")
    if x.shape[0] >= 2 ** 31:
        raise ValueError("x longer than int32 column indices can address")
    if x.dtype not in DTYPES or data.dtype != x.dtype:
        raise ValueError(f"data and x must share dtype float32 or bfloat16, "
                         f"got {data.dtype} and {x.dtype}")


def sell_spmv(slice_ptrs: torch.Tensor, cols: torch.Tensor, data: torch.Tensor,
              perm: torch.Tensor, x: torch.Tensor, m: int, c: int) -> torch.Tensor:
    """y = A @ x for SELL-C-sigma A given as flat (slice_ptrs, cols, data,
    perm) with slice height ``c``. f32 accumulation; y in x's dtype."""
    global launches
    if x.device.type == "cpu":
        return sell_spmv_ref(slice_ptrs, cols, data, perm, x, m, c)
    if x.device.type != "cuda":
        raise ValueError(f"sell_spmv runs on cuda or cpu tensors, got {x.device}")
    _check(slice_ptrs, cols, data, perm, x, m, c)
    n = x.shape[0]
    if m == 0 or n == 0:  # nothing to launch: every row (if any) sums nothing
        return torch.zeros((m,), dtype=x.dtype, device=x.device)
    y = torch.empty((m,), dtype=x.dtype, device=x.device)
    fn, err_str = _fn(x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(slice_ptrs.data_ptr(), cols.data_ptr(), data.data_ptr(), perm.data_ptr(),
             x.data_ptr(), y.data_ptr(), perm.shape[0], c, m, n, x.device.index, stream)
    if err:
        raise RuntimeError(f"sell_spmv launch failed: {err_str(err).decode()} ({err})")
    launches += 1
    return y
