"""Block-CSR SpMM: wrapper of the hand-written CUDA kernel ``csrc/bsr_spmm.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/bsr_spmm.py::bsr_spmm``. On a
CUDA tensor the wrapper launches the kernel (or raises); on a CPU tensor it
runs the plain version, ``repro_torch.kernels.ref.bsr_spmm_ref``. Unlike the
JAX wrapper it needs no per-block row array and no host look at
``indptr``: the kernel walks each block row itself, and an empty block row
writes zeros. ``launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bsr_spmm_ref

NAME = "bsr_spmm"
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
             ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    return _build.entry_point(NAME, f"{NAME}_{DTYPES[dtype]}", _ARGTYPES)


def _check(indptr, indices, blocks, B, m):
    dev = B.device
    for name, t in (("indptr", indptr), ("indices", indices), ("blocks", blocks)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, B on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if indptr.dtype != torch.int32 or indices.dtype != torch.int32:
        raise ValueError(f"indptr/indices must be int32, got {indptr.dtype}/{indices.dtype}")
    if blocks.dim() != 3 or blocks.shape[1] != blocks.shape[2] or blocks.shape[1] == 0:
        raise ValueError(f"blocks must be (nblk, bs, bs), got {tuple(blocks.shape)}")
    bs = blocks.shape[1]
    if indices.dim() != 1 or indices.shape[0] != blocks.shape[0]:
        raise ValueError(f"indices must hold one block column per block "
                         f"({blocks.shape[0]}), got {tuple(indices.shape)}")
    if m % bs or indptr.dim() != 1 or indptr.shape[0] != m // bs + 1:
        raise ValueError(f"indptr must have m/bs+1={m // bs + 1} entries (m={m}, bs={bs}), "
                         f"got {tuple(indptr.shape)}")
    if B.dim() != 2 or not B.is_contiguous() or B.shape[0] % bs:
        raise ValueError(f"B must be 2-D (N, K), contiguous, N a multiple of bs={bs}; "
                         f"got {tuple(B.shape)}")
    if B.dtype not in DTYPES or blocks.dtype != B.dtype:
        raise ValueError(f"blocks and B must share dtype float32 or bfloat16, "
                         f"got {blocks.dtype} and {B.dtype}")


def bsr_spmm(indptr: torch.Tensor, indices: torch.Tensor, blocks: torch.Tensor,
             B: torch.Tensor, m: int) -> torch.Tensor:
    """Y = A @ B for block-CSR A given as (indptr[m/bs+1], indices[nblk],
    blocks[nblk, bs, bs]); B is (N, K). f32 accumulation; Y in B's dtype."""
    global launches
    if B.device.type == "cpu":
        return bsr_spmm_ref(indptr, indices, blocks, B, m)
    if B.device.type != "cuda":
        raise ValueError(f"bsr_spmm runs on cuda or cpu tensors, got {B.device}")
    _check(indptr, indices, blocks, B, m)
    bs = blocks.shape[1]
    n, k = B.shape
    if m == 0 or k == 0 or n == 0:  # nothing to launch: every output sums nothing
        return torch.zeros((m, k), dtype=B.dtype, device=B.device)
    y = torch.empty((m, k), dtype=B.dtype, device=B.device)
    fn, err_str = _fn(B.dtype)
    stream = torch.cuda.current_stream(B.device).cuda_stream
    err = fn(indptr.data_ptr(), indices.data_ptr(), blocks.data_ptr(), B.data_ptr(),
             y.data_ptr(), m, k, bs, n // bs, B.device.index, stream)
    if err:
        raise RuntimeError(f"bsr_spmm launch failed: {err_str(err).decode()} ({err})")
    launches += 1
    return y
