"""Bind the hand-written CUDA kernels to the core containers.

``SPMV_CUDA`` maps a container type to its kernel entry point, which
launches with the geometry :func:`default_config` picks for the container.

Unlike the JAX package, there are no residency fallbacks here: the TPU
wrappers send a matrix whose x exceeds a VMEM budget to the reference path,
a TPU limit with no Hopper counterpart. A CUDA tensor runs its kernel or the
call raises; nothing falls back to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import CSR, DIA
from repro_torch.kernels import csr_spmv as _csr
from repro_torch.kernels import dia_spmv as _dia


def _pow2_clamp(v: float, lo: int, hi: int) -> int:
    """Smallest power of two >= v, clamped into [lo, hi]."""
    p = 1
    while p < v:
        p *= 2
    return int(min(max(p, lo), hi))


# Row entries each CSR lane sums: on an H100 at HPCG 104^3 (27.5 entries a
# row) 4 lanes a row ran 0.101 ms against 0.212 ms for a full warp
# (chip_smoke.py's launch-geometry sweep; PERF.md).
CSR_ENTRIES_PER_LANE = 8


def default_config(A) -> dict:
    """Launch geometry for ``A``'s kernel.

    DIA: ``block`` threads per block, one row per thread. CSR: ``vec``
    lanes per row, the smallest power of two with at most
    ``CSR_ENTRIES_PER_LANE`` entries of an average row per lane, clamped to
    [2, 32] (the block is fixed at 256 threads in ``csrc/csr_spmv.cu``).
    """
    if isinstance(A, DIA):
        return {"block": 256}
    if isinstance(A, CSR):
        avg = max(1, int(A.nnz)) / max(1, A.shape[0])
        return {"vec": _pow2_clamp(avg / CSR_ENTRIES_PER_LANE, 2, 32)}
    return {}


def dia_spmv(A: DIA, x: torch.Tensor) -> torch.Tensor:
    return _dia.dia_spmv(A.offsets, A.data, x, A.shape[1],
                         block=default_config(A)["block"])


def csr_spmv(A: CSR, x: torch.Tensor) -> torch.Tensor:
    return _csr.csr_spmv(A.indptr, A.indices, A.data, x, A.shape[0],
                         vec=default_config(A)["vec"])


SPMV_CUDA = {CSR: csr_spmv, DIA: dia_spmv}

# The kernel modules, by kernel name, for launch counting.
KERNELS = {_dia.NAME: _dia, _csr.NAME: _csr}


def reset_launches() -> None:
    """Set every kernel's ``launches`` count to 0."""
    for mod in KERNELS.values():
        mod.launches = 0


def launch_counts() -> dict:
    """Kernel name -> ``launches`` since the last reset."""
    return {name: mod.launches for name, mod in KERNELS.items()}
