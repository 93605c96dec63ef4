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

from repro_torch.core.formats import BSR, COO, CSR, DIA, ELL, HYB, SELL
from repro_torch.kernels import bsr_spmm as _bsr
from repro_torch.kernels import csr_spmv as _csr
from repro_torch.kernels import dia_spmv as _dia
from repro_torch.kernels import ell_spmv as _ell
from repro_torch.kernels import sell_spmv as _sell


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


def _csr_vec(nnz: int, m: int) -> int:
    avg = max(1, int(nnz)) / max(1, m)
    return _pow2_clamp(avg / CSR_ENTRIES_PER_LANE, 2, 32)


def default_config(A) -> dict:
    """Launch geometry for ``A``'s kernel.

    DIA: ``block`` threads per block, one row per thread. CSR: ``vec``
    lanes per row, the smallest power of two with at most
    ``CSR_ENTRIES_PER_LANE`` entries of an average row per lane, clamped to
    [2, 32] (the block is fixed at 256 threads in ``csrc/csr_spmv.cu``).
    HYB: ``{"ell": ..., "csr": {"vec": ...}}``, the CSR width from the
    tail's average row. ELL, SELL and BSR take no launch knob (their tiles
    are constants of their sources): ``{}``.
    """
    if isinstance(A, DIA):
        return {"block": 256}
    if isinstance(A, CSR):
        return {"vec": _csr_vec(A.nnz, A.shape[0])}
    if isinstance(A, HYB):
        return {"ell": default_config(A.ell), "csr": {"vec": _csr_vec(A.coo.nnz, A.shape[0])}}
    return {}


def dia_spmv(A: DIA, x: torch.Tensor) -> torch.Tensor:
    return _dia.dia_spmv(A.offsets, A.data, x, A.shape[1],
                         block=default_config(A)["block"])


def csr_spmv(A: CSR, x: torch.Tensor) -> torch.Tensor:
    return _csr.csr_spmv(A.indptr, A.indices, A.data, x, A.shape[0],
                         vec=default_config(A)["vec"])


def ell_spmv(A: ELL, x: torch.Tensor) -> torch.Tensor:
    return _ell.ell_spmv(A.cols, A.data, x)


def sell_spmv(A: SELL, x: torch.Tensor) -> torch.Tensor:
    return _sell.sell_spmv(A.slice_ptrs, A.cols, A.data, A.perm, x, A.shape[0], A.c)


def tail_csr(coo: COO, m: int):
    """The HYB overflow as CSR ``(indptr, indices, data)``, built on the
    device with no device->host sync: a stable sort by row, then row
    pointers by ``searchsorted`` over the sorted row ids (a CUDA
    ``bincount`` would read its maximum back to the host). Entries with a
    row id outside [0, m) fall outside ``indptr[0]..indptr[m]`` and are
    never read."""
    rows, order = torch.sort(coo.row, stable=True)
    bounds = torch.arange(m + 1, dtype=rows.dtype, device=rows.device)
    indptr = torch.searchsorted(rows, bounds, out_int32=True)
    return indptr, coo.col.index_select(0, order), coo.data.index_select(0, order)


def hyb_spmv(A: HYB, x: torch.Tensor) -> torch.Tensor:
    """The ELL kernel over the regular planes plus the CSR kernel over the
    COO tail, as the JAX package composes them."""
    indptr, indices, data = tail_csr(A.coo, A.shape[0])
    tail = _csr.csr_spmv(indptr, indices, data, x, A.shape[0],
                         vec=default_config(A)["csr"]["vec"])
    return ell_spmv(A.ell, x) + tail


def bsr_spmm(A: BSR, B: torch.Tensor) -> torch.Tensor:
    return _bsr.bsr_spmm(A.indptr, A.indices, A.data, B, A.shape[0])


def bsr_spmv(A: BSR, x: torch.Tensor) -> torch.Tensor:
    return bsr_spmm(A, x[:, None])[:, 0]


SPMV_CUDA = {CSR: csr_spmv, DIA: dia_spmv, ELL: ell_spmv, SELL: sell_spmv,
             HYB: hyb_spmv, BSR: bsr_spmv}

# The kernel modules, by kernel name, for launch counting.
KERNELS = {m.NAME: m for m in (_dia, _csr, _ell, _sell, _bsr)}


def reset_launches() -> None:
    """Set every kernel's ``launches`` count to 0."""
    for mod in KERNELS.values():
        mod.launches = 0


def launch_counts() -> dict:
    """Kernel name -> ``launches`` since the last reset."""
    return {name: mod.launches for name, mod in KERNELS.items()}
