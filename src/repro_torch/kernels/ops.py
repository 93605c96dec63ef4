"""Bind the hand-written CUDA kernels to the core containers.

``SPMV_CUDA``, ``SPMM_CUDA`` and ``SPMM_T_CUDA`` map a container type to
its kernel entry point for SpMV, SpMM (Y = A @ B) and SpMM_T (Y = X @ A^T),
which launch with the geometry :func:`default_config` /
:func:`spmm_t_config` picks for the container.

Unlike the JAX package, there are no residency fallbacks here: the TPU
wrappers send a matrix whose x exceeds a VMEM budget to the reference path,
a TPU limit with no Hopper counterpart. A CUDA tensor runs its kernel or the
call raises; nothing falls back to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import BSR, COO, CSR, DIA, ELL, HYB, SELL
from repro_torch.kernels import bsr_spmm as _bsr
from repro_torch.kernels import csr_spmm as _csr_mm
from repro_torch.kernels import csr_spmv as _csr
from repro_torch.kernels import dia_spmv as _dia
from repro_torch.kernels import ell_spmm as _ell_mm
from repro_torch.kernels import ell_spmv as _ell
from repro_torch.kernels import sell_spmm as _sell_mm
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


def spmm_t_config(A) -> dict:
    """Launch geometry of ``A``'s SpMM_T kernel: ``vec`` lanes a row for the
    row-walking CSR and ELL kernels, as for CSR SpMV (ELL from its K). HYB:
    ``{"ell": ..., "csr": ...}``, the CSR width from the tail's average row.
    SELL takes no launch knob: ``{}``. The token tile follows T in each
    kernel's wrapper (``csr_spmm.token_tile``)."""
    if isinstance(A, CSR):
        return {"vec": _csr_vec(A.nnz, A.shape[0])}
    if isinstance(A, ELL):
        return {"vec": _pow2_clamp(A.k / CSR_ENTRIES_PER_LANE, 2, 32)}
    if isinstance(A, HYB):
        return {"ell": spmm_t_config(A.ell), "csr": {"vec": _csr_vec(A.coo.nnz, A.shape[0])}}
    return {}


def csr_spmm(A: CSR, B: torch.Tensor) -> torch.Tensor:
    return _csr_mm.csr_spmm(A.indptr, A.indices, A.data, B, A.shape[0],
                            vec=default_config(A)["vec"])


def csr_spmm_t(A: CSR, X: torch.Tensor) -> torch.Tensor:
    return _csr_mm.csr_spmm_t(A.indptr, A.indices, A.data, X, A.shape[0],
                              **spmm_t_config(A))


def ell_spmm_t(A: ELL, X: torch.Tensor) -> torch.Tensor:
    return _ell_mm.ell_spmm_t(A.cols, A.data, X, **spmm_t_config(A))


def sell_spmm_t(A: SELL, X: torch.Tensor) -> torch.Tensor:
    return _sell_mm.sell_spmm_t(A.slice_ptrs, A.cols, A.data, A.perm, X, A.shape[0], A.c)


def hyb_spmm_t(A: HYB, X: torch.Tensor) -> torch.Tensor:
    """The ELL SpMM_T kernel over the regular planes plus the CSR SpMM_T
    kernel over the COO tail, as the JAX package composes them."""
    indptr, indices, data = tail_csr(A.coo, A.shape[0])
    tail = _csr_mm.csr_spmm_t(indptr, indices, data, X, A.shape[0], **spmm_t_config(A)["csr"])
    return ell_spmm_t(A.ell, X) + tail


def bsr_spmm_t(A: BSR, X: torch.Tensor) -> torch.Tensor:
    """BSR has no transposed-rhs kernel: the (N, K) kernel on X^T, as the
    JAX package does."""
    return bsr_spmm(A, X.T.contiguous()).T


SPMV_CUDA = {CSR: csr_spmv, DIA: dia_spmv, ELL: ell_spmv, SELL: sell_spmv,
             HYB: hyb_spmv, BSR: bsr_spmv}
SPMM_CUDA = {BSR: bsr_spmm, CSR: csr_spmm}
SPMM_T_CUDA = {CSR: csr_spmm_t, ELL: ell_spmm_t, HYB: hyb_spmm_t, SELL: sell_spmm_t,
               BSR: bsr_spmm_t}
# Formats with a Pallas SpMM kernel in the JAX package that the port has
# not ported yet: on the card their SpMM raises instead of running the
# reference under a kernel's name.
SPMM_PENDING = (ELL, SELL, HYB)
_SPMM_PENDING_WHY = ("ELL/SELL/HYB SpMM (Y = A @ B) kernels are ROADMAP Queue 2 rows 8 and 10 "
                     "(ell_spmm, sell_spmm; hyb_spmm composes them), not ported yet")


def spmm_cuda_route(A):
    """The SpMM kernel entry point for ``A`` on the card: its kernel, None
    where the JAX package has no kernel either (COO, DIA, Dense: the
    reference runs), or ``NotImplementedError`` for a kernel still to be
    ported."""
    if isinstance(A, SPMM_PENDING):
        raise NotImplementedError(f"{type(A).__name__}: {_SPMM_PENDING_WHY}")
    return SPMM_CUDA.get(type(A))


def cuda_registry(op: str) -> dict:
    """The kernel registry of ``op`` ("spmv" | "spmm" | "spmm_t")."""
    return {"spmv": SPMV_CUDA, "spmm": SPMM_CUDA, "spmm_t": SPMM_T_CUDA}[op]


# The kernel modules, by library (source) name.
KERNELS = {m.NAME: m for m in (_dia, _csr, _ell, _sell, _bsr, _csr_mm, _ell_mm, _sell_mm)}
# Kernel name (the Pallas function it replaces) -> (module, its launch count).
LAUNCH_COUNTERS = {
    "dia_spmv": (_dia, "launches"), "csr_spmv": (_csr, "launches"),
    "ell_spmv": (_ell, "launches"), "sell_spmv": (_sell, "launches"),
    "bsr_spmm": (_bsr, "launches"), "csr_spmm": (_csr_mm, "launches"),
    "csr_spmm_t": (_csr_mm, "launches_t"), "ell_spmm_t": (_ell_mm, "launches"),
    "sell_spmm_t": (_sell_mm, "launches"),
}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for mod, attr in LAUNCH_COUNTERS.values():
        setattr(mod, attr, 0)


def launch_counts() -> dict:
    """Kernel name -> launches since the last reset."""
    return {name: getattr(mod, attr) for name, (mod, attr) in LAUNCH_COUNTERS.items()}
