"""Bind the hand-written CUDA kernels to the core containers.

``SPMV_CUDA``, ``SPMM_CUDA`` and ``SPMM_T_CUDA`` map a container type to
its kernel entry point for SpMV, SpMM (Y = A @ B) and SpMM_T (Y = X @ A^T).
Every entry point takes ``cfg=``, a dict of launch knobs: an explicit
``cfg`` wins, then the measured winner that ``repro_torch.tuning.kernel_tune``
cached for the matrix's shape bucket (and rhs-width bucket), then
:func:`default_config`'s choice (:func:`resolve_config`). The knobs are the
ones the kernels take: DIA ``block``; CSR and ELL ``vec`` (lanes a row);
``tt`` (tokens a block) of every SpMM_T kernel; ``xt`` of the CSR, ELL and
SELL SpMM_T kernels (HYB's two parts too) and of the CSR, ELL and SELL SpMM
kernels (HYB's ELL part), which picks their schedule: absent or 0 the row
(SELL: slice) schedule, 32, 64 or 128 the token-major one with that many
tokens (columns of B) a block; ``tc`` of the CSR and SELL SpMM kernels,
128: the dense-tile schedule on the tensor cores, strips of that many
columns of B (a cfg gives at most one of ``xt`` and ``tc``). SELL's
``c``/``sigma`` name a container geometry: the tuner rebuilds the container to time them,
and no launch reads them. ``repro_torch.core.ops.spmv(backend="auto")``
threads a measured winner here.

Unlike the JAX package, there are no residency fallbacks here: the TPU
wrappers send a matrix whose x exceeds a VMEM budget to the reference path,
a TPU limit with no Hopper counterpart. A CUDA tensor runs its kernel or the
call raises; nothing falls back to the plain version.
"""
from __future__ import annotations

import weakref
from typing import Optional

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


def _ell_vec(k: int) -> int:
    return _pow2_clamp(k / CSR_ENTRIES_PER_LANE, 2, 32)


# SELL's token-major SpMM_T repacks the slices row-major on every call: on
# an H100 at the minitron-8b MLP shapes (f32; chip_smoke.py's width sweep,
# PERF.md) it lost to the slice kernel at T = 32 on both weights and won
# from T = 64.
SELL_XT_FROM = 64
# Y = A @ B of CSR and SELL on the token-major schedule stages all of B for
# every 128 rows, whatever the density nnz / (M * N): on an H100 at the
# up weight's shape (chip_smoke.py's sweeps, PERF.md) it won from width 32
# (SELL lost at 16) at densities 0.25 and 0.05 and lost 2x to the row
# schedule at 0.01, in float32 and bfloat16.
AB_XT_MIN_DENSITY = 0.03
# The dense-tile schedule (``tc``) multiplies every slot of each 64 x 64
# tile of A. At the up weight's shape and width 256 it beat the token-major
# one only in bfloat16 at density 0.25 (both the CSR and the SELL kernel),
# lost 3x at 0.05, and lost in float32 (three tensor products a slot) and on
# the down weight (64 row tiles: a block walks all of N, so a short matrix
# leaves multiprocessors idle); in bfloat16 it won from width 128 (lost at
# 64). So: from TC_FROM columns, above the density of the dtype (None:
# never), on TC_MIN_ROW_TILES 64-row tiles.
TC_FROM = 128
TC_MIN_DENSITY = {torch.float32: None, torch.bfloat16: 0.2}
TC_MIN_ROW_TILES = 132  # one a multiprocessor of an H100


def default_config(A, op: str = "spmv", ncols: Optional[int] = None) -> dict:
    """The untuned launch knobs of ``A``'s kernel for ``op`` ("spmv" |
    "spmm" | "spmm_t") at rhs width ``ncols`` (K of B, or T of X).

    DIA: ``block`` threads per block, one row per thread. CSR: ``vec``
    lanes a row, the smallest power of two with at most
    ``CSR_ENTRIES_PER_LANE`` entries of an average row per lane, clamped to
    [2, 32]; ELL's SpMM kernels the same from its K (its SpMV kernel takes
    no knob). SpMM_T adds ``tt``, ``csr_spmm.token_tile`` of T, and for CSR
    and ELL ``xt``, ``csr_spmm.xt_tile`` of T where that is not 0 (the
    token-major schedule from T = 32; SELL's from ``SELL_XT_FROM``); ELL's
    SpMM adds ``xt`` of Kb alike, CSR's and SELL's too at a density of at
    least ``AB_XT_MIN_DENSITY`` unless they take ``tc`` (:func:`tc_tile`).
    HYB: ``{"ell": ..., "csr": ...}``, the CSR part from the tail's average
    row (its SpMM takes neither ``xt`` nor ``tc``). SELL (but for ``tt``,
    ``xt`` and ``tc``) and BSR take no launch knob: ``{}``.
    """
    if isinstance(A, DIA):
        return {"block": 256}
    if isinstance(A, HYB):
        csr = {"vec": _csr_vec(A.coo.nnz, A.shape[0])}
        if op == "spmm_t":
            csr["tt"] = _csr_mm.token_tile(ncols or 1)
            _add_xt(csr, ncols)
        return {"ell": default_config(A.ell, op=op, ncols=ncols), "csr": csr}
    if isinstance(A, CSR):
        cfg = {"vec": _csr_vec(A.nnz, A.shape[0])}
    elif isinstance(A, ELL):
        cfg = {} if op == "spmv" else {"vec": _ell_vec(A.k)}
    elif isinstance(A, SELL):
        cfg = {}
    else:
        return {}
    if op == "spmm_t":
        cfg["tt"] = _csr_mm.token_tile(ncols or 1)
        if not isinstance(A, SELL) or (ncols or 1) >= SELL_XT_FROM:
            _add_xt(cfg, ncols)
    elif op == "spmm" and isinstance(A, ELL):
        _add_xt(cfg, ncols)
    elif op == "spmm":
        tc = tc_tile(A, ncols)
        if tc:
            cfg["tc"] = tc
        elif A.nnz >= AB_XT_MIN_DENSITY * A.shape[0] * A.shape[1]:
            _add_xt(cfg, ncols)
    return cfg


def tc_tile(A, ncols: Optional[int]) -> int:
    """The ``tc`` knob of CSR or SELL Y = A @ B at width ``ncols``: 128 from
    ``TC_FROM`` columns, at ``TC_MIN_DENSITY`` of A's dtype and
    ``TC_MIN_ROW_TILES`` 64-row tiles; else 0. Host ints only: no device
    access."""
    m, n = A.shape
    least = TC_MIN_DENSITY.get(A.dtype)
    if ((ncols or 1) < TC_FROM or least is None or A.nnz < least * m * n
            or -(-m // 64) < TC_MIN_ROW_TILES):
        return 0
    return 128


def _add_xt(cfg: dict, ncols: Optional[int]) -> None:
    xt = _csr_mm.xt_tile(ncols or 1)
    if xt:
        cfg["xt"] = xt


def _xt(cfg: Optional[dict], key: str = "xt") -> int:
    """``cfg``'s schedule knob ``key`` ("xt" or "tc"): absent (a cfg or
    record from before that schedule) is 0, the row schedule."""
    return int((cfg or {}).get(key) or 0)


_best_config = None  # repro_torch.tuning.kernel_tune.best_config


def resolve_config(A, cfg: Optional[dict], op: str = "spmv",
                   ncols: Optional[int] = None) -> dict:
    """The launch knobs a wrapper runs with: an explicit ``cfg`` wins;
    otherwise the tuned winner cached for ``A``'s shape bucket (and rhs
    width bucket; a host dict lookup, no device work); otherwise
    :func:`default_config`. Consulting the tuned records here, and not only
    on the ``"auto"`` route, gives ``backend=None``/``"cuda"`` callers the
    measured geometry too; whether the kernel runs never depends on it."""
    global _best_config
    if cfg is not None:
        return cfg
    if _best_config is None:  # bound at first use: tuning imports kernels
        from repro_torch.tuning.kernel_tune import best_config as _best_config
    rec = _best_config(A, op=op, ncols=ncols)
    if rec is not None:
        return dict(rec.cfg)
    return default_config(A, op=op, ncols=ncols)


def _pick(cfg: dict, key: str, A, op: str = "spmv", ncols: Optional[int] = None) -> int:
    """``cfg[key]``, else :func:`default_config`'s (a record tuned before a
    knob existed still launches)."""
    v = cfg.get(key)
    return int(v if v is not None else default_config(A, op=op, ncols=ncols)[key])


def dia_spmv(A: DIA, x: torch.Tensor, cfg: Optional[dict] = None) -> torch.Tensor:
    cfg = resolve_config(A, cfg)
    return _dia.dia_spmv(A.offsets, A.data, x, A.shape[1], block=_pick(cfg, "block", A))


# The CSR kernel's long-row plan of each container, by ``vec``, made at the
# container's first SpMV at that width. Containers are immutable (new values
# make a new container; the plan reads only indptr), so the plan holds for
# the container's life; the entry goes with it.
_CSR_PLANS: "weakref.WeakKeyDictionary[CSR, dict]" = weakref.WeakKeyDictionary()


def csr_plan(A: CSR, vec: int) -> "_csr.LongRowPlan":
    """``A``'s cached :func:`~repro_torch.kernels.csr_spmv.long_row_plan` at
    ``vec`` lanes a short row (built on A's device, no host sync)."""
    plans = _CSR_PLANS.setdefault(A, {})
    plan = plans.get(vec)
    if plan is None:
        plan = plans[vec] = _csr.long_row_plan(A.indptr, A.capacity, vec)
    return plan


def csr_spmv(A: CSR, x: torch.Tensor, cfg: Optional[dict] = None) -> torch.Tensor:
    cfg = resolve_config(A, cfg)
    vec = _pick(cfg, "vec", A)
    return _csr.csr_spmv(A.indptr, A.indices, A.data, x, A.shape[0], vec=vec,
                         plan=csr_plan(A, vec))


def ell_spmv(A: ELL, x: torch.Tensor, cfg: Optional[dict] = None) -> torch.Tensor:
    """No launch knob: ``cfg`` is taken for a uniform signature."""
    return _ell.ell_spmv(A.cols, A.data, x)


def sell_spmv(A: SELL, x: torch.Tensor, cfg: Optional[dict] = None) -> torch.Tensor:
    """No launch knob (``cfg``'s ``c``/``sigma`` name the container)."""
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


def _hyb_tail_knob(A: HYB, cfg: dict, key: str, op: str, ncols: Optional[int]) -> int:
    v = (cfg.get("csr") or {}).get(key)
    return int(v if v is not None else default_config(A, op=op, ncols=ncols)["csr"][key])


def hyb_spmv(A: HYB, x: torch.Tensor, cfg: Optional[dict] = None) -> torch.Tensor:
    """The ELL kernel over the regular planes plus the CSR kernel over the
    COO tail, as the JAX package composes them."""
    cfg = resolve_config(A, cfg)
    indptr, indices, data = tail_csr(A.coo, A.shape[0])
    # the tail is sorted anew every call, and its long-row plan built with it
    tail = _csr.csr_spmv(indptr, indices, data, x, A.shape[0],
                         vec=_hyb_tail_knob(A, cfg, "vec", "spmv", None))
    return ell_spmv(A.ell, x) + tail


def bsr_spmm(A: BSR, B: torch.Tensor, cfg: Optional[dict] = None) -> torch.Tensor:
    """No launch knob: ``cfg`` is taken for a uniform signature."""
    return _bsr.bsr_spmm(A.indptr, A.indices, A.data, B, A.shape[0])


def bsr_spmv(A: BSR, x: torch.Tensor, cfg: Optional[dict] = None) -> torch.Tensor:
    return bsr_spmm(A, x[:, None])[:, 0]


def csr_spmm(A: CSR, B: torch.Tensor, cfg: Optional[dict] = None) -> torch.Tensor:
    k = B.shape[1]
    cfg = resolve_config(A, cfg, "spmm", k)
    return _csr_mm.csr_spmm(A.indptr, A.indices, A.data, B, A.shape[0],
                            vec=_pick(cfg, "vec", A, "spmm", k), xt=_xt(cfg),
                            tc=_xt(cfg, "tc"))


def ell_spmm(A: ELL, B: torch.Tensor, cfg: Optional[dict] = None) -> torch.Tensor:
    k = B.shape[1]
    cfg = resolve_config(A, cfg, "spmm", k)
    return _ell_mm.ell_spmm(A.cols, A.data, B, vec=_pick(cfg, "vec", A, "spmm", k),
                            xt=_xt(cfg))


def sell_spmm(A: SELL, B: torch.Tensor, cfg: Optional[dict] = None) -> torch.Tensor:
    """Launch knobs ``xt`` and ``tc`` (``cfg``'s ``c``/``sigma`` name the
    container)."""
    cfg = resolve_config(A, cfg, "spmm", B.shape[1])
    return _sell_mm.sell_spmm(A.slice_ptrs, A.cols, A.data, A.perm, B, A.shape[0], A.c,
                              xt=_xt(cfg), tc=_xt(cfg, "tc"))


def hyb_spmm(A: HYB, B: torch.Tensor, cfg: Optional[dict] = None) -> torch.Tensor:
    """The ELL SpMM kernel over the regular planes plus the CSR SpMM kernel
    over the COO tail, as the JAX package composes them."""
    k = B.shape[1]
    cfg = resolve_config(A, cfg, "spmm", k)
    indptr, indices, data = tail_csr(A.coo, A.shape[0])
    tail = _csr_mm.csr_spmm(indptr, indices, data, B, A.shape[0],
                            vec=_hyb_tail_knob(A, cfg, "vec", "spmm", k))
    return ell_spmm(A.ell, B, cfg=cfg.get("ell")) + tail


def csr_spmm_t(A: CSR, X: torch.Tensor, cfg: Optional[dict] = None) -> torch.Tensor:
    t = X.shape[0]
    cfg = resolve_config(A, cfg, "spmm_t", t)
    return _csr_mm.csr_spmm_t(A.indptr, A.indices, A.data, X, A.shape[0],
                              vec=_pick(cfg, "vec", A, "spmm_t", t),
                              tt=_pick(cfg, "tt", A, "spmm_t", t), xt=_xt(cfg))


def ell_spmm_t(A: ELL, X: torch.Tensor, cfg: Optional[dict] = None) -> torch.Tensor:
    t = X.shape[0]
    cfg = resolve_config(A, cfg, "spmm_t", t)
    return _ell_mm.ell_spmm_t(A.cols, A.data, X, vec=_pick(cfg, "vec", A, "spmm_t", t),
                              tt=_pick(cfg, "tt", A, "spmm_t", t), xt=_xt(cfg))


def sell_spmm_t(A: SELL, X: torch.Tensor, cfg: Optional[dict] = None) -> torch.Tensor:
    t = X.shape[0]
    cfg = resolve_config(A, cfg, "spmm_t", t)
    return _sell_mm.sell_spmm_t(A.slice_ptrs, A.cols, A.data, A.perm, X, A.shape[0], A.c,
                                tt=_pick(cfg, "tt", A, "spmm_t", t), xt=_xt(cfg))


def hyb_spmm_t(A: HYB, X: torch.Tensor, cfg: Optional[dict] = None) -> torch.Tensor:
    """The ELL SpMM_T kernel over the regular planes plus the CSR SpMM_T
    kernel over the COO tail, as the JAX package composes them."""
    t = X.shape[0]
    cfg = resolve_config(A, cfg, "spmm_t", t)
    indptr, indices, data = tail_csr(A.coo, A.shape[0])
    tail = _csr_mm.csr_spmm_t(indptr, indices, data, X, A.shape[0],
                              vec=_hyb_tail_knob(A, cfg, "vec", "spmm_t", t),
                              tt=_hyb_tail_knob(A, cfg, "tt", "spmm_t", t),
                              xt=_xt(cfg.get("csr")))
    return ell_spmm_t(A.ell, X, cfg=cfg.get("ell")) + tail


def bsr_spmm_t(A: BSR, X: torch.Tensor, cfg: Optional[dict] = None) -> torch.Tensor:
    """BSR has no transposed-rhs kernel: the (N, K) kernel on X^T, as the
    JAX package does."""
    return bsr_spmm(A, X.T.contiguous()).T


SPMV_CUDA = {CSR: csr_spmv, DIA: dia_spmv, ELL: ell_spmv, SELL: sell_spmv,
             HYB: hyb_spmv, BSR: bsr_spmv}
SPMM_CUDA = {BSR: bsr_spmm, CSR: csr_spmm, ELL: ell_spmm, HYB: hyb_spmm, SELL: sell_spmm}
SPMM_T_CUDA = {CSR: csr_spmm_t, ELL: ell_spmm_t, HYB: hyb_spmm_t, SELL: sell_spmm_t,
               BSR: bsr_spmm_t}


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
    "csr_spmm_t": (_csr_mm, "launches_t"), "ell_spmm": (_ell_mm, "launches"),
    "ell_spmm_t": (_ell_mm, "launches_t"), "sell_spmm": (_sell_mm, "launches"),
    "sell_spmm_t": (_sell_mm, "launches_t"),
}


# "kernel:schedule" -> (module, its count): the launches of each kernel on
# its token-major (xt) and dense-tile (tc) schedules, counted apart as well.
SCHEDULE_COUNTERS = {
    "csr_spmm_t:xt": (_csr_mm, "launches_xt"), "ell_spmm_t:xt": (_ell_mm, "launches_xt"),
    "sell_spmm_t:xt": (_sell_mm, "launches_xt"), "ell_spmm:xt": (_ell_mm, "launches_kxt"),
    "csr_spmm:xt": (_csr_mm, "launches_kxt"), "csr_spmm:tc": (_csr_mm, "launches_tc"),
    "sell_spmm:xt": (_sell_mm, "launches_kxt"), "sell_spmm:tc": (_sell_mm, "launches_tc"),
}


def reset_launches() -> None:
    """Set every kernel's launch count, and every schedule's, to 0."""
    for mod, attr in (*LAUNCH_COUNTERS.values(), *SCHEDULE_COUNTERS.values()):
        setattr(mod, attr, 0)


def schedule_counts() -> dict:
    """"kernel:schedule" -> launches on that schedule since the last reset."""
    return {name: getattr(mod, attr) for name, (mod, attr) in SCHEDULE_COUNTERS.items()}


def launch_counts() -> dict:
    """Kernel name -> launches since the last reset."""
    return {name: getattr(mod, attr) for name, (mod, attr) in LAUNCH_COUNTERS.items()}
