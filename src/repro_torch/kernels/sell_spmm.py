"""SELL-C-sigma SpMM: wrappers of the hand-written CUDA kernels ``csrc/sell_spmm.cu``.

Two kernels in one source: ``sell_spmm`` (Y = A @ B, B (N, Kb)) replaces the
Pallas TPU kernel ``repro/kernels/sell_spmv.py::sell_spmm``, and
``sell_spmm_t`` (Y = X @ A^T, X (T, N)) replaces
``repro/kernels/sell_spmv.py::sell_spmm_t``. On a CUDA tensor each wrapper
launches its kernel (or raises); on a CPU tensor it runs the plain version,
``repro_torch.kernels.ref.sell_spmm_ref`` / ``sell_spmm_t_ref``. The kernels
write each lane's sums straight to row (or column) ``perm[lane]`` of Y, so
``perm`` must be a permutation of the rows plus ghost lanes (``perm == M``),
as every SELL container is: every row is then written once and Y needs no
zero fill. Each kernel has its own count: ``launches`` (sell_spmm) and
``launches_t`` (sell_spmm_t), raised where the kernel launches and nowhere
else.

The slice schedule (``sell_spmm`` for Kb <= 8, ``sell_spmm_t`` at ``xt`` =
0) runs the launch :func:`slice_plan` decides from the shapes, the card's
SM count and its opt-in shared-memory limit: a block of 512 threads (1024
for C > 512) a slice, the rhs tile (``tt`` rows of X, or B as it lies)
staged in shared memory where it fits and pays, and slices too few to
fill the card split over a cluster of 2 or 4 blocks. ``last_plan`` holds
the plan of the last slice launch. ``sell_spmm_t`` takes the launch knob
``xt`` as ``csr_spmm.csr_spmm_t`` does: 0 the slice schedule, 32, 64 or 128
the token-major one (``spmm_common.cuh::tokens_spmm_t`` over the sorted
rows, the slices first repacked row-major into scratch); ``launches_xt``
counts the token-major launches among ``launches_t``. ``sell_spmm`` takes
``xt`` and ``tc`` as ``csr_spmm.csr_spmm`` does (at most one non-zero): 0
the slice (Kb <= 8) or row (wider) kernel, ``xt`` the token-major schedule
over the repacked slices with B in XT's place, ``tc`` the dense-tile
schedule over 64 of the repacked sorted rows a block; ``launches_kxt`` and
``launches_tc`` count those among ``launches``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.csr_spmm import (TOKEN_TILES, XT_MAX_ENTRIES, ab_scratch,
                                          check_ab_schedule, check_xt, token_tile, xt_scratch)
from repro_torch.kernels.ref import sell_spmm_ref, sell_spmm_t_ref

NAME = "sell_spmm"
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_C = 1024  # a slice's lanes share one block of at most 1024 threads
SLICE_MAX_TOKENS = 8  # Kb up to this runs the slice kernel; wider Kb the row kernel
launches = 0
launches_t = 0
launches_xt = 0  # of launches_t, those on the token-major schedule
launches_kxt = 0  # of launches, those on the token-major schedule
launches_tc = 0  # of launches, those on the dense-tile schedule
last_plan = None  # the SlicePlan of the last slice-schedule launch

_P, _I64, _I32, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int
_PLAN = [_INT, _INT, _INT, _I64]  # threads, stage, split, per
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I64, _I32, _I64, _I32, _I64] + _PLAN + [_INT, _P]
_ARGTYPES_T = [_P, _P, _P, _P, _P, _P, _I64, _I32, _I64, _I32, _I64, _INT] + _PLAN + [_INT, _P]
_ARGTYPES_XT = [_P] * 9 + [_I64, _I64, _I32, _I64, _I32, _I64, _INT, _INT, _P]


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    return _build.entry_point(NAME, f"sell_spmm_{DTYPES[dtype]}", _ARGTYPES)


# The slice kernel's launch (csrc/sell_spmm.cu): its shared memory holds the
# groups' partial sums, the block's sums and the staged rhs, each area
# rounded up to 16 bytes; each thread has UNROLL planes in flight (8 in
# bf16 at width 1), and a split's rank keeps at least one such trip a group.
UNROLL = 4
SPLITS = (1, 2, 4)  # blocks of a cluster that share a slice's planes
RESERVED_SMEM = 1024  # bytes the card keeps of an SM's shared memory a block
REGS_A_THREAD = 64  # the kernel's register cap (__launch_bounds__(1024))
REGS_AN_SM = 65536


@dataclasses.dataclass(frozen=True)
class SlicePlan:
    """The slice kernel's launch: ``threads`` a block, the rhs tile
    ``stage``d in shared memory or gathered through L1, ``split`` blocks
    (one cluster) that share a slice's planes, ``per`` slices a block (or
    cluster), ``blocks`` in the grid, ``smem`` bytes of shared memory a
    block and ``slots`` blocks resident on the card at once."""
    threads: int
    stage: bool
    split: int
    per: int
    blocks: int
    smem: int
    slots: int

    def describe(self) -> str:
        return (f"{'staged' if self.stage else 'L1-gathered'} rhs, split {self.split}, "
                f"{self.per} slice(s) a block, {self.blocks} blocks of {self.threads} "
                f"threads, {self.smem} B shared, {self.slots} resident")


def _round16(b: int) -> int:
    return -(-b // 16) * 16


@functools.lru_cache(maxsize=1024)
def slice_plan(nslices: int, c: int, planes: int, tt: int, rhs_bytes: int, tiles: int,
               weight_bytes: int, sms: int, optin: int, smem_per_sm: int) -> SlicePlan:
    """The slice kernel's launch for ``nslices`` slices of height ``c``
    holding ``planes`` planes in all (``weight_bytes`` of indices and
    values), ``tt`` rhs columns a block (the token tile, or Kb rounded up to
    a power of two), ``rhs_bytes`` of rhs a block stages (``tt`` rows of X,
    or B), ``tiles`` token tiles; on a card of ``sms`` SMs with ``optin``
    bytes of shared memory a block and ``smem_per_sm`` an SM. Host ints
    only, and cached (a call's host time counts at T = 1): the CPU tests
    pin it.

    - ``stage``: the rhs copied into shared memory where it fits ``optin``
      beside the sums, and its copies (one a block) cost no more bytes than
      the weight the blocks stream; else it is gathered through L1.
    - ``threads``: 512, so that two blocks share an SM at the kernel's
      register cap; 1024 where ``c`` > 512 (a block holds a slice's lanes)
      or where the staged rhs leaves room for one block an SM only.
    - ``split``: the smallest of ``SPLITS`` that gives every SM a block,
      where each rank keeps at least one full trip of its plane groups.
    - ``per``: slices a block when unsplit, about four blocks a resident
      slot (``spmm_common.cuh::split_rows``'s rule)."""
    def smem_of(threads, stage):
        sums = _round16(threads // c * c * tt * 4) + _round16(c * tt * 4)
        return sums + (rhs_bytes if stage else 0)

    def per_sm(threads, smem):
        return min(2048 // threads, REGS_AN_SM // (threads * REGS_A_THREAD),
                   smem_per_sm // (smem + RESERVED_SMEM))

    def layout(stage):
        threads = 512 if c <= 512 else 1024
        if per_sm(threads, smem_of(threads, stage)) < 2 and smem_of(1024, stage) <= optin:
            threads = 1024
        groups = threads // c
        smem = smem_of(threads, stage)
        slots = max(1, per_sm(threads, smem)) * sms
        units = nslices * tiles
        split = 1
        for s in SPLITS[1:]:
            if units * split >= sms or planes < nslices * s * groups * UNROLL:
                break
            split = s
        if split > 1:
            per = 1
        else:
            want = max(1, -(-4 * slots // tiles))
            per = -(-nslices // want)
        blocks = -(-nslices // per) * tiles * split
        return SlicePlan(threads, stage, split, per, blocks, smem, slots)

    plan = layout(smem_of(512 if c <= 512 else 1024, True) <= optin)
    if plan.stage and rhs_bytes * plan.blocks > weight_bytes:
        plan = layout(False)
    return plan


@functools.lru_cache(maxsize=None)
def _limits(index: int):
    """(SMs, opt-in shared memory a block, shared memory an SM) of card ``index``."""
    lib = _build.load(NAME)
    fn = lib.sell_spmm_limits
    fn.argtypes, fn.restype = [_INT, ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    out = (ctypes.c_int * 3)()
    err = fn(index, out)
    if err:
        raise RuntimeError(f"sell_spmm: reading the card's limits failed ({err})")
    return tuple(out)


def _plan_for(slice_ptrs, data, X, c, tt, rhs_elems, tiles):
    """The slice plan of this launch on X's card, kept in ``last_plan``."""
    global last_plan
    nslices = slice_ptrs.shape[0] - 1
    es = X.element_size()
    sms, optin, per_sm = _limits(X.device.index if X.device.index is not None
                                 else torch.cuda.current_device())
    last_plan = slice_plan(nslices, c, data.shape[0] // c, tt, rhs_elems * es, tiles,
                           data.shape[0] * (4 + es), sms, optin, per_sm)
    return last_plan


def _plan_args(plan: SlicePlan):
    return plan.threads, int(plan.stage), plan.split, plan.per


@functools.lru_cache(maxsize=None)
def _fn_t(dtype: torch.dtype):
    return _build.entry_point(NAME, f"sell_spmm_t_{DTYPES[dtype]}", _ARGTYPES_T)


@functools.lru_cache(maxsize=None)
def _fn_xt(dtype: torch.dtype):
    return _build.entry_point(NAME, f"sell_spmm_xt_{DTYPES[dtype]}", _ARGTYPES_XT)


@functools.lru_cache(maxsize=None)
def _fn_kxt(dtype: torch.dtype):
    # (ptrs, cols, data, perm, B, BP, ...): sell_spmm_xt's signature with B, BP for X, XT
    return _build.entry_point(NAME, f"sell_spmm_kxt_{DTYPES[dtype]}", _ARGTYPES_XT)


@functools.lru_cache(maxsize=None)
def _fn_tc(dtype: torch.dtype):  # sell_spmm_kxt's signature, tc for xt
    return _build.entry_point(NAME, f"sell_spmm_tc_{DTYPES[dtype]}", _ARGTYPES_XT)


def _check(slice_ptrs, cols, data, perm, X, m, c, tt, what="X", n_axis=1):
    """``X`` is the rhs: X (T, N) (N on axis 1) or B (N, Kb) (N on axis 0)."""
    dev = X.device
    for name, t in (("slice_ptrs", slice_ptrs), ("cols", cols), ("data", data),
                    ("perm", perm)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, {what} on {dev}")
        if not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"{name} must be 1-D and contiguous")
    for name, t in (("slice_ptrs", slice_ptrs), ("cols", cols), ("perm", perm)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if not 0 < c <= MAX_C:
        raise ValueError(f"slice height c must be in [1, {MAX_C}], got {c}")
    nslices = slice_ptrs.shape[0] - 1
    if perm.shape[0] != nslices * c or perm.shape[0] < m:
        raise ValueError(f"perm must have nslices*c={nslices * c} >= m={m} entries, "
                         f"got {perm.shape[0]}")
    if cols.shape != data.shape or data.shape[0] % c:
        raise ValueError(f"cols {tuple(cols.shape)} and data {tuple(data.shape)} must "
                         f"match and hold whole planes of c={c}")
    if X.dim() != 2 or not X.is_contiguous():
        shape = "(T, N)" if n_axis else "(N, Kb)"
        raise ValueError(f"{what} must be 2-D {shape} and contiguous")
    if X.shape[n_axis] >= 2 ** 31:
        raise ValueError(f"{what} wider than int32 column indices can address")
    if X.dtype not in DTYPES or data.dtype != X.dtype:
        raise ValueError(f"data and X must share dtype float32 or bfloat16, "
                         f"got {data.dtype} and {X.dtype}")
    if tt not in TOKEN_TILES:
        raise ValueError(f"tt must be one of {TOKEN_TILES}, got {tt}")


def sell_spmm(slice_ptrs: torch.Tensor, cols: torch.Tensor, data: torch.Tensor,
              perm: torch.Tensor, B: torch.Tensor, m: int, c: int, xt: int = 0,
              tc: int = 0) -> torch.Tensor:
    """Y = A @ B for SELL-C-sigma A given as flat (slice_ptrs, cols, data,
    perm) with slice height ``c``, and B (N, Kb); returns (M, Kb). ``xt`` =
    ``tc`` = 0: for Kb <= 8 the slice schedule on :func:`slice_plan`'s
    launch (a block a slice, ``c`` at most ``MAX_C``, B staged in shared
    memory where it fits, few slices split over a cluster), wider Kb runs
    lanes along Kb, one group a sorted row; ``xt`` in
    ``csr_spmm.XT_TILES``: the token-major schedule,
    the slices repacked row-major into scratch; ``tc`` in
    ``csr_spmm.TC_TILES``: the dense-tile schedule on the tensor cores over
    the repacked slices. f32 accumulation; Y in B's dtype."""
    global launches, launches_kxt, launches_tc
    xt, tc = check_ab_schedule(xt, tc)
    if B.device.type == "cpu":
        return sell_spmm_ref(slice_ptrs, cols, data, perm, B, m, c)
    if B.device.type != "cuda":
        raise ValueError(f"sell_spmm runs on cuda or cpu tensors, got {B.device}")
    _check(slice_ptrs, cols, data, perm, B, m, c, 1, "B", 0)
    if (xt or tc) and data.shape[0] > XT_MAX_ENTRIES:
        raise ValueError(f"xt={xt}, tc={tc} address at most {XT_MAX_ENTRIES} stored entries")
    n, kb = B.shape
    if m == 0 or kb == 0 or n == 0:  # nothing to launch: every output sums nothing
        return torch.zeros((m, kb), dtype=B.dtype, device=B.device)
    y = torch.empty((m, kb), dtype=B.dtype, device=B.device)
    stream = torch.cuda.current_stream(B.device).cuda_stream
    if xt or tc:
        fn, err_str = (_fn_kxt if xt else _fn_tc)(B.dtype)
        # scratch, freed on this stream after the launch (reuse waits): B
        # padded where it is not read in place, the slices repacked row-major
        scratch = ab_scratch(B, xt)
        pcols, pdata = torch.empty_like(cols), torch.empty_like(data)
        err = fn(slice_ptrs.data_ptr(), cols.data_ptr(), data.data_ptr(), perm.data_ptr(),
                 B.data_ptr(), None if scratch is None else scratch.data_ptr(),
                 pcols.data_ptr(), pdata.data_ptr(), y.data_ptr(), data.shape[0],
                 perm.shape[0], c, m, n, kb, xt or tc, B.device.index, stream)
    else:
        fn, err_str = _fn(B.dtype)
        plan = (SlicePlan(0, False, 1, 1, 0, 0, 0) if kb > SLICE_MAX_TOKENS else
                _plan_for(slice_ptrs, data, B, c, token_tile(kb), n * kb, 1))
        err = fn(slice_ptrs.data_ptr(), cols.data_ptr(), data.data_ptr(), perm.data_ptr(),
                 B.data_ptr(), y.data_ptr(), perm.shape[0], c, m, n, kb, *_plan_args(plan),
                 B.device.index, stream)
    if err:
        raise RuntimeError(f"sell_spmm launch failed: {err_str(err).decode()} ({err})")
    launches += 1
    launches_kxt += bool(xt)
    launches_tc += bool(tc)
    return y


def sell_spmm_t(slice_ptrs: torch.Tensor, cols: torch.Tensor, data: torch.Tensor,
                perm: torch.Tensor, X: torch.Tensor, m: int, c: int,
                tt: int | None = None, xt: int = 0) -> torch.Tensor:
    """Y = X @ A^T for SELL-C-sigma A given as flat (slice_ptrs, cols, data,
    perm) with slice height ``c``, and activations X (T, N); returns (T, M).
    ``xt`` 0: the slice schedule on :func:`slice_plan`'s launch, ``tt``
    tokens a block (default ``csr_spmm.token_tile`` of T), their rows of X
    copied into shared memory where they fit, few slices split over a
    cluster (one token runs ``sell_spmm``'s Kb = 1 kernel: X (1, N) is B
    (N, 1)); ``xt`` in ``csr_spmm.XT_TILES``: the
    token-major schedule, ``xt`` tokens a block (``tt`` unread). f32
    accumulation; Y in X's dtype."""
    global launches_t, launches_xt
    xt = check_xt(xt)
    if X.device.type == "cpu":
        return sell_spmm_t_ref(slice_ptrs, cols, data, perm, X, m, c)
    if X.device.type != "cuda":
        raise ValueError(f"sell_spmm_t runs on cuda or cpu tensors, got {X.device}")
    tt = token_tile(X.shape[0]) if tt is None else tt
    _check(slice_ptrs, cols, data, perm, X, m, c, tt)
    if xt and data.shape[0] > XT_MAX_ENTRIES:
        raise ValueError(f"xt={xt} addresses at most {XT_MAX_ENTRIES} stored entries")
    t, n = X.shape
    if m == 0 or t == 0 or n == 0:  # nothing to launch: every output sums nothing
        return torch.zeros((t, m), dtype=X.dtype, device=X.device)
    y = torch.empty((t, m), dtype=X.dtype, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    if xt:
        fn, err_str = _fn_xt(X.dtype)
        # scratch, freed on this stream after the launch (reuse waits): XT and
        # the slices repacked row-major
        scratch = xt_scratch(X, xt)
        pcols, pdata = torch.empty_like(cols), torch.empty_like(data)
        err = fn(slice_ptrs.data_ptr(), cols.data_ptr(), data.data_ptr(), perm.data_ptr(),
                 X.data_ptr(), scratch.data_ptr(), pcols.data_ptr(), pdata.data_ptr(),
                 y.data_ptr(), data.shape[0], perm.shape[0], c, m, n, t, xt, X.device.index,
                 stream)
    else:
        fn, err_str = _fn_t(X.dtype)
        # one token runs sell_spmm's Kb = 1 kernel (X (1, n) is B (n, 1))
        plan = _plan_for(slice_ptrs, data, X, c, 1, n, 1) if t == 1 else _plan_for(
            slice_ptrs, data, X, c, tt, tt * n, -(-t // tt))
        err = fn(slice_ptrs.data_ptr(), cols.data_ptr(), data.data_ptr(), perm.data_ptr(),
                 X.data_ptr(), y.data_ptr(), perm.shape[0], c, m, n, t, tt, *_plan_args(plan),
                 X.device.index, stream)
    if err:
        raise RuntimeError(f"sell_spmm_t launch failed: {err_str(err).decode()} ({err})")
    launches_t += 1
    launches_xt += bool(xt)
    return y
