"""CSR-format SpMM: wrappers of the hand-written CUDA kernels ``csrc/csr_spmm.cu``.

Two kernels in one source: ``csr_spmm`` (Y = A @ B, B (N, K)) replaces the
Pallas TPU kernel ``repro/kernels/csr_spmm.py::csr_spmm``, and
``csr_spmm_t`` (Y = X @ A^T, X (T, N)) replaces
``repro/kernels/csr_spmm.py::csr_spmm_t``. On a CUDA tensor each wrapper
launches its kernel (or raises); on a CPU tensor it runs the plain version,
``repro_torch.kernels.ref.csr_spmm_ref`` / ``csr_spmm_t_ref``. Each kernel
has its own count: ``launches`` (csr_spmm) and ``launches_t``
(csr_spmm_t), raised where the kernel launches and nowhere else.

``csr_spmm_t`` has two schedules (``csrc/spmm_common.cuh``), picked by the
launch knob ``xt``: 0 runs the row schedule (``rows_spmm_t``: ``vec`` lanes
a row, ``tt`` <= 8 tokens a block, X gathered through L1); 32, 64 or 128
runs the token-major schedule (``tokens_spmm_t``: X transposed into a
scratch XT once a call, ``xt`` tokens a block staged in shared memory).
Both count in ``launches_t``.

``csr_spmm`` has three, picked by ``xt`` and ``tc`` (at most one of them
non-zero): both 0 the row schedule (``rows_spmm_launch``); ``xt`` in
``XT_TILES`` the token-major one with B in XT's place (``xt`` columns of B a
block); ``tc`` in ``TC_TILES`` the dense-tile one (``tiles_spmm_ab``: 64
rows of A a block made dense in shared memory, strips of ``tc`` columns of
B, the products on the tensor cores). All count in ``launches``; of them
``launches_kxt`` the token-major and ``launches_tc`` the dense-tile ones.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import csr_spmm_ref, csr_spmm_t_ref

NAME = "csr_spmm"
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
VEC_WIDTHS = (2, 4, 8, 16, 32)
TOKEN_TILES = (1, 2, 4, 8)
# Tokens a transposed-rhs block takes at once: each stored entry, loaded
# once, feeds this many multiply-adds. On an H100 at the minitron-8b MLP
# shapes (T = 256, f32; chip_smoke.py's token-tile sweep, PERF.md) 8 tokens
# ran fastest for the CSR kernel on both weights and for the SELL kernel on
# the down weight; the SELL kernel on the up weight ran 2.13 ms at 4 tokens
# against 2.29 ms at 8.
MAX_TOKEN_TILE = 8
# Token tiles of the token-major schedule (``xt``; 0 is the row schedule).
# ``kernels.ops.default_config`` takes the largest tile <= T: on an H100 at
# the minitron-8b MLP shapes (f32; chip_smoke.py's T sweep, PERF.md) it beat
# the row schedule and the other tiles on both weights at T = 32, 64, 128
# and 256, and lost to the row schedule at T = 8 and 16.
XT_TILES = (32, 64, 128)
# Strips of B's columns a block of the dense-tile schedule (``tc``; 0 is
# another schedule). 64-column strips gave a short matrix twice the blocks
# but densified A twice as often; on an H100 they won no cell of
# chip_smoke.py's sweeps (PERF.md), so 128 is the one strip built.
TC_TILES = (128,)
launches = 0
launches_t = 0
launches_xt = 0  # of launches_t, those on the token-major schedule
launches_kxt = 0  # of launches, those on the token-major schedule
launches_tc = 0  # of launches, those on the dense-tile schedule

_P, _I64, _I32, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I64, _I32, _I64, _INT, _INT, _P]
_ARGTYPES_T = [_P, _P, _P, _P, _P, _I64, _I32, _I64, _INT, _INT, _INT, _P]
_ARGTYPES_XT = [_P, _P, _P, _P, _P, _P, _I64, _I32, _I64, _INT, _INT, _P]


def token_tile(t: int) -> int:
    """Tokens a block takes for ``t`` tokens: the smallest power of two
    >= ``t``, at most ``MAX_TOKEN_TILE``."""
    tt = 1
    while tt < min(t, MAX_TOKEN_TILE):
        tt *= 2
    return tt


def xt_tile(t: int) -> int:
    """The ``xt`` knob for ``t`` tokens: the largest of ``XT_TILES`` <= t,
    or 0 (the row schedule) below the smallest."""
    return max((xt for xt in XT_TILES if xt <= t), default=0)


def check_xt(xt: int) -> int:
    """``xt`` as an int if the kernels take it (0 or one of ``XT_TILES``),
    else ValueError. The wrappers call it before anything else."""
    if isinstance(xt, bool) or not isinstance(xt, int) or xt not in (0,) + XT_TILES:
        raise ValueError(f"xt must be 0 (the row schedule) or one of {XT_TILES}, got {xt!r}")
    return xt


def check_tc(tc: int) -> int:
    """``tc`` as an int if the kernels take it (0 or one of ``TC_TILES``),
    else ValueError. The wrappers call it before anything else."""
    if isinstance(tc, bool) or not isinstance(tc, int) or tc not in (0,) + TC_TILES:
        raise ValueError(f"tc must be 0 (another schedule) or one of {TC_TILES}, got {tc!r}")
    return tc


def check_ab_schedule(xt: int, tc: int) -> tuple:
    """``(xt, tc)`` of a Y = A @ B wrapper, each checked; both non-zero
    names two schedules at once: ValueError."""
    xt, tc = check_xt(xt), check_tc(tc)
    if xt and tc:
        raise ValueError(f"xt={xt} and tc={tc} name two schedules: give at most one")
    return xt, tc


# Stored entries the token-major and dense-tile schedules address (int32
# positions).
XT_MAX_ENTRIES = 2 ** 31 - 65


def xt_scratch(X: torch.Tensor, xt: int) -> torch.Tensor:
    """The token-major schedule's scratch XT: (N, T rounded up to ``xt``)
    in X's dtype, on X's device, uninitialised (the kernel fills it)."""
    t, n = X.shape
    return torch.empty((n, -(-t // xt) * xt), dtype=X.dtype, device=X.device)


def ab_scratch(B: torch.Tensor, xt: int):
    """The scratch of a Y = A @ B launch on the token-major schedule (tiles
    of ``xt`` columns) or, for ``xt`` = 0, the dense-tile one, or None where
    B is read in place: its rows must be whole tiles (dense-tile: whole
    16-byte pieces) and 16-byte aligned; else B is padded once into (N, Kb
    rounded up) by the kernel's launcher. Freed on this stream after the
    launch: reuse waits."""
    per = xt or 16 // B.element_size()
    if B.shape[1] % per == 0 and B.data_ptr() % 16 == 0:
        return None
    return torch.empty((B.shape[0], -(-B.shape[1] // per) * per), dtype=B.dtype,
                       device=B.device)


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    return _build.entry_point(NAME, f"csr_spmm_{DTYPES[dtype]}", _ARGTYPES)


@functools.lru_cache(maxsize=None)
def _fn_t(dtype: torch.dtype):
    return _build.entry_point(NAME, f"csr_spmm_t_{DTYPES[dtype]}", _ARGTYPES_T)


@functools.lru_cache(maxsize=None)
def _fn_xt(dtype: torch.dtype):
    return _build.entry_point(NAME, f"csr_spmm_xt_{DTYPES[dtype]}", _ARGTYPES_XT)


@functools.lru_cache(maxsize=None)
def _fn_kxt(dtype: torch.dtype):
    # (indptr, indices, data, B, BP, Y, ...): csr_spmm_xt's signature with B, BP for X, XT
    return _build.entry_point(NAME, f"csr_spmm_kxt_{DTYPES[dtype]}", _ARGTYPES_XT)


@functools.lru_cache(maxsize=None)
def _fn_tc(dtype: torch.dtype):  # csr_spmm_kxt's signature, tc for xt
    return _build.entry_point(NAME, f"csr_spmm_tc_{DTYPES[dtype]}", _ARGTYPES_XT)


def _check(indptr, indices, data, rhs, m, what, n_axis):
    """``rhs`` is B (N on axis 0) or X (N on axis 1)."""
    dev = rhs.device
    for name, t in (("indptr", indptr), ("indices", indices), ("data", data)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, {what} on {dev}")
        if not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"{name} must be 1-D and contiguous")
    if indptr.dtype != torch.int32 or indices.dtype != torch.int32:
        raise ValueError(f"indptr/indices must be int32, got {indptr.dtype}/{indices.dtype}")
    if indptr.shape[0] != m + 1:
        raise ValueError(f"indptr must have m+1={m + 1} entries, got {indptr.shape[0]}")
    if indices.shape[0] != data.shape[0]:
        raise ValueError(f"indices ({indices.shape[0]}) and data ({data.shape[0]}) differ")
    if rhs.dim() != 2 or not rhs.is_contiguous():
        raise ValueError(f"{what} must be 2-D and contiguous")
    if rhs.shape[n_axis] >= 2 ** 31:
        raise ValueError(f"{what} wider than int32 column indices can address")
    if rhs.dtype not in DTYPES or data.dtype != rhs.dtype:
        raise ValueError(f"data and {what} must share dtype float32 or bfloat16, "
                         f"got {data.dtype} and {rhs.dtype}")


def csr_spmm(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor,
             B: torch.Tensor, m: int, vec: int, xt: int = 0, tc: int = 0) -> torch.Tensor:
    """Y = A @ B for CSR A given as (indptr[M+1], indices[cap], data[cap])
    and B (N, K); returns (M, K). ``xt`` = ``tc`` = 0: the row schedule, for
    K <= 8 ``vec`` lanes reduce each row (``kernels.ops.default_config``
    picks it), wider K runs lanes along K; ``xt`` in ``XT_TILES``: the
    token-major schedule, ``xt`` columns of B a block; ``tc`` in
    ``TC_TILES``: the dense-tile schedule on the tensor cores, strips of
    ``tc`` columns (``vec`` unread by both). f32 accumulation; Y in B's
    dtype."""
    global launches, launches_kxt, launches_tc
    xt, tc = check_ab_schedule(xt, tc)
    if B.device.type == "cpu":
        return csr_spmm_ref(indptr, indices, data, B, m)
    if B.device.type != "cuda":
        raise ValueError(f"csr_spmm runs on cuda or cpu tensors, got {B.device}")
    _check(indptr, indices, data, B, m, "B", 0)
    if vec not in VEC_WIDTHS:
        raise ValueError(f"vec must be one of {VEC_WIDTHS}, got {vec}")
    if (xt or tc) and data.shape[0] > XT_MAX_ENTRIES:
        raise ValueError(f"xt={xt}, tc={tc} address at most {XT_MAX_ENTRIES} stored entries")
    n, k = B.shape
    if m == 0 or k == 0 or n == 0:  # nothing to launch: every output sums nothing
        return torch.zeros((m, k), dtype=B.dtype, device=B.device)
    y = torch.empty((m, k), dtype=B.dtype, device=B.device)
    stream = torch.cuda.current_stream(B.device).cuda_stream
    if xt or tc:
        fn, err_str = (_fn_kxt if xt else _fn_tc)(B.dtype)
        scratch = ab_scratch(B, xt)
        err = fn(indptr.data_ptr(), indices.data_ptr(), data.data_ptr(), B.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), y.data_ptr(), m, n, k,
                 xt or tc, B.device.index, stream)
    else:
        fn, err_str = _fn(B.dtype)
        err = fn(indptr.data_ptr(), indices.data_ptr(), data.data_ptr(), B.data_ptr(),
                 y.data_ptr(), m, n, k, vec, B.device.index, stream)
    if err:
        raise RuntimeError(f"csr_spmm launch failed: {err_str(err).decode()} ({err})")
    launches += 1
    launches_kxt += bool(xt)
    launches_tc += bool(tc)
    return y


def csr_spmm_t(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor,
               X: torch.Tensor, m: int, vec: int, tt: int | None = None,
               xt: int = 0) -> torch.Tensor:
    """Y = X @ A^T for CSR A and activations X (T, N); returns (T, M).
    ``xt`` 0: the row schedule, ``vec`` lanes reduce each row
    (``kernels.ops.default_config`` picks it) and a block takes ``tt``
    tokens at once (default :func:`token_tile` of T). ``xt`` in
    ``XT_TILES``: the token-major schedule, ``xt`` tokens a block (``vec``
    and ``tt`` unread). f32 accumulation; Y in X's dtype."""
    global launches_t, launches_xt
    xt = check_xt(xt)
    if X.device.type == "cpu":
        return csr_spmm_t_ref(indptr, indices, data, X, m)
    if X.device.type != "cuda":
        raise ValueError(f"csr_spmm_t runs on cuda or cpu tensors, got {X.device}")
    _check(indptr, indices, data, X, m, "X", 1)
    if xt and data.shape[0] > XT_MAX_ENTRIES:
        raise ValueError(f"xt={xt} addresses at most {XT_MAX_ENTRIES} stored entries")
    tt = token_tile(X.shape[0]) if tt is None else tt
    if vec not in VEC_WIDTHS or tt not in TOKEN_TILES:
        raise ValueError(f"vec must be one of {VEC_WIDTHS} and tt one of {TOKEN_TILES}, "
                         f"got {vec}, {tt}")
    t, n = X.shape
    if m == 0 or t == 0 or n == 0:  # nothing to launch: every output sums nothing
        return torch.zeros((t, m), dtype=X.dtype, device=X.device)
    y = torch.empty((t, m), dtype=X.dtype, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    if xt:
        fn, err_str = _fn_xt(X.dtype)
        scratch = xt_scratch(X, xt)  # freed on this stream after the launch: reuse waits
        err = fn(indptr.data_ptr(), indices.data_ptr(), data.data_ptr(), X.data_ptr(),
                 scratch.data_ptr(), y.data_ptr(), m, n, t, xt, X.device.index, stream)
    else:
        fn, err_str = _fn_t(X.dtype)
        err = fn(indptr.data_ptr(), indices.data_ptr(), data.data_ptr(), X.data_ptr(),
                 y.data_ptr(), m, n, t, vec, tt, X.device.index, stream)
    if err:
        raise RuntimeError(f"csr_spmm_t launch failed: {err_str(err).decode()} ({err})")
    launches_t += 1
    launches_xt += bool(xt)
    return y
