"""Format conversions (paper §III-B "Convert" copy concept).

Port of ``repro.core.convert``: the explicit two-phase **plan/execute**
split.

  * ``plan_switch`` (symbolic phase): analyse the sparsity pattern on the
    device and pull only the small plan artifacts (a few scalars, an offset
    list, a block map) to the host, through :func:`_planned_pull`, which
    counts every such sync (``.cpu()``, ``.item()``, ``.tolist()``) in the
    ``planned_pulls`` counter.
  * ``convert_execute`` (numeric phase): a gather/scatter of values into
    the target layout, with every shape taken from the plan: no
    device->host transfer.

As in the paper, COO is the proxy format: any -> COO -> any. A
:class:`SwitchPlan` written by the JAX package (``SwitchPlan.to_json``)
loads here with :meth:`SwitchPlan.from_json` and builds the same container.

JAX-to-torch notes: ``jnp.lexsort`` and ``argsort(stable=True)`` become
stable ``torch.argsort`` passes in the JAX key order; ``.at[].add`` becomes
``index_put_(accumulate=True)``; ``bincount`` becomes an ``index_add_`` (a
CUDA ``bincount`` syncs to size its output).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.formats import (BSR, COO, CSR, DIA, ELL, Dense, Format,
                                      HYB, SELL)
from repro_torch.core.ops import csr_row_ids, segment_sum, take_clip
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

# Sentinels pushed past every valid diagonal offset (int32) / block id
# (int64) during the device-side ``unique`` sweeps.
_SENTINEL = int(np.iinfo(np.int32).max)
_SENTINEL64 = int(np.iinfo(np.int64).max)


def planned_pull_count() -> int:
    """Number of sanctioned symbolic-phase device->host pulls so far
    (process-monotonic; use :class:`planned_pulls_scope` for deltas)."""
    return int(_metrics.value("planned_pulls"))


class planned_pulls_scope:
    """``with planned_pulls_scope() as s: ...; s.count`` — the pulls made
    inside the scope. After exit, ``count`` freezes at its closing value."""

    _final: Optional[int] = None

    def __enter__(self):
        self._final = None
        self._scope = _metrics.scope()
        return self

    def __exit__(self, *exc):
        self._final = int(self._scope.delta("planned_pulls"))
        return False

    @property
    def count(self) -> int:
        if self._final is not None:
            return self._final
        return int(self._scope.delta("planned_pulls"))


def _planned_pull(x: torch.Tensor) -> np.ndarray:
    """Pull a small plan artifact (scalar / offset list) to the host: the
    only sanctioned device->host sync of the plan pipeline, counted."""
    _metrics.inc("planned_pulls")
    return x.detach().cpu().numpy()


def _zero(A) -> torch.Tensor:
    return torch.zeros((), dtype=A.dtype, device=A.device)


def _i32(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.int32)


# ---------------------------------------------------------------------------
# any -> COO
# ---------------------------------------------------------------------------


def csr_to_coo(A: CSR) -> COO:
    """CSR -> COO: recover row ids from the row-pointer array."""
    rows = csr_row_ids(A.indptr, A.capacity, A.shape[0])
    return COO(rows, A.indices, A.data, A.shape, A.nnz)


def ell_to_coo(A: ELL) -> COO:
    """ELL -> COO flatten; padding entries stay (0-valued)."""
    m, k = A.data.shape
    rows = torch.arange(m, dtype=torch.int32, device=A.device).repeat_interleave(k)
    return COO(rows, A.cols.reshape(-1).clamp(0, A.shape[1] - 1),
               A.data.reshape(-1), A.shape, A.nnz)


def dia_to_coo(A: DIA) -> COO:
    """DIA -> COO; out-of-matrix diagonal tails become padding."""
    m, n = A.shape
    nd = A.ndiag
    i = torch.arange(m, dtype=torch.int32, device=A.device)[None, :]
    cols = i + _i32(A.offsets)[:, None]
    valid = (cols >= 0) & (cols < n)
    rows = i.expand(nd, m)
    zero_i = torch.zeros((), dtype=torch.int32, device=A.device)
    data = torch.where(valid, A.data, _zero(A))
    rows = torch.where(valid, rows, zero_i)
    cols = torch.where(valid, cols, zero_i)
    return COO(rows.reshape(-1), cols.reshape(-1), data.reshape(-1), A.shape, A.nnz)


def bsr_to_coo(A: BSR) -> COO:
    """BSR -> COO block expansion."""
    from repro_torch.core.ops import _bsr_block_rows
    bs = A.block_size
    nblk = A.nblocks
    brow = _bsr_block_rows(A)
    bi = torch.arange(bs, dtype=torch.int32, device=A.device)
    rows = brow[:, None, None] * bs + bi[None, :, None]
    cols = A.indices[:, None, None] * bs + bi[None, None, :]
    rows = rows.expand(nblk, bs, bs).reshape(-1)
    cols = cols.expand(nblk, bs, bs).reshape(-1)
    return COO(_i32(rows), _i32(cols), A.data.reshape(-1), A.shape, A.nnz)


def hyb_to_coo(A: HYB) -> COO:
    """HYB -> COO: concatenate the parts' COO views."""
    e = ell_to_coo(A.ell)
    c = A.coo
    return COO(torch.cat([e.row, c.row]), torch.cat([e.col, c.col]),
               torch.cat([e.data, c.data]), A.shape, A.nnz)


def sell_to_coo(A: SELL) -> COO:
    """SELL -> COO: (slice, lane) of each flat position from the slice
    pointers, then the original row through the permutation. Padding and
    ghost entries stay inert (row 0, val 0)."""
    m, n = A.shape
    c = A.c
    p = torch.arange(A.capacity, dtype=torch.int32, device=A.device)
    s = _i32(torch.searchsorted(A.slice_ptrs, p, right=True)) - 1
    s = s.clamp(0, A.nslices - 1)
    lane = (p - A.slice_ptrs[s.long()]) % c
    rows = _i32(take_clip(A.perm, s * c + lane).clamp(0, m - 1))
    live = A.data != 0
    zero_i = torch.zeros((), dtype=torch.int32, device=A.device)
    rows = torch.where(live, rows, zero_i)
    cols = torch.where(live, A.cols.clamp(0, n - 1), zero_i)
    return COO(rows, _i32(cols), A.data, A.shape, A.nnz)


def dense_to_coo(A: Dense, capacity: Optional[int] = None) -> COO:
    """Dense -> COO. With ``capacity`` (from a plan) the extraction is
    sync-free (``nonzero_static``); without one the nonzero count is pulled
    first (one counted sync)."""
    cnt = torch.count_nonzero(A.data)
    if capacity is None:
        capacity = max(1, int(_planned_pull(cnt)))
    cap = int(capacity)
    nz = torch.nonzero_static(A.data, size=cap, fill_value=0)
    r, c = nz[:, 0], nz[:, 1]
    mask = torch.arange(cap, device=A.device) < torch.clamp(cnt, max=cap)
    zero_i = torch.zeros((), dtype=torch.int32, device=A.device)
    val = torch.where(mask, A.data[r, c], _zero(A))
    r = torch.where(mask, _i32(r), zero_i)
    c = torch.where(mask, _i32(c), zero_i)
    return COO(r, c, val, A.shape, cap)


def to_coo(A, capacity: Optional[int] = None) -> COO:
    if isinstance(A, COO):
        return A
    if isinstance(A, CSR):
        return csr_to_coo(A)
    if isinstance(A, ELL):
        return ell_to_coo(A)
    if isinstance(A, DIA):
        return dia_to_coo(A)
    if isinstance(A, BSR):
        return bsr_to_coo(A)
    if isinstance(A, HYB):
        return hyb_to_coo(A)
    if isinstance(A, SELL):
        return sell_to_coo(A)
    if isinstance(A, Dense):
        return dense_to_coo(A, capacity)
    raise TypeError(f"not a sparse container: {type(A)}")


# ---------------------------------------------------------------------------
# The symbolic phase: SwitchPlan / plan_switch
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SwitchPlan:
    """Output of the symbolic phase of a format switch: static Python data
    (ints and tuples) only, so a plan is hashable and JSON-serialisable.
    Same fields and JSON layout as the JAX package's ``SwitchPlan``."""

    target: Format
    ell_k: Optional[int] = None                       # ELL width / HYB split
    dia_offsets: Optional[Tuple[int, ...]] = None     # occupied diagonals
    block_size: Optional[int] = None                  # BSR block edge
    bsr_indptr: Optional[Tuple[int, ...]] = None      # BSR block-row ptrs
    bsr_indices: Optional[Tuple[int, ...]] = None     # BSR block columns
    hyb_coo_capacity: Optional[int] = None            # HYB overflow slots
    capacity: Optional[int] = None                    # Dense->COO extraction
    sell_c: Optional[int] = None                      # SELL slice height C
    sell_sigma: Optional[int] = None                  # SELL sort window
    sell_slice_ptrs: Optional[Tuple[int, ...]] = None  # SELL flat slice caps
    sell_perm: Optional[Tuple[int, ...]] = None       # SELL row permutation

    def __post_init__(self):
        object.__setattr__(self, "target", Format(self.target))

    def to_json(self) -> dict:
        """JSON-ready dict (Format by name, tuples as lists)."""
        out = {"target": Format(self.target).name}
        for f in dataclasses.fields(self):
            if f.name == "target":
                continue
            v = getattr(self, f.name)
            if v is not None:
                out[f.name] = list(v) if isinstance(v, tuple) else v
        return out

    @classmethod
    def from_json(cls, doc: dict) -> "SwitchPlan":
        kw = {"target": Format[doc["target"]]}
        for f in dataclasses.fields(cls):
            if f.name == "target" or f.name not in doc:
                continue
            v = doc[f.name]
            kw[f.name] = tuple(v) if isinstance(v, list) else v
        return cls(**kw)


def _live_row_counts(C: COO, live: torch.Tensor) -> torch.Tensor:
    """Per-row count of live (non-zero) entries, on device (int32)."""
    return segment_sum(_i32(live), C.row, C.shape[0])


def _unique_small(values: torch.Tensor, sentinel: int = _SENTINEL) -> np.ndarray:
    """Device ``unique``, then pull only the compacted result to the host."""
    u = _planned_pull(torch.unique(values))
    return u[u != sentinel]


def _sell_geometry(c: Optional[int], sigma: Optional[int], m: int):
    """Normalize (C, sigma) hints: C defaults to 32 lanes, sigma to 8*C
    (and is never smaller than C)."""
    C = 32 if c is None else max(1, int(c))
    s = 8 * C if sigma is None else int(sigma)
    s = max(C, s)
    nslices = max(1, -(-m // C))
    return C, s, nslices


def _sell_perm(counts: torch.Tensor, sigma: int, m: int) -> torch.Tensor:
    """sigma-window sort permutation: rows ordered by window, then by
    descending live-entry count, ties in matrix order — ``jnp.lexsort((
    -counts, wid))`` as two stable sorts, secondary key first."""
    wid = torch.arange(m, dtype=torch.int32, device=counts.device) // sigma
    o1 = torch.argsort(-counts.to(torch.int32), stable=True)
    o2 = torch.argsort(wid[o1], stable=True)
    return _i32(o1[o2])


def _sell_widths(counts: torch.Tensor, perm: torch.Tensor, c: int,
                 nslices: int) -> torch.Tensor:
    """Per-slice max live-row-count after the sigma-sort, on device."""
    mp = nslices * c
    m = counts.shape[0]
    sc = torch.zeros((mp,), dtype=torch.int32, device=counts.device)
    sc[:m] = _i32(counts[perm.long()])
    return sc.view(nslices, c).amax(dim=1)


def _sell_ptrs(widths_np: np.ndarray, c: int) -> Tuple[int, ...]:
    """Static flat slice pointers from pulled per-slice widths. An all-empty
    matrix keeps one padding plane so the flat arrays are never zero-size."""
    widths_np = np.asarray(widths_np, np.int64).copy()
    if widths_np.sum() == 0:
        widths_np[0] = 1
    ptrs = np.concatenate([np.zeros(1, np.int64), np.cumsum(widths_np * c)])
    return tuple(int(x) for x in ptrs)


def plan_switch(A, fmt: Format, *, k: Optional[int] = None,
                offsets: Optional[Sequence[int]] = None,
                block_size: int = 128,
                capacity: Optional[int] = None,
                c: Optional[int] = None,
                sigma: Optional[int] = None,
                check: bool = True) -> SwitchPlan:
    """Symbolic phase: compute the :class:`SwitchPlan` for ``A`` -> ``fmt``.

    Pattern analysis runs on the device of ``A``; only the plan artifacts
    are pulled to the host. Explicit hints (``k=``, ``offsets=``,
    ``block_size=``) short-circuit the analysis.
    """
    fmt = Format(fmt)
    if isinstance(A, Dense):
        need = max(1, int(_planned_pull(torch.count_nonzero(A.data))))
        if capacity is None:
            capacity = need
        elif int(capacity) < need:
            raise ValueError(f"capacity {capacity} < {need} nonzeros")
    if capacity is not None:
        capacity = int(capacity)

    if fmt in (Format.COO, Format.CSR, Format.DENSE):
        return SwitchPlan(fmt, capacity=capacity)

    C = to_coo(A, capacity=capacity)
    m, n = C.shape
    live = C.data != 0

    if fmt == Format.ELL:
        if k is None:
            k = max(1, int(_planned_pull(_live_row_counts(C, live).max())))
        elif check:
            counts = _live_row_counts(C, live)
            probe = _planned_pull(torch.stack([counts.max(),
                                               _i32(counts.argmax())]))
            kmax, bad_row = int(probe[0]), int(probe[1])
            if kmax > int(k):
                raise ValueError(
                    f"coo_to_ell: k={int(k)} but row {bad_row} holds {kmax} "
                    f"live entries; the overflow would be silently dropped. "
                    f"Pass k>={kmax}, or use Format.HYB which spills "
                    f"overflow into its COO part.")
        return SwitchPlan(fmt, ell_k=int(k), capacity=capacity)

    if fmt == Format.SELL:
        C_, sig, nslices = _sell_geometry(c, sigma, m)
        counts = _live_row_counts(C, live)
        perm = _sell_perm(counts, sig, m)
        widths = _sell_widths(counts, perm, C_, nslices)
        # one planned pull for the whole geometry: widths then permutation
        probe = _planned_pull(torch.cat([widths, perm]))
        ptrs = _sell_ptrs(probe[:nslices], C_)
        return SwitchPlan(fmt, sell_c=C_, sell_sigma=sig,
                          sell_slice_ptrs=ptrs,
                          sell_perm=tuple(int(x) for x in probe[nslices:]),
                          capacity=capacity)

    if fmt == Format.DIA:
        if offsets is None:
            sent = torch.full((), _SENTINEL, dtype=torch.int32, device=C.row.device)
            diffs = torch.where(live, _i32(C.col) - _i32(C.row), sent)
            offs = _unique_small(diffs)
            offsets = offs if offs.size else np.array([0])
        # ascending *unique* offsets: the numeric phase routes entries with
        # searchsorted, so every plan is canonical.
        offsets = tuple(int(o) for o in np.unique(np.asarray(offsets).ravel()))
        return SwitchPlan(fmt, dia_offsets=offsets, capacity=capacity)

    if fmt == Format.BSR:
        bs = int(block_size)
        if m % bs or n % bs:
            raise ValueError(f"shape {C.shape} not a multiple of block size {bs}")
        nbr, nbc = m // bs, n // bs
        # block ids are int64 here: the JAX package's int32 ids refuse a
        # block grid of 2^31 blocks or more (HPCG 104^3 at bs=8 has 1.98e10)
        gid = (C.row.long() // bs) * nbc + (C.col.long() // bs)
        gid = torch.where(live, gid, torch.full_like(gid, _SENTINEL64))
        blk = _unique_small(gid, _SENTINEL64).astype(np.int64)
        if blk.size == 0:
            blk = np.zeros(1, np.int64)  # single inert zero block at (0, 0)
        pbr, pbc = blk // nbc, blk % nbc
        indptr = np.zeros(nbr + 1, np.int64)
        np.add.at(indptr, pbr + 1, 1)
        indptr = np.cumsum(indptr)
        return SwitchPlan(fmt, block_size=bs,
                          bsr_indptr=tuple(int(i) for i in indptr),
                          bsr_indices=tuple(int(c) for c in pbc),
                          capacity=capacity)

    if fmt == Format.HYB:
        counts = _live_row_counts(C, live)
        if k is None:
            k = _median_positive(counts, m)
        k = max(1, int(k))
        # counted here; the JAX package syncs this scalar uncounted
        over = torch.clamp(counts.long() - k, min=0).sum()
        coo_cap = max(1, int(_planned_pull(over)))
        return SwitchPlan(fmt, ell_k=k, hyb_coo_capacity=coo_cap,
                          capacity=capacity)

    raise ValueError(f"unknown format {fmt}")


def _median_positive(counts: torch.Tensor, m: int) -> int:
    """Median of the positive row counts (mirrors the historical
    ``np.median(counts[counts > 0])``), with two scalar syncs."""
    npos = int(_planned_pull((counts > 0).sum()))
    if npos == 0:
        return 1
    s = torch.sort(counts).values
    nz = m - npos
    lo = min(nz + (npos - 1) // 2, m - 1)
    hi = min(nz + npos // 2, m - 1)
    return max(1, int(_planned_pull(s[lo].long() + s[hi].long())) // 2)


# ---------------------------------------------------------------------------
# Batched symbolic/numeric phases (stacked shard containers)
# ---------------------------------------------------------------------------


def map_container(fn, *containers):
    """Apply ``fn`` to the matching tensor fields of same-format containers
    (nested parts, HYB's, recursed; static metadata taken from the first)."""
    first = containers[0]
    kw = {}
    for f in dataclasses.fields(first):
        vals = [getattr(c, f.name) for c in containers]
        if f.metadata.get("static"):
            kw[f.name] = vals[0]
        elif dataclasses.is_dataclass(vals[0]):
            kw[f.name] = map_container(fn, *vals)
        else:
            kw[f.name] = fn(*vals)
    return type(first)(**kw)


def stack_parts(parts: Sequence):
    """Stack P same-structure containers into one with a leading P axis."""
    return map_container(lambda *ts: torch.stack(ts), *parts)


def part_of(stacked, p: int):
    """Part ``p`` of a stacked container: the ``[p]`` slice of every field
    (contiguous, no copy)."""
    return map_container(lambda t: t[p], stacked)


def nparts(stacked) -> int:
    """Length of a stacked container's leading (part) axis."""
    return int(stacked.data.shape[0]) if hasattr(stacked, "data") else nparts(stacked.ell)


def _batch_row_counts(C: COO) -> torch.Tensor:
    """(P, M) live-entry row counts of a stacked COO batch, one device pass."""
    p, cap = C.data.shape
    m = C.shape[0]
    ids = C.row.long() + torch.arange(p, device=C.device)[:, None] * m
    return segment_sum(_i32(C.data != 0).reshape(-1), ids.reshape(-1), p * m).view(p, m)


def plan_switch_batch(A: COO, fmt: Format, *, k: Optional[int] = None,
                      offsets: Optional[Sequence[int]] = None,
                      block_size: int = 128,
                      capacity: Optional[int] = None,
                      c: Optional[int] = None,
                      sigma: Optional[int] = None,
                      check: bool = True) -> SwitchPlan:
    """Shared symbolic phase over a *stacked* batch of same-shape COO parts.

    ``A`` is a COO container whose arrays carry a leading batch (shard)
    axis: ``row/col/data`` of shape ``(P, capacity)`` with ``shape`` the
    per-part matrix shape. One :class:`SwitchPlan` is valid for the whole
    batch: ELL width = max over parts, SELL slice caps = elementwise max of
    the per-part widths, DIA offsets = deduped union over parts, HYB split
    at the median positive count of all P*M rows with the COO capacity the
    largest overflow of a part, BSR block map = union over parts. Host
    traffic is a handful of :func:`_planned_pull` artifacts, whatever P is.
    """
    fmt = Format(fmt)
    if not isinstance(A, COO) or A.data.dim() != 2:
        raise TypeError("plan_switch_batch expects a stacked COO container "
                        "with (P, capacity) arrays")
    m, n = A.shape

    if fmt in (Format.COO, Format.CSR, Format.DENSE):
        return SwitchPlan(fmt, capacity=capacity)

    live = A.data != 0

    if fmt == Format.ELL:
        if k is None:
            k = max(1, int(_planned_pull(_batch_row_counts(A).max())))
        elif check:
            counts = _batch_row_counts(A)
            probe = _planned_pull(torch.stack([counts.max(),
                                               _i32(counts.argmax())]))
            kmax, flat = int(probe[0]), int(probe[1])
            part, bad_row = divmod(flat, m)
            if kmax > int(k):
                raise ValueError(
                    f"plan_switch_batch: k={int(k)} but row {bad_row} of "
                    f"part {part} holds {kmax} live entries; the overflow "
                    f"would be silently dropped. Pass k>={kmax}, or use "
                    f"Format.HYB which spills overflow into its COO part.")
        return SwitchPlan(fmt, ell_k=int(k), capacity=capacity)

    if fmt == Format.SELL:
        C_, sig, nslices = _sell_geometry(c, sigma, m)
        counts = _batch_row_counts(A)
        # shared slice caps = elementwise max over parts: every part's own
        # sigma-sort fits under them
        widths = torch.stack([_sell_widths(cnt, _sell_perm(cnt, sig, m), C_, nslices)
                              for cnt in counts]).amax(dim=0)
        ptrs = _sell_ptrs(_planned_pull(widths), C_)
        return SwitchPlan(fmt, sell_c=C_, sell_sigma=sig,
                          sell_slice_ptrs=ptrs, sell_perm=None,
                          capacity=capacity)

    if fmt == Format.DIA:
        if offsets is None:
            sent = torch.full((), _SENTINEL, dtype=torch.int32, device=A.device)
            diffs = torch.where(live, _i32(A.col) - _i32(A.row), sent)
            offs = _unique_small(diffs.reshape(-1))  # deduped union over parts
            offsets = offs if offs.size else np.array([0])
        offsets = tuple(int(o) for o in np.unique(np.asarray(offsets).ravel()))
        return SwitchPlan(fmt, dia_offsets=offsets, capacity=capacity)

    if fmt == Format.HYB:
        counts = _batch_row_counts(A)
        if k is None:
            k = _median_positive(counts.reshape(-1), int(counts.numel()))
        k = max(1, int(k))
        overflow = torch.clamp(counts.long() - k, min=0).sum(dim=1)  # per part
        coo_cap = max(1, int(_planned_pull(overflow.max())))
        return SwitchPlan(fmt, ell_k=k, hyb_coo_capacity=coo_cap,
                          capacity=capacity)

    if fmt == Format.BSR:
        bs = int(block_size)
        if m % bs or n % bs:
            raise ValueError(f"shape {A.shape} not a multiple of block size {bs}")
        nbr, nbc = m // bs, n // bs
        gid = (A.row.long() // bs) * nbc + (A.col.long() // bs)
        gid = torch.where(live, gid, torch.full_like(gid, _SENTINEL64))
        blk = _unique_small(gid.reshape(-1), _SENTINEL64).astype(np.int64)  # union
        if blk.size == 0:
            blk = np.zeros(1, np.int64)
        pbr, pbc = blk // nbc, blk % nbc
        indptr = np.zeros(nbr + 1, np.int64)
        np.add.at(indptr, pbr + 1, 1)
        indptr = np.cumsum(indptr)
        return SwitchPlan(fmt, block_size=bs,
                          bsr_indptr=tuple(int(i) for i in indptr),
                          bsr_indices=tuple(int(c) for c in pbc),
                          capacity=capacity)

    raise ValueError(f"unknown format {fmt}")


def convert_execute_batch(A, plan: SwitchPlan):
    """Batched numeric phase: :func:`convert_execute` of every part under
    one shared plan, stacked. No device->host transfer; the JAX package
    ``vmap``s the same per-part conversion."""
    return stack_parts([convert_execute(part_of(A, p), plan) for p in range(nparts(A))])


# ---------------------------------------------------------------------------
# The numeric phase: convert_execute (no device->host transfer given a plan)
# ---------------------------------------------------------------------------


def _row_slots(C: COO):
    """Stable row sort + within-row slot of every *live* entry.

    Slots rank live (non-zero) entries only; dead entries get a meaningless
    slot that callers mask out.
    """
    m = C.shape[0]
    order = torch.argsort(C.row, stable=True)
    rows, cols, data = C.row[order], C.col[order], C.data[order]
    live = data != 0
    live_i = live.long()
    live_counts = segment_sum(live_i, rows, m)
    live_starts = torch.cat([live_counts.new_zeros(1), live_counts.cumsum(0)])[:-1]
    slot = live_i.cumsum(0) - 1 - live_starts[rows.long()]
    return rows, cols, data, slot, live


def coo_to_csr(A: COO) -> CSR:
    """COO -> CSR: stable sort by row, counted row pointers. Padding entries
    (row 0, val 0) sort to the front of row 0 — harmless."""
    m = A.shape[0]
    order = torch.argsort(A.row, stable=True)
    rows = A.row[order]
    counts = segment_sum(torch.ones_like(rows), rows, m)
    indptr = torch.cat([counts.new_zeros(1), _i32(counts.cumsum(0))])
    return CSR(_i32(indptr), A.col[order], A.data[order], A.shape, A.nnz)


def _coo_to_ell_exec(A: COO, k: int) -> ELL:
    """ELL numeric phase: scatter into the (M, K) planes. Dead entries are
    parked in a guard column that is dropped; padding is col=-1, val=0."""
    m = A.shape[0]
    k = int(k)
    rows, cols, data, slot, live = _row_slots(A)
    dead = ~live
    sl = torch.where(dead, torch.full_like(slot, k), slot).clamp(0, k)
    r = rows.long()
    neg1 = torch.full((), -1, dtype=torch.int32, device=A.device)
    cols_plane = torch.full((m, k + 1), -1, dtype=torch.int32, device=A.device)
    cols_plane[r, sl] = torch.where(dead, neg1, _i32(cols))
    data_plane = torch.zeros((m, k + 1), dtype=A.dtype, device=A.device)
    data_plane.index_put_((r, sl), torch.where(dead, _zero(A), data), accumulate=True)
    return ELL(cols_plane[:, :k].contiguous(), data_plane[:, :k].contiguous(),
               A.shape, A.nnz)


def coo_to_ell(A: COO, k: Optional[int] = None, *, check: bool = True) -> ELL:
    """COO -> ELL. ``k`` missing -> planned on the fly; ``k`` given ->
    validated unless ``check=False``."""
    plan = plan_switch(A, Format.ELL, k=k, check=check)
    return _coo_to_ell_exec(A, plan.ell_k)


def _coo_to_dia_exec(A: COO, offsets: Sequence[int]) -> DIA:
    """DIA numeric phase: scatter into the (ndiag, M) table; entries on
    diagonals missing from ``offsets`` are dropped."""
    m, n = A.shape
    offsets_arr = torch.tensor(list(offsets), dtype=torch.int32, device=A.device)
    nd = int(offsets_arr.shape[0])
    k = _i32(A.col - A.row)
    slot = torch.searchsorted(offsets_arr, k).clamp(0, nd - 1)
    hit = offsets_arr[slot] == k
    data = torch.zeros((nd, m), dtype=A.dtype, device=A.device)
    data.index_put_((slot, A.row.long()), torch.where(hit, A.data, _zero(A)),
                    accumulate=True)
    return DIA(offsets_arr, data, A.shape, A.nnz)


def coo_to_dia(A: COO, offsets: Optional[Sequence[int]] = None) -> DIA:
    """COO -> DIA. Symbolic: the occupied diagonals (planned unless given,
    ascending); numeric: scatter."""
    plan = plan_switch(A, Format.DIA, offsets=offsets)
    return _coo_to_dia_exec(A, plan.dia_offsets)


def _coo_to_bsr_exec(A: COO, plan: SwitchPlan) -> BSR:
    """BSR numeric phase: scatter of entries into their blocks; the block
    map rides in the plan."""
    m, n = A.shape
    bs = plan.block_size
    nbc = n // bs
    dev = A.device
    bcol_np = np.asarray(plan.bsr_indices, np.int32)
    indptr_np = np.asarray(plan.bsr_indptr, np.int32)
    brow_np = np.repeat(np.arange(len(indptr_np) - 1, dtype=np.int64),
                        np.diff(indptr_np))
    blk_sorted = brow_np * nbc + bcol_np.astype(np.int64)
    nblk = max(1, len(bcol_np))
    blk_lut = torch.from_numpy(blk_sorted).to(dev)
    gid = (A.row.long() // bs) * nbc + A.col.long() // bs
    slot = torch.searchsorted(blk_lut, gid).clamp(0, nblk - 1)
    hit = take_clip(blk_lut, slot) == gid
    bi = (A.row % bs).long()
    bj = (A.col % bs).long()
    data = torch.zeros((nblk, bs, bs), dtype=A.dtype, device=dev)
    data.index_put_((slot, bi, bj), torch.where(hit, A.data, _zero(A)),
                    accumulate=True)
    return BSR(torch.from_numpy(indptr_np).to(dev), torch.from_numpy(bcol_np).to(dev),
               data, A.shape, A.nnz, bs)


def coo_to_bsr(A: COO, block_size: int = 128,
               plan: Optional[SwitchPlan] = None) -> BSR:
    """COO -> BSR (planned unless ``plan`` is given)."""
    if plan is None:
        plan = plan_switch(A, Format.BSR, block_size=block_size)
    return _coo_to_bsr_exec(A, plan)


def _coo_to_hyb_exec(A: COO, k: int, coo_cap: int) -> HYB:
    """HYB numeric phase: one stable row sort, then scatters into the ELL
    planes (within-row rank < k) and the compacted COO overflow; excess
    past ``coo_cap`` lands in a dropped guard slot."""
    m, n = A.shape
    k, coo_cap = int(k), int(coo_cap)
    dev = A.device
    rows, cols, data, slot, live = _row_slots(A)
    in_ell = (slot < k) & live
    in_coo = (~in_ell) & live
    r = rows.long()
    neg1 = torch.full((), -1, dtype=torch.int32, device=dev)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    ell_slot = torch.where(in_ell, slot, torch.full_like(slot, k)).clamp(0, k)
    cols_plane = torch.full((m, k + 1), -1, dtype=torch.int32, device=dev)
    cols_plane[r, ell_slot] = torch.where(in_ell, _i32(cols), neg1)
    data_plane = torch.zeros((m, k + 1), dtype=A.dtype, device=dev)
    data_plane.index_put_((r, ell_slot), torch.where(in_ell, data, _zero(A)),
                          accumulate=True)
    ell = ELL(cols_plane[:, :k].contiguous(), data_plane[:, :k].contiguous(),
              A.shape, A.nnz)
    pos = in_coo.long().cumsum(0) - 1
    pos = torch.where(in_coo, pos, torch.full_like(pos, coo_cap)).clamp(0, coo_cap)
    crow = torch.zeros((coo_cap + 1,), dtype=torch.int32, device=dev)
    ccol = torch.zeros((coo_cap + 1,), dtype=torch.int32, device=dev)
    cdat = torch.zeros((coo_cap + 1,), dtype=A.dtype, device=dev)
    crow[pos] = torch.where(in_coo, _i32(rows), zero_i)
    ccol[pos] = torch.where(in_coo, _i32(cols), zero_i)
    cdat[pos] = torch.where(in_coo, data, _zero(A))
    coo = COO(crow[:coo_cap], ccol[:coo_cap], cdat[:coo_cap], A.shape, coo_cap)
    return HYB(ell, coo, A.shape, A.nnz)


def coo_to_hyb(A: COO, k: Optional[int] = None) -> HYB:
    """COO -> HYB. Symbolic: split each row at k entries (planned; default
    k = median positive row length); numeric: scatters."""
    plan = plan_switch(A, Format.HYB, k=k)
    return _coo_to_hyb_exec(A, plan.ell_k, plan.hyb_coo_capacity)


def _coo_to_sell_exec(A: COO, plan: SwitchPlan) -> SELL:
    """SELL numeric phase: scatter into the flat column-major slice storage.
    Without ``plan.sell_perm`` the sigma-sort is re-derived on the device."""
    m, n = A.shape
    dev = A.device
    cs = int(plan.sell_c)
    ptrs_np = np.asarray(plan.sell_slice_ptrs, np.int32)
    nslices = len(ptrs_np) - 1
    cap = int(ptrs_np[-1])
    mp = nslices * cs
    rows, cols, data, slot, live = _row_slots(A)
    if plan.sell_perm is not None:
        perm = torch.tensor(list(plan.sell_perm), dtype=torch.int32, device=dev)
    else:
        counts = segment_sum(_i32(A.data != 0), A.row, m)
        perm = _sell_perm(counts, int(plan.sell_sigma), m)
    # sorted position of each original row; ghost lanes past M map to row M
    inv = torch.zeros((m,), dtype=torch.int32, device=dev)
    inv[perm.long()] = torch.arange(m, dtype=torch.int32, device=dev)
    perm_p = (torch.cat([perm, torch.full((mp - m,), m, dtype=torch.int32, device=dev)])
              if mp > m else perm)
    ptrs = torch.from_numpy(ptrs_np).to(dev)
    p = inv[rows.long()].long()
    sl = p // cs
    lane = p % cs
    width = (ptrs[sl + 1] - ptrs[sl]).long() // cs
    # a live entry whose within-row rank exceeds its slice cap can only mean
    # a stale plan: park it in the dropped guard slot at ``cap``.
    ok = live & (slot < width)
    pos = torch.where(ok, ptrs[sl].long() + slot * cs + lane,
                      torch.full_like(p, cap))
    neg1 = torch.full((), -1, dtype=torch.int32, device=dev)
    cols_flat = torch.full((cap + 1,), -1, dtype=torch.int32, device=dev)
    cols_flat[pos] = torch.where(ok, _i32(cols), neg1)
    data_flat = torch.zeros((cap + 1,), dtype=A.dtype, device=dev)
    data_flat.index_put_((pos,), torch.where(ok, data, _zero(A)), accumulate=True)
    return SELL(cols_flat[:cap].contiguous(), data_flat[:cap].contiguous(), perm_p,
                ptrs, A.shape, A.nnz, cs, int(plan.sell_sigma))


def coo_to_sell(A: COO, c: Optional[int] = None,
                sigma: Optional[int] = None) -> SELL:
    """COO -> SELL-C-sigma. Symbolic: sigma-window sort permutation and
    per-slice caps (planned); numeric: flat scatter."""
    plan = plan_switch(A, Format.SELL, c=c, sigma=sigma)
    return _coo_to_sell_exec(A, plan)


def coo_to_dense(A: COO) -> Dense:
    """COO -> Dense scatter-add."""
    m, n = A.shape
    out = torch.zeros((m, n), dtype=A.dtype, device=A.device)
    out.index_put_((A.row.long(), A.col.long()), A.data, accumulate=True)
    return Dense(out, A.shape, A.nnz)


def convert_execute(A, plan: SwitchPlan):
    """Numeric phase of the paper's convert(): any -> ``plan.target`` via
    the COO proxy, every shape taken from the plan; no device->host sync
    (Dense sources need ``plan.capacity``)."""
    fmt = Format(plan.target)
    C = to_coo(A, capacity=plan.capacity)
    if fmt == Format.COO:
        return C
    if fmt == Format.CSR:
        return coo_to_csr(C)
    if fmt == Format.ELL:
        return _coo_to_ell_exec(C, plan.ell_k)
    if fmt == Format.DIA:
        return _coo_to_dia_exec(C, plan.dia_offsets)
    if fmt == Format.BSR:
        return _coo_to_bsr_exec(C, plan)
    if fmt == Format.HYB:
        return _coo_to_hyb_exec(C, plan.ell_k, plan.hyb_coo_capacity)
    if fmt == Format.SELL:
        return _coo_to_sell_exec(C, plan)
    if fmt == Format.DENSE:
        return coo_to_dense(C)
    raise ValueError(f"unknown format {fmt}")


def convert(A, fmt: Format, plan: Optional[SwitchPlan] = None, **kwargs):
    """Element-wise conversion between any two formats via the COO proxy.

    With ``plan`` the call is the pure numeric phase. Without one, the
    symbolic hints in ``kwargs`` seed :func:`plan_switch`.
    """
    fmt = Format(fmt)
    if plan is not None:
        if not isinstance(plan, SwitchPlan):
            raise TypeError(f"plan must be a SwitchPlan, got {type(plan)}")
        if Format(plan.target) != fmt:
            raise ValueError(f"plan targets {Format(plan.target).name}, not {fmt.name}")
        return convert_execute(A, plan)
    if getattr(A, "format", None) == fmt and not kwargs:
        return A
    with _trace.span("convert.any", target=fmt.name):
        return convert_execute(A, plan_switch(A, fmt, **kwargs))


# ---------------------------------------------------------------------------
# Observability: plan/execute spans and padding-waste histograms
# ---------------------------------------------------------------------------
# The plan spans time host-side symbolic work (plan_switch); the execute
# span waits for the converted container in summary and full mode, so it
# times the numeric phase on the device (see obs.trace). The
# padding-waste histograms cost two divisions of host ints: every input
# (shape, nnz, plan fields) is host metadata, never device data.


def _observe_plan_waste(A, plan: SwitchPlan) -> None:
    try:
        m = int(A.shape[0])
        nnz = int(A.nnz)
    except (TypeError, AttributeError):  # inputs without nnz
        return
    if m <= 0:
        return
    if Format(plan.target) == Format.SELL and plan.sell_slice_ptrs:
        slots = int(plan.sell_slice_ptrs[-1])
        if slots > 0:
            _metrics.observe("sell.padding_waste", min(1.0, max(0.0, 1.0 - nnz / slots)))
        return
    if plan.ell_k is None:
        return
    slots = m * int(plan.ell_k)
    if slots <= 0:
        return
    if Format(plan.target) == Format.ELL:
        _metrics.observe("ell.padding_waste", min(1.0, max(0.0, 1.0 - nnz / slots)))
    elif Format(plan.target) == Format.HYB:
        # the ELL part's occupancy: nnz minus (at most) the planned COO
        # overflow capacity lands in the k-wide slots
        ell_nnz = max(0, nnz - int(plan.hyb_coo_capacity or 0))
        _metrics.observe("hyb.padding_waste", min(1.0, max(0.0, 1.0 - ell_nnz / slots)))


def _traced_plan(fn, name: str):
    @functools.wraps(fn)
    def wrapper(A, fmt, **kwargs):
        fmt = Format(fmt)
        with _trace.span(name, fmt=fmt.name) as sp:
            plan = fn(A, fmt, **kwargs)
            if plan.ell_k is not None:
                sp.set(ell_k=plan.ell_k)
            if plan.dia_offsets is not None:
                sp.set(n_offsets=len(plan.dia_offsets))
        _observe_plan_waste(A, plan)
        return plan
    return wrapper


def _container_tensors(C):
    """Every tensor of a container, nested containers (HYB's) opened."""
    for v in C.tensors().values():
        yield from (_container_tensors(v) if hasattr(v, "tensors") else (v,))


def _traced_execute(fn):
    @functools.wraps(fn)
    def wrapper(A, plan: SwitchPlan):
        # the span waits for the converted container, so it times the
        # conversion's execution, not its enqueue (no wait in off mode)
        with _trace.span("convert.execute", target=Format(plan.target).name) as sp:
            out = fn(A, plan)
            sp.sync(*_container_tensors(out))
        return out
    return wrapper


# Rebound, so internal callers (convert, coo_to_*, the tuning policy, the
# distributed and multigrid builders) all go through the instrumented
# entry points, as in the JAX package.
plan_switch = _traced_plan(plan_switch, "plan.switch")
plan_switch_batch = _traced_plan(plan_switch_batch, "plan.switch_batch")
convert_execute = _traced_execute(convert_execute)
