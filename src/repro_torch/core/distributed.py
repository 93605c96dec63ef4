"""Distributed dynamic sparse matrices (port of ``repro.core.distributed``).

The paper's MPI design (§V-E), as the JAX package maps it:

  * the global matrix is row-partitioned into P contiguous slabs;
  * each slab's rows split into a **local** square block (columns it owns)
    and a **remote** rectangular block (columns owned by neighbours), each
    an independently formatted dynamic matrix;
  * the local block optionally splits further into **interior** rows (no
    live remote entry) and **boundary** rows (the classic overlap split);
  * SpMV = interior SpMV + boundary SpMV + remote SpMV over halo values;
  * per-shard format selection ("Multi-Format") holds each part as a
    stacked ``SwitchDynamicMatrix`` with one format id per shard.

The plan/execute split carries over unchanged: ``plan_partition`` is one
host scan that emits a :class:`DistPlan` of static metadata (string-equal
JSON with the JAX package's, so plans cross both ways); ``partition_execute``
and ``split_local_execute`` scatter the triplets into stacked
uniform-capacity containers on the device with no device->host transfer;
conversion and selection are batched (``plan_switch_batch``,
``convert_execute_batch``, ``FormatPolicy.select_batch``).

How P shards run on one device. JAX runs them under ``shard_map`` on a
mesh; the port keeps all P shards in one process on one device (the
counterpart of the JAX package's host-simulated mesh):

  * every part is a stacked container (a leading P axis, one shared
    capacity), bitwise the arrays JAX's build produces; shard p's part is
    the container of the contiguous ``[p]`` slices, which the kernels take
    as they are;
  * a global vector of length M is P contiguous blocks of ``mp`` rows;
  * the halo exchange is one gather on the device from an index table
    built once per matrix: in ``neighbor`` mode shard p's halo is
    ``[x[p*mp-hw : p*mp] | x[(p+1)*mp : (p+1)*mp+hw]]``, with shard 0's
    first half and shard P-1's second half zero (``ppermute`` leaves slots
    with no source at zero); in ``gather`` mode the halo is x itself;
  * per-shard format ids are host ints, so picking a shard's variant
    reads no device tensor;
  * :func:`dist_spmv` issues the gather, then each shard's interior,
    boundary and remote SpMVs, in order on one stream. There is no
    collective to hide on one device: the split is kept for its structure
    and for parity with the reference.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import ops as _ops
from repro_torch.core.convert import (SwitchPlan, convert_execute_batch, part_of,
                                      plan_switch_batch, stack_parts)
from repro_torch.core.dynamic import SwitchDynamicMatrix
from repro_torch.core.formats import COO, Format
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import metrics as _metrics

__all__ = ["DistSparseMatrix", "DistPlan", "PartitionedCOO", "stack_parts",
           "plan_partition", "partition_execute", "split_local_execute",
           "plan_dist_formats", "partition_coo", "build_dist_matrix", "dist_spmv",
           "dist_spmv_phase", "distribute_vector", "activate_dist"]

PARTS = ("local", "boundary", "remote")


# ---------------------------------------------------------------------------
# The distributed container
# ---------------------------------------------------------------------------


class DistSparseMatrix:
    """Row-partitioned sparse matrix with a local/remote split per shard.

    ``local``/``remote`` (and ``boundary`` when split) are stacked
    containers, or stacked :class:`SwitchDynamicMatrix` unions in
    Multi-Format mode. ``halo_mode`` is ``"neighbor"`` (remote columns
    renumbered into a [prev_tail | next_head] halo of width ``hw`` per side)
    or ``"gather"`` (remote columns are global ids). ``remote_empty`` marks
    a block-diagonal partition: SpMV skips the exchange and the remote
    term. With the interior/boundary split, ``local`` holds the interior
    rows and ``boundary`` the rest of the local block; ``boundary is None``
    means unsplit. ``plan`` is the build's :class:`DistPlan` (pass it back
    to a rebuild and the symbolic work is skipped).

    The shard views each SpMV reads (``shard_parts``) and the halo's index
    table are made once, here.
    """

    def __init__(self, local, remote, *, nshards: int, mp: int, shape,
                 device: torch.device, halo_mode: str, hw: int,
                 remote_empty: bool = False, boundary=None,
                 plan: Optional["DistPlan"] = None):
        self.local = local
        self.remote = remote
        self.boundary = boundary
        self.nshards = nshards
        self.mp = mp
        self.shape = tuple(shape)
        self.device = torch.device(device)
        self.halo_mode = halo_mode
        self.hw = hw
        self.remote_empty = remote_empty
        self.plan = plan
        self.shard_parts = {name: tuple(_shard(getattr(self, name), p) for p in range(nshards))
                            for name in PARTS if getattr(self, name) is not None}
        self.halo_index = (_halo_index(nshards, mp, hw, self.device)
                           if halo_mode == "neighbor" and not remote_empty else None)

    @property
    def split(self) -> bool:
        """True when ``local`` is interior-only and ``boundary`` carries the
        halo-coupled rows."""
        return self.boundary is not None

    def formats(self, part: str) -> Tuple[str, ...]:
        """Each shard's active format name in ``part`` (host metadata)."""
        return tuple(Format(c.format).name for c in self.shard_parts[part])

    def _replace_parts(self, local, remote, boundary=None) -> "DistSparseMatrix":
        return DistSparseMatrix(
            local, remote, boundary=self.boundary if boundary is None else boundary,
            nshards=self.nshards, mp=self.mp, shape=self.shape, device=self.device,
            halo_mode=self.halo_mode, hw=self.hw, remote_empty=self.remote_empty,
            plan=self.plan)

    def __repr__(self):
        lf = type(self.local).__name__
        rf = type(self.remote).__name__
        halo = "empty" if self.remote_empty else f"{self.halo_mode}:{self.hw}"
        parts = f"local={lf}"
        if self.split:
            parts += f", boundary={type(self.boundary).__name__}"
        return (f"DistSparseMatrix(shape={self.shape}, P={self.nshards}, "
                f"{parts}, remote={rf}, halo={halo})")


def _shard(part, p: int):
    return part.part(p) if isinstance(part, SwitchDynamicMatrix) else part_of(part, p)


def _halo_index(nshards: int, mp: int, hw: int, device: torch.device) -> torch.Tensor:
    """Sources in x of the halo slots that have one, in shard order: in the
    flat ``(P * 2hw,)`` halo they fill ``[hw, P*2hw - hw)``, contiguously
    (only shard 0's first half and shard P-1's second half have no source)."""
    p = np.arange(nshards, dtype=np.int64)[:, None]
    k = np.arange(hw, dtype=np.int64)[None, :]
    idx = np.concatenate([p * mp - hw + k, (p + 1) * mp + k], axis=1).reshape(-1)
    return torch.from_numpy(idx[hw:idx.size - hw].copy()).to(device)


# ---------------------------------------------------------------------------
# Halo exchange and SpMV
# ---------------------------------------------------------------------------


def _halo(A: DistSparseMatrix, x: torch.Tensor) -> torch.Tensor:
    """The remote SpMV's input: ``(P, 2hw)`` in neighbor mode (zeros where
    a shard has no neighbour), x itself in gather mode."""
    if A.halo_mode == "gather":
        return x
    halo = x.new_zeros((A.nshards * 2 * A.hw,))
    torch.index_select(x, 0, A.halo_index, out=halo[A.hw:halo.numel() - A.hw])
    return halo.view(A.nshards, 2 * A.hw)


def _count_exchange(A: DistSparseMatrix, x: torch.Tensor) -> None:
    elems = 2 * A.hw if A.halo_mode == "neighbor" else A.shape[1]
    _metrics.inc("halo.bytes", A.nshards * elems * x.element_size())


def _remote_in(A: DistSparseMatrix, halo: torch.Tensor, p: int) -> torch.Tensor:
    return halo if A.halo_mode == "gather" else halo[p]


def _parts_spmv(A: DistSparseMatrix, x: torch.Tensor, names, backend, cfg) -> torch.Tensor:
    """``y = sum over the parts in names`` of each shard's SpMV (the remote
    part over the halo, gathered first), written into y's block p."""
    halo = None
    if "remote" in names:
        _count_exchange(A, x)
        halo = _halo(A, x)
    xb = x.view(A.nshards, A.mp)
    y = torch.empty((A.nshards, A.mp), dtype=x.dtype, device=x.device)
    for p in range(A.nshards):
        terms = [_ops.spmv(A.shard_parts[n][p],
                           _remote_in(A, halo, p) if n == "remote" else xb[p],
                           backend=backend, cfg=cfg) for n in names]
        _sum_into(terms, y[p])
    return y.view(-1)


def _sum_into(terms, out: torch.Tensor) -> None:
    """``out = ((t0 + t1) + t2)``, left to right as the reference sums."""
    if len(terms) == 1:
        out.copy_(terms[0])
        return
    acc = terms[0]
    for t in terms[1:-1]:
        acc = acc + t
    torch.add(acc, terms[-1], out=out)


def dist_spmv(A: DistSparseMatrix, x: torch.Tensor, backend: Optional[str] = None,
              cfg: Optional[dict] = None) -> torch.Tensor:
    """Global SpMV ``y = A x`` for a global vector ``x`` of length M.

    The halo gather comes first, then per shard the interior (``local``),
    boundary and remote SpMVs; shard p's sum is written into ``y``'s block
    p. ``backend``/``cfg`` reach every shard's SpMV (``core.ops.spmv``:
    ``None`` runs the kernels on CUDA tensors). No device->host sync.
    """
    names = ("local", "boundary") if A.split else ("local",)
    return _parts_spmv(A, x, names if A.remote_empty else names + ("remote",), backend, cfg)


PHASES = ("full", "local", "exchange", "interior", "boundary")


def dist_spmv_phase(A: DistSparseMatrix, x: torch.Tensor, phase: str = "full",
                    backend: Optional[str] = None, cfg: Optional[dict] = None) -> torch.Tensor:
    """One phase of the distributed SpMV (the overlap diagnostic):
    ``"full"`` (:func:`dist_spmv`), ``"local"`` (interior + boundary, no
    exchange), ``"exchange"`` (halo exchange + remote SpMV), ``"interior"``
    and ``"boundary"`` (split matrices). ``local + exchange == full``."""
    if phase == "full":
        return dist_spmv(A, x, backend=backend, cfg=cfg)
    if phase not in PHASES:
        raise ValueError(f"phase {phase!r} not in {PHASES}")
    if phase in ("interior", "boundary") and not A.split:
        raise ValueError(f"phase {phase!r} needs a split matrix "
                         "(build_dist_matrix(split=True))")
    if phase == "exchange" and A.remote_empty:
        return torch.zeros_like(x)
    names = {"interior": ("local",), "boundary": ("boundary",), "exchange": ("remote",),
             "local": ("local", "boundary") if A.split else ("local",)}[phase]
    return _parts_spmv(A, x, names, backend, cfg)


def distribute_vector(x, device: DeviceLike = None, dtype: Optional[torch.dtype] = None):
    """A global vector (numpy or tensor) on ``device`` (``None``: the card).
    All P blocks live on one device: nothing is sharded."""
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    return t.to(device=resolve_device(device), dtype=dtype).contiguous()


# ---------------------------------------------------------------------------
# The partition plan (symbolic phase: static host metadata only)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DistPlan:
    """Static metadata of a slab partition: the distributed symbolic phase.

    Same fields and JSON as the JAX package's ``DistPlan``.
    ``local_plans``/``remote_plans`` (``interior_plans``/``boundary_plans``
    when split) memoise the per-candidate :class:`SwitchPlan` s of a
    Multi-Format build, valid for the live pattern ``pattern_sig``.
    """

    nshards: int
    mp: int                       # rows per slab
    hw: int                       # halo width per side (0: remote empty)
    halo_mode: str                # "neighbor" | "gather"
    shape: Tuple[int, int]
    local_cap: int                # shared local COO capacity across shards
    remote_cap: int               # shared remote COO capacity across shards
    remote_empty: bool = False
    candidates: Optional[Tuple[Format, ...]] = None
    local_plans: Optional[Tuple[SwitchPlan, ...]] = None
    remote_plans: Optional[Tuple[SwitchPlan, ...]] = None
    pattern_sig: Optional[str] = None
    interior_cap: Optional[int] = None
    boundary_cap: Optional[int] = None
    interior_plans: Optional[Tuple[SwitchPlan, ...]] = None
    boundary_plans: Optional[Tuple[SwitchPlan, ...]] = None

    @property
    def remote_width(self) -> int:
        if self.remote_empty:
            return 1  # inert 1-column placeholder part
        return 2 * self.hw if self.halo_mode == "neighbor" else self.shape[1]

    @property
    def local_shape(self) -> Tuple[int, int]:
        return (self.mp, self.mp)

    @property
    def remote_shape(self) -> Tuple[int, int]:
        return (self.mp, self.remote_width)

    def to_json(self) -> str:
        """The whole plan as one JSON string (the ``distplan:`` record)."""
        doc = {"nshards": self.nshards, "mp": self.mp, "hw": self.hw,
               "halo_mode": self.halo_mode, "shape": list(self.shape),
               "local_cap": self.local_cap, "remote_cap": self.remote_cap,
               "remote_empty": self.remote_empty,
               "pattern_sig": self.pattern_sig,
               "interior_cap": self.interior_cap,
               "boundary_cap": self.boundary_cap}
        if self.candidates is not None:
            doc["candidates"] = [Format(f).name for f in self.candidates]
        for name in _PLAN_LISTS:
            plans = getattr(self, name)
            if plans is not None:
                doc[name] = [p.to_json() for p in plans]
        return json.dumps(doc, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "DistPlan":
        doc = json.loads(s)
        kw = {k: doc[k] for k in ("nshards", "mp", "hw", "halo_mode",
                                  "local_cap", "remote_cap", "remote_empty",
                                  "pattern_sig", "interior_cap",
                                  "boundary_cap")}
        kw["shape"] = tuple(doc["shape"])
        if "candidates" in doc:
            kw["candidates"] = tuple(Format[n] for n in doc["candidates"])
        for name in _PLAN_LISTS:
            if name in doc:
                kw[name] = tuple(SwitchPlan.from_json(p) for p in doc[name])
        return cls(**kw)


_PLAN_LISTS = ("local_plans", "remote_plans", "interior_plans", "boundary_plans")


def _bare(plan: DistPlan) -> DistPlan:
    """``plan`` without its memoised format plans and fingerprint."""
    return dataclasses.replace(plan, candidates=None, pattern_sig=None,
                               **{n: None for n in _PLAN_LISTS})


def _slab_masks(row: np.ndarray, col: np.ndarray, mp: int):
    shard = row // mp
    local_mask = (col // mp) == shard
    return shard, local_mask


def _reach(row, col, mp: int) -> int:
    """Largest distance of a remote column beyond its row's slab."""
    shard, local_mask = _slab_masks(row, col, mp)
    remote = ~local_mask
    lo = np.where(remote, shard * mp - col, 0).max(initial=0)
    hi = np.where(remote, col - ((shard + 1) * mp - 1), 0).max(initial=0)
    return int(max(lo, hi))


def plan_partition(row, col, val, shape, nshards: int,
                   halo_mode: str = "auto") -> DistPlan:
    """Symbolic phase of the slab partitioner: one vectorised host scan.

    Rows split into ``nshards`` equal slabs (M must divide evenly). Halo
    mode ``auto``: ``neighbor`` when every remote column lies within one
    slab-width of its slab (stencil matrices), else ``gather``; a
    block-diagonal matrix gets ``hw=0`` and an empty remote part.
    """
    m, n = shape
    if nshards <= 0 or m % nshards or m != n:
        raise ValueError(
            f"square matrix with M % P == 0 required, got {shape} / {nshards}")
    mp = m // nshards
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    shard, local_mask = _slab_masks(row, col, mp)
    remote_empty = not bool((~local_mask).any())
    reach = _reach(row, col, mp)
    if halo_mode == "auto":
        halo_mode = "neighbor" if reach <= mp else "gather"
    if halo_mode == "neighbor":
        if reach > mp:
            raise ValueError("neighbor halo violated; use halo_mode='gather'")
        hw = 0 if remote_empty else max(1, reach)
    elif halo_mode == "gather":
        hw = 0 if remote_empty else mp
    else:
        raise ValueError(halo_mode)
    lcounts = np.bincount(shard[local_mask], minlength=nshards)
    rcounts = np.bincount(shard[~local_mask], minlength=nshards)
    return DistPlan(nshards=nshards, mp=mp, hw=hw, halo_mode=halo_mode,
                    shape=(m, n), local_cap=max(1, int(lcounts.max())),
                    remote_cap=max(1, int(rcounts.max())),
                    remote_empty=remote_empty)


def _tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def _scatter_slots(select: torch.Tensor, rank: torch.Tensor, base: torch.Tensor,
                   cap: int, total: int, fields) -> list:
    """Entries with ``select`` and ``rank < cap`` land at ``base + rank``;
    every other entry goes to one guard slot past ``total``, written with
    zeros and cut off (so which duplicate lands there does not matter)."""
    ok = select & (rank < cap)
    dest = torch.where(ok, base + rank, torch.full_like(rank, total)).long()
    out = []
    for x in fields:
        buf = torch.zeros((total + 1,), dtype=x.dtype, device=x.device)
        buf[dest] = torch.where(ok, x, torch.zeros((), dtype=x.dtype, device=x.device))
        out.append(buf[:total])
    return out


def partition_execute(row, col, val, plan: DistPlan, dtype: torch.dtype = torch.float32,
                      device: DeviceLike = None) -> Tuple[COO, COO]:
    """Numeric phase of the slab partitioner: stacked ``(P, cap)`` local and
    remote COO parts on ``device``.

    One stable argsort over the global triplets orders entries by
    (shard, local/remote); a rank-within-group scatter drops every entry
    into its slot. Local columns are renumbered shard-relative, remote
    columns halo-relative (neighbor mode) or kept global (gather mode). No
    device->host transfer.
    """
    dev = resolve_device(device)
    nshards, mp, hw = plan.nshards, plan.mp, plan.hw
    row = _tensor(row, torch.int32, dev)
    col = _tensor(col, torch.int32, dev)
    val = _tensor(val, dtype, dev)
    nent = row.shape[0]

    shard = torch.div(row, mp, rounding_mode="floor")
    is_remote = torch.div(col, mp, rounding_mode="floor") != shard
    key = shard * 2 + is_remote.to(torch.int32)
    order = torch.argsort(key, stable=True)
    k_s, r_s, c_s, v_s = key[order], row[order], col[order], val[order]
    counts = _ops.segment_sum(torch.ones_like(key), key, 2 * nshards)
    starts = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)
    rank = torch.arange(nent, dtype=torch.int32, device=dev) - starts[k_s.long()]
    p = torch.div(k_s, 2, rounding_mode="floor")
    rem = (k_s % 2) == 1

    lrow = r_s - p * mp
    lcol = c_s - p * mp
    if plan.halo_mode == "neighbor" and not plan.remote_empty:
        below = c_s < p * mp
        rcol = torch.where(below, c_s - (p * mp - hw), hw + (c_s - (p + 1) * mp))
    else:
        rcol = c_s

    def scatter(select, cap, cols):
        out = _scatter_slots(select, rank, p * cap, cap, nshards * cap, (lrow, cols, v_s))
        return [t.view(nshards, cap) for t in out]

    lr, lc, lv = scatter(~rem, plan.local_cap, lcol)
    rr, rc, rv = scatter(rem, plan.remote_cap, rcol)
    return (COO(lr, lc, lv, plan.local_shape, plan.local_cap),
            COO(rr, rc, rv, plan.remote_shape, plan.remote_cap))


# ---------------------------------------------------------------------------
# Interior/boundary split of the local block
# ---------------------------------------------------------------------------


def _split_caps(row, col, val, mp: int, nshards: int) -> Tuple[int, int]:
    """Shared (interior, boundary) capacities: one vectorised host scan
    over the live entries. A row is *boundary* when it has a live remote
    entry."""
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    live = np.asarray(val) != 0
    shard, local_mask = _slab_masks(row, col, mp)
    brow = np.zeros((mp * nshards,), bool)
    brow[row[live & ~local_mask]] = True
    loc_live = live & local_mask
    is_b = brow[row] & loc_live
    icounts = np.bincount(shard[loc_live & ~is_b], minlength=nshards)
    bcounts = np.bincount(shard[is_b], minlength=nshards)
    return (max(1, int(icounts.max(initial=0))),
            max(1, int(bcounts.max(initial=0))))


def split_local_execute(local: COO, remote: COO, mp: int, icap: int,
                        bcap: int) -> Tuple[COO, COO]:
    """Numeric phase of the overlap split: per shard, rows with a live
    remote entry are flagged (a count over the remote triplets, so the
    capacity padding, row 0 value 0, flags nothing), then every live local
    entry lands in the interior or boundary container by a rank-within-mask
    scatter. Dead entries are dropped; both outputs keep the (mp, mp)
    shape. No device->host transfer."""
    nshards = local.data.shape[0]
    dev = local.device
    shard_base = torch.arange(nshards, dtype=torch.int64, device=dev)[:, None]
    flags = _ops.segment_sum((remote.data != 0).to(torch.int32).reshape(-1),
                             (remote.row.long() + shard_base * mp).reshape(-1), nshards * mp)
    bflag = (flags > 0).view(nshards, mp)
    on_b = torch.gather(bflag, 1, local.row.long())
    live = local.data != 0
    out = []
    for mask, cap in (((~on_b) & live, icap), (on_b & live, bcap)):
        rank = mask.to(torch.int64).cumsum(dim=1) - 1
        r, c, v = _scatter_slots(mask.reshape(-1), rank.reshape(-1),
                                 (shard_base * cap).expand_as(rank).reshape(-1), cap,
                                 nshards * cap,
                                 (local.row.reshape(-1), local.col.reshape(-1),
                                  local.data.reshape(-1)))
        out.append(COO(r.view(nshards, cap), c.view(nshards, cap), v.view(nshards, cap),
                       (mp, mp), cap))
    return out[0], out[1]


def plan_dist_formats(local: COO, remote: COO, plan: DistPlan,
                      candidates: Sequence[Format],
                      boundary: Optional[COO] = None) -> DistPlan:
    """Attach the per-candidate :class:`SwitchPlan` s to a plan: one
    :func:`plan_switch_batch` per candidate and part; a plan that already
    carries them is returned unchanged. With ``boundary`` (the split),
    ``local`` is the interior part and the plan memoises
    ``interior_plans``/``boundary_plans``."""
    candidates = tuple(Format(c) for c in candidates)
    if boundary is None:
        if plan.candidates == candidates and plan.local_plans is not None:
            return plan
        return dataclasses.replace(
            plan, candidates=candidates,
            local_plans=tuple(plan_switch_batch(local, f) for f in candidates),
            remote_plans=tuple(plan_switch_batch(remote, f) for f in candidates))
    if plan.candidates == candidates and plan.interior_plans is not None:
        return plan
    return dataclasses.replace(
        plan, candidates=candidates,
        interior_plans=tuple(plan_switch_batch(local, f) for f in candidates),
        boundary_plans=tuple(plan_switch_batch(boundary, f) for f in candidates),
        remote_plans=tuple(plan_switch_batch(remote, f) for f in candidates))


def _pattern_sig(row, col, val) -> str:
    """sha1 of the *live* pattern's int64 rows then columns: the JAX
    package's fingerprint, digest for digest."""
    live = np.asarray(val) != 0
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(np.asarray(row, np.int64)[live]).tobytes())
    h.update(np.ascontiguousarray(np.asarray(col, np.int64)[live]).tobytes())
    return h.hexdigest()


def _check_plan_fits(row, col, plan: DistPlan, val=None) -> None:
    """Raise if a reused plan no longer fits the triplets (capacities, split
    capacities with ``val``, remote-empty, halo reach): the guard-slot
    scatters would otherwise drop entries silently."""
    if val is not None and plan.interior_cap is not None:
        icap, bcap = _split_caps(row, col, val, plan.mp, plan.nshards)
        if icap > plan.interior_cap or bcap > plan.boundary_cap:
            raise ValueError(
                f"stale DistPlan: split capacities (interior "
                f"{plan.interior_cap}, boundary {plan.boundary_cap}) too "
                f"small for these triplets (need {icap}/{bcap}); re-plan "
                f"with plan_partition")
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    shard, local_mask = _slab_masks(row, col, plan.mp)
    lmax = int(np.bincount(shard[local_mask], minlength=plan.nshards).max(initial=0))
    rmax = int(np.bincount(shard[~local_mask], minlength=plan.nshards).max(initial=0))
    if lmax > plan.local_cap or rmax > plan.remote_cap:
        raise ValueError(
            f"stale DistPlan: capacities (local {plan.local_cap}, remote "
            f"{plan.remote_cap}) too small for these triplets (need "
            f"{lmax}/{rmax}); re-plan with plan_partition")
    if rmax and plan.remote_empty:
        raise ValueError("stale DistPlan: marked remote-empty but the "
                         "triplets have remote entries; re-plan")
    if plan.halo_mode == "neighbor" and not plan.remote_empty:
        reach = _reach(row, col, plan.mp)
        if reach > plan.hw:
            raise ValueError(
                f"stale DistPlan: halo width {plan.hw} smaller than the "
                f"triplets' reach {reach}; re-plan")


# ---------------------------------------------------------------------------
# Host partitioner (the easy-to-inspect oracle)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PartitionedCOO:
    """Host-side per-shard COO triplets: the per-shard loop counterpart of
    :func:`partition_execute`, kept as the oracle."""

    local: list   # [(row, col, val)] per shard, columns shard-local
    remote: list  # [(row, col, val)] per shard, columns halo-renumbered
    mp: int
    hw: int
    halo_mode: str
    shape: Tuple[int, int]
    remote_empty: bool = False


def partition_coo(row, col, val, shape, nshards: int,
                  halo_mode: str = "auto") -> PartitionedCOO:
    """Split global COO triplets into per-shard local/remote host triplets."""
    plan = plan_partition(row, col, val, shape, nshards, halo_mode=halo_mode)
    mp, hw = plan.mp, plan.hw
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    val = np.asarray(val)
    shard, local_mask = _slab_masks(row, col, mp)
    locals_, remotes = [], []
    for p in range(nshards):
        in_shard = shard == p
        lm = in_shard & local_mask
        rm = in_shard & ~local_mask
        locals_.append((row[lm] - p * mp, col[lm] - p * mp, val[lm]))
        rr = row[rm] - p * mp
        gc = col[rm]
        if plan.halo_mode == "neighbor" and not plan.remote_empty:
            start, end = p * mp, (p + 1) * mp
            rc = np.where(gc < start, gc - (start - hw), hw + (gc - end))
        else:
            rc = gc
        remotes.append((rr, rc, val[rm]))
    return PartitionedCOO(locals_, remotes, mp, hw, plan.halo_mode, plan.shape,
                          remote_empty=plan.remote_empty)


# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------


def _policy(tune, candidates: Tuple[Format, ...]):
    from repro_torch.tuning.policy import FormatPolicy  # lazy: tuning imports core
    if isinstance(tune, FormatPolicy):
        if not set(tune.candidates) <= set(candidates):
            raise ValueError(
                f"tune policy candidates {[f.name for f in tune.candidates]} "
                f"must be a subset of the build candidates "
                f"{[f.name for f in candidates]}: every pick has "
                f"to map onto a resident union variant")
        return tune
    mode = "profile" if tune == "calibrated" else tune
    return FormatPolicy(mode, candidates=candidates, profile_iters=3)


def build_dist_matrix(row, col, val, shape, nshards: int, *,
                      device: DeviceLike = None,
                      local_format: Format = Format.CSR,
                      remote_format: Format = Format.CSR,
                      mode: str = "uniform",
                      candidates: Sequence[Format] = (Format.COO, Format.CSR, Format.DIA,
                                                      Format.ELL, Format.SELL),
                      tune="calibrated",
                      halo_mode: str = "auto",
                      dtype: torch.dtype = torch.float32,
                      plan: Optional[DistPlan] = None,
                      check_plan: bool = True,
                      parts: Optional[Tuple[COO, COO]] = None,
                      split: Union[str, bool] = "auto",
                      plan_cache=None) -> DistSparseMatrix:
    """Build a distributed dynamic matrix of ``nshards`` row slabs on
    ``device`` (``None``: the card; raises without one).

    ``mode="uniform"``: every shard's local (interior and boundary) part in
    ``local_format``, its remote part in ``remote_format``.
    ``mode="multiformat"``: every candidate built for every part, and each
    shard's active format picked by ``tune`` (a ``FormatPolicy`` mode,
    ``"calibrated"`` = ``"profile"``, or a policy whose candidates are a
    subset of ``candidates``) from one ``select_batch`` pass a part.

    ``plan``: a :class:`DistPlan` to reuse (``check_plan`` scans the
    triplets for staleness first, and memoised format plans of another live
    pattern are dropped: counter ``replan.pattern_sig``). ``parts``: the
    stacked ``(local, remote)`` COO pair already partitioned from the same
    plan (``hpcg.partition_problem``). ``split``: the interior/boundary
    split (``"auto"``: exactly when there is a halo). ``plan_cache``: a
    ``SelectionCache`` holding the enriched plan under
    ``distplan:{sig}|{m}x{n}|P{P}|{halo_mode}`` (the JAX package's key),
    consulted when ``plan`` is None (``distplan.cache_hit``/``_miss``).
    """
    dev = resolve_device(device)
    cache_key = None
    if plan is None and plan_cache is not None:
        sig = _pattern_sig(row, col, val)
        m, n = shape
        cache_key = f"distplan:{sig}|{m}x{n}|P{nshards}|{halo_mode}"
        rec = plan_cache.get_raw(cache_key)
        if rec is not None:
            try:
                plan = DistPlan.from_json(rec)
            except (KeyError, ValueError):
                plan = None  # unreadable or old record: plan anew
        _metrics.inc("distplan.cache_hit" if plan is not None else "distplan.cache_miss")

    if plan is None:
        plan = plan_partition(row, col, val, shape, nshards, halo_mode=halo_mode)
    else:
        if plan.nshards != nshards or plan.shape != tuple(shape):
            raise ValueError(f"plan is for P={plan.nshards} shape={plan.shape}, "
                             f"build asked for P={nshards} shape={tuple(shape)}")
        if check_plan:
            _check_plan_fits(row, col, plan, val=val)
            if ((plan.local_plans is not None or plan.interior_plans is not None)
                    and plan.pattern_sig != _pattern_sig(row, col, val)):
                _metrics.inc("replan.pattern_sig")  # the memoised plans are void
                plan = _bare(plan)
    if split == "auto":
        split = not plan.remote_empty
    if split and plan.interior_cap is None:
        icap, bcap = _split_caps(row, col, val, plan.mp, plan.nshards)
        plan = dataclasses.replace(plan, interior_cap=icap, boundary_cap=bcap)
    if parts is not None:
        lcoos, rcoos = parts
        if lcoos.shape != plan.local_shape or rcoos.shape != plan.remote_shape:
            raise ValueError(
                f"parts shapes {lcoos.shape}/{rcoos.shape} do not match the "
                f"plan's {plan.local_shape}/{plan.remote_shape}")
    else:
        lcoos, rcoos = partition_execute(row, col, val, plan, dtype=dtype, device=dev)

    bcoos = None
    if split:
        lcoos, bcoos = split_local_execute(lcoos, rcoos, plan.mp, plan.interior_cap,
                                           plan.boundary_cap)

    boundary = None
    if mode == "uniform":
        def uniform(C, fmt):
            return convert_execute_batch(C, plan_switch_batch(C, Format(fmt)))
        local = uniform(lcoos, local_format)
        if bcoos is not None:
            boundary = uniform(bcoos, local_format)
        remote = uniform(rcoos, remote_format)
    elif mode == "multiformat":
        candidates = tuple(Format(c) for c in candidates)
        policy = _policy(tune, candidates)
        plan = plan_dist_formats(lcoos, rcoos, plan, candidates, boundary=bcoos)
        if plan.pattern_sig is None:
            plan = dataclasses.replace(plan, pattern_sig=_pattern_sig(row, col, val))
        # policy-candidate indices -> build-candidate (variant) indices
        remap = np.asarray([candidates.index(f) for f in policy.candidates], np.int32)

        def union(C, plans):
            return SwitchDynamicMatrix.build_batched(
                C, candidates, plans=plans, active_ids=remap[policy.select_batch(C)])
        local = union(lcoos, plan.interior_plans if split else plan.local_plans)
        if bcoos is not None:
            boundary = union(bcoos, plan.boundary_plans)
        remote = union(rcoos, plan.remote_plans)
    else:
        raise ValueError(mode)

    if cache_key is not None:
        if plan.pattern_sig is None:
            plan = dataclasses.replace(plan, pattern_sig=sig)
        plan_cache.put_raw(cache_key, plan.to_json())
    return DistSparseMatrix(local, remote, boundary=boundary, nshards=nshards,
                            mp=plan.mp, shape=shape, device=dev,
                            halo_mode=plan.halo_mode, hw=plan.hw,
                            remote_empty=plan.remote_empty, plan=plan)


def activate_dist(A: DistSparseMatrix, part: str, fmt_or_ids) -> DistSparseMatrix:
    """Run-time format switch of the local, boundary or remote part of a
    Multi-Format matrix (paper ``activate()``): a ``Format`` for every
    shard, or candidate indices (a scalar broadcasts, else one per shard)."""
    if part not in PARTS:
        raise ValueError(f"part {part!r} not in {PARTS}")
    if part == "boundary" and not A.split:
        raise ValueError("matrix has no boundary part "
                         "(build_dist_matrix(split=True))")
    tgt = getattr(A, part)
    if not isinstance(tgt, SwitchDynamicMatrix):
        raise TypeError("uniform-mode parts switch via build (conversion); "
                        "use mode='multiformat' for runtime switching")
    new = (tgt.activate(fmt_or_ids) if isinstance(fmt_or_ids, Format)
           else tgt.activate_id(fmt_or_ids))
    if part == "local":
        return A._replace_parts(new, A.remote)
    if part == "boundary":
        return A._replace_parts(A.local, A.remote, boundary=new)
    return A._replace_parts(A.local, new)
