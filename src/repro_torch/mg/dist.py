"""Distributed MG-PCG: per-level slab partitions (port of ``repro.mg.dist``).

Every level of the geometric hierarchy is an independent HPCG stencil
system, so every level gets its own analytic ``DistPlan`` from
``hpcg.slab_plan`` (z-slab partition, correct by construction:
``check_plan=False``) and its own ``build_dist_matrix``, including
``mode="multiformat"``, where the tuning policy picks each level's
per-shard formats.

The smoother is the distributed adaptation of HPCG's SymGS: halo values
are exchanged once per sweep and *frozen* during it (block-Jacobi across
shards, colored symmetric Gauss-Seidel within each shard's local block).
Folding the frozen halo term into the right-hand side
(``b_eff = b - A_remote x_halo``, skipped on a first sweep from zero)
leaves per shard the single-device colored sweep over the local block.
Grid transfers are injection, and z-slabs align across levels (fine z =
2 * coarse z lies in the same shard), so restriction and prolongation are
shard-local.

Differences from the JAX package: all P shards live on one device (as in
``core.distributed``). Every shard's slab has the same geometry, so a
color's live rows are shared: a color update issues one SpMV a shard, then
gathers, divides and adds for all shards at once (``(P, rows)`` tensors),
and adds only the live rows (JAX scatters every lane and drops the padded
ones); the rows of the diagonal are gathered once at build time. With a
``smoother_policy`` a color's stacked union holds the formats that some
shard picked, not every candidate (a color block in DIA stores one
diagonal per row of the block). No cycle syncs with the host. The JAX
package's spans carry over: ``build.mg_dist_level`` a level at build time
and, while tracing is on, ``mg.vcycle_dist`` a level on every cycle.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import ops as _ops
from repro_torch.core.convert import (_planned_pull, convert_execute_batch, part_of,
                                      plan_switch_batch)
from repro_torch.core.distributed import (DistSparseMatrix, _halo, _remote_in,
                                          _shard, build_dist_matrix, dist_spmv)
from repro_torch.core.dynamic import DEFAULT_CANDIDATES, SwitchDynamicMatrix
from repro_torch.core.formats import COO, Format
from repro_torch.core.hpcg import HPCGProblem, generate_problem, partition_problem
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.mg.coarsen import f2c_map, plan_coarsen
from repro_torch.mg.cycle import MIN_COARSE_ROWS
from repro_torch.mg.smoothers import (NCOLORS, _split_colors_device, color_grid,
                                      color_ranks, color_rows_padded)
from repro_torch.obs import trace as _trace


@dataclasses.dataclass(frozen=True)
class DistColoredSystem:
    """Stacked per-shard color split of the local blocks.

    ``blocks[c]`` is a stacked ``(P, ...)`` container (or stacked union) of
    shape ``(rmax, mp)``; ``shard_blocks[c][p]`` shard p's block. Every
    slab has one geometry, so a color's rows are shared: ``live_rows[c]``
    (int64, on the device); ``diag_rows[c]`` is ``(P, rows)``, the local
    diagonal at those rows (1 where it is 0).
    """

    blocks: Tuple
    shard_blocks: Tuple[Tuple, ...]
    live_rows: Tuple[torch.Tensor, ...]
    diag_rows: Tuple[torch.Tensor, ...]

    @property
    def formats(self):
        return [[f.name for f in b.candidates] if isinstance(b, SwitchDynamicMatrix)
                else Format(b.format).name for b in self.blocks]


@dataclasses.dataclass(frozen=True)
class DistMGLevel:
    A: DistSparseMatrix
    colored: DistColoredSystem
    f2c_local: Optional[torch.Tensor]   # (mp_coarse,) int64; None on the coarsest
    dims: Tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class DistMGHierarchy:
    levels: Tuple[DistMGLevel, ...]
    pre: int = 1
    post: int = 1
    coarse_sweeps: int = 4
    backend: Optional[str] = None

    @property
    def nlevels(self) -> int:
        return len(self.levels)

    @property
    def nshards(self) -> int:
        return self.levels[0].A.nshards

    def apply_M(self) -> Callable:
        return lambda r: v_cycle_dist(self, r)

    def formats(self):
        """Per level: dims, the smoother's color-block formats and each part
        of A (per-shard active formats of a Multi-Format part)."""
        out = []
        for i, lev in enumerate(self.levels):
            rec = {"level": i, "dims": lev.dims, "colors": lev.colored.formats}
            for part in (("local", "boundary", "remote") if lev.A.split
                         else ("local", "remote")):
                t = getattr(lev.A, part)
                rec[part] = (list(lev.A.formats(part)) if isinstance(t, SwitchDynamicMatrix)
                             else Format(t.format).name)
            out.append(rec)
        return out

    def __repr__(self):
        dims = " > ".join("x".join(map(str, lev.dims)) for lev in self.levels)
        return (f"DistMGHierarchy({dims}; P={self.nshards}, "
                f"pre={self.pre}, post={self.post})")


# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------


def _diag_batched(local: COO) -> torch.Tensor:
    """(P, mp) local-block diagonal in one device pass."""
    nshards = local.data.shape[0]
    mp = local.shape[0]
    on = local.row == local.col
    vals = torch.where(on, local.data, torch.zeros((), dtype=local.dtype, device=local.device))
    ids = local.row.long() + torch.arange(nshards, device=local.device)[:, None] * mp
    return _ops.segment_sum(vals.reshape(-1), ids.reshape(-1), nshards * mp).view(nshards, mp)


def _build_dist_colored(local: COO, slab_dims, fmt: Format = Format.CSR, policy=None,
                        candidates: Sequence[Format] = DEFAULT_CANDIDATES
                        ) -> DistColoredSystem:
    """Color-split every shard's local block with one shared capacity (one
    planned pull), then per color one batched conversion (``fmt``) or, with
    a ``FormatPolicy``, one ``select_batch`` pass and a stacked union."""
    nshards = local.data.shape[0]
    mp = local.shape[0]
    dev = local.device
    colors = color_grid(*slab_dims)
    counts = np.bincount(colors, minlength=NCOLORS)
    rmax = max(1, int(counts.max()))
    colors_d = torch.from_numpy(colors.astype(np.int64)).to(dev)
    rank_d = torch.from_numpy(color_ranks(colors)).to(dev)

    key = torch.where(local.data != 0, colors_d[local.row.long()],
                      torch.full((), NCOLORS, dtype=torch.int64, device=dev))
    ids = key + torch.arange(nshards, device=dev)[:, None] * (NCOLORS + 1)
    ecnt = _ops.segment_sum(torch.ones_like(ids).reshape(-1), ids.reshape(-1),
                            nshards * (NCOLORS + 1)).view(nshards, NCOLORS + 1)
    cap = max(1, int(_planned_pull(ecnt[:, :NCOLORS].max())))

    planes = [_split_colors_device(part_of(local, p), colors_d, rank_d, cap)
              for p in range(nshards)]
    rr, cc, vv = (torch.stack([pl[i] for pl in planes]) for i in range(3))  # (P, 8, cap)

    blocks = []
    for c in range(NCOLORS):
        Cc = COO(rr[:, c].contiguous(), cc[:, c].contiguous(), vv[:, c].contiguous(),
                 (rmax, mp), cap)
        if policy is not None:
            picks = [policy.candidates[i] for i in policy.select_batch(Cc)]
            held = tuple(f for f in candidates if f in picks)
            blk = SwitchDynamicMatrix.build_batched(
                Cc, candidates=held, active_ids=[held.index(f) for f in picks])
        else:
            blk = convert_execute_batch(Cc, plan_switch_batch(Cc, Format(fmt)))
        blocks.append(blk)
    rows_np = color_rows_padded(colors, mp, rmax)
    diag = _diag_batched(local)
    one = torch.ones((), dtype=diag.dtype, device=dev)
    live_rows, diag_rows = [], []
    for c in range(NCOLORS):
        lr = torch.from_numpy(rows_np[c, :counts[c]].astype(np.int64)).to(dev)
        dc = diag.index_select(1, lr)
        live_rows.append(lr)
        diag_rows.append(torch.where(dc != 0, dc, one))
    shard_blocks = tuple(tuple(_shard(b, p) for p in range(nshards)) for b in blocks)
    return DistColoredSystem(tuple(blocks), shard_blocks, tuple(live_rows), tuple(diag_rows))


def build_dist_hierarchy(prob: HPCGProblem, nshards: int, *,
                         device: DeviceLike = None,
                         nlevels: Optional[int] = None,
                         mode: str = "uniform",
                         tune="cached",
                         local_format: Format = Format.DIA,
                         remote_format: Format = Format.COO,
                         candidates: Sequence[Format] = DEFAULT_CANDIDATES,
                         smoother_format: Format = Format.CSR,
                         smoother_policy=None,
                         pre: int = 1, post: int = 1, coarse_sweeps: int = 4,
                         backend: Optional[str] = None,
                         dtype: torch.dtype = torch.float32) -> DistMGHierarchy:
    """Per-level slab-partitioned hierarchy of ``nshards`` shards on
    ``device`` (``None``: the card).

    Coarsening continues while the grid dims stay even, the coarse slab
    height divides the shard count (``(nz/2) % P == 0``, so each level's
    ``slab_plan`` exists) and the coarse level keeps at least
    ``MIN_COARSE_ROWS`` rows (or until ``nlevels``). ``mode``/``tune``/
    ``*_format`` reach every level's ``build_dist_matrix``;
    ``smoother_policy`` picks each (shard, color) block's format.
    """
    dev = resolve_device(device)
    dims = (prob.nx, prob.ny, prob.nz)
    if prob.nz % nshards:
        raise ValueError(f"nz={prob.nz} not divisible by P={nshards}")
    levels = []
    prob_l = prob
    while True:
        nx, ny, nz = dims
        last = ((nlevels is not None and len(levels) + 1 >= nlevels)
                or any(d % 2 for d in dims)
                or (nz // 2) % nshards
                or (nx * ny * nz) // 8 < MIN_COARSE_ROWS)
        # one device scatter a level: the stacked (local, remote) parts feed
        # both the matrix builder (parts=) and the colored smoother
        with _trace.span("build.mg_dist_level", level=len(levels),
                         dims="x".join(map(str, dims)), p=nshards):
            local, remote, plan = partition_problem(prob_l, nshards, dtype=dtype, device=dev)
            A = build_dist_matrix(prob_l.row, prob_l.col, prob_l.val, prob_l.shape, nshards,
                                  device=dev, local_format=local_format,
                                  remote_format=remote_format, mode=mode, tune=tune,
                                  candidates=candidates, plan=plan, check_plan=False,
                                  dtype=dtype, parts=(local, remote))
            slab_dims = (nx, ny, nz // nshards)
            colored = _build_dist_colored(local, slab_dims, fmt=smoother_format,
                                          policy=smoother_policy, candidates=candidates)
        # coarse slab -> fine slab injection (fine z = 2 * coarse z stays
        # inside the same z-slab)
        f2c_local = None if last else f2c_map(plan_coarsen(*slab_dims), dev)
        levels.append(DistMGLevel(A, colored, f2c_local, dims))
        if last:
            break
        dims = (nx // 2, ny // 2, nz // 2)
        prob_l = generate_problem(*dims)
    return DistMGHierarchy(tuple(levels), pre=pre, post=post,
                           coarse_sweeps=coarse_sweeps, backend=backend)


# ---------------------------------------------------------------------------
# The distributed V-cycle
# ---------------------------------------------------------------------------


def _dist_smooth(hier: DistMGHierarchy, lev: DistMGLevel, b: torch.Tensor,
                 x: Optional[torch.Tensor], sweeps: int, x_is_zero: bool) -> torch.Tensor:
    """``sweeps`` distributed SymGS sweeps, updating ``x`` (owned by the
    cycle) in place: per sweep one halo exchange and remote SpMV (skipped
    when ``x`` is zero: the halo term vanishes), then the frozen-halo colored
    forward and backward sweeps of every shard's local block."""
    if sweeps <= 0:
        return x if x is not None else torch.zeros_like(b)
    A, cs = lev.A, lev.colored
    backend = hier.backend
    nshards = A.nshards
    x = torch.zeros_like(b) if x is None else x
    xv, bv = x.view(nshards, A.mp), b.view(nshards, A.mp)
    for s in range(int(sweeps)):
        if A.remote_empty or (x_is_zero and s == 0):
            beff = bv
        else:
            halo = _halo(A, x)
            beff = bv - torch.stack([
                _ops.spmv(A.shard_parts["remote"][p], _remote_in(A, halo, p), backend=backend)
                for p in range(nshards)])
        for order in (range(NCOLORS), range(NCOLORS - 1, -1, -1)):
            for c in order:
                rows = cs.live_rows[c]
                k = rows.shape[0]
                if k == 0:
                    continue
                y = torch.stack([_ops.spmv(blk, xv[p], backend=backend)
                                 for p, blk in enumerate(cs.shard_blocks[c])])
                delta = (beff.index_select(1, rows) - y[:, :k]) / cs.diag_rows[c]
                xv.index_add_(1, rows, delta.to(x.dtype))
    return x


def _dist_restrict(lev: DistMGLevel, r: torch.Tensor) -> torch.Tensor:
    """Shard-local injection: every shard keeps its coarse points."""
    return r.view(lev.A.nshards, lev.A.mp).index_select(1, lev.f2c_local).reshape(-1)


def _dist_prolong(lev: DistMGLevel, xc: torch.Tensor) -> torch.Tensor:
    nshards, mp = lev.A.nshards, lev.A.mp
    out = torch.zeros((nshards, mp), dtype=xc.dtype, device=xc.device)
    return out.index_copy_(1, lev.f2c_local, xc.view(nshards, -1)).view(-1)


def v_cycle_dist(hier: DistMGHierarchy, r: torch.Tensor, level: int = 0) -> torch.Tensor:
    """One distributed V-cycle from a zero guess. No device->host sync."""
    with _trace.span("mg.vcycle_dist", level=level):
        return _v_cycle_dist(hier, r, level)


def _v_cycle_dist(hier: DistMGHierarchy, r: torch.Tensor, level: int) -> torch.Tensor:
    lev = hier.levels[level]
    if level == hier.nlevels - 1:
        return _dist_smooth(hier, lev, r, None, hier.coarse_sweeps, True)
    x = _dist_smooth(hier, lev, r, None, hier.pre, True)
    res = r - dist_spmv(lev.A, x, backend=hier.backend)
    rc = _dist_restrict(lev, res)
    xc = v_cycle_dist(hier, rc, level + 1)
    x = x + _dist_prolong(lev, xc)
    return _dist_smooth(hier, lev, r, x, hier.post, False)
