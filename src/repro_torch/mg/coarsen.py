"""Geometric 2:1 coarsening of the HPCG grid hierarchy (port of ``repro.mg.coarsen``).

The multigrid analogue of ``core.convert``'s symbolic/numeric split:

  * :func:`plan_coarsen` (symbolic) is integer arithmetic over the grid
    dimensions: no device work, no data. It emits a hashable
    :class:`CoarsenPlan` of Python ints and strings.
  * :func:`coarsen_execute` (numeric) builds the level-transfer tables on
    the device: the injection map ``f2c`` (coarse point i -> fine grid
    index), the trilinear corner tables and, for the rediscretized coarse
    operator, the 27-point-stencil COO triplets of the coarse grid, all
    from ``torch.arange`` index arithmetic on the device the caller names
    (``device=None``: the card). No index array passes through the host.

Transfer operators (HPCG §3.3 conventions): **injection** restriction
(``rc[i] = rf[f2c[i]]``) paired with injection prolongation, or **full
weighting** (``R = P^T / 8``) paired with trilinear prolongation; both keep
``P = c R^T``, so the V-cycle stays symmetric. Coarse operator:
**rediscretize** (the stencil regenerated on the coarse grid, on the
device) or **galerkin** (``Ac = R Af P``, a host triple product; setup
only, the algebraic cross-check).

JAX-to-torch notes: JAX's scatter drops an out-of-range index; here the
trilinear scatter sums into an ``nc + 1`` buffer whose last slot (the
sentinel column ``nc``) is cut off. ``index_add_`` sums repeated indices
with atomics on the card, so full-weighting restriction reruns within
rounding, not bitwise; the injection pair has no repeated index.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.convert import to_coo
from repro_torch.core.formats import COO
from repro_torch.core.hpcg import HPCGProblem, generate_problem
from repro_torch.device import DeviceLike, resolve_device

PROLONG_MODES = ("injection", "trilinear")
COARSE_OPS = ("rediscretize", "galerkin")


@dataclasses.dataclass(frozen=True)
class CoarsenPlan:
    """Static metadata of one 2:1 coarsening step (hashable).

    ``fine``/``coarse`` are the grid dims; ``prolong`` fixes the transfer
    pair (injection/injection or trilinear/full-weighting); ``coarse_op``
    picks how the coarse operator is built.
    """

    fine: Tuple[int, int, int]
    coarse: Tuple[int, int, int]
    prolong: str = "injection"
    coarse_op: str = "rediscretize"

    @property
    def nf(self) -> int:
        return int(np.prod(self.fine))

    @property
    def nc(self) -> int:
        return int(np.prod(self.coarse))


def plan_coarsen(nx: int, ny: int, nz: int, prolong: str = "injection",
                 coarse_op: str = "rediscretize") -> CoarsenPlan:
    """Symbolic phase: validate the 2:1 step and fix its static metadata."""
    if prolong not in PROLONG_MODES:
        raise ValueError(f"prolong {prolong!r} not in {PROLONG_MODES}")
    if coarse_op not in COARSE_OPS:
        raise ValueError(f"coarse_op {coarse_op!r} not in {COARSE_OPS}")
    if coarse_op == "galerkin" and prolong == "injection":
        # R A P with injection R/P just samples A at the even points: for a
        # reach-1 stencil every sampled off-diagonal vanishes and Ac
        # degenerates to a diagonal — pair galerkin with trilinear instead.
        raise ValueError("coarse_op='galerkin' requires prolong='trilinear' "
                         "(injection Galerkin degenerates to diag sampling)")
    for d in (nx, ny, nz):
        if d < 2 or d % 2:
            raise ValueError(
                f"2:1 coarsening needs even dims >= 2, got {(nx, ny, nz)}")
    return CoarsenPlan((nx, ny, nz), (nx // 2, ny // 2, nz // 2),
                       prolong=prolong, coarse_op=coarse_op)


# ---------------------------------------------------------------------------
# Device index arithmetic (grid ordering is x-fastest,
# idx = x + nx*(y + ny*z), matching core.hpcg.generate_problem)
# ---------------------------------------------------------------------------


def _grid_xyz(n: int, nx: int, ny: int, dev: torch.device):
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    return idx % nx, (idx // nx) % ny, idx // (nx * ny)


def f2c_map(plan: CoarsenPlan, device: DeviceLike = None) -> torch.Tensor:
    """(nc,) int64 fine-grid index of every coarse point (fine = 2 * coarse)."""
    nxc, nyc, _ = plan.coarse
    nxf, nyf, _ = plan.fine
    xc, yc, zc = _grid_xyz(plan.nc, nxc, nyc, resolve_device(device))
    return 2 * xc + nxf * (2 * yc + nyf * 2 * zc)


def trilinear_corners(plan: CoarsenPlan,
                      device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-fine-point coarse interpolation corners.

    Returns ``(cols, wts)`` of shape ``(nf, 8)``: the up-to-8 coarse points
    each fine point interpolates from (int64) and their trilinear weights
    (float32; 1 per even coordinate, 1/2 per odd-coordinate neighbour
    pair). Corners outside the coarse grid (the odd top boundary) carry
    weight 0 and the column id ``nc``, the sentinel that the scatter drops
    and the gather clamps.
    """
    dev = resolve_device(device)
    nxf, nyf, _ = plan.fine
    nxc, nyc, nzc = plan.coarse
    xf, yf, zf = _grid_xyz(plan.nf, nxf, nyf, dev)
    odd = [(c % 2) == 1 for c in (xf, yf, zf)]
    # per-axis weight: even coord -> only the d=0 corner (w=1);
    # odd coord -> both corners at w=1/2 each
    w = torch.ones((plan.nf,), dtype=torch.float32, device=dev)
    for o in odd:
        w = w * torch.where(o, 0.5, 1.0)
    cols, wts = [], []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                xc, yc, zc = xf // 2 + dx, yf // 2 + dy, zf // 2 + dz
                ok = (xc < nxc) & (yc < nyc) & (zc < nzc)
                for o, d in zip(odd, (dx, dy, dz)):
                    if d == 1:  # an even coord has no d=1 corner
                        ok = ok & o
                cid = xc + nxc * (yc + nyc * zc)
                cols.append(torch.where(ok, cid, plan.nc))
                wts.append(torch.where(ok, w, 0.0))
    return torch.stack(cols, dim=1), torch.stack(wts, dim=1)


def stencil27_coo(nx: int, ny: int, nz: int, dtype: torch.dtype = torch.float32,
                  device: DeviceLike = None) -> COO:
    """The HPCG 27-point stencil (diag 26, off-diag -1) as device COO.

    The device twin of ``core.hpcg.generate_problem``: capacity ``27*n``,
    out-of-grid neighbours stored as inert padding (row kept, col 0, val
    0), so the shape is static for any grid.
    """
    dev = resolve_device(device)
    n = nx * ny * nz
    x, y, z = _grid_xyz(n, nx, ny, dev)
    row = (x + nx * (y + ny * z)).to(torch.int32)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    zero_v = torch.zeros((), dtype=dtype, device=dev)
    rows, cols, vals = [], [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                xp, yp, zp = x + dx, y + dy, z + dz
                ok = ((xp >= 0) & (xp < nx) & (yp >= 0) & (yp < ny)
                      & (zp >= 0) & (zp < nz))
                c = (xp + nx * (yp + ny * zp)).to(torch.int32)
                v = torch.full((), 26.0 if dx == dy == dz == 0 else -1.0,
                               dtype=dtype, device=dev)
                rows.append(row)
                cols.append(torch.where(ok, c, zero_i))
                vals.append(torch.where(ok, v, zero_v))
    return COO(torch.cat(rows), torch.cat(cols), torch.cat(vals), (n, n), 27 * n)


# ---------------------------------------------------------------------------
# The numeric phase: Coarsening (the level-transfer tables on the device)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Coarsening:
    """Device artifacts of one coarsening step (output of
    :func:`coarsen_execute`). ``tri_cols``/``tri_wts`` are only populated
    for trilinear plans."""

    plan: CoarsenPlan
    f2c: torch.Tensor                        # (nc,) injection map, int64
    tri_cols: Optional[torch.Tensor] = None  # (nf, 8) coarse corner ids
    tri_wts: Optional[torch.Tensor] = None   # (nf, 8) trilinear weights
    Ac: Optional[COO] = None                 # coarse operator


def coarsen_execute(plan: CoarsenPlan, Af: Optional[COO] = None,
                    device: DeviceLike = None) -> Coarsening:
    """Numeric phase: build the level-transfer artifacts for ``plan`` on
    ``device`` (default: the device of ``Af`` if given, else the card).

    The injection/trilinear maps and the rediscretized coarse stencil are
    built on the device. A ``galerkin`` plan also needs the fine operator
    ``Af`` and runs the host triple product (:func:`galerkin_coarse`),
    setup only.
    """
    dev = resolve_device(Af.device if device is None and Af is not None else device)
    f2c = f2c_map(plan, dev)
    tc = tw = None
    if plan.prolong == "trilinear":
        tc, tw = trilinear_corners(plan, dev)
    if plan.coarse_op == "galerkin":
        if Af is None:
            raise ValueError("coarse_op='galerkin' needs the fine operator "
                             "Af (host triple product)")
        Ac = galerkin_coarse(Af, plan, dtype=Af.dtype, device=dev)
    else:
        Ac = stencil27_coo(*plan.coarse, dtype=Af.dtype if Af is not None else torch.float32,
                           device=dev)
    return Coarsening(plan, f2c, tri_cols=tc, tri_wts=tw, Ac=Ac)


def restrict(c: Coarsening, rf: torch.Tensor) -> torch.Tensor:
    """rc = R rf: injection gather, or full weighting ``P^T rf / 8`` for
    trilinear plans (a scatter-add over the corner tables into an
    ``nc + 1`` buffer; the sentinel slot ``nc`` is cut off)."""
    if c.plan.prolong == "injection":
        return rf.index_select(0, c.f2c)
    nc = c.plan.nc
    contrib = (c.tri_wts * rf[:, None]).reshape(-1).to(rf.dtype)
    out = torch.zeros((nc + 1,), dtype=rf.dtype, device=rf.device)
    return out.index_add_(0, c.tri_cols.reshape(-1), contrib)[:nc] / 8.0


def prolong(c: Coarsening, xc: torch.Tensor) -> torch.Tensor:
    """xf = P xc: injection scatter (zeros elsewhere), or trilinear
    interpolation over the corner tables."""
    if c.plan.prolong == "injection":
        out = torch.zeros((c.plan.nf,), dtype=xc.dtype, device=xc.device)
        return out.index_copy_(0, c.f2c, xc)
    gathered = xc.index_select(0, c.tri_cols.clamp(max=c.plan.nc - 1).reshape(-1))
    return (c.tri_wts * gathered.view(c.plan.nf, 8)).sum(dim=1).to(xc.dtype)


# ---------------------------------------------------------------------------
# Galerkin triple product (host; the algebraic cross-check of rediscretize)
# ---------------------------------------------------------------------------


def _coalesce(r, c, v):
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    first = np.ones(len(r), bool)
    first[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    idx = np.cumsum(first) - 1
    out = np.zeros(int(first.sum()), v.dtype)
    np.add.at(out, idx, v)
    return r[first], c[first], out


def _p_padded(plan: CoarsenPlan):
    """Host (nf, 8) padded form of the prolongation P (cols=-1 padding)."""
    if plan.prolong == "injection":
        cols = np.full((plan.nf, 1), -1, np.int64)
        wts = np.zeros((plan.nf, 1))
        f2c = f2c_map(plan, "cpu").numpy()
        cols[f2c, 0] = np.arange(plan.nc)
        wts[f2c, 0] = 1.0
        return cols, wts
    tc_d, tw_d = trilinear_corners(plan, "cpu")
    tc = tc_d.numpy().astype(np.int64)
    tw = tw_d.numpy().astype(np.float64)
    return np.where(tw > 0, tc, -1), tw


def galerkin_coarse(Af: COO, plan: CoarsenPlan, dtype: torch.dtype = torch.float32,
                    device: DeviceLike = None) -> COO:
    """Ac = R Af P on the host via two padded-neighbour joins, returned on
    ``device`` (default: the device of ``Af``).

    ``R`` is the adjoint pairing of the plan's prolongation (``P^T`` for
    injection, ``P^T / 8`` full weighting for trilinear), so ``Ac`` is
    symmetric whenever ``Af`` is. O(nnz(Af) * 8^2) intermediate entries: a
    setup-phase cost.
    """
    dev = resolve_device(Af.device if device is None else device)
    Af = to_coo(Af)
    pc, pw = _p_padded(plan)
    k = pc.shape[1]
    ar = Af.row.cpu().numpy().astype(np.int64)
    ac = Af.col.cpu().numpy().astype(np.int64)
    av = Af.data.cpu().double().numpy()
    live = av != 0
    ar, ac, av = ar[live], ac[live], av[live]
    # join 1: (A P)[i, kc] = sum_j A[i, j] P[j, kc]
    jr = np.repeat(ar, k)
    jc = pc[ac].reshape(-1)
    jv = (av[:, None] * pw[ac]).reshape(-1)
    ok = jc >= 0
    jr, jc, jv = _coalesce(jr[ok], jc[ok], jv[ok])
    # join 2: Ac[kr, kc] = sum_i P[i, kr] (A P)[i, kc]   (R = P^T [/8])
    gr = pc[jr].reshape(-1)
    gc = np.repeat(jc, k)
    gv = (pw[jr] * jv[:, None]).reshape(-1)
    ok = gr >= 0
    gr, gc, gv = _coalesce(gr[ok], gc[ok], gv[ok])
    if plan.prolong == "trilinear":
        gv = gv / 8.0
    return COO(torch.from_numpy(gr.astype(np.int32)).to(dev),
               torch.from_numpy(gc.astype(np.int32)).to(dev),
               torch.from_numpy(gv).to(dev, dtype), (plan.nc, plan.nc), len(gv))


def coarse_problem(prob: HPCGProblem) -> HPCGProblem:
    """Rediscretized coarse :class:`HPCGProblem` (host twin of
    :func:`stencil27_coo`)."""
    plan = plan_coarsen(prob.nx, prob.ny, prob.nz)
    return generate_problem(*plan.coarse)
