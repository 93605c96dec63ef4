"""HPCG problem substrate (paper §II-B, §IV-B).

Port of ``repro.core.hpcg``: the synthetic Poisson problem on a regular 3D
grid, 27-point stencil (26 on the diagonal, -1 off it), x-fastest ordering
(idx = x + nx*(y + ny*z)). The triplets are built and lexsorted on the host
in numpy exactly as the JAX package builds them, so both packages see
bit-identical problems; only :func:`to_coo` touches the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.formats import COO, coo_from_arrays
from repro_torch.device import DeviceLike


@dataclasses.dataclass(frozen=True)
class HPCGProblem:
    nx: int
    ny: int
    nz: int
    row: np.ndarray
    col: np.ndarray
    val: np.ndarray
    shape: Tuple[int, int]

    @property
    def nrows(self) -> int:
        return self.nx * self.ny * self.nz


def generate_problem(nx: int, ny: int, nz: int, dtype=np.float32) -> HPCGProblem:
    """27-point stencil: diag = 26, off-diag = -1 (HPCG's synthetic system)."""
    n = nx * ny * nz
    x, y, z = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    # row index, x-fastest ordering
    idx = (x + nx * (y + ny * z)).ravel()
    xs, ys, zs = x.ravel(), y.ravel(), z.ravel()

    rows, cols, vals = [], [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                nxp, nyp, nzp = xs + dx, ys + dy, zs + dz
                ok = ((nxp >= 0) & (nxp < nx) & (nyp >= 0) & (nyp < ny)
                      & (nzp >= 0) & (nzp < nz))
                r = idx[ok]
                c = (nxp + nx * (nyp + ny * nzp))[ok]
                v = np.where(r == c, 26.0, -1.0).astype(dtype)
                rows.append(r)
                cols.append(c)
                vals.append(v)
    row = np.concatenate(rows)
    col = np.concatenate(cols)
    val = np.concatenate(vals)
    order = np.lexsort((col, row))
    return HPCGProblem(nx, ny, nz, row[order].astype(np.int64),
                       col[order].astype(np.int64), val[order], (n, n))


def to_coo(prob: HPCGProblem, capacity: Optional[int] = None,
           dtype: torch.dtype = torch.float32, device: DeviceLike = None) -> COO:
    return coo_from_arrays(prob.row, prob.col, prob.val, prob.shape,
                           capacity=capacity, dtype=dtype, device=device)


def slab_plan(prob: HPCGProblem, nshards: int):
    """Analytic ``DistPlan`` of the z-slab partition of the stencil problem:
    slabs of ``nz/P`` whole x-y planes, every remote column in a
    neighbouring slab's boundary plane, halo width ``nx*ny`` a side. Only
    the capacities (and the interior/boundary split's) come from the
    triplets, one vectorised bincount each. Correct by construction: feed
    it to ``build_dist_matrix(..., plan=..., check_plan=False)``."""
    from repro_torch.core.distributed import DistPlan, _split_caps

    n = prob.shape[0]
    if nshards <= 0 or prob.nz % nshards:
        raise ValueError(
            f"z-slab partition needs nz % P == 0, got nz={prob.nz} / {nshards}")
    mp = n // nshards
    shard = prob.row // mp
    local_mask = (prob.col // mp) == shard
    lcounts = np.bincount(shard[local_mask], minlength=nshards)
    rcounts = np.bincount(shard[~local_mask], minlength=nshards)
    remote_empty = nshards == 1
    icap, bcap = (None, None) if remote_empty else _split_caps(
        prob.row, prob.col, prob.val, mp, nshards)
    return DistPlan(nshards=nshards, mp=mp,
                    hw=0 if remote_empty else prob.nx * prob.ny,
                    halo_mode="neighbor", shape=prob.shape,
                    local_cap=max(1, int(lcounts.max())),
                    remote_cap=max(1, int(rcounts.max())),
                    remote_empty=remote_empty,
                    interior_cap=icap, boundary_cap=bcap)


def partition_problem(prob: HPCGProblem, nshards: int, dtype: torch.dtype = torch.float32,
                      device: DeviceLike = None):
    """``(local, remote, plan)``: the stacked per-shard COO parts of the
    z-slab partition, scattered on ``device`` from the global triplets."""
    from repro_torch.core.distributed import partition_execute

    plan = slab_plan(prob, nshards)
    local, remote = partition_execute(prob.row, prob.col, prob.val, plan,
                                      dtype=dtype, device=device)
    return local, remote, plan


def rhs_for_ones(prob: HPCGProblem, dtype=np.float32) -> np.ndarray:
    """b = A @ 1 — HPCG's exact solution is the all-ones vector."""
    b = np.zeros(prob.shape[0], dtype=np.float64)
    np.add.at(b, prob.row, prob.val.astype(np.float64))
    return b.astype(dtype)


def exact_solution(prob: HPCGProblem, dtype=np.float32) -> np.ndarray:
    return np.ones(prob.shape[0], dtype=dtype)
