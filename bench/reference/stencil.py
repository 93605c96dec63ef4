"""HPCG's 27-point operator applied on the grid itself.

Row ``x + nx * (y + ny * z)`` of HPCG's matrix is the grid point
``(x, y, z)``: 26 on the diagonal, -1 to each of its up to 26 neighbours
inside the grid. So ``A v = 27 v - box(v)``, where ``box`` sums each point's
3 x 3 x 3 block of the grid with zeros outside it. No matrix is stored: the
operator is three one-dimensional sums, one per axis.
"""
from __future__ import annotations

from typing import Tuple

import torch


def grid_view(v: torch.Tensor, grid: Tuple[int, int, int]) -> torch.Tensor:
    """``v`` (n,) as (nz, ny, nx): x runs fastest, as HPCG numbers rows."""
    nx, ny, nz = grid
    return v.view(nz, ny, nx)


def _sum3(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Each entry plus its two neighbours along ``dim`` (zeros outside)."""
    n = t.shape[dim]
    out = t.clone()
    if n > 1:
        out.narrow(dim, 1, n - 1).add_(t.narrow(dim, 0, n - 1))
        out.narrow(dim, 0, n - 1).add_(t.narrow(dim, 1, n - 1))
    return out


def apply(v3: torch.Tensor) -> torch.Tensor:
    """``A v`` for a grid-shaped ``v3`` (nz, ny, nx)."""
    box = _sum3(_sum3(_sum3(v3, 2), 1), 0)
    return 27.0 * v3 - box


def nnz(grid: Tuple[int, int, int]) -> int:
    """Entries of HPCG's matrix on ``grid``: every in-grid neighbour pair
    plus the diagonal, ``(3 nx - 2)(3 ny - 2)(3 nz - 2)``."""
    nx, ny, nz = grid
    return (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
