"""The inputs every run makes from its configuration and ``--seed``, on the
device, in a few large calls: HPCG's 27-point matrix as triplets sorted by
row and column by construction, and the pool of right-hand sides."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from reference import stencil

# Neighbour offsets in the order that sorts each row's columns ascending:
# col = row + dx + nx (dy + ny dz), and |dx| < nx, |dy| < ny.
OFFSETS = tuple((dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
DIAG_SLOT = OFFSETS.index((0, 0, 0))


def stencil_triplets(grid: Sequence[int], dtype: torch.dtype,
                     device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(row, col, val)`` of HPCG's matrix on ``grid``: int32 indices, 26 on
    the diagonal and -1 to each in-grid neighbour, in (row, col) order."""
    nx, ny, nz = grid
    n = nx * ny * nz
    idx = torch.arange(n, dtype=torch.int64, device=device)
    x, y, z = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    keep = torch.empty((n, len(OFFSETS)), dtype=torch.bool, device=device)
    cols = torch.empty((n, len(OFFSETS)), dtype=torch.int32, device=device)
    for k, (dx, dy, dz) in enumerate(OFFSETS):
        keep[:, k] = ((x + dx >= 0) & (x + dx < nx) & (y + dy >= 0) & (y + dy < ny)
                      & (z + dz >= 0) & (z + dz < nz))
        cols[:, k] = idx + (dx + nx * (dy + ny * dz))
    del x, y, z
    vals = torch.full((1, len(OFFSETS)), -1.0, dtype=dtype, device=device)
    vals[0, DIAG_SLOT] = 26.0
    row = idx.to(torch.int32).unsqueeze(1).expand(n, len(OFFSETS))[keep]
    return row, cols[keep], vals.expand(n, len(OFFSETS))[keep]


def rhs_pool(grid: Sequence[int], size: int, base: float, amplitude: float, seed: int,
             dtype: torch.dtype, device) -> List[torch.Tensor]:
    """``size`` right-hand sides ``b = A x*`` with ``x* = base + amplitude u``,
    ``u`` uniform in [-1, 1) drawn from ``seed`` in one call on the device;
    ``A x*`` is taken on the grid in float64, then rounded to ``dtype``."""
    nx, ny, nz = grid
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    u = torch.rand((size, nz, ny, nx), generator=g, dtype=torch.float64, device=device)
    pool = []
    for i in range(size):
        xs = base + amplitude * (2.0 * u[i] - 1.0)
        pool.append(stencil.apply(xs).reshape(-1).to(dtype))
    return pool
