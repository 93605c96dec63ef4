"""CG and MG-PCG on the grid, as HPCG defines them, in plain PyTorch.

``cg`` is unpreconditioned conjugate gradients from ``x0 = 0``: an
iteration is active while ``||r||^2 > tol^2 ||r_0||^2`` and fewer than
``maxiter`` have run. ``pcg`` is the same loop preconditioned by one
V-cycle of HPCG's geometric multigrid (``vcycle``): on each level but the
coarsest, ``pre`` symmetric Gauss-Seidel sweeps from zero, the residual,
injection to the grid of every second point on each axis, the coarse
correction added back at those points, and ``post`` sweeps; on the
coarsest, ``coarse_sweeps`` sweeps from zero. The coarse operators are the
same stencil on the coarse grids.

The Gauss-Seidel sweep runs in colour order: the 2 x 2 x 2 parity colours
``(x % 2) + 2 (y % 2) + 4 (z % 2)``, ascending forward and descending
backward. No two points of one colour are coupled by the stencil, so a
colour's points update at once: ``x_c += (b_c - (A x)_c) / 26``. This is
Gauss-Seidel over the colour-ordered rows, exactly.

Every function works in the dtype of its inputs: the benchmark runs them
in float64 to judge a float32 program.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from reference import stencil

DIAG = 26.0


class Solve(NamedTuple):
    x: torch.Tensor          # (n,)
    iters: int               # active iterations
    history: torch.Tensor    # (iters + 1,) ||r_k||, r_0 = b


def grids(grid: Tuple[int, int, int], nlevels: int) -> List[Tuple[int, int, int]]:
    """The hierarchy's grids: halved on every axis, ``nlevels`` of them;
    every grid but the last must be even on every axis."""
    out = [tuple(grid)]
    for _ in range(nlevels - 1):
        g = out[-1]
        if any(d % 2 for d in g):
            raise ValueError(f"grid {g} does not halve")
        out.append(tuple(d // 2 for d in g))
    return out


def _colour(t3: torch.Tensor, c: int) -> torch.Tensor:
    """The points of colour ``c`` of a grid-shaped tensor, as a view."""
    px, py, pz = c & 1, (c >> 1) & 1, (c >> 2) & 1
    return t3[pz::2, py::2, px::2]


def symgs(x3: torch.Tensor, b3: torch.Tensor, sweeps: int) -> torch.Tensor:
    """``sweeps`` symmetric colour-order Gauss-Seidel sweeps on ``x3`` in
    place (forward over colours 0..7, then backward 7..0)."""
    order = list(range(8)) + list(range(7, -1, -1))
    for _ in range(sweeps):
        for c in order:
            ax = stencil.apply(x3)
            _colour(x3, c).add_((_colour(b3, c) - _colour(ax, c)) / DIAG)
    return x3


def vcycle(r3: torch.Tensor, levels: int, pre: int = 1, post: int = 1,
           coarse_sweeps: int = 1) -> torch.Tensor:
    """One V-cycle on ``A z = r`` from ``z = 0``; ``r3`` is grid-shaped and
    ``levels`` counts it and the coarser grids below it."""
    x3 = torch.zeros_like(r3)
    if levels == 1:
        return symgs(x3, r3, coarse_sweeps)
    symgs(x3, r3, pre)
    res = r3 - stencil.apply(x3)
    xc = vcycle(res[::2, ::2, ::2].contiguous(), levels - 1, pre, post, coarse_sweeps)
    x3[::2, ::2, ::2] += xc
    return symgs(x3, r3, post)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a, b)


def cg(grid: Tuple[int, int, int], b: torch.Tensor, tol: float, maxiter: int,
       precond=None) -> Solve:
    """(P)CG on HPCG's operator over ``grid`` from ``x0 = 0``; ``precond``
    maps a residual (n,) to ``z`` (n,), None for plain CG. With ``tol = 0``
    every one of the ``maxiter`` iterations is active."""
    A = lambda v: stencil.apply(stencil.grid_view(v, grid)).reshape(-1)  # noqa: E731
    x = torch.zeros_like(b)
    r = b.clone()
    z = r if precond is None else precond(r)
    p = z.clone()
    rr = _dot(r, r)
    rz = rr if precond is None else _dot(r, z)
    tol2 = (tol ** 2) * rr
    hist = [torch.sqrt(rr)]
    k = 0
    while k < maxiter and bool(rr > tol2):
        ap = A(p)
        alpha = rz / _dot(p, ap)
        x.add_(alpha * p)
        r.sub_(alpha * ap)
        rr = _dot(r, r)
        if precond is None:
            rz_new = rr
            z = r
        else:
            z = precond(r)
            rz_new = _dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        hist.append(torch.sqrt(rr))
        k += 1
    return Solve(x, k, torch.stack(hist))


def mg_pcg(grid: Tuple[int, int, int], b: torch.Tensor, tol: float, maxiter: int,
           nlevels: int, pre: int = 1, post: int = 1, coarse_sweeps: int = 1) -> Solve:
    """PCG preconditioned by one :func:`vcycle` an iteration."""
    grids(grid, nlevels)  # raises where the grid does not halve
    M = lambda r: vcycle(stencil.grid_view(r, grid), nlevels, pre, post,  # noqa: E731
                         coarse_sweeps).reshape(-1)
    return cg(grid, b, tol, maxiter, precond=M)


def residual_norm(grid: Tuple[int, int, int], b: torch.Tensor, x: torch.Tensor) -> float:
    """``||b - A x||_2 / ||b||_2`` in the dtype of the inputs."""
    r = b - stencil.apply(stencil.grid_view(x, grid)).reshape(-1)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))
