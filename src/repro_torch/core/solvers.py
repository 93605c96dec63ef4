"""Iterative solvers over (dynamic) sparse matrices (port of ``repro.core.solvers``).

CG is the paper's workload (HPCG, benchmarked with the preconditioner
disabled, §IV-B). The solvers are generic over an ``apply_A`` closure; the
vector algebra goes through ``repro_torch.core.ops``.

JAX runs the CG loop as a device-side ``while_loop``. PyTorch runs eagerly,
so :func:`cg` and :func:`pcg` read the convergence test back to the host
once per iteration (one ``.item()``-style sync each); :func:`cg_fixed_iters`
has no early exit and never syncs.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import ops as _ops


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    resnorm: torch.Tensor  # final ||r||_2
    # ``history[k] = ||r_k||_2`` with ``history[0]`` the initial residual;
    # entries past the converged iteration are NaN; shape ``(maxiter + 1,)``.
    history: Optional[torch.Tensor] = None


def operator(A, backend: Optional[str] = None, cfg: Optional[dict] = None) -> Callable:
    """``apply_A`` closure for the solvers over a concrete container, a
    (Switch)DynamicMatrix or a ``DistSparseMatrix`` (then the closure is
    :func:`~repro_torch.core.distributed.dist_spmv`, with the
    interior/boundary split when the matrix was built split).
    ``backend=None`` runs the CUDA kernels on CUDA tensors and the reference
    on CPU tensors; ``"auto"`` routes each SpMV by the measured kernel
    records; ``cfg`` pins the kernel's launch knobs (see ``ops.spmv``)."""
    from repro_torch.core.distributed import DistSparseMatrix, dist_spmv

    if isinstance(A, DistSparseMatrix):
        return lambda v: dist_spmv(A, v, backend=backend, cfg=cfg)
    return lambda v: _ops.spmv(A, v, backend=backend, cfg=cfg)


def _floor(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(v, min=1e-30)


def _cg_step(apply_A: Callable, state):
    """One CG iteration (shared by :func:`cg` and :func:`cg_fixed_iters`):
    (x, r, p, rs) -> (x, r, p, rs)."""
    x, r, p, rs = state
    Ap = apply_A(p)
    alpha = rs / _floor(_ops.dot(p, Ap))
    x = _ops.axpy(alpha, p, x)
    r = _ops.axpy(-alpha, Ap, r)
    rs_new = _ops.dot(r, r)
    beta = rs_new / _floor(rs)
    p = _ops.waxpby(1.0, r, beta, p)
    return x, r, p, rs_new


def _tol2(tol: float, rs0: torch.Tensor) -> torch.Tensor:
    return torch.tensor(tol, dtype=rs0.dtype, device=rs0.device) ** 2 * _floor(rs0)


def _history(maxiter: int, r0norm: torch.Tensor) -> torch.Tensor:
    hist = torch.full((maxiter + 1,), math.nan, dtype=r0norm.dtype, device=r0norm.device)
    hist[0] = r0norm
    return hist


def cg(apply_A: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       tol: float = 1e-8, maxiter: int = 100) -> CGResult:
    """Unpreconditioned conjugate gradients (HPCG's optimized-phase solve):
    stops when ||r||^2 <= tol^2 * ||r_0||^2 or after ``maxiter`` steps."""
    x0 = torch.zeros_like(b) if x0 is None else x0
    r0 = b - apply_A(x0)
    rs0 = _ops.dot(r0, r0)
    tol2 = _tol2(tol, rs0)
    hist = _history(maxiter, torch.sqrt(rs0))
    state, k = (x0, r0, r0, rs0), 0
    while k < maxiter and bool(state[3] > tol2):  # the per-iteration host sync
        state = _cg_step(apply_A, state)
        k += 1
        hist[k] = torch.sqrt(state[3])
    x, _, _, rs = state
    return CGResult(x, k, torch.sqrt(rs), hist)


def cg_fixed_iters(apply_A: Callable, b: torch.Tensor,
                   x0: Optional[torch.Tensor] = None, iters: int = 50) -> CGResult:
    """Fixed-iteration CG (no early exit, no host sync): the HPCG
    'optimized problem timing' loop shape, same step as :func:`cg`."""
    x0 = torch.zeros_like(b) if x0 is None else x0
    r0 = b - apply_A(x0)
    rs0 = _ops.dot(r0, r0)
    hist = _history(iters, torch.sqrt(rs0))
    state = (x0, r0, r0, rs0)
    for k in range(iters):
        state = _cg_step(apply_A, state)
        hist[k + 1] = torch.sqrt(state[3])
    x, _, _, rs = state
    return CGResult(x, iters, torch.sqrt(rs), hist)


def pcg(apply_A: Callable, b: torch.Tensor,
        diag_A: Optional[torch.Tensor] = None,
        x0: Optional[torch.Tensor] = None, tol: float = 1e-8,
        maxiter: int = 100, *, apply_M: Optional[Callable] = None) -> CGResult:
    """Preconditioned CG over ``z = M^{-1} r``: ``apply_M`` is any SPD
    linear map; without it, ``diag_A`` gives the Jacobi preconditioner
    M = diag(A). Convergence is tested on ||r||^2, as in :func:`cg`."""
    if apply_M is None:
        if diag_A is None:
            raise ValueError("pcg needs apply_M= (e.g. an MG V-cycle) or "
                             "diag_A= (Jacobi)")
        minv = torch.where(diag_A.abs() > 1e-30, 1.0 / diag_A,
                           torch.zeros((), dtype=diag_A.dtype, device=diag_A.device))
        apply_M = lambda r: minv * r  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - apply_A(x)
    z = apply_M(r)
    p = z
    rz = _ops.dot(r, z)
    rr = _ops.dot(r, r)
    tol2 = _tol2(tol, rr)
    hist = _history(maxiter, torch.sqrt(rr))
    k = 0
    while k < maxiter and bool(rr > tol2):  # the per-iteration host sync
        Ap = apply_A(p)
        alpha = rz / _floor(_ops.dot(p, Ap))
        x = _ops.axpy(alpha, p, x)
        r = _ops.axpy(-alpha, Ap, r)
        z = apply_M(r)
        rz_new = _ops.dot(r, z)
        rr = _ops.dot(r, r)
        beta = rz_new / _floor(rz)
        p = _ops.waxpby(1.0, z, beta, p)
        rz = rz_new
        k += 1
        hist[k] = torch.sqrt(rr)
    return CGResult(x, k, torch.sqrt(rr), hist)
