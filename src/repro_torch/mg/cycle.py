"""MGHierarchy — geometric multigrid V-cycle over sparse levels (port of
``repro.mg.cycle``).

Each level is an *independent* sparse operator with its own sparsity
structure, the case where run-time format selection pays: with a
``FormatPolicy``, ``build_hierarchy`` picks every level's operator format
(``select``) and every smoother color block's format (one batched
``select_batch`` pass per level).

``apply_M()`` returns a closure ``r -> z`` (one V-cycle) that plugs into
``repro_torch.core.solvers.pcg(apply_A, b, apply_M=...)``. The default
configuration (SymGS pre/post smoothing with equal sweep counts, the
injection pair ``P = R^T``, a SymGS coarse solve) keeps M symmetric
positive definite, which plain PCG requires.

Differences from the JAX package: ``backend`` defaults to ``None`` (the
SpMV kernels on the card, the reference on the CPU), as the port's
``operator`` does; JAX defaults to ``"auto"``. ``build_hierarchy`` builds
on the device it is given (``device=None``: the card, raising without
one). A V-cycle runs eagerly and never syncs with the host. The JAX
package's trace spans carry over: ``build.mg_level`` a level at build time
and, while tracing is on, ``mg.vcycle`` a level on *every* cycle (JAX opens
it once per jit trace); off, a level costs one mode check.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import ops as _ops
from repro_torch.core.convert import convert_execute, plan_switch
from repro_torch.core.formats import COO, Format
from repro_torch.core.hpcg import HPCGProblem, to_coo as hpcg_to_coo
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.mg.coarsen import Coarsening, coarsen_execute, plan_coarsen, prolong, restrict
from repro_torch.mg.smoothers import ColoredSystem, _symgs_, build_colored, jacobi
from repro_torch.obs import trace as _trace

# Coarsening stops once a level has this few rows (the coarse solve,
# SymGS sweeps, handles the rest).
MIN_COARSE_ROWS = 8


@dataclasses.dataclass(frozen=True)
class MGLevel:
    """One level: operator + smoother + (except coarsest) the coarsening."""

    A: object                           # level operator, any concrete format
    diag: torch.Tensor                  # diag(A) for the Jacobi fallback
    smoother: Optional[ColoredSystem]   # None -> weighted Jacobi
    coarsen: Optional[Coarsening]       # None on the coarsest level
    dims: Tuple[int, int, int]

    @property
    def n(self) -> int:
        return self.A.shape[0]

    @property
    def format(self) -> Format:
        return Format(self.A.format)


@dataclasses.dataclass(frozen=True)
class MGHierarchy:
    """The V-cycle preconditioner M^{-1} ~ A^{-1} over a level stack."""

    levels: Tuple[MGLevel, ...]
    pre: int = 1
    post: int = 1
    coarse_sweeps: int = 4
    backend: Optional[str] = None

    @property
    def nlevels(self) -> int:
        return len(self.levels)

    def apply_M(self) -> Callable:
        """``r -> z = M^{-1} r``: one V-cycle."""
        return lambda r: v_cycle(self, r)

    def formats(self):
        """Per-level (operator format, color-block formats)."""
        return [{
            "level": i, "dims": lev.dims, "n": lev.n,
            "A": lev.format.name,
            "colors": ([f.name for f in lev.smoother.formats]
                       if lev.smoother is not None else None),
        } for i, lev in enumerate(self.levels)]

    def __repr__(self):
        dims = " > ".join("x".join(map(str, lev.dims)) for lev in self.levels)
        return (f"MGHierarchy({dims}; pre={self.pre}, post={self.post}, "
                f"coarse_sweeps={self.coarse_sweeps})")


def _smooth(hier: MGHierarchy, lev: MGLevel, b, x, sweeps: int):
    """``sweeps`` smoothing steps from ``x`` (None: zeros). ``x`` is a
    tensor the cycle owns, so SymGS updates it in place."""
    if sweeps <= 0:
        return x if x is not None else torch.zeros_like(b)
    if lev.smoother is not None:
        x = torch.zeros_like(b) if x is None else x
        return _symgs_(lev.smoother, b, x, sweeps, hier.backend, None)
    return jacobi(lev.diag, lambda v: _ops.spmv(lev.A, v, backend=hier.backend),
                  b, x, sweeps=sweeps)


def v_cycle(hier: MGHierarchy, r: torch.Tensor, level: int = 0) -> torch.Tensor:
    """One V-cycle on ``A_level z = r`` from a zero initial guess."""
    if _trace.mode() == "off":
        return _v_cycle(hier, r, level)
    with _trace.span("mg.vcycle", level=level):
        return _v_cycle(hier, r, level)


def _v_cycle(hier: MGHierarchy, r: torch.Tensor, level: int) -> torch.Tensor:
    lev = hier.levels[level]
    if level == hier.nlevels - 1:
        return _smooth(hier, lev, r, None, hier.coarse_sweeps)
    x = _smooth(hier, lev, r, None, hier.pre)
    res = r - _ops.spmv(lev.A, x, backend=hier.backend)
    rc = restrict(lev.coarsen, res)
    xc = v_cycle(hier, rc, level + 1)
    x = x + prolong(lev.coarsen, xc)
    return _smooth(hier, lev, r, x, hier.post)


def _pick_format(C: COO, policy, fmt: Format):
    best = policy.select(C).best if policy is not None else Format(fmt)
    return convert_execute(C, plan_switch(C, best))


def build_hierarchy(prob: HPCGProblem, nlevels: Optional[int] = None,
                    fmt: Format = Format.CSR, policy=None,
                    smoother: str = "symgs",
                    pre: int = 1, post: int = 1, coarse_sweeps: int = 4,
                    prolong: str = "injection",
                    coarse_op: str = "rediscretize",
                    backend: Optional[str] = None,
                    dtype: torch.dtype = torch.float32,
                    device: DeviceLike = None, A=None) -> MGHierarchy:
    """Construct the geometric hierarchy for an HPCG stencil problem on
    ``device`` (``None``: the card; raises where CUDA is absent). ``A`` is
    the level-0 COO of ``prob`` where the caller holds it already (it then
    sets the device and dtype); else it is built from ``prob``.

    Levels coarsen 2:1 while every grid dim stays even and the level keeps
    at least ``MIN_COARSE_ROWS`` rows (or until ``nlevels``). Each level's
    operator format comes from ``policy.select`` (``fmt`` without a
    policy); each level's smoother color blocks come from one
    ``policy.select_batch`` pass over the stacked blocks. ``smoother`` is
    ``"symgs"`` (colored symmetric Gauss-Seidel) or ``"jacobi"``.

    Per step one static :class:`~repro_torch.mg.coarsen.CoarsenPlan` plus
    the device :func:`~repro_torch.mg.coarsen.coarsen_execute`
    (rediscretized coarse stencil, injection/trilinear tables): index
    arrays never pass through the host.
    """
    if smoother not in ("symgs", "jacobi"):
        raise ValueError(f"unknown smoother {smoother!r}")
    dims = (prob.nx, prob.ny, prob.nz)
    C = A if A is not None else hpcg_to_coo(prob, dtype=dtype, device=resolve_device(device))

    levels = []
    while True:
        last = ((nlevels is not None and len(levels) + 1 >= nlevels)
                or any(d % 2 for d in dims)
                or (C.shape[0] // 8) < MIN_COARSE_ROWS)
        with _trace.span("build.mg_level", level=len(levels),
                         dims="x".join(map(str, dims))) as sp:
            cz = None
            if not last:
                plan = plan_coarsen(*dims, prolong=prolong, coarse_op=coarse_op)
                cz = coarsen_execute(plan, Af=C)
            op = _pick_format(C, policy, fmt)
            cs = (build_colored(C, dims=dims, fmt=fmt, policy=policy)
                  if smoother == "symgs" else None)
            diag = cs.diag if cs is not None else _ops.extract_diagonal(C)
            sp.set(fmt=Format(op.format).name).sync(diag)
        levels.append(MGLevel(op, diag, cs, cz, dims))
        if last:
            break
        C = cz.Ac
        dims = plan.coarse
    return MGHierarchy(tuple(levels), pre=pre, post=post,
                       coarse_sweeps=coarse_sweeps, backend=backend)
