"""Iterative solvers over (dynamic) sparse matrices (port of ``repro.core.solvers``).

CG is the paper's workload (HPCG, benchmarked with the preconditioner
disabled, §IV-B). The solvers are generic over an ``apply_A`` closure.

JAX runs ``cg`` and ``pcg`` as one device-side ``while_loop`` and
``cg_fixed_iters`` under ``scan``. The port runs the loop in blocks of
``K`` masked iterations (:func:`block_iters`): each iteration is active
while ``rr > tol2 and k < maxiter`` (JAX's ``cond``), evaluated on the
device, and an inactive one leaves ``x``, ``r``, ``p``, the scalars, ``k``
and ``history`` bit for bit as they were. The state lives in buffers that
the block updates in place; the vector algebra is
:mod:`repro_torch.kernels.solver_vec` (the hand-written kernels on the
card, the ``ops.dot`` / ``axpy`` / ``waxpby`` sequence on the CPU).

On a CUDA tensor the first block runs eagerly (it warms every route, plan
cache and lazy kernel build); the block is then captured into one
``torch.cuda.CUDAGraph`` and later blocks replay it. The host reads the
flag once a block: one device->host sync per ``K`` iterations, and none at
all in :func:`cg_fixed_iters`, which knows its count. The capture takes in
whatever ``apply_A`` / ``apply_M`` launch (any format's SpMV, ``dist_spmv``,
the V-cycle); one that cannot be captured (it syncs, say) raises with the
capture's error, and nothing falls back to the eager loop. Python code
inside the closures runs at capture time only: a trace span such as
``mg.vcycle`` opens once a capture (JAX opens it once per jit trace), and a
caller's counter of calls counts the eager block and the capture, not the
replays (:data:`last_loop` says how many blocks ran which way). The
kernels' launch counts (``kernels.ops.launch_counts``,
``solver_vec.launches``) count what the device ran: the launches recorded
into the capture are taken back out of them, and each replay adds them
again. On the CPU every block runs eagerly through the plain versions.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import ops as _ops
from repro_torch.kernels import ops as _kops
from repro_torch.kernels import solver_vec as _sv

# Iterations a block. A block costs up to K - 1 masked iterations past
# convergence and saves K - 1 host syncs: a CG (or Jacobi-PCG) iteration is
# a few launches, so K = 8; a caller's apply_M (a V-cycle: hundreds of
# launches, milliseconds an iteration) makes a masked iteration dear and the
# sync cheap beside it, so K = 2.
BLOCK_ITERS = 8
BLOCK_ITERS_PRECOND = 2


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    resnorm: torch.Tensor  # final ||r||_2
    # ``history[k] = ||r_k||_2`` with ``history[0]`` the initial residual;
    # entries past the converged iteration are NaN; shape ``(maxiter + 1,)``.
    history: Optional[torch.Tensor] = None


class LoopStats(NamedTuple):
    """How the last solve ran its blocks: ``k_block`` iterations a block,
    ``eager`` blocks run eagerly, ``captured`` whether a block was captured
    into a CUDA graph, ``replays`` how often it was replayed, ``syncs`` the
    host's reads of the loop flag. Iterations issued = ``k_block * (eager +
    replays)``, of which ``iters`` were active."""
    k_block: int
    eager: int
    captured: bool
    replays: int
    syncs: int
    iters: int


last_loop: Optional[LoopStats] = None


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


def block_iters(preconditioned: bool) -> int:
    """K: :data:`BLOCK_ITERS`, or :data:`BLOCK_ITERS_PRECOND` for a caller's
    ``apply_M``."""
    return BLOCK_ITERS_PRECOND if preconditioned else BLOCK_ITERS


class _Loop:
    """The solver state in place and one masked iteration over it."""

    def __init__(self, apply_A, apply_M, b, x0, tol, maxiter, fixed):
        self.apply_A, self.apply_M = apply_A, apply_M
        self.maxiter, self.fixed = maxiter, fixed
        acc = _sv.acc_dtype(b.dtype)
        self.x = torch.zeros_like(b) if x0 is None else x0.clone()
        self.r = b - apply_A(self.x)
        z = self.r if apply_M is None else apply_M(self.r)
        self.p = z.clone()
        rr = _sv.dot(self.r, self.r).sum()
        rho = rr if apply_M is None else _sv.dot(self.r, z).sum()
        # tol rounded to the scalars' dtype and squared there, as JAX's
        # asarray(tol, dtype) ** 2, on the host: no copy to the card
        tol_sq = float(torch.tensor(tol, dtype=acc) ** 2)
        tol2 = tol_sq * torch.clamp(rr, min=_sv.FLOOR)
        self.sc = torch.stack([rr, rho, tol2]).to(acc)
        active = (rr > tol2) | fixed
        self.st = torch.stack([torch.zeros((), dtype=torch.int64, device=b.device),
                               (active & (maxiter > 0)).to(torch.int64)])
        self.hist = torch.full((maxiter + 1,), math.nan, dtype=b.dtype, device=b.device)
        self.hist[0] = torch.sqrt(rr).to(b.dtype)

    def iteration(self) -> None:
        ap = self.apply_A(self.p)
        rr = _sv.update(self.x, self.r, self.p, ap, _sv.dot(self.p, ap), self.sc, self.st)
        if self.apply_M is None:
            _sv.direction(self.p, self.r, rr, self.sc, self.st)
            _sv.finish(rr, None, self.sc, self.st, self.hist, self.maxiter, self.fixed)
        else:
            z = self.apply_M(self.r)
            rz = _sv.dot(self.r, z)
            _sv.direction(self.p, z, rz, self.sc, self.st)
            _sv.finish(rr, rz, self.sc, self.st, self.hist, self.maxiter, self.fixed)

    def result(self, iters: int) -> CGResult:
        return CGResult(self.x, iters, torch.sqrt(self.sc[0]).to(self.x.dtype), self.hist)


def _launch_counts() -> dict:
    """Every kernel wrapper's launch count: ``(module, attribute)`` of
    ``kernels.ops``' counters, ``(None, kernel)`` of ``solver_vec``'s."""
    regs = {*_kops.LAUNCH_COUNTERS.values(), *_kops.SCHEDULE_COUNTERS.values()}
    out = {(mod, attr): getattr(mod, attr) for mod, attr in regs}
    out.update({(None, k): v for k, v in _sv.launches.items()})
    return out


def _add_launches(delta: dict, sign: int = 1) -> None:
    for (mod, attr), d in delta.items():
        if mod is None:
            _sv.launches[attr] += sign * d
        else:
            setattr(mod, attr, getattr(mod, attr) + sign * d)


def _capture(block: Callable, dev: torch.device) -> "torch.cuda.CUDAGraph":
    """``block`` captured into a CUDA graph on a side stream; raises (with
    the capture's error) when something in it cannot be captured."""
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        g.capture_begin()
        try:
            block()
        except Exception as e:
            try:
                g.capture_end()
            except Exception:  # the capture was invalidated by the same error
                pass
            raise RuntimeError(f"the solver's block of iterations cannot be captured into a "
                               f"CUDA graph (apply_A / apply_M must not sync with the host): "
                               f"{e}") from e
        g.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    return g


def _run(loop: _Loop, k_block: int, nblocks: Optional[int] = None) -> int:
    """Run ``loop`` in blocks of ``k_block`` iterations: until the flag is
    off (``nblocks`` None), or exactly ``nblocks`` blocks with no read of
    the flag. Returns the iterations done."""
    global last_loop
    dev = loop.x.device
    graph, eager, replays, syncs, in_graph = None, 0, 0, 0, {}

    def block():
        for _ in range(k_block):
            loop.iteration()

    def next_block():  # eager on the CPU and the first time; then replays
        nonlocal graph, eager, replays, in_graph
        if eager == 0 or dev.type != "cuda":
            block()
            eager += 1
            return
        if graph is None:  # the launches recorded run at each replay, not now
            before = _launch_counts()
            try:
                graph = _capture(block, dev)
            finally:
                in_graph = {k: v - before[k] for k, v in _launch_counts().items()
                            if v != before[k]}
                _add_launches(in_graph, -1)
        graph.replay()
        _add_launches(in_graph)
        replays += 1

    if nblocks is not None:  # cg_fixed_iters: no flag to read
        for _ in range(nblocks):
            next_block()
        iters = min(loop.maxiter, k_block * nblocks)
    else:
        next_block()
        iters, active = loop.st.tolist()
        syncs += 1
        while active:
            next_block()
            iters, active = loop.st.tolist()
            syncs += 1
    last_loop = LoopStats(k_block, eager, graph is not None, replays, syncs, iters)
    return iters


def cg(apply_A: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       tol: float = 1e-8, maxiter: int = 100) -> CGResult:
    """Unpreconditioned conjugate gradients (HPCG's optimized-phase solve):
    stops when ||r||^2 <= tol^2 * ||r_0||^2 or after ``maxiter`` steps."""
    loop = _Loop(apply_A, None, b, x0, tol, maxiter, fixed=False)
    return loop.result(_run(loop, block_iters(False)))


def cg_fixed_iters(apply_A: Callable, b: torch.Tensor,
                   x0: Optional[torch.Tensor] = None, iters: int = 50) -> CGResult:
    """Fixed-iteration CG (no early exit, no host sync): the HPCG
    'optimized problem timing' loop shape, same step as :func:`cg`."""
    loop = _Loop(apply_A, None, b, x0, 0.0, iters, fixed=True)
    k = block_iters(False)
    return loop.result(_run(loop, k, nblocks=max(1, -(-iters // k))))


def pcg(apply_A: Callable, b: torch.Tensor,
        diag_A: Optional[torch.Tensor] = None,
        x0: Optional[torch.Tensor] = None, tol: float = 1e-8,
        maxiter: int = 100, *, apply_M: Optional[Callable] = None) -> CGResult:
    """Preconditioned CG over ``z = M^{-1} r``: ``apply_M`` is any SPD
    linear map; without it, ``diag_A`` gives the Jacobi preconditioner
    M = diag(A). Convergence is tested on ||r||^2, as in :func:`cg`."""
    k = block_iters(apply_M is not None)
    if apply_M is None:
        if diag_A is None:
            raise ValueError("pcg needs apply_M= (e.g. an MG V-cycle) or "
                             "diag_A= (Jacobi)")
        minv = torch.where(diag_A.abs() > 1e-30, 1.0 / diag_A,
                           torch.zeros((), dtype=diag_A.dtype, device=diag_A.device))
        apply_M = lambda r: minv * r  # noqa: E731
    loop = _Loop(apply_A, apply_M, b, x0, tol, maxiter, fixed=False)
    return loop.result(_run(loop, k))
