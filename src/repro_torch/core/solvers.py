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

Every call of :func:`cg`, :func:`pcg` or :func:`cg_fixed_iters` that
returns appends one :class:`LoopStats` to :data:`loops`: its blocks, and
its host time split into five phases that partition it from the call to
the return (the preamble, the eager blocks, the capture, the replays with
the graph's release, and the waits in the flag reads), with the caching
allocator's ``cudaMalloc`` and ``cudaFree`` calls on the card. The same
phases open the trace spans ``solver.preamble``, ``solver.eager_block``,
``solver.capture``, ``solver.replay`` and ``solver.wait``
(:mod:`repro_torch.obs.trace`; on the profiler's timeline whenever it
records). The record is always on: a few clock reads, three reads of the
allocator's counters on the card, one tuple a solve.
"""
from __future__ import annotations

import collections
import math
import time
from typing import Callable, Deque, List, NamedTuple, Optional

import torch

from repro_torch.core import ops as _ops
from repro_torch.kernels import ops as _kops
from repro_torch.kernels import solver_vec as _sv
from repro_torch.obs import trace as _trace

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
    """How a solve ran its blocks: ``k_block`` iterations a block,
    ``eager`` blocks run eagerly, ``captured`` whether a block was captured
    into a CUDA graph, ``replays`` how often it was replayed, ``syncs`` the
    host's reads of the loop flag. Iterations issued = ``k_block * (eager +
    replays)``, of which ``iters`` were active.

    The host's milliseconds from the call to the return, in five phases
    that sum to it: ``preamble_ms`` (the first residual, ``pcg``'s first
    ``apply_M``, the dots, the state's buffers), ``eager_ms`` (the blocks
    run eagerly, their flag reads left out), ``capture_ms`` (the capture),
    ``replay_ms`` (the replays, the graph's release and the result) and
    ``wait_ms`` (the host blocked in the flag reads while the device runs
    what was enqueued). ``device_allocs``: the caching allocator's
    ``cudaMalloc`` and ``cudaFree`` calls (``num_device_alloc +
    num_device_free``) over the solve; 0 on the CPU."""
    k_block: int
    eager: int
    captured: bool
    replays: int
    syncs: int
    iters: int
    preamble_ms: float
    eager_ms: float
    capture_ms: float
    replay_ms: float
    wait_ms: float
    device_allocs: int


# one record a returned solve, oldest first; ``last_loop is loops[-1]``
loops: Deque[LoopStats] = collections.deque(maxlen=16384)
last_loop: Optional[LoopStats] = None

# the phases of :class:`LoopStats`, in its order
PREAMBLE, EAGER, CAPTURE, REPLAY, WAIT = range(5)


def _device_allocs(dev: torch.device) -> int:
    """The caching allocator's ``cudaMalloc`` and ``cudaFree`` calls on
    ``dev`` so far."""
    if dev.type != "cuda":
        return 0
    st = torch.cuda.memory_stats_as_nested_dict(dev)
    return st.get("num_device_alloc", 0) + st.get("num_device_free", 0)


class _Meter:
    """How one solve runs, for its :class:`LoopStats`: the blocks, the
    graph while it lives, the host time by phase (:meth:`lap` charges the
    time since the previous lap to a phase, so the phases sum to the
    solve's time with no overlap) and the allocator's ``cudaMalloc`` and
    ``cudaFree`` calls since the start (:meth:`allocs`)."""

    __slots__ = ("t", "ns", "dev", "allocs0", "eager", "replays", "syncs", "graph")

    def __init__(self, dev: torch.device):
        self.t = time.perf_counter_ns()
        self.ns: List[int] = [0] * 5
        self.dev, self.allocs0 = dev, _device_allocs(dev)
        self.eager = self.replays = self.syncs = 0
        self.graph: Optional["torch.cuda.CUDAGraph"] = None

    def lap(self, phase: int) -> None:
        now = time.perf_counter_ns()
        self.ns[phase] += now - self.t
        self.t = now

    def allocs(self) -> int:
        return _device_allocs(self.dev) - self.allocs0


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
    the flag. Returns the iterations done; ``loop.meter`` says how, and
    holds the captured graph until :func:`_solve` releases it."""
    m = loop.meter
    dev, in_graph = loop.x.device, {}

    def block():
        for _ in range(k_block):
            loop.iteration()

    def next_block():  # eager on the CPU and the first time; then replays
        nonlocal in_graph
        if m.eager == 0 or dev.type != "cuda":
            with _trace.span("solver.eager_block"):
                block()
            m.eager += 1
            m.lap(EAGER)
            return
        if m.graph is None:  # the launches recorded run at each replay, not now
            with _trace.span("solver.capture") as sp:
                before = _launch_counts()
                try:
                    m.graph = _capture(block, dev)
                finally:
                    in_graph = {k: v - before[k] for k, v in _launch_counts().items()
                                if v != before[k]}
                    _add_launches(in_graph, -1)
                sp.set(device_allocs=m.allocs())
            m.lap(CAPTURE)
        with _trace.span("solver.replay"):
            m.graph.replay()
            _add_launches(in_graph)
        m.replays += 1
        m.lap(REPLAY)

    def flag():
        with _trace.span("solver.wait"):
            out = loop.st.tolist()
        m.syncs += 1
        m.lap(WAIT)
        return out

    if nblocks is not None:  # cg_fixed_iters: no flag to read
        for _ in range(nblocks):
            next_block()
        return min(loop.maxiter, k_block * nblocks)
    next_block()
    iters, active = flag()
    while active:
        next_block()
        iters, active = flag()
    return iters


def _solve(make_loop: Callable[[], _Loop], dev: torch.device, k_block: int,
           nblocks: Optional[int] = None) -> CGResult:
    """The loop that ``make_loop`` sets up, run by :func:`_run`; appends
    the solve's :class:`LoopStats` to :data:`loops`."""
    global last_loop
    with _trace.span("solver.preamble"):
        m = _Meter(dev)
        loop = make_loop()
    loop.meter = m
    m.lap(PREAMBLE)
    iters = _run(loop, k_block, nblocks)
    captured = m.graph is not None
    with _trace.span("solver.replay"):
        m.graph = None  # the graph and its private pool go
        allocs = m.allocs()
        res = loop.result(iters)
    m.lap(REPLAY)
    last_loop = LoopStats(k_block, m.eager, captured, m.replays, m.syncs, iters,
                          *(ns * 1e-6 for ns in m.ns), allocs)
    loops.append(last_loop)
    return res


def cg(apply_A: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       tol: float = 1e-8, maxiter: int = 100) -> CGResult:
    """Unpreconditioned conjugate gradients (HPCG's optimized-phase solve):
    stops when ||r||^2 <= tol^2 * ||r_0||^2 or after ``maxiter`` steps."""
    return _solve(lambda: _Loop(apply_A, None, b, x0, tol, maxiter, fixed=False),
                  b.device, block_iters(False))


def cg_fixed_iters(apply_A: Callable, b: torch.Tensor,
                   x0: Optional[torch.Tensor] = None, iters: int = 50) -> CGResult:
    """Fixed-iteration CG (no early exit, no host sync): the HPCG
    'optimized problem timing' loop shape, same step as :func:`cg`."""
    k = block_iters(False)
    return _solve(lambda: _Loop(apply_A, None, b, x0, 0.0, iters, fixed=True),
                  b.device, k, nblocks=max(1, -(-iters // k)))


def pcg(apply_A: Callable, b: torch.Tensor,
        diag_A: Optional[torch.Tensor] = None,
        x0: Optional[torch.Tensor] = None, tol: float = 1e-8,
        maxiter: int = 100, *, apply_M: Optional[Callable] = None) -> CGResult:
    """Preconditioned CG over ``z = M^{-1} r``: ``apply_M`` is any SPD
    linear map; without it, ``diag_A`` gives the Jacobi preconditioner
    M = diag(A). Convergence is tested on ||r||^2, as in :func:`cg`."""
    if apply_M is None and diag_A is None:
        raise ValueError("pcg needs apply_M= (e.g. an MG V-cycle) or "
                         "diag_A= (Jacobi)")
    k = block_iters(apply_M is not None)

    def make_loop():
        M = apply_M
        if M is None:
            minv = torch.where(diag_A.abs() > 1e-30, 1.0 / diag_A,
                               torch.zeros((), dtype=diag_A.dtype, device=diag_A.device))
            M = lambda r: minv * r  # noqa: E731
        return _Loop(apply_A, M, b, x0, tol, maxiter, fixed=False)
    return _solve(make_loop, b.device, k)
