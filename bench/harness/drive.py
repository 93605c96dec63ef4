"""The one generator of traffic: a closed loop with one client that solves
one system after another over a pool of right-hand sides.

A traffic mix is data (``bench/traffic/<name>.json``): the solver
(``cg`` or ``pcg_mg``, entries of :data:`SOLVERS`), its ``tol`` and
``maxiter``, the pool, the sample of solves kept for the check, and
``trace_seconds``, the part of the window a ``--trace 1`` run profiles.
Each solve is timed from the call to its result on the host, synchronised.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from harness.system import sync


def _cg(system, b, traffic):
    from repro_torch.core.solvers import cg

    return cg(system.apply_A, b, tol=traffic["tol"], maxiter=traffic["maxiter"])


def _pcg_mg(system, b, traffic):
    from repro_torch.core.solvers import pcg

    return pcg(system.apply_A, b, tol=traffic["tol"], maxiter=traffic["maxiter"],
               apply_M=system.apply_M)


SOLVERS: Dict[str, Callable] = {"cg": _cg, "pcg_mg": _pcg_mg}


def failed(res, traffic: dict) -> bool:
    """A solve with a tolerance fails when it stops at ``maxiter`` short of
    it; a set of fixed iterations, when it runs fewer."""
    if traffic["tol"] > 0:
        h0 = float(res.history[0])
        return res.iters >= traffic["maxiter"] and float(res.resnorm) > traffic["tol"] * h0
    return res.iters != traffic["maxiter"]


def sample_indices(traffic: dict, seed: int) -> set:
    """The solves whose outputs the check keeps, drawn from ``seed``: a
    ``draw`` of the first ``from_first`` (and the window's last solve)."""
    s = traffic["sample"]
    rng = np.random.default_rng(int(seed))
    return set(int(i) for i in rng.choice(s["from_first"], size=s["draw"], replace=False))


def solve(system, b: torch.Tensor, traffic: dict):
    return SOLVERS[traffic["solver"]](system, b, traffic)


def window(system, pool: Sequence[torch.Tensor], traffic: dict, seconds: float, seed: int,
           device: torch.device, profiler_factory: Optional[Callable] = None,
           solves_max: Optional[int] = None) -> dict:
    """Solve over ``pool`` in turn until ``seconds`` have passed; returns the
    window's records. With ``profiler_factory`` the first
    ``trace_seconds`` of the window run under the profiler it makes. With
    ``solves_max`` the window is that many solves, every one kept."""
    keep = sample_indices(traffic, seed) if solves_max is None else set(range(solves_max))
    solves: List[dict] = []
    samples: List[dict] = []
    prof = profiler_factory() if profiler_factory is not None else None
    traced = None
    sync(device)
    start = time.perf_counter()
    if prof is not None:
        prof.__enter__()
    i, last = 0, None
    while True:
        rhs = i % len(pool)
        t0 = time.perf_counter()
        with (torch.profiler.record_function("bench.solve") if prof is not None
              else contextlib.nullcontext()):
            res = solve(system, pool[rhs], traffic)
            sync(device)
        t1 = time.perf_counter()
        solves.append({"ms": (t1 - t0) * 1e3, "iters": int(res.iters),
                       "failed": failed(res, traffic)})
        out = {"index": i, "rhs": rhs, "x": res.x, "history": res.history,
               "iters": int(res.iters)}
        if i in keep:
            samples.append(out)
        last = out
        i += 1
        if prof is not None and t1 - start >= traffic["trace_seconds"]:
            prof.__exit__(None, None, None)
            traced = {"prof": prof, "solves": i, "seconds": t1 - start}
            prof = None
        if (t1 - start >= seconds) if solves_max is None else i >= solves_max:
            break
    end = t1
    if prof is not None:  # the window was shorter than trace_seconds
        prof.__exit__(None, None, None)
        traced = {"prof": prof, "solves": i, "seconds": end - start}
    if last["index"] not in keep:
        samples.append(last)
    return {"seconds": end - start, "solves": solves, "samples": samples, "traced": traced}
