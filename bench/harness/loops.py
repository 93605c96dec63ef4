"""The port's record of each solve (``repro_torch.core.solvers.loops``, one
``LoopStats`` a call of ``cg``, ``pcg`` or ``cg_fixed_iters``), read over
a run's window for the solver layer's readers under ``bench/metrics/``.

The window's solves are the last N records, N the window's solves: nothing
calls the port's solvers between the window and the readers (the check's
reference is the harness's own). The traced solves, the window's first,
are dropped, as ``solve_p95_ms.cg`` drops them. Each function returns None
where there is nothing to read: a program that keeps no such record, fewer
records than solves, no untraced solve.
"""
from __future__ import annotations

from typing import List, Optional


def untraced(ctx: dict) -> Optional[List[tuple]]:
    """The records of the window's untraced solves, oldest first."""
    from repro_torch.core import solvers

    recs = getattr(solvers, "loops", None)
    n = len(ctx["window"]["solves"])
    if recs is None or len(recs) < n:
        return None
    traced = len(ctx["trace"]["solves"]) if ctx["trace"] is not None else 0
    return list(recs)[len(recs) - n + traced:] or None


def mean(ctx: dict, field: str, card_only: bool = False) -> Optional[float]:
    """The mean of ``field`` over the window's untraced solves; with
    ``card_only``, None where the run was not on the card (no peaks)."""
    if card_only and ctx["peaks"] is None:
        return None
    recs = untraced(ctx)
    if recs is None or not hasattr(recs[0], field):
        return None
    return sum(float(getattr(r, field)) for r in recs) / len(recs)
