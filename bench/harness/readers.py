"""Arithmetic the metric readers under ``bench/metrics/`` share. Every
function returns None where the run has nothing for it to read: no trace,
no card's peaks, no matching kernel."""
from __future__ import annotations

import re
from typing import Optional


def active_iters(solves) -> int:
    return sum(s["iters"] for s in solves)


def iter_roofline(ctx: dict) -> Optional[float]:
    """Percent: the window's active iterations at the configuration's bytes
    an iteration, moved at the card's HBM rate, over the window's wall time."""
    if ctx["peaks"] is None:
        return None
    w = ctx["window"]
    need_s = active_iters(w["solves"]) * ctx["work"]["bytes"]["iter"] / ctx["peaks"]["hbm_Bps"]
    return 100.0 * need_s / w["seconds"]


def launches_per_iter(ctx: dict) -> Optional[float]:
    """The port's kernel launches in the window (replays counted) per
    active iteration; None where nothing was launched (the CPU)."""
    w = ctx["window"]
    iters = active_iters(w["solves"])
    if not w["launches"] or not iters:
        return None
    return w["launches"] / iters


def idle_share(ctx: dict) -> Optional[float]:
    t = ctx["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]


def kernel_seconds(ctx: dict, pattern: str):
    """``(seconds, launches)`` of the traced device operations whose short
    name matches ``pattern``; None without a trace or a match."""
    t = ctx["trace"]
    if t is None:
        return None
    rx = re.compile(pattern)
    hits = [v for n, v in t["by_name"].items() if rx.search(n)]
    if not hits:
        return None
    return sum(v["seconds"] for v in hits), sum(v["launches"] for v in hits)


def kernel_roofline(ctx: dict, pattern: str, bytes_key: str,
                    count: Optional[float] = None) -> Optional[float]:
    """Percent: ``count`` (default: the matching kernels' launches) times
    the configuration's ``bytes_key`` bytes at the HBM rate over the
    matching kernels' traced device time."""
    ks = kernel_seconds(ctx, pattern)
    if ks is None or ctx["peaks"] is None or ks[0] <= 0:
        return None
    count = ks[1] if count is None else count
    need_s = count * ctx["work"]["bytes"][bytes_key] / ctx["peaks"]["hbm_Bps"]
    return 100.0 * need_s / ks[0]
