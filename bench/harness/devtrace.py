"""Reading ``torch.profiler``'s trace of part of the window.

:func:`events` turns a finished profiler into plain tuples
``(name, start_ns, end_ns, on_device)``; :func:`summarise` reduces them to
what the per-layer readers and the ``breakdown`` need: the device's busy
seconds (the union of every kernel, copy and fill on the card), its time
by operation name, and the longest idle gaps, each named by the host
operation that was running at its middle.
"""
from __future__ import annotations

import bisect
import re
from typing import Dict, List, Sequence, Tuple

Event = Tuple[str, int, int, bool]


def events(prof) -> List[Event]:
    """Every event of a finished ``torch.profiler.profile``, but the device
    side's copies of host annotations (``record_function`` ranges), which
    span work without being any."""
    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = "CUDA" in str(e.device_type())
        if on_device and e.is_user_annotation():
            continue
        out.append((e.name(), int(e.start_ns()), int(e.end_ns()), on_device))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' noise,
    template arguments and parameter list."""
    s = re.sub(r"^void\s+", "", name)
    s = s.replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in s:  # drop <...> and (...) at any depth
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name[:64]


def _union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _host_at(host: List[Event], starts: List[int], t: int) -> str:
    """The innermost host operation running at ``t`` (shortest that
    covers it), or ``host`` where none was recorded."""
    best, best_len = "host (no operation recorded)", None
    i = bisect.bisect_right(starts, t)
    for name, s, e, _ in host[max(0, i - 4000):i]:
        if s <= t <= e and (best_len is None or e - s < best_len):
            best, best_len = name, e - s
    return best


def summarise(evs: Sequence[Event], window_s: float, top: int = 10) -> dict:
    """``busy_s``, ``window_s``, ``by_name`` (device seconds by short name,
    with the launch count), ``ops`` and ``gaps`` (the ``breakdown``
    lists) of the traced events."""
    dev = [e for e in evs if e[3] and e[2] > e[1]]
    host = sorted((e for e in evs if not e[3]), key=lambda e: e[1])
    busy = _union([(s, e) for _, s, e, _ in dev])
    by_name: Dict[str, List[float]] = {}
    for name, s, e, _ in dev:
        acc = by_name.setdefault(short_name(name), [0.0, 0])
        acc[0] += (e - s) * 1e-9
        acc[1] += 1
    gaps = []
    if busy:
        lo = min([busy[0][0]] + [h[1] for h in host[:1]])
        hi = max([busy[-1][1]] + [max((h[2] for h in host), default=0)])
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    starts = [h[1] for h in host]
    named = [[_host_at(host, starts, (a + b) // 2), (b - a) * 1e-9] for a, b in gaps[:top]]
    ops = sorted(([n, v[0]] for n, v in by_name.items()), key=lambda x: -x[1])[:top]
    return {"busy_s": sum(e - s for s, e in busy) * 1e-9, "window_s": window_s,
            "by_name": {n: {"seconds": v[0], "launches": v[1]} for n, v in by_name.items()},
            "ops": ops, "gaps": named}
