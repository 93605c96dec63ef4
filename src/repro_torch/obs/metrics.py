"""Named monotonic counters, gauges and bucketed histograms (port of
``repro.obs.metrics``).

Counters are always on: one dict update under a lock, made only on host
decision paths (planning, selection, routing), never inside a kernel. They
answer what the tracer's spans cannot: *how many* times did each decision go
each way over a whole run?

Standard counter names (incremented by the instrumented layers):

    planned_pulls               sanctioned symbolic-phase device->host syncs
                                (``repro_torch.core.convert._planned_pull``)
    selection.cache_hit/miss    selection-store lookups
                                (``repro_torch.tuning.cache``)
    kernel.route.cuda           ``backend="auto"`` calls routed to a kernel by
                                a record that beat the reference
    kernel.route.veto           ... kept on the reference by a record that lost
    kernel.route.ref            ... kept on the reference with no record, or
                                off the card (``repro_torch.core.ops.kernel_route``)
    halo.bytes                  bytes a distributed SpMV's halo exchange
                                moves (P * halo width * itemsize a call)
    distplan.cache_hit/miss     ``build_dist_matrix(plan_cache=)`` lookups
                                of a persisted DistPlan
    replan.pattern_sig          reused DistPlans whose memoised format plans
                                were dropped for a changed live pattern
                                (``repro_torch.core.distributed``)
    trace.dropped_events        full-mode trace ring overwrites (the export
                                is truncated when this is nonzero)
    serve.retune                ``LinearSparse.retune`` calls: every
                                width-aware re-selection of a weight format
    serve.format_switch         the retunes that changed the weight's format
                                (``repro_torch.models.linear_sparse``)

Standard histogram names (:func:`observe`):

    ell.padding_waste           1 - nnz/(m*k) of each planned ELL layout
    hyb.padding_waste           the same for the ELL part of each HYB plan
    sell.padding_waste          1 - nnz/slots of each planned SELL-C-sigma
                                slicing (per-slice widths, after the sort)

Kernel launches are counted by each kernel module's ``launches`` integer
(``repro_torch.kernels.ops.launch_counts``), not here.

Histograms have **fixed bucket boundaries** (a 1-2-5 geometric series from
1e-3 to 5e8 by default, about +-25% resolution anywhere in range), so
p50/p95/p99 come from :func:`quantile` without storing raw samples;
:func:`define_histogram` sets other boundaries for a name. The estimate is
the JAX package's, so the same observations give the same quantiles.
Gauges (:func:`set_gauge`) keep the last value written.

``snapshot()`` returns a plain, JSON-ready dict (the JAX package's layout);
``scope()`` gives order-independent deltas, so a test's assertion does not
depend on what ran earlier in the process.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, Optional, Sequence, Tuple

_LOCK = threading.Lock()
_COUNTERS: Dict[str, float] = {}
# name -> [count, sum, min, max, bucket_counts]; bucket_counts has
# len(boundaries) + 1 slots (the last one is the overflow bucket).
_HISTS: Dict[str, list] = {}
# name -> boundaries (sorted, ascending); set at the first observe from
# DEFAULT_BUCKETS unless define_histogram() registered others.
_BOUNDS: Dict[str, Tuple[float, ...]] = {}
_GAUGES: Dict[str, float] = {}


def _geometric_125(lo_exp: int, hi_exp: int) -> Tuple[float, ...]:
    """1-2-5 series boundaries covering 10**lo_exp .. 5 * 10**hi_exp."""
    out = []
    for e in range(lo_exp, hi_exp + 1):
        for m in (1.0, 2.0, 5.0):
            out.append(m * 10.0 ** e)
    return tuple(out)


# Covers 0..1 waste ratios, microsecond latencies and multi-second builds.
DEFAULT_BUCKETS = _geometric_125(-3, 8)


def define_histogram(name: str, buckets: Sequence[float]) -> None:
    """Register fixed bucket boundaries for histogram ``name``, before its
    first :func:`observe` (counts cannot be re-binned without the samples)."""
    b = tuple(sorted(float(v) for v in buckets))
    if not b:
        raise ValueError("buckets must be non-empty")
    with _LOCK:
        if name in _HISTS:
            raise ValueError(f"histogram {name!r} already has observations; "
                             "define buckets before the first observe()")
        _BOUNDS[name] = b


def inc(name: str, n: float = 1) -> None:
    """Increment counter ``name`` by ``n`` (created at 0 on first use)."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def set_gauge(name: str, value: float) -> None:
    """Set gauge ``name`` to ``value`` (last write wins)."""
    with _LOCK:
        _GAUGES[name] = float(value)


def gauge(name: str, default: float = 0) -> float:
    """Current value of gauge ``name``."""
    with _LOCK:
        return _GAUGES.get(name, default)


def observe(name: str, value: float) -> None:
    """Record ``value`` into histogram ``name`` (count, sum, min, max and
    its fixed-boundary bucket)."""
    v = float(value)
    with _LOCK:
        h = _HISTS.get(name)
        if h is None:
            bounds = _BOUNDS.setdefault(name, DEFAULT_BUCKETS)
            h = _HISTS[name] = [0, 0.0, float("inf"), float("-inf"),
                                [0] * (len(bounds) + 1)]
        h[0] += 1
        h[1] += v
        h[2] = min(h[2], v)
        h[3] = max(h[3], v)
        h[4][bisect.bisect_left(_BOUNDS[name], v)] += 1


def value(name: str, default: float = 0) -> float:
    """Current value of counter ``name``."""
    with _LOCK:
        return _COUNTERS.get(name, default)


def quantile(name: str, q: float) -> Optional[float]:
    """The ``q``-quantile (0..1) of histogram ``name`` from its bucket
    counts: the mid-rank interpolated linearly within its bucket, clamped to
    the observed [min, max]. None when the histogram is empty."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile {q} outside [0, 1]")
    with _LOCK:
        h = _HISTS.get(name)
        if h is None or h[0] == 0:
            return None
        count, lo, hi = h[0], h[2], h[3]
        counts = list(h[4])
        bounds = _BOUNDS[name]
    rank = q * (count - 1) + 0.5  # mid-rank convention
    seen = 0.0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if seen + c >= rank:
            # bucket i spans (bounds[i-1], bounds[i]]; the edge buckets are
            # clamped by the observed min/max
            b_lo = bounds[i - 1] if i > 0 else lo
            b_hi = bounds[i] if i < len(bounds) else hi
            b_lo = max(b_lo, lo)
            b_hi = min(b_hi, hi)
            if b_hi <= b_lo:
                return float(b_lo)
            frac = (rank - seen) / c
            return float(b_lo + frac * (b_hi - b_lo))
        seen += c
    return float(hi)


def quantiles(name: str, qs: Sequence[float] = (0.5, 0.95, 0.99)
              ) -> Dict[str, Optional[float]]:
    """``{"p50": ..., "p95": ..., "p99": ...}`` for the standard cuts."""
    return {f"p{round(q * 100)}": quantile(name, q) for q in qs}


def snapshot() -> dict:
    """JSON-ready snapshot: counters, gauges, and histograms with their
    p50/p95/p99 bucket estimates."""
    with _LOCK:
        hist_names = list(_HISTS)
        base = {
            name: {"count": h[0], "sum": h[1], "min": h[2], "max": h[3],
                   "mean": h[1] / max(1, h[0])}
            for name, h in _HISTS.items()}
        counters = dict(_COUNTERS)
        gauges = dict(_GAUGES)
    for name in hist_names:
        base[name].update(quantiles(name))
    return {"counters": counters, "gauges": gauges, "histograms": base}


def reset(names: Optional[Iterable[str]] = None) -> None:
    """Zero counters, gauges and histograms (all, or just ``names``).
    Bucket definitions survive a reset."""
    with _LOCK:
        if names is None:
            _COUNTERS.clear()
            _HISTS.clear()
            _GAUGES.clear()
        else:
            for n in names:
                _COUNTERS.pop(n, None)
                _HISTS.pop(n, None)
                _GAUGES.pop(n, None)


class Scope:
    """Delta view of the counters since scope entry (see :func:`scope`)."""

    def __init__(self):
        with _LOCK:
            self._base = dict(_COUNTERS)

    def delta(self, name: str) -> float:
        """Counter growth since the scope opened."""
        return value(name) - self._base.get(name, 0)

    def deltas(self) -> Dict[str, float]:
        """Every counter that moved since the scope opened."""
        with _LOCK:
            cur = dict(_COUNTERS)
        out = {}
        for name, v in cur.items():
            d = v - self._base.get(name, 0)
            if d:
                out[name] = d
        return out

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def scope() -> Scope:
    """``with metrics.scope() as s: ...; s.delta("planned_pulls")``: the
    scope never writes the global counters, so nested scopes and earlier
    activity cannot disturb each other."""
    return Scope()
