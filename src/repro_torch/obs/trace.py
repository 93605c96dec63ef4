"""Structured tracing: spans, events, Chrome/Perfetto export (port of
``repro.obs.trace``).

Every run-time decision of the workflow (format selection, switch planning,
kernel routing, distributed and multigrid builds) leaves a span or an event:

* ``span("plan.switch", fmt="ELL")`` is a context manager that times a
  region and records it (name, host time, thread, parent span, attributes)
  into a bounded thread-safe ring buffer.
* The ``REPRO_TRACE`` environment variable gates everything (the JAX
  package's variable and modes):

    - ``off``      (default) ``span()`` returns a shared no-op object: the
                   hot path costs one global load and one branch.
    - ``summary``  spans are timed and folded into per-name aggregates
                   (count/total/min/max); no per-event storage.
    - ``full``     aggregates *plus* the event ring buffer, exportable to
                   ``trace.json`` (``chrome://tracing`` or Perfetto's
                   ``ui.perfetto.dev``) with :func:`export_chrome`.

* **What a span measures.** The port runs eagerly and CUDA launches are
  asynchronous, so a span around ``y = spmv(A, x)`` measures the time the
  host took to *enqueue* the work, not the device's time. Register tensors
  with ``sp.sync(y)`` and the span calls ``torch.cuda.synchronize`` on the
  device of the registered CUDA tensors *once, at span close*: never in
  off mode, never when nothing was registered, never anywhere else. The
  hot paths (``spmv``, ``dist_spmv``, the V-cycle) register nothing, so no
  mode adds a device->host sync to them.

* **Eager, not trace time.** The JAX package opens ``mg.vcycle`` or
  ``exchange.dist_spmv`` once per jit trace; the port opens them on every
  call, and only while tracing is on.

The tracer imports nothing heavy: ``torch`` is imported inside the sync of
an active span only.

Span-name taxonomy (the first dotted component is the phase the report
attributes time to; see ``repro_torch.obs.report``):

    select.*    FormatPolicy decisions (``select.policy``, ``select.batch``)
    plan.*      symbolic phases (``plan.switch``, ``plan.partition``, ...)
    convert.*   numeric conversion phases
    kernel.*    kernel routing decisions (``kernel.route`` events)
    exchange.*  halo exchange (``exchange.dist_spmv``, ``exchange.issue``)
    solver.*    solve time (``solver.solve``)
    build.*     composite build phases (``build.dist``, ``build.mg_level``)
    mg.*        V-cycle structure (``mg.vcycle`` per level)
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
import warnings
from typing import Dict, List, Optional

from repro_torch.obs import metrics as _metrics

ENV_VAR = "REPRO_TRACE"
MODES = ("off", "summary", "full")

# Ring-buffer capacity (events). Old events are overwritten, newest win.
RING_CAPACITY = 65536

_LOCK = threading.Lock()
_MODE: Optional[str] = None      # resolved from $REPRO_TRACE at first use
_IDS = itertools.count(1)
_T0 = time.perf_counter_ns()     # trace epoch: ts fields are relative us

# ring buffer of finished events (dicts); _RING_POS wraps at capacity
_RING: List[dict] = []
_RING_POS = 0
_DROPPED = 0

# per-name aggregates: name -> [count, total_us, min_us, max_us]
_AGG: Dict[str, list] = {}

_TLS = threading.local()         # .stack: list of open spans


def _resolve_mode() -> str:
    v = os.environ.get(ENV_VAR, "off").strip().lower() or "off"
    return v if v in MODES else "off"


def mode() -> str:
    """Effective trace mode (cached; the first call reads ``$REPRO_TRACE``)."""
    global _MODE
    m = _MODE
    if m is None:
        m = _MODE = _resolve_mode()
    return m


def enabled() -> bool:
    return mode() != "off"


def set_mode(m: str) -> None:
    """Override the environment's mode (tests, embedding callers)."""
    global _MODE
    if m not in MODES:
        raise ValueError(f"trace mode {m!r} not in {MODES}")
    _MODE = m


class tracing:
    """``with tracing("full"): ...``: a scoped mode override (restores the
    previous mode on exit; keeps the collected data)."""

    def __init__(self, m: str):
        if m not in MODES:
            raise ValueError(f"trace mode {m!r} not in {MODES}")
        self._m = m
        self._prev: Optional[str] = None

    def __enter__(self):
        self._prev = mode()
        set_mode(self._m)
        return self

    def __exit__(self, *exc):
        set_mode(self._prev)
        return False


def _stack() -> list:
    s = getattr(_TLS, "stack", None)
    if s is None:
        s = _TLS.stack = []
    return s


def _record(ev: dict) -> None:
    global _RING_POS, _DROPPED
    with _LOCK:
        a = _AGG.setdefault(ev["name"], [0, 0.0, float("inf"), 0.0])
        dur = ev["dur"]
        a[0] += 1
        a[1] += dur
        a[2] = min(a[2], dur)
        a[3] = max(a[3], dur)
        if mode() == "full":
            if len(_RING) < RING_CAPACITY:
                _RING.append(ev)
            else:
                _RING[_RING_POS % RING_CAPACITY] = ev
                _DROPPED += 1
                _RING_POS += 1
                # counted outside the trace too: a wrapped ring must not
                # pass for a complete one
                _metrics.inc("trace.dropped_events")


class _Span:
    """An active span. Use :func:`span`; not constructed directly."""

    __slots__ = ("name", "attrs", "id", "parent", "tid", "_t0", "_sync")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.id = next(_IDS)
        self.tid = threading.get_ident()
        self._sync: list = []
        self.parent = None
        self._t0 = 0

    def sync(self, *values) -> "_Span":
        """Register tensors whose device work the span must wait for at its
        close (one ``torch.cuda.synchronize`` of the first CUDA tensor's
        device; CPU tensors need no wait), so the span measures execution,
        not the enqueue. Chainable."""
        self._sync.extend(values)
        return self

    def set(self, **attrs) -> "_Span":
        """Attach or overwrite span attributes (e.g. the decision made)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        st = _stack()
        self.parent = st[-1].id if st else None
        st.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._sync:
            dev = next((v.device for v in self._sync if getattr(v, "is_cuda", False)), None)
            if dev is not None:
                import torch  # the tracer itself imports nothing heavy

                torch.cuda.synchronize(dev)
        t1 = time.perf_counter_ns()
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        else:  # tolerate mispaired exits rather than corrupting the stack
            try:
                st.remove(self)
            except ValueError:
                pass
        _record({"name": self.name, "ts": (self._t0 - _T0) / 1e3,
                 "dur": (t1 - self._t0) / 1e3, "tid": self.tid,
                 "id": self.id, "parent": self.parent,
                 "args": self.attrs})
        return False


class _NullSpan:
    """The off-mode span: every operation is a no-op."""

    __slots__ = ()

    def sync(self, *values):
        return self

    def set(self, **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


def span(name: str, **attrs):
    """Open a traced span. Off mode returns a shared no-op object."""
    m = _MODE
    if m is None:
        m = mode()
    if m == "off":
        return _NULL
    return _Span(name, attrs)


def event(name: str, **attrs) -> None:
    """Record an instantaneous event (zero duration, current parent)."""
    m = _MODE
    if m is None:
        m = mode()
    if m == "off":
        return
    st = _stack()
    _record({"name": name, "ts": (time.perf_counter_ns() - _T0) / 1e3,
             "dur": 0.0, "tid": threading.get_ident(), "id": next(_IDS),
             "parent": st[-1].id if st else None, "args": attrs})


# ---------------------------------------------------------------------------
# Introspection and export
# ---------------------------------------------------------------------------


def events() -> List[dict]:
    """Snapshot of the ring buffer, oldest first (full mode only)."""
    with _LOCK:
        if len(_RING) < RING_CAPACITY:
            return list(_RING)
        p = _RING_POS % RING_CAPACITY
        return _RING[p:] + _RING[:p]


def aggregate() -> Dict[str, dict]:
    """Per-span-name stats: {name: {count, total_us, min_us, max_us, mean_us}}."""
    with _LOCK:
        return {name: {"count": a[0], "total_us": a[1], "min_us": a[2],
                       "max_us": a[3], "mean_us": a[1] / max(1, a[0])}
                for name, a in _AGG.items()}


def dropped() -> int:
    """Events overwritten because the ring buffer wrapped."""
    return _DROPPED


def clear() -> None:
    """Drop all collected events and aggregates (the mode is unchanged)."""
    global _RING_POS, _DROPPED, _TRUNCATION_WARNED
    with _LOCK:
        _RING.clear()
        _RING_POS = 0
        _DROPPED = 0
        _TRUNCATION_WARNED = False
        _AGG.clear()


def summary(sort_by: str = "total_us") -> str:
    """Human-readable per-span-name table of the collected aggregates."""
    agg = aggregate()
    if not agg:
        return "(trace empty)"
    rows = sorted(agg.items(), key=lambda kv: -kv[1].get(sort_by, 0.0))
    w = max(len("span"), max(len(n) for n, _ in rows))
    out = [f"{'span':<{w}}  {'count':>6}  {'total_ms':>9}  {'mean_us':>9}  "
           f"{'max_us':>9}",
           "-" * (w + 40)]
    for name, s in rows:
        out.append(f"{name:<{w}}  {s['count']:>6}  "
                   f"{s['total_us'] / 1e3:>9.2f}  {s['mean_us']:>9.1f}  "
                   f"{s['max_us']:>9.1f}")
    return "\n".join(out)


_TRUNCATION_WARNED = False


def export_chrome(path: str) -> str:
    """Write the ring buffer as a Chrome/Perfetto ``trace.json`` (the JAX
    package's document: span attributes in ``args``, with the span and
    parent ids that ``repro_torch.obs.report`` reads back). A wrapped ring
    exports only the newest ``RING_CAPACITY`` events: warned once per
    collection, and recorded in ``otherData.dropped_events``."""
    global _TRUNCATION_WARNED
    evs = events()
    if _DROPPED and not _TRUNCATION_WARNED:
        _TRUNCATION_WARNED = True
        warnings.warn(
            f"trace ring wrapped: export is truncated to the newest "
            f"{RING_CAPACITY} events ({_DROPPED} older events dropped — "
            f"see the trace.dropped_events counter)", RuntimeWarning,
            stacklevel=2)
    out = []
    for e in evs:
        out.append({"name": e["name"], "ph": "X", "cat": e["name"].split(".")[0],
                    "ts": e["ts"], "dur": max(e["dur"], 0.001),
                    "pid": 0, "tid": e["tid"],
                    "args": {**e["args"], "span_id": e["id"],
                             "parent_id": e["parent"]}})
    doc = {"traceEvents": out, "displayTimeUnit": "ms",
           "otherData": {"dropped_events": _DROPPED}}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
