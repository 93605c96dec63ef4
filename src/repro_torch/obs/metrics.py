"""Named monotonic counters (the counter half of ``repro.obs.metrics``).

Counters are host-side dict updates under a lock. Standard names:

    planned_pulls               sanctioned symbolic-phase device->host syncs
                                (``repro_torch.core.convert._planned_pull``)
    serve.retune                ``LinearSparse.retune`` calls: every
                                width-aware re-selection of a weight format
    serve.format_switch         the retunes that changed the weight's format
                                (``repro_torch.models.linear_sparse``)
    kernel.route.cuda           ``backend="auto"`` calls routed to a kernel by
                                a record that beat the reference
    kernel.route.veto           ... kept on the reference by a record that lost
    kernel.route.ref            ... kept on the reference with no record, or
                                off the card (``repro_torch.core.ops.kernel_route``)
    selection.cache_hit/miss    selection-store lookups
                                (``repro_torch.tuning.cache``)

Kernel launches are counted by each kernel module's ``launches`` integer
(``repro_torch.kernels.ops.launch_counts``), not here.

``scope()`` gives order-independent deltas, so a test's assertion does not
depend on what ran earlier in the process.
"""
from __future__ import annotations

import threading
from typing import Dict

_LOCK = threading.Lock()
_COUNTERS: Dict[str, float] = {}


def inc(name: str, n: float = 1) -> None:
    """Increment counter ``name`` by ``n`` (created at 0 on first use)."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def get(name: str, default: float = 0) -> float:
    """Current value of counter ``name``."""
    with _LOCK:
        return _COUNTERS.get(name, default)


def snapshot() -> Dict[str, float]:
    """A copy of every counter."""
    with _LOCK:
        return dict(_COUNTERS)


class Scope:
    """Delta view of the counters since scope entry (see :func:`scope`)."""

    def __init__(self):
        self._base = snapshot()

    def delta(self, name: str) -> float:
        """Counter growth since the scope opened."""
        return get(name) - self._base.get(name, 0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def scope() -> Scope:
    """``with metrics.scope() as s: ...; s.delta("planned_pulls")``."""
    return Scope()
