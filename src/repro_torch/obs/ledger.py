"""Decision ledger: a bounded ring of structured records (port of
``repro.obs.ledger``; the same record kinds, fields and dump schema, so a
dump of either package replays in the other's ``explain``).

* ``FormatPolicy.select``/``select_batch`` append ``format.select`` /
  ``format.select_batch`` records: the feature vector, the CART path taken
  (node by node, with the feature value and threshold at each split), the
  candidates' scores when an engine produced them, the cache hit/miss and
  the pinned kernel decision with its veto reason.
* ``kernel_route`` appends ``kernel.route`` records: the route taken, the
  cached :class:`~repro_torch.tuning.kernel_tune.KernelRecord` (cfg with
  SELL's (c, sigma), kernel_us/ref_us/speedup) and why the kernel was
  refused. The port routes eagerly on every call, so a decision is recorded
  once per container, op and width bucket, and again when the tuning store
  changes (``repro_torch.core.ops.kernel_route``).
* ``FormatPolicy.plan_for`` appends ``plan.switch`` records: the format
  planned and where its geometry hints came from.

Records are plain JSON-ready dicts in a thread-safe bounded ring (newest
win; ``dropped()`` counts overwrites). The ledger is **on by default**:
each record is a small host dict built on setup paths that already do host
dict lookups. ``REPRO_LEDGER=off`` turns it off. ``python -m
repro_torch.obs.explain`` replays the ring, or a :func:`dump_json` file,
as a human-readable account.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional

ENV_VAR = "REPRO_LEDGER"
CAPACITY = 4096

_LOCK = threading.Lock()
_RING: collections.deque = collections.deque(maxlen=CAPACITY)
_SEQ = 0
_DROPPED = 0
_ENABLED: Optional[bool] = None  # resolved from $REPRO_LEDGER at first use


def enabled() -> bool:
    """The ledger's gate (cached; the first call reads ``$REPRO_LEDGER``)."""
    global _ENABLED
    e = _ENABLED
    if e is None:
        e = _ENABLED = os.environ.get(ENV_VAR, "on").strip().lower() not in (
            "off", "0", "false")
    return e


def set_enabled(flag: bool) -> None:
    """Override the environment's gate (tests, embedding callers)."""
    global _ENABLED
    _ENABLED = bool(flag)


def record(kind: str, **fields) -> None:
    """Append a decision record (a no-op when the ledger is off).
    ``fields`` must be JSON-serializable."""
    global _SEQ, _DROPPED
    if not enabled():
        return
    with _LOCK:
        _SEQ += 1
        if len(_RING) == CAPACITY:
            _DROPPED += 1
        _RING.append({"seq": _SEQ, "ts": time.time(), "kind": kind, **fields})


def records(kind: Optional[str] = None, last: Optional[int] = None
            ) -> List[dict]:
    """Snapshot of the ring, oldest first; filter by ``kind`` and/or keep
    only the ``last`` N matches."""
    with _LOCK:
        out = list(_RING)
    if kind is not None:
        out = [r for r in out if r["kind"] == kind]
    if last is not None:
        out = out[-last:]
    return out


def dropped() -> int:
    """Records overwritten because the ring wrapped."""
    return _DROPPED


def clear() -> None:
    """Drop all records (the gate and the sequence counter are kept: seq
    stays monotonic across clears, so dumps of one process never alias)."""
    global _DROPPED
    with _LOCK:
        _RING.clear()
        _DROPPED = 0


def dump_json(path: str) -> str:
    """Write the ring as ``{"records": [...], "dropped", "capacity"}``."""
    doc = {"records": records(), "dropped": dropped(), "capacity": CAPACITY}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return path


def load_json(path: str) -> Dict:
    """Read a :func:`dump_json` document back (records under "records")."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "records" not in doc:
        raise ValueError(f"{path} is not a ledger dump (no 'records' key)")
    return doc
