"""Render traces into per-phase attribution tables (port of
``repro.obs.report``).

The span taxonomy (``repro_torch.obs.trace``) prefixes every span with its
phase: ``select.*``, ``plan.*``, ``convert.*``, ``kernel.*``,
``exchange.*``, ``solver.*``, ``build.*``, ``mg.*``. This module folds a
trace (the live buffers or an exported ``trace.json``, of either package:
the documents are the same) into the question: *where does the time go*,
selection, planning, conversion, kernel routing, exchange, or the solve?

Attribution uses **self time**: a span's duration minus its children's,
so ``build.dist`` does not count the ``plan.*``/``convert.*`` spans it
contains twice. Spans time the host (see ``repro_torch.obs.trace``): a
phase's share is the host's share unless its spans registered ``sync``.

The overlap table reads a ``BENCH_obs.json``-style document (rows
``obs_overlap_<version>_p<P>`` with ``local_us``/``exch_us`` derived
fields): per shard count, the distributed SpMV split into local compute,
exchange and remote, and the combined call.

CLI::

    python -m repro_torch.obs.report trace.json              # phase attribution
    python -m repro_torch.obs.report --bench BENCH_obs.json  # overlap table
    python -m repro_torch.obs.report                         # both, from cwd
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Dict, List, Optional

PHASES = ("select", "plan", "convert", "kernel", "exchange", "solver",
          "build", "mg")


def phase_of(name: str) -> str:
    head = name.split(".", 1)[0]
    return head if head in PHASES else "other"


# ---------------------------------------------------------------------------
# Trace loading
# ---------------------------------------------------------------------------


def load_trace(path: str) -> List[dict]:
    """Read an exported Chrome ``trace.json`` back into event dicts."""
    with open(path) as f:
        doc = json.load(f)
    evs = []
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        args = dict(e.get("args", {}))
        evs.append({"name": e["name"], "ts": float(e.get("ts", 0.0)),
                    "dur": float(e.get("dur", 0.0)),
                    "tid": e.get("tid", 0),
                    "id": args.pop("span_id", None),
                    "parent": args.pop("parent_id", None),
                    "args": args})
    return evs


def live_events() -> List[dict]:
    from repro_torch.obs import trace
    return trace.events()


# ---------------------------------------------------------------------------
# Phase attribution
# ---------------------------------------------------------------------------


def attribution(events: List[dict]) -> List[dict]:
    """Fold events into per-phase rows sorted by self time, largest first.

    Returns ``[{"phase", "calls", "total_ms", "self_ms", "share"}]``.
    ``share`` is self time over the summed self time of all phases (the
    trace's attributed wall clock).
    """
    self_us: Dict[Optional[int], float] = {}
    for e in events:
        self_us[e["id"]] = e["dur"]
    for e in events:
        p = e.get("parent")
        if p in self_us:
            self_us[p] -= e["dur"]

    rows: Dict[str, dict] = {}
    for e in events:
        ph = phase_of(e["name"])
        r = rows.setdefault(ph, {"phase": ph, "calls": 0, "total_ms": 0.0,
                                 "self_ms": 0.0})
        r["calls"] += 1
        r["total_ms"] += e["dur"] / 1e3
        r["self_ms"] += max(0.0, self_us.get(e["id"], 0.0)) / 1e3
    wall = sum(r["self_ms"] for r in rows.values()) or 1.0
    out = sorted(rows.values(), key=lambda r: -r["self_ms"])
    for r in out:
        r["share"] = r["self_ms"] / wall
    return out


def render_attribution(rows: List[dict]) -> str:
    if not rows:
        return "(no spans recorded — is REPRO_TRACE set?)"
    out = [f"{'phase':<10} {'calls':>7} {'total_ms':>10} {'self_ms':>10} "
           f"{'share':>7}",
           "-" * 48]
    for r in rows:
        out.append(f"{r['phase']:<10} {r['calls']:>7} {r['total_ms']:>10.2f} "
                   f"{r['self_ms']:>10.2f} {r['share']:>6.1%}")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# The p8 overlap table (from BENCH_obs.json)
# ---------------------------------------------------------------------------


def _parse_derived(derived: str) -> dict:
    out = {}
    for part in derived.split(";"):
        if "=" in part:
            k, v = part.split("=", 1)
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out


def overlap_rows(doc: dict) -> List[dict]:
    """Extract per-shard-count overlap rows from a BENCH_obs.json doc."""
    rows = []
    for r in doc.get("rows", []):
        m = re.fullmatch(r"obs_overlap_(\w+)_p(\d+)", r["name"])
        if not m:
            continue
        d = _parse_derived(r.get("derived", ""))
        rows.append({"version": m.group(1), "p": int(m.group(2)),
                     "full_us": r["us_per_call"], **d})
    return sorted(rows, key=lambda r: (r["version"], r["p"]))


def render_overlap(rows: List[dict]) -> str:
    if not rows:
        return "(no obs_overlap rows in the document)"
    out = [f"{'version':<10} {'P':>3} {'local_us':>9} {'exch_us':>9} "
           f"{'sum_us':>9} {'full_us':>9} {'hidden_us':>10} {'hidden':>7} "
           f"{'overhead':>8}",
           "-" * 81]
    for r in rows:
        loc = r.get("local_us", 0.0)
        exc = r.get("exch_us", 0.0)
        full = r["full_us"]
        if "hidden_frac" in r:  # absent at P=1 (remote part statically empty)
            hidden = loc + exc - full
            denom = min(loc, exc) if min(loc, exc) > 0 else 1.0
            hid = f"{hidden:>10.0f}"
            frac = f"{max(0.0, hidden) / denom:>6.1%}"
            over = f"{max(0.0, -hidden) / denom:>7.1%}"
        else:
            hid, frac, over = f"{'-':>10}", f"{'-':>6}", f"{'-':>7}"
        out.append(f"{r['version']:<10} {r['p']:>3} {loc:>9.0f} {exc:>9.0f} "
                   f"{loc + exc:>9.0f} {full:>9.0f} {hid} {frac} {over}")
    out.append("")
    out.append("hidden_us = local_us + exch_us - full_us (signed): the wall "
               "time the scheduler overlapped.")
    out.append("hidden ~ 100% => exchange fully hidden behind local compute; "
               "0% => nothing hidden; overhead > 0% => composing the phases "
               "costs *more* than running them apart (serialization penalty).")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Render repro_torch.obs traces into per-phase attribution")
    p.add_argument("trace", nargs="?", default=None,
                   help="exported trace.json (default: ./trace.json if present)")
    p.add_argument("--bench", default=None,
                   help="BENCH_obs.json for the overlap table "
                        "(default: ./BENCH_obs.json if present)")
    p.add_argument("--json", action="store_true",
                   help="emit the attribution rows as JSON instead of a table")
    args = p.parse_args(argv)

    trace_path = args.trace or ("trace.json" if os.path.exists("trace.json")
                                else None)
    bench_path = args.bench or ("BENCH_obs.json"
                                if os.path.exists("BENCH_obs.json") else None)
    printed = False
    if trace_path:
        evs = load_trace(trace_path)
        rows = attribution(evs)
        if args.json:
            print(json.dumps(rows, indent=1))
        else:
            print(f"# phase attribution ({trace_path}, {len(evs)} spans)")
            print(render_attribution(rows))
        printed = True
    if bench_path and not args.json:
        try:
            with open(bench_path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            doc = {}
        print(f"\n# exchange/local overlap per shard count ({bench_path})")
        print(render_overlap(overlap_rows(doc)))
        printed = True
    if not printed:
        p.error("nothing to report: no trace.json or BENCH_obs.json found "
                "(pass paths explicitly)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
