"""Bench-trajectory regression gate (port of ``repro.obs.regress``).

The same ``{meta, rows}`` artifact schema, tolerance classes, win-flip
rule, baseline document and history lines as the JAX package's gate, so
either package's gate reads the other's artifacts. What differs is what
it points at by default: the port's own artifacts (``BENCH_torch_*.json``),
its own baseline (``results/baseline_torch.json``) and its own history
(``results/history_torch/``). It never writes the JAX package's
``results/baseline.json`` or ``results/history/``. The artifact names can
be passed (``artifacts=``, ``--artifacts``), so the gate runs over any set
of ``BENCH_*.json`` files, the JAX package's included.

* **History store**: one JSONL line per artifact and run
  (:func:`append_history`), the rows that run measured with their
  ``env_info()`` provenance.
* **Baseline compare**: ``python -m repro_torch.obs.regress`` compares the
  current artifacts against a blessed baseline with noise-aware per-row
  tolerance classes. Raw ``us_per_call`` rows get a wide band;
  ``speedup_vs_ref`` rows (ratios of two timings of one run, where host
  noise mostly cancels) a tighter band plus a win-flip rule. Decision rows
  (us == 0) and rows missing from the baseline are informational, never
  failures. Exit status is the gate: nonzero iff a row regressed.
* **Environment guard**: timings from another backend, card or
  interpret mode are not comparable; when the baseline's fingerprint
  differs from the current one, timing comparisons are downgraded to
  informational with a note.

Tolerance classes (``classify``):

    speedup     derived carries ``speedup_vs_ref`` (or ``*_vs_csr``):
                fail if current < baseline * (1 - 0.45), or a clear win
                (>= 1.3x) flipped to a clear loss (< 0.95x).
    throughput  derived carries ``tok_per_s``: fail below
                baseline * (1 - 0.45). Higher is better.
    time        raw ``us_per_call`` > 0: fail above
                baseline * (1 + 0.75).
    info        decision rows (us == 0): derived changes are notes only.

CLI::

    python -m repro_torch.obs.regress                       # gate cwd vs baseline
    python -m repro_torch.obs.regress --report regress.md   # + markdown report
    python -m repro_torch.obs.regress --bless               # re-bless baseline
    python -m repro_torch.obs.regress --artifacts BENCH_spmv BENCH_hpcg \\
        --baseline results/baseline.json                    # other artifacts
    python -m repro_torch.obs.regress --inject-slowdown NAME:2.0   # gate self-test
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

SUITES = ("spmv", "convert", "dist", "hpcg", "obs", "serve")
ARTIFACTS = tuple(f"BENCH_torch_{s}" for s in SUITES)

DEFAULT_BASELINE = os.path.join("results", "baseline_torch.json")
DEFAULT_HISTORY = os.path.join("results", "history_torch")
HISTORY_FILE = "trajectory.jsonl"
# The JAX package's gate state: this gate reads it, never writes it.
_REFERENCE_STATE = (("results", "baseline.json"), ("results", "history"))

# Noise-aware tolerance bands per row class (the JAX package's): wide
# enough for run-to-run noise of about 40%, tight enough that a 2x
# slowdown (ratio 0.50 < 0.55) still fails the gate.
TOL = {"speedup": 0.45, "throughput": 0.45, "time": 0.75}
# A clear win (>= FLIP_WIN x) that becomes a clear loss (< FLIP_LOSS x)
# is a regression even inside the relative band.
FLIP_WIN, FLIP_LOSS = 1.30, 0.95

# env_info() fields that decide whether two timings are comparable.
ENV_COMPARE_KEYS = ("backend", "device_kind", "interpret_mode")


def parse_derived(derived: str) -> dict:
    """``k=v;k=v`` derived fields -> dict (floats where possible)."""
    out = {}
    for part in str(derived or "").split(";"):
        if "=" in part:
            k, v = part.split("=", 1)
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out


def classify(row: dict) -> Tuple[str, float]:
    """Tolerance class and the comparable value for one bench row."""
    d = parse_derived(row.get("derived", ""))
    for key in ("speedup_vs_ref", "speedup_vs_csr", "speedup_vs_csr_ref"):
        if isinstance(d.get(key), float):
            return "speedup", d[key]
    if isinstance(d.get("tok_per_s"), float):
        return "throughput", d["tok_per_s"]
    us = float(row.get("us_per_call", 0) or 0)
    if us > 0:
        return "time", us
    return "info", 0.0


# ---------------------------------------------------------------------------
# Row comparison
# ---------------------------------------------------------------------------


def compare_row(name: str, base: Optional[dict], cur: Optional[dict],
                enforce: bool = True) -> dict:
    """Compare one row; returns a finding dict with ``status`` in
    ``ok | regression | improved | new | missing | info``."""
    if cur is None:
        return {"name": name, "cls": "info", "status": "missing",
                "note": "row present in baseline but absent from this run"}
    cls, cur_v = classify(cur)
    if base is None:
        return {"name": name, "cls": cls, "status": "new", "current": cur_v,
                "note": "no baseline row — informational"}
    bcls, base_v = classify(base)
    if cls != bcls:
        return {"name": name, "cls": cls, "status": "info",
                "baseline": base_v, "current": cur_v,
                "note": f"metric class changed ({bcls} -> {cls})"}
    if cls == "info":
        note = None
        if str(base.get("derived", "")) != str(cur.get("derived", "")):
            note = (f"decision changed: {base.get('derived', '')!r} -> "
                    f"{cur.get('derived', '')!r}")
        return {"name": name, "cls": cls, "status": "info", "note": note}

    tol = TOL[cls]
    ratio = cur_v / base_v if base_v else float("inf")
    finding = {"name": name, "cls": cls, "baseline": base_v,
               "current": cur_v, "ratio": ratio}
    if cls == "time":
        bad = cur_v > base_v * (1 + tol)
        better = cur_v < base_v * (1 - tol)
        why = f"{cur_v:.0f}us vs baseline {base_v:.0f}us (x{ratio:.2f})"
    else:  # speedup / throughput: higher is better
        bad = cur_v < base_v * (1 - tol)
        if cls == "speedup" and base_v >= FLIP_WIN and cur_v < FLIP_LOSS:
            bad = True
            finding["note"] = (f"win flipped to loss: {base_v:.2f}x -> "
                               f"{cur_v:.2f}x vs ref")
        better = cur_v > base_v * (1 + tol)
        why = f"{cur_v:.2f} vs baseline {base_v:.2f} (x{ratio:.2f})"
    finding.setdefault("note", why)
    if bad:
        finding["status"] = "regression" if enforce else "info"
        if not enforce:
            finding["note"] = f"[env mismatch, not enforced] {finding['note']}"
    elif better:
        finding["status"] = "improved"
    else:
        finding["status"] = "ok"
    return finding


def env_matches(base_env: Optional[dict], cur_env: Optional[dict]) -> bool:
    """Are two env_info() fingerprints timing-comparable?"""
    if not base_env or not cur_env:
        return False
    return all(base_env.get(k) == cur_env.get(k) for k in ENV_COMPARE_KEYS)


def load_artifact(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def compare(baseline: dict, json_dir: str = ".",
            current_env: Optional[dict] = None,
            inject: Optional[Dict[str, float]] = None,
            artifacts: Sequence[str] = ARTIFACTS) -> List[dict]:
    """Compare every current ``<artifact>.json`` under ``json_dir`` against
    the blessed ``baseline`` doc; returns findings, regressions first.

    ``inject`` maps row name -> slowdown factor applied to the current
    value before comparing (the gate's self-test: an injected 2x slowdown
    must come back as a regression)."""
    findings: List[dict] = []
    arts = baseline.get("artifacts", {})
    for art in artifacts:
        cur_doc = load_artifact(os.path.join(json_dir, f"{art}.json"))
        base_art = arts.get(art)
        if cur_doc is None and base_art is None:
            continue
        base_rows = dict(base_art.get("rows", {})) if base_art else {}
        cur_rows = {r["name"]: dict(r)
                    for r in (cur_doc or {}).get("rows", [])}
        if inject:
            for name, factor in inject.items():
                if name in cur_rows:
                    cur_rows[name] = _inject_slowdown(cur_rows[name], factor)
        env = (cur_doc or {}).get("meta", {}).get("env") or current_env
        enforce = env_matches(base_art.get("env") if base_art else None, env)
        for name in sorted(set(base_rows) | set(cur_rows)):
            f = compare_row(name, base_rows.get(name), cur_rows.get(name),
                            enforce=enforce or base_art is None)
            f["artifact"] = art
            if not enforce and base_art is not None and f["status"] == "ok":
                f["note"] = "[env mismatch, not enforced] " + str(
                    f.get("note") or "")
            findings.append(f)
    order = {"regression": 0, "improved": 1, "new": 2, "missing": 3,
             "info": 4, "ok": 5}
    findings.sort(key=lambda f: (order.get(f["status"], 9), f["name"]))
    return findings


def _inject_slowdown(row: dict, factor: float) -> dict:
    """Apply a synthetic slowdown to a row (gate self-test only): times
    get slower by ``factor``, ratios/throughput worse by ``factor``."""
    row = dict(row)
    d = parse_derived(row.get("derived", ""))
    parts = []
    for k, v in d.items():
        if k.startswith("speedup_vs") or k == "tok_per_s":
            v = float(v) / factor
        parts.append(f"{k}={v}")
    if parts:
        row["derived"] = ";".join(parts)
    row["us_per_call"] = float(row.get("us_per_call", 0) or 0) * factor
    return row


# ---------------------------------------------------------------------------
# Baseline bless / load
# ---------------------------------------------------------------------------


def _refuse_reference_state(path: str) -> None:
    """Raise for a path of the JAX package's gate state."""
    parts = tuple(os.path.normpath(os.path.abspath(path)).split(os.sep))
    for tail in _REFERENCE_STATE:
        n = len(tail)
        if any(parts[i:i + n] == tail for i in range(len(parts) - n + 1)):
            raise ValueError(f"{path!r} is the JAX package's gate state "
                             f"({os.path.join(*tail)}); the port's gate "
                             f"writes {DEFAULT_BASELINE} / {DEFAULT_HISTORY}")


def bless(json_dir: str = ".", baseline_path: str = DEFAULT_BASELINE,
          artifacts: Sequence[str] = ARTIFACTS) -> dict:
    """Write the current artifacts as the new blessed baseline."""
    _refuse_reference_state(baseline_path)
    doc = {"blessed_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
           "artifacts": {}}
    for art in artifacts:
        cur = load_artifact(os.path.join(json_dir, f"{art}.json"))
        if cur is None:
            continue
        doc["artifacts"][art] = {
            "env": cur.get("meta", {}).get("env"),
            "rows": {r["name"]: r for r in cur.get("rows", [])},
        }
    if not doc["artifacts"]:
        raise SystemExit(f"nothing to bless: no {'/'.join(artifacts)} under "
                         f"{os.path.abspath(json_dir)}")
    d = os.path.dirname(baseline_path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{baseline_path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    os.replace(tmp, baseline_path)
    return doc


def load_baseline(path: str = DEFAULT_BASELINE) -> Optional[dict]:
    return load_artifact(path)


# ---------------------------------------------------------------------------
# History store (results/history_torch/trajectory.jsonl)
# ---------------------------------------------------------------------------


def append_history(artifact: str, rows, meta: dict,
                   history_dir: str = DEFAULT_HISTORY) -> str:
    """Append one run's rows for ``artifact`` as a JSONL trajectory entry.

    ``rows`` are the bench harness's (name, us, derived) triples — only
    the rows *this* run measured, not the merged artifact, so the
    trajectory records what actually ran."""
    _refuse_reference_state(history_dir)
    os.makedirs(history_dir, exist_ok=True)
    path = os.path.join(history_dir, HISTORY_FILE)
    entry = {"ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
             "artifact": artifact,
             "git_rev": (meta.get("env") or {}).get("git_rev"),
             "env": {k: (meta.get("env") or {}).get(k)
                     for k in ENV_COMPARE_KEYS},
             "rows": [{"name": str(n), "us_per_call": float(us),
                       "derived": str(der)} for n, us, der in rows]}
    with open(path, "a") as f:
        f.write(json.dumps(entry, sort_keys=True) + "\n")
    return path


def load_history(history_dir: str = DEFAULT_HISTORY) -> List[dict]:
    """All trajectory entries, oldest first (empty when no history)."""
    path = os.path.join(history_dir, HISTORY_FILE)
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        pass
    return out


# ---------------------------------------------------------------------------
# Report rendering
# ---------------------------------------------------------------------------


def render_markdown(findings: List[dict], baseline_path: str) -> str:
    """The regression report: regressions first, then the rest."""
    n_reg = sum(1 for f in findings if f["status"] == "regression")
    n_imp = sum(1 for f in findings if f["status"] == "improved")
    n_new = sum(1 for f in findings if f["status"] == "new")
    n_ok = sum(1 for f in findings if f["status"] == "ok")
    out = ["# Perf regression report",
           "",
           f"Baseline: `{baseline_path}` — "
           f"**{n_reg} regression(s)**, {n_imp} improved, {n_new} new, "
           f"{n_ok} within tolerance.",
           ""]
    if n_reg:
        out += ["## Regressions", "",
                "| row | artifact | class | baseline | current | note |",
                "|---|---|---|---|---|---|"]
        for f in findings:
            if f["status"] != "regression":
                continue
            out.append(f"| `{f['name']}` | {f['artifact']} | {f['cls']} "
                       f"| {f.get('baseline', '-'):.4g} "
                       f"| {f.get('current', '-'):.4g} "
                       f"| {f.get('note') or ''} |")
        out.append("")
    notable = [f for f in findings
               if f["status"] in ("improved", "new", "missing")
               or (f["status"] == "info" and f.get("note"))]
    if notable:
        out += ["## Notable (non-gating)", "",
                "| row | artifact | status | note |",
                "|---|---|---|---|"]
        for f in notable:
            out.append(f"| `{f['name']}` | {f['artifact']} | {f['status']} "
                       f"| {f.get('note') or ''} |")
        out.append("")
    out.append(f"Tolerances: speedup ±{TOL['speedup']:.0%} (+ win-flip "
               f"rule {FLIP_WIN}x -> <{FLIP_LOSS}x), throughput "
               f"-{TOL['throughput']:.0%}, raw time +{TOL['time']:.0%}; "
               "decision/new/missing rows are informational. Timing rows "
               "are only enforced when the baseline's environment "
               f"fingerprint ({', '.join(ENV_COMPARE_KEYS)}) matches.")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Compare the port's current BENCH_torch_*.json against "
                    "the blessed baseline; exit nonzero on regression")
    p.add_argument("--json-dir", default=".",
                   help="where the current artifacts live")
    p.add_argument("--artifacts", nargs="+", default=list(ARTIFACTS),
                   help="artifact names without .json (default: the port's "
                        "BENCH_torch_*)")
    p.add_argument("--baseline", default=DEFAULT_BASELINE)
    p.add_argument("--report", default=None,
                   help="write the markdown report here")
    p.add_argument("--bless", action="store_true",
                   help="rewrite the baseline from the current artifacts "
                        "(the legitimate-perf-change workflow) and exit")
    p.add_argument("--inject-slowdown", default=None, metavar="NAME:FACTOR",
                   help="gate self-test: pretend row NAME measured "
                        "FACTOR x slower and verify the gate catches it")
    p.add_argument("--json", action="store_true",
                   help="emit findings as JSON instead of the table")
    args = p.parse_args(argv)

    if args.bless:
        doc = bless(args.json_dir, args.baseline, artifacts=args.artifacts)
        rows = sum(len(a["rows"]) for a in doc["artifacts"].values())
        print(f"blessed {len(doc['artifacts'])} artifact(s), {rows} rows "
              f"-> {args.baseline}")
        return 0

    baseline = load_baseline(args.baseline)
    if baseline is None:
        print(f"no baseline at {args.baseline} — run with --bless first "
              "(nothing to gate against; exiting 0)", file=sys.stderr)
        return 0
    inject = None
    if args.inject_slowdown:
        name, _, factor = args.inject_slowdown.rpartition(":")
        inject = {name: float(factor)}
    findings = compare(baseline, json_dir=args.json_dir, inject=inject,
                       artifacts=args.artifacts)
    report = render_markdown(findings, args.baseline)
    if args.report:
        d = os.path.dirname(args.report)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.report, "w") as f:
            f.write(report + "\n")
    try:
        if args.json:
            print(json.dumps(findings, indent=1, default=str))
        else:
            print(report)
    except BrokenPipeError:
        # a downstream `head`/`grep -q` closed the pipe: the exit code is
        # the verdict, not the rendering
        sys.stderr.close()
        return 1 if any(f["status"] == "regression" for f in findings) else 0
    regressions = [f for f in findings if f["status"] == "regression"]
    if regressions:
        print(f"\nREGRESSION: {len(regressions)} row(s) failed the gate: "
              + ", ".join(f["name"] for f in regressions), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
