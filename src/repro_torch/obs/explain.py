"""Replay the decision ledger: "why did the policy pick that?" (port of
``repro.obs.explain``).

Renders :mod:`repro_torch.obs.ledger` records (the live ring, or a
``dump_json`` file of either package: the record schema is shared) as a
human-readable account of every format selection (feature vector, the CART
path taken, candidate scores, cache hit/miss, pinned kernel decision),
kernel route (cfg with SELL's (c, sigma), measured speedup, veto reason),
switch plan and serving request.

CLI::

    python -m repro_torch.obs.explain                 # demo on the card: select,
                                                      # tune and route a power-law
                                                      # matrix, then replay
    python -m repro_torch.obs.explain --family stencil27 --seed 3
    python -m repro_torch.obs.explain --device cpu    # the demo on the CPU (no tune)
    python -m repro_torch.obs.explain ledger.json     # replay a dump_json file
    python -m repro_torch.obs.explain --kind kernel.route --last 5
    python -m repro_torch.obs.explain --dump ledger.json   # also write the dump
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from repro_torch.obs import ledger


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------


def _ts(rec: dict) -> str:
    try:
        return time.strftime("%H:%M:%S", time.localtime(float(rec["ts"])))
    except (KeyError, ValueError, OSError):
        return "--:--:--"


def _fmt_us(v) -> str:
    try:
        return f"{float(v):.1f}us"
    except (TypeError, ValueError):
        return "?"


def _cfg_str(cfg) -> str:
    if not cfg:
        return "-"
    return "/".join(f"{k}={v}" for k, v in sorted(cfg.items()))


def _render_tree_path(path: List[dict], indent: str = "    ") -> List[str]:
    out = [f"{indent}CART path:"]
    for step in path:
        if step.get("leaf"):
            out.append(f"{indent}  leaf[{step['node']}] -> "
                       f"{step.get('predict_name', step.get('predict'))}")
        else:
            op = "<=" if step["went"] == "left" else ">"
            out.append(f"{indent}  node[{step['node']}] "
                       f"{step['feature']} = {step['value']:.4g} {op} "
                       f"{step['thresh']:.4g} -> {step['went']}")
    return out


def _render_kernel(k: dict, indent: str = "    ") -> str:
    return (f"{indent}kernel record: {k.get('fmt')}/{k.get('op')} "
            f"cfg[{_cfg_str(k.get('cfg'))}] "
            f"{_fmt_us(k.get('kernel_us'))} vs ref "
            f"{_fmt_us(k.get('ref_us'))} "
            f"({float(k.get('speedup', 0)):.2f}x)")


def render_record(rec: dict, verbose: bool = True) -> str:
    """One ledger record -> a multi-line human-readable block."""
    kind = rec.get("kind", "?")
    head = f"[#{rec.get('seq', '?')} {_ts(rec)}] {kind}"
    lines = []
    if kind == "format.select":
        ncols = rec.get("ncols")
        width = f" b={ncols}" if ncols else ""
        lines.append(f"{head} mode={rec.get('mode')} op={rec.get('op')}"
                     f"{width} -> {rec.get('chosen')} "
                     f"(tier={rec.get('tier')}, "
                     f"backend={rec.get('backend') or 'auto'})")
        if rec.get("cache"):
            lines.append(f"    cache: {rec['cache']}")
        if verbose and rec.get("features"):
            feats = rec["features"]
            pairs = [f"{k}={v:.4g}" for k, v in feats.items()]
            for i in range(0, len(pairs), 5):
                prefix = "    features: " if i == 0 else "              "
                lines.append(prefix + " ".join(pairs[i:i + 5]))
        if rec.get("tree_path"):
            lines += _render_tree_path(rec["tree_path"])
        if rec.get("tree_rejected"):
            lines.append(f"    tree pick rejected: {rec['tree_rejected']}")
        if rec.get("scores"):
            pairs = " ".join(f"{k}={v:.3e}" for k, v in rec["scores"].items())
            lines.append(f"    candidate scores (s): {pairs}")
        if rec.get("cfg"):
            lines.append(f"    pinned cfg: {_cfg_str(rec['cfg'])}")
        if rec.get("kernel"):
            lines.append(_render_kernel(rec["kernel"]))
        if rec.get("kernel_veto"):
            lines.append(f"    veto: {rec['kernel_veto']}")
    elif kind == "format.select_batch":
        lines.append(f"{head} mode={rec.get('mode')} parts={rec.get('parts')}"
                     f" -> {rec.get('chosen_counts')}")
    elif kind == "kernel.route":
        lines.append(f"{head} op={rec.get('op')} fmt={rec.get('fmt')} -> "
                     f"{rec.get('route')}")
        if rec.get("kernel"):
            lines.append(_render_kernel(rec["kernel"]))
        if rec.get("reason"):
            lines.append(f"    reason: {rec['reason']}")
        if rec.get("bucket"):
            lines.append(f"    bucket: {rec['bucket']}")
    elif kind == "plan.switch":
        lines.append(f"{head} -> {rec.get('fmt')} "
                     f"hints[{_cfg_str(rec.get('hints'))}]"
                     + (f" geometry from {rec['geometry_source']}"
                        if rec.get("geometry_source") else ""))
    elif kind == "serve.request":
        lines.append(f"{head} rid={rec.get('rid')} "
                     f"queue={_fmt_us(rec.get('queue_us'))} "
                     f"prefill={_fmt_us(rec.get('prefill_us'))} "
                     f"decode={_fmt_us(rec.get('decode_us'))} "
                     f"total={_fmt_us(rec.get('total_us'))} "
                     f"tokens={rec.get('tokens')}")
    else:
        extra = {k: v for k, v in rec.items()
                 if k not in ("seq", "ts", "kind")}
        lines.append(f"{head} {json.dumps(extra, default=str)}")
    return "\n".join(lines)


def render(records: List[dict], verbose: bool = True) -> str:
    if not records:
        return ("(ledger empty — run a selection with REPRO_LEDGER=on, or "
                "use the --family demo)")
    return "\n".join(render_record(r, verbose=verbose) for r in records)


# ---------------------------------------------------------------------------
# Demo: one matrix through the whole decision stack
# ---------------------------------------------------------------------------


def run_demo(family: str = "powerlaw", seed: int = 7, tune_iters: int = 2,
             device=None) -> None:
    """Build a matrix on ``device`` (``None``: the card), select, plan,
    tune and route it, filling the ledger with the complete decision trail
    for one operand. The kernel is tuned on the card only (its route needs
    CUDA tensors); on the CPU the route is the reference's."""
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import convert_execute, ops as core_ops
    from repro_torch.kernels import ops as kops
    from repro_torch.tuning import SelectionCache, kernel_tune
    from repro_torch.tuning.corpus import make_matrix
    from repro_torch.tuning.policy import FormatPolicy

    coo = make_matrix(family, np.random.default_rng(seed), device=device)
    with tempfile.TemporaryDirectory() as td:
        kcache = SelectionCache(os.path.join(td, "kernels.json"))
        policy = FormatPolicy("cached", cache=kcache)
        rep = policy.select(coo)                     # format.select record
        plan = policy.plan_for(coo, fmt=rep.best)    # plan.switch record
        A = convert_execute(coo, plan)
        if A.device.type == "cuda" and type(A) in kops.cuda_registry("spmv"):
            kernel_tune.tune_kernel(
                A, cache=kcache, grid=kernel_tune.default_grid(A, smoke=True),
                iters=tune_iters, inner=1)
        # the measured auto route (+ kernel.route record: cuda, veto or ref)
        backend, cfg = core_ops.kernel_route(A, cache=kcache)
        x = torch.ones((A.shape[1],), dtype=A.dtype, device=A.device)
        core_ops.spmv(A, x, backend=backend, cfg=cfg)
        # a second select now hits the cache: the hit is its own record
        policy.select(coo)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Replay the repro_torch.obs decision ledger")
    p.add_argument("ledger_file", nargs="?", default=None,
                   help="a ledger.dump_json file to replay (default: run "
                        "the --family demo and replay the live ring)")
    p.add_argument("--family", default="powerlaw",
                   help="demo matrix family (corpus.FAMILIES; default "
                        "powerlaw — the SELL-C-sigma regime)")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="where the demo runs (default: cuda, raises without a card)")
    p.add_argument("--kind", default=None,
                   help="only records of this kind (e.g. kernel.route)")
    p.add_argument("--last", type=int, default=None,
                   help="only the newest N matching records")
    p.add_argument("--dump", default=None,
                   help="also write the ledger as JSON to this path")
    p.add_argument("--json", action="store_true",
                   help="emit raw records as JSON instead of the account")
    p.add_argument("--quiet", action="store_true",
                   help="skip the per-record feature vectors")
    args = p.parse_args(argv)

    if args.ledger_file:
        doc = ledger.load_json(args.ledger_file)
        recs = doc["records"]
        if doc.get("dropped"):
            print(f"(ledger wrapped: {doc['dropped']} older records lost)",
                  file=sys.stderr)
    else:
        ledger.set_enabled(True)
        run_demo(family=args.family, seed=args.seed, device=args.device)
        recs = ledger.records()
    if args.kind:
        recs = [r for r in recs if r.get("kind") == args.kind]
    if args.last:
        recs = recs[-args.last:]
    if args.dump:
        if args.ledger_file:
            with open(args.dump, "w") as f:
                json.dump({"records": recs, "dropped": 0,
                           "capacity": ledger.CAPACITY}, f, indent=1)
        else:
            ledger.dump_json(args.dump)
        print(f"ledger dump written to {args.dump}", file=sys.stderr)
    try:
        if args.json:
            print(json.dumps(recs, indent=1, default=str))
        else:
            print(render(recs, verbose=not args.quiet))
    except BrokenPipeError:
        # a downstream `head`/`grep -q` closed the pipe: not an error
        sys.stderr.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
