"""Run one cell of the port's benchmark once, on the card.

  python3 bench/run.py --workload hpcg192-cg.solve --seed 7 --seconds 30 --trace 0

from the root of a checkout that holds ``BENCHMARK.json``, ``bench/`` and
the program (``src/repro_torch``). The last line of standard output is the
run's JSON result; the numbers that decided ``correct`` are also the last
lines of standard error. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics, with part of the window
under ``torch.profiler``. Without a card the run fails: there is no CPU
fallback. Every build and kernel cache goes under ``build/`` in the
checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
CACHES = {"REPRO_TORCH_BUILD_DIR": BUILD / "repro_torch_kernels",
          "TORCH_EXTENSIONS_DIR": BUILD / "torch_extensions",
          "TRITON_CACHE_DIR": BUILD / "triton",
          "CUDA_CACHE_PATH": BUILD / "cuda_cache",
          "REPRO_TUNING_CACHE": BUILD / "bench" / "selections.json"}


def _environment() -> None:
    for var, path in CACHES.items():
        os.environ[var] = str(path)
    os.environ["REPRO_TRACE"] = "off"
    for p in (ROOT / "bench", ROOT / "src"):
        sys.path.insert(0, str(p))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()

    from harness import cell, guard
    from harness.spec import Spec

    spec = Spec(ROOT)
    chips = spec.workload(args.workload)["chips"]
    import torch
    from repro_torch import env

    env.apply("cuda")  # as the port's entry points do, before the card is used
    try:
        card = guard.require_cuda(chips)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    result = cell.run(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START, card)
    bad = guard.forbidden_loaded()
    if bad:
        print(f"bench: the run loaded forbidden modules: {', '.join(bad)}", file=sys.stderr)
        return 3
    emit(result)
    return 0


def emit(result: dict, out=None, err=None) -> None:
    """The numbers compared, each with its limit, as the last lines of
    standard error; then the result as the last line of standard output."""
    out, err = out or sys.stdout, err or sys.stderr
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)


if __name__ == "__main__":
    sys.exit(main())
