"""Readings for the limits of ``correct``: a cell's program on many seeds,
and the control, in one process over one set-up.

  python3 bench/control.py --workload hpcg192-cg.solve --seeds 12 --solves 5
  python3 bench/control.py --workload hpcg192-cg.solve --seeds 3 --solves 5 --dtype bfloat16

Each seed makes its own pool of right-hand sides, runs ``--solves`` solves
through the cell's timed path, keeps every one, and prints one JSON line of
every reading of ``reference.compare``. ``--dtype bfloat16`` runs the
program in the precision below the configuration's (the control); the
inputs stay as the configuration states. It runs on the card only; the
benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=2**31 + 1000)
    p.add_argument("--solves", type=int, default=5)
    p.add_argument("--dtype", default=None)
    args = p.parse_args(argv)

    import run  # the benchmark's environment: caches under build/
    run._environment()
    import torch
    from harness import drive, guard
    from harness.cell import Cell
    from harness.spec import Spec
    from repro_torch import env

    env.apply("cuda")
    guard.require_cuda(1)
    dev = torch.device("cuda", 0)
    cell = Cell(Spec(ROOT), args.workload, dev, args.dtype)
    t0 = time.perf_counter()
    cell.setup()
    print(json.dumps({"workload": args.workload, "dtype": args.dtype, "setup_s":
                      time.perf_counter() - t0, "info": cell.system.info}, default=str),
          flush=True)
    for k in range(args.seeds):
        seed = args.first_seed + k
        pool = cell.pool_for(seed)
        rec = drive.window(cell.system, cell.program_pool(pool), cell.traffic, 0.0, seed,
                           dev, solves_max=args.solves)
        t1 = time.perf_counter()
        reads = cell.readings(pool, rec["samples"])
        print(json.dumps({"seed": seed, "dtype": args.dtype, **reads,
                          "iters": [s["iters"] for s in rec["solves"]],
                          "failed": sum(s["failed"] for s in rec["solves"]),
                          "ms": [round(s["ms"], 3) for s in rec["solves"]],
                          "reference_s": time.perf_counter() - t1}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
