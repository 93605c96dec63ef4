"""Quickstart: dynamic sparse matrices in 60 seconds (port of ``examples/quickstart.py``).

Run on the card:  PYTHONPATH=src python -m repro_torch.quickstart
Run on the CPU:   PYTHONPATH=src python -m repro_torch.quickstart --device cpu

On the card every SpMV below runs the format's CUDA kernel; on the CPU it
runs the plain torch version. The inputs come from numpy.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.core import (DynamicMatrix, Format, SwitchDynamicMatrix, autotune,
                              banded_coo, convert, convert_execute, spmv)
from repro_torch.device import resolve_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: cuda (raises without a card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. Build a stencil-like banded matrix (the paper's HPCG pattern).
    A = banded_coo((4096, 4096), [-64, -1, 0, 1, 64], device=dev)
    x = torch.from_numpy(np.ones(4096, np.float32)).to(dev)

    # 2. Wrap it in a DynamicMatrix, the paper's core abstraction.
    dyn = DynamicMatrix(A)
    print("device:", dev, "| active format:", dyn.active.name)

    # 3. Same algorithm interface, any active state (State pattern).
    y_coo = dyn.spmv(x)
    for fmt in [Format.CSR, Format.DIA, Format.ELL]:
        switched = dyn.activate(fmt)  # run-time format switch (convert)
        y = switched.spmv(x)
        print(f"  spmv in {fmt.name:5s}: max|y - y_coo| = "
              f"{float((y - y_coo).abs().max()):.2e}")

    # 4. Plan/execute switching: the symbolic phase runs once, the numeric
    #    phase never leaves the device, the cheap switch solvers use to
    #    re-format mid-run.
    plan = dyn.plan(Format.DIA)
    A_dia = convert_execute(A, plan)
    print("planned switch ->", A_dia.format.name,
          f"(ndiag={A_dia.ndiag}, zero host syncs)")

    # 5. Let the auto-tuner pick the best format.
    report = autotune(A, x, mode="profile", iters=5)
    print("profile auto-tune:", report)
    report = autotune(A, mode="analytic")
    print("analytic auto-tune:", report)

    # 6. SwitchDynamicMatrix: all formats resident, O(1) run-time dispatch.
    sw = SwitchDynamicMatrix.from_matrix(A, active=report.best)
    y = sw.spmv(x)
    matches = [bool(torch.allclose(y, y_coo, rtol=1e-4, atol=1e-4))]
    print("switch-dispatch spmv matches:", matches[-1])

    # 7. The hand-written SpMV kernels on the card (the plain versions on
    #    the CPU), against the COO product.
    route = "cuda" if dev.type == "cuda" else "plain"
    for fmt in (Format.DIA, Format.CSR):
        y_k = spmv(convert(A, fmt), x)
        matches.append(bool(torch.allclose(y_k, y_coo, rtol=1e-4, atol=1e-4)))
        print(f"{route} {fmt.name} kernel matches:", matches[-1])
    return 0 if all(matches) else 1


if __name__ == "__main__":
    sys.exit(main())
