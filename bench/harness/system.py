"""The system under test, built from ``repro_torch`` for one configuration.

The harness hands the program the COO matrix it made; the program picks
its format (``FormatPolicy(policy).select``), converts it
(``DynamicMatrix.activate`` with the plan), and, where the configuration
has a multigrid preconditioner, builds the hierarchy
(``repro_torch.mg.build_hierarchy``). Each step is timed on the host
clock, synchronised; selection by its spans.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class System:
    """``apply_A`` (and ``apply_M``) of one configuration on ``device``;
    ``timers`` holds the host seconds of ``convert`` and ``mg_build``,
    ``info`` the picked formats. Selection is timed by the port's own
    ``select.*`` spans."""

    def __init__(self, config: dict, A, device: torch.device):
        from repro_torch.core.dynamic import DynamicMatrix
        from repro_torch.core.formats import Format
        from repro_torch.core.solvers import operator
        from repro_torch.tuning.policy import FormatPolicy

        self.timers: Dict[str, float] = {}
        self.info: Dict[str, object] = {}
        self.apply_M: Optional[Callable] = None
        report = FormatPolicy(config["policy"]).select(A)
        t0 = time.perf_counter()
        D = DynamicMatrix(A)
        M = D.activate(report.best, plan=D.plan(report.best))
        sync(device)
        self.timers["convert"] = time.perf_counter() - t0
        self.info["format"] = Format(M.active).name
        self.apply_A = operator(M, cfg=report.cfg)
        self.matrix = M
        pre = config.get("preconditioner")
        if pre:
            self._build_mg(config, pre, A, device)

    def _build_mg(self, config: dict, pre: dict, A, device: torch.device) -> None:
        from repro_torch.core.hpcg import HPCGProblem
        from repro_torch.mg import build_hierarchy
        from repro_torch.tuning.policy import FormatPolicy

        if pre["kind"] != "mg":
            raise ValueError(f"no preconditioner {pre['kind']!r}")
        nx, ny, nz = config["grid"]
        # build_hierarchy reads the grid from the problem and the level-0
        # matrix from A: no host triplets are made
        dims = HPCGProblem(nx, ny, nz, None, None, None, A.shape)
        t0 = time.perf_counter()
        self.hierarchy = build_hierarchy(
            dims, nlevels=pre["nlevels"], policy=FormatPolicy(config["policy"]),
            smoother=pre["smoother"], pre=pre["pre"], post=pre["post"],
            coarse_sweeps=pre["coarse_sweeps"], prolong=pre["prolong"],
            coarse_op=pre["coarse_op"], A=A)
        sync(device)
        self.timers["mg_build"] = time.perf_counter() - t0
        self.info["levels"] = self.hierarchy.formats()
        self.apply_M = self.hierarchy.apply_M()
