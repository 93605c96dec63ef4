"""One cell, from set-up through the window to the check.

:func:`setup` builds the system once; :func:`pool_for` makes a seed's
right-hand sides; :func:`measure` drives the window; :func:`judge` frees
nothing itself and runs the reference over the kept solves. :func:`run`
composes them as one benchmark run does, and ``bench/control.py`` reuses
the pieces to read many seeds over one set-up.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from harness import drive, problem, yardstick
from harness.spec import Spec, read_all
from harness.system import DTYPES, System, sync
from reference import compare


def launches() -> int:
    """Every launch of the port's hand-written kernels so far: the SpMV and
    SpMM kernels' counters and ``solver_vec``'s (replays counted)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import solver_vec

    return sum(kops.launch_counts().values()) + sum(solver_vec.launches.values())


class Cell:
    """A workload's configuration, traffic, checks and, once built, its
    system; ``program_dtype`` puts the program in another precision than
    the configuration states (the control), the inputs staying as stated."""

    def __init__(self, spec: Spec, workload: str, device: torch.device,
                 program_dtype: Optional[str] = None):
        self.spec, self.workload, self.device = spec, workload, device
        w = spec.workload(workload)
        self.config = spec.config(w["config"])
        self.traffic = spec.traffic(w["traffic"])
        self.checks = spec.checks(workload)
        self.grid = tuple(self.config["grid"])
        self.dtype = DTYPES[self.config["dtype"]]
        self.program_dtype = DTYPES[program_dtype or self.config["dtype"]]
        self.spans: Dict[str, dict] = {}
        self.system: Optional[System] = None

    def setup(self, trace: bool = False) -> None:
        """The matrix made on the device and handed to the program, which
        selects, converts and (MG) builds its hierarchy. With ``trace`` the
        port's spans are on for this part only (summary mode)."""
        from repro_torch.core.formats import COO
        from repro_torch.obs import trace as ptrace

        ptrace.set_mode("summary" if trace else "off")
        ptrace.clear()
        row, col, val = problem.stencil_triplets(self.grid, self.program_dtype, self.device)
        n = self.grid[0] * self.grid[1] * self.grid[2]
        A = COO(row, col, val, (n, n), int(val.shape[0]))
        self.system = System(self.config, A, self.device)
        self.spans = ptrace.aggregate()
        ptrace.set_mode("off")

    def pool_for(self, seed: int):
        t = self.traffic
        return problem.rhs_pool(self.grid, t["pool"], t["x_star"]["base"],
                                t["x_star"]["amplitude"], seed, self.dtype, self.device)

    def program_pool(self, pool):
        return [b.to(self.program_dtype) for b in pool]

    def warm(self, pool) -> None:
        """The cell's own solve, once."""
        drive.solve(self.system, pool[0], self.traffic)
        sync(self.device)

    def method(self) -> dict:
        m = {k: self.traffic[k] for k in ("solver", "tol", "maxiter")}
        m.update(self.config.get("preconditioner") or {})
        return m

    def readings(self, pool, samples) -> Dict[str, float]:
        """Every reading of :mod:`reference.compare` over the kept solves,
        the reference run in float64."""
        return compare.readings(self.method(), self.grid, pool, samples,
                                self.checks["hist_iters"], self.checks["floor"])

    def judge(self, pool, samples) -> Dict[str, dict]:
        """``{number: {"value", "limit"}}`` of the cell's checks."""
        reads = self.readings(pool, samples)
        return {k: {"value": reads[k], "limit": lim}
                for k, lim in self.checks["limits"].items()}

    def free(self) -> None:
        self.system = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _profiler_factory():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def run(spec: Spec, workload: str, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, card: str,
        program_dtype: Optional[str] = None) -> dict:
    """One benchmark run: the result's dict, ``checks`` last. ``program_dtype``
    runs the program in another precision (the control's)."""
    from harness import devtrace

    marks = [time.perf_counter()]  # set-up's phases, for the record
    cell = Cell(spec, workload, device, program_dtype)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    cell.setup(trace)
    sync(device)
    marks.append(time.perf_counter())
    pool = cell.pool_for(seed)
    prog_pool = cell.program_pool(pool)
    sync(device)
    marks.append(time.perf_counter())
    cell.warm(prog_pool)
    if trace and device.type == "cuda":
        with _profiler_factory():  # the profiler's own start-up, out of the window
            cell.warm(prog_pool)
    marks.append(time.perf_counter())
    setup_s = marks[-1] - t_start
    phases = dict(zip(("start", "system", "pool", "warm"),
                      (b - a for a, b in zip([t_start] + marks, marks))))
    info, timers = cell.system.info, cell.system.timers
    n0 = launches()
    rec = drive.window(cell.system, prog_pool, cell.traffic, seconds, seed, device,
                       _profiler_factory if trace and device.type == "cuda" else None)
    window_launches = launches() - n0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    cell.free()
    traced = None
    if rec["traced"] is not None:
        t = rec["traced"]
        traced = devtrace.summarise(devtrace.events(t["prof"]), t["seconds"])
        traced["solves"] = rec["solves"][:t["solves"]]
        rec["traced"] = None
    t0 = time.perf_counter()
    checks = cell.judge(pool, rec["samples"])
    reference_s = time.perf_counter() - t0
    ctx = {"workload": workload, "config": cell.config, "traffic": cell.traffic,
           "work": yardstick.work(cell.config),
           "peaks": yardstick.peaks_for(card) if device.type == "cuda" else None,
           "setup_s": setup_s, "timers": timers, "spans": cell.spans,
           "window": {"seconds": rec["seconds"], "solves": rec["solves"],
                      "launches": window_launches},
           "trace": traced}
    metrics = read_all(spec, workload, "per_layer" if trace else "end_to_end", ctx)
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": len(rec["solves"]),
              "failed": sum(s["failed"] for s in rec["solves"]),
              "metrics": metrics,
              "device": {"platform": "gpu", "kind": card,
                         "count": spec.workload(workload)["chips"],
                         "memory_peak_bytes": int(peak)}}
    if traced is not None:
        result["device"].update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = {"device_ops": traced["ops"], "idle_gaps": traced["gaps"]}
    result["info"] = {"format": info.get("format"), "reference_s": reference_s,
                      "window_s": rec["seconds"], "setup_phases_s": phases}
    result["checks"] = checks
    return result
