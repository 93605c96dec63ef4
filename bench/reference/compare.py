"""The readings that decide ``correct``: the program's solves held against
the reference's, in float64.

For each sampled solve the program hands over its right-hand side's index
in the pool, its ``x``, its residual history and its iteration count. The
reference solves the same right-hand side again from ``x0 = 0`` with the
same method, tolerance and iteration limit, and reads:

* ``rres``: ``||b - A x|| / ||b||`` of the program's ``x``, the operator
  applied on the grid in float64;
* ``rres_gap``: how far ``rres`` lies from the reference's own, as a share
  of the reference's or of ``floor``, whichever is larger (for a fixed
  count of iterations, which may stop where the residual is still far
  above the rounding of the program's precision);
* ``iters_gap``: how many iterations the program's solve took more or
  fewer than the reference's (only where a solve stops at a tolerance);
* ``hist_gap``: the largest relative gap between the program's residual
  norm after iteration ``k`` and the reference's, over ``k = 1 ..
  hist_iters`` while the reference's stays above ``floor`` times its
  start (below that the program's precision, not its method, sets it).

Each is the worst over the sample. The reference runs once per distinct
right-hand side of the sample.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from reference import solvers

READINGS = ("rres", "rres_gap", "iters_gap", "hist_gap")


def reference_solve(method: dict, grid: Tuple[int, int, int], b: torch.Tensor) -> solvers.Solve:
    """The reference's solve of ``b`` (float64) by ``method``: ``{"solver":
    "cg" | "pcg_mg", "tol", "maxiter"}`` and, for ``pcg_mg``, the
    hierarchy's ``nlevels``, ``pre``, ``post``, ``coarse_sweeps``."""
    if method["solver"] == "cg":
        return solvers.cg(grid, b, method["tol"], method["maxiter"])
    if method["solver"] == "pcg_mg":
        return solvers.mg_pcg(grid, b, method["tol"], method["maxiter"], method["nlevels"],
                              method["pre"], method["post"], method["coarse_sweeps"])
    raise ValueError(f"no reference for solver {method['solver']!r}")


def readings(method: dict, grid: Tuple[int, int, int], pool: Sequence[torch.Tensor],
             samples: Sequence[dict], hist_iters: int, floor: float) -> Dict[str, float]:
    """The worst of each reading over ``samples``: dicts with ``rhs`` (index
    into ``pool``), ``x``, ``history`` and ``iters`` of the program's
    solve. ``pool`` holds the right-hand sides as the program got them."""
    refs: Dict[int, tuple] = {}
    out = dict.fromkeys(READINGS, 0.0)
    for s in samples:
        b = pool[s["rhs"]].to(torch.float64)
        if s["rhs"] not in refs:
            ref = reference_solve(method, grid, b)
            refs[s["rhs"]] = (ref, solvers.residual_norm(grid, b, ref.x))
        ref, ref_rres = refs[s["rhs"]]
        rres = solvers.residual_norm(grid, b, s["x"].to(torch.float64))
        rres = rres if rres == rres else float("inf")  # NaN fails every limit
        out["rres"] = max(out["rres"], rres)
        out["rres_gap"] = max(out["rres_gap"], abs(rres - ref_rres) / max(ref_rres, floor))
        out["iters_gap"] = max(out["iters_gap"], float(abs(int(s["iters"]) - ref.iters)))
        above = (ref.history[1:] >= floor * ref.history[0]).tolist() + [False]
        k = min(hist_iters, above.index(False), int(s["iters"]))
        if k < 1:
            gap = 0.0 if int(s["iters"]) == ref.iters else float("inf")
        else:
            h = s["history"][1:k + 1].to(torch.float64)
            h_ref = ref.history[1:k + 1]
            gap = float(((h - h_ref).abs() / h_ref.abs().clamp_min(1e-300)).max())
            gap = gap if gap == gap else float("inf")
        out["hist_gap"] = max(out["hist_gap"], gap)
    return out
