"""The benchmark's yardstick: the card's published peaks, and the work a
configuration's iteration, solve or set needs, counted from the grid and
never from a storage format.

A configuration's ``work`` section lists terms ``[coefficient, symbol]``.
``per_iter``, ``spmv``, ``solver_vec`` and ``per_set`` use the finest
level's ``n0`` and ``nnz0``; ``per_fine_level`` is summed over every level
but the coarsest with that level's ``n``, ``nnz`` and the next level's
``n_next``; ``per_coarsest_level`` uses the coarsest level's ``n`` and
``nnz``. An iteration's total is ``per_iter`` plus the level sums.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# Data-sheet peaks by card name, most specific first: HBM bytes/s and
# float32 FLOP/s outside the tensor cores (NVIDIA's H100 and H200 data
# sheets; the SXM part's "H100" key last).
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H200": (4.8e12, 67e12), "H100": (3.35e12, 67e12)}


def peaks_for(name: str) -> Dict[str, float]:
    """``{"hbm_Bps", "f32_flops"}`` of the card called ``name``; raises for
    a card the table does not know."""
    for key, (hbm, f32) in PEAKS.items():
        if key in name:
            return {"card": key, "hbm_Bps": hbm, "f32_flops": f32}
    raise KeyError(f"no data-sheet peaks for card {name!r}")


def stencil_nnz(grid: Sequence[int]) -> int:
    nx, ny, nz = grid
    return (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)


def levels(grid: Sequence[int], nlevels: int) -> List[Tuple[int, int]]:
    """``(n, nnz)`` of each level: the grid halved on every axis."""
    out, g = [], tuple(grid)
    for _ in range(nlevels):
        out.append((g[0] * g[1] * g[2], stencil_nnz(g)))
        g = tuple(d // 2 for d in g)
    return out


def _terms(terms, env: Dict[str, int]) -> float:
    return float(sum(c * env[sym] for c, sym in terms))


def evaluate(section: dict, grid: Sequence[int], nlevels: int) -> Dict[str, float]:
    """The totals of one ``work`` section (``flops`` or ``bytes``):
    ``iter`` and every named term list over the finest level."""
    levs = levels(grid, max(1, nlevels))
    base = {"n0": levs[0][0], "nnz0": levs[0][1]}
    out = {k: _terms(v, base) for k, v in section.items()
           if isinstance(v, list) and k not in ("per_fine_level", "per_coarsest_level")}
    it = out.get("per_iter", 0.0)
    if nlevels > 1:
        for i, (n, nnz) in enumerate(levs[:-1]):
            it += _terms(section.get("per_fine_level", []),
                         {"n": n, "nnz": nnz, "n_next": levs[i + 1][0]})
        n, nnz = levs[-1]
        it += _terms(section.get("per_coarsest_level", []), {"n": n, "nnz": nnz})
    out["iter"] = it
    return out


def work(config: dict) -> Dict[str, Dict[str, float]]:
    """``{"flops": {...}, "bytes": {...}}`` of a configuration."""
    nlevels = (config.get("preconditioner") or {}).get("nlevels", 1)
    return {kind: evaluate(sec, config["grid"], nlevels)
            for kind, sec in config["work"].items() if kind in ("flops", "bytes")}
