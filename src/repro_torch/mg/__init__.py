"""repro_torch.mg — geometric multigrid over dynamic sparse matrices (port of ``repro.mg``).

The preconditioner the paper's HPCG leaves off (§IV-B benchmarks with it
disabled because reference SymGS is sequential): a V-cycle of
2:1-coarsened stencil levels, smoothed by a multicolored (vector-parallel)
symmetric Gauss-Seidel, with every level and every color block routed
through run-time format selection.

    coarsen    plan/execute 2:1 grid coarsening (injection / trilinear,
               rediscretized / Galerkin coarse operators)
    smoothers  8-color SymGS as per-color row-block SpMVs + Jacobi fallback
    cycle      MGHierarchy + the V-cycle apply_M for solvers.pcg

The JAX package's ``mg.dist`` (the per-level slab-partitioned hierarchy)
comes with the distributed layer.
"""
from repro_torch.mg.coarsen import (CoarsenPlan, Coarsening, coarse_problem,
                                    coarsen_execute, f2c_map, galerkin_coarse,
                                    plan_coarsen, prolong, restrict, stencil27_coo,
                                    trilinear_corners)
from repro_torch.mg.cycle import (MIN_COARSE_ROWS, MGHierarchy, MGLevel, build_hierarchy,
                                  v_cycle)
from repro_torch.mg.smoothers import (NCOLORS, ColoredSystem, build_colored, check_coloring,
                                      color_grid, color_ranks, color_rows_padded, gs_sweep,
                                      jacobi, split_colors_stacked, symgs,
                                      symgs_reference_np)

__all__ = [
    "CoarsenPlan", "Coarsening", "plan_coarsen", "coarsen_execute",
    "f2c_map", "trilinear_corners", "stencil27_coo", "galerkin_coarse",
    "restrict", "prolong", "coarse_problem",
    "ColoredSystem", "NCOLORS", "color_grid", "color_ranks", "color_rows_padded",
    "split_colors_stacked", "build_colored", "check_coloring",
    "gs_sweep", "symgs", "jacobi", "symgs_reference_np",
    "MGHierarchy", "MGLevel", "MIN_COARSE_ROWS", "build_hierarchy", "v_cycle",
]
