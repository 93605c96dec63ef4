"""repro_torch.core — dynamic sparse matrices in PyTorch (port of ``repro.core``).

Public API:
    Format, COO, CSR, DIA, ELL, BSR, Dense, HYB, SELL   containers
    from_numpy, to_numpy                                 JAX <-> port crossing
    coo_from_arrays, banded_coo, random_coo, ...         host-side builders
    plan_switch, convert_execute, convert, SwitchPlan    format conversion
    DynamicMatrix, SwitchDynamicMatrix                   dynamic abstractions
    spmv, spmm, spmm_t, dot, waxpby, axpy, norm2,        algorithms
    assign, reduction
    bytes_of, shallow_copy, deep_copy                    copy semantics
    autotune, analytic_select, profile_select,           per-matrix format tuner
    TuneReport, PatternStats
    kernel_route                                         measured backend="auto" route
    plan_switch_batch, convert_execute_batch             batched (stacked) conversion
    DistSparseMatrix, DistPlan, build_dist_matrix,       the distributed layer
    dist_spmv, dist_spmv_phase, distribute_vector,
    activate_dist
"""
from repro_torch.core.autotune import autotune
from repro_torch.core.convert import (SwitchPlan, convert, convert_execute,
                                      convert_execute_batch, coo_to_sell, plan_switch,
                                      plan_switch_batch, sell_to_coo, to_coo)
from repro_torch.core.distributed import (DistPlan, DistSparseMatrix, activate_dist,
                                          build_dist_matrix, dist_spmv, dist_spmv_phase,
                                          distribute_vector)
from repro_torch.core.dynamic import (DEFAULT_CANDIDATES, DynamicMatrix,
                                      SwitchDynamicMatrix)
from repro_torch.core.formats import (BSR, COO, CSR, DIA, ELL, SELL, Dense,
                                      Format, HYB, banded_coo, bytes_of, coo_from_arrays,
                                      coo_from_dense_np, deep_copy, dense_from_array,
                                      from_numpy, random_coo, shallow_copy, to_dense_np,
                                      to_numpy)
from repro_torch.core.ops import (assign, axpy, dot, extract_diagonal, kernel_route, norm2,
                                  reduction, spmm, spmm_t, spmv, update_diagonal, waxpby)
from repro_torch.tuning.engines import TuneReport, analytic_select, profile_select
from repro_torch.tuning.features import PatternStats

__all__ = [
    "Format", "COO", "CSR", "DIA", "ELL", "BSR", "Dense", "HYB", "SELL",
    "from_numpy", "to_numpy", "coo_from_arrays", "coo_from_dense_np",
    "dense_from_array", "banded_coo", "random_coo", "to_dense_np",
    "SwitchPlan", "plan_switch", "convert_execute", "convert", "to_coo",
    "plan_switch_batch", "convert_execute_batch", "coo_to_sell", "sell_to_coo",
    "DistSparseMatrix", "DistPlan", "build_dist_matrix", "dist_spmv", "dist_spmv_phase",
    "distribute_vector", "activate_dist",
    "DynamicMatrix", "SwitchDynamicMatrix", "DEFAULT_CANDIDATES",
    "spmv", "spmm", "spmm_t", "dot", "waxpby", "axpy", "norm2", "extract_diagonal",
    "update_diagonal", "autotune", "kernel_route", "assign", "reduction",
    "profile_select", "analytic_select", "TuneReport", "PatternStats",
    "bytes_of", "shallow_copy", "deep_copy",
]
