"""repro_torch.core — dynamic sparse matrices in PyTorch (port of ``repro.core``).

Public API:
    Format, COO, CSR, DIA, ELL, BSR, Dense, HYB, SELL   containers
    from_numpy, to_numpy                                 JAX <-> port crossing
    plan_switch, convert_execute, convert, SwitchPlan    format conversion
    DynamicMatrix, SwitchDynamicMatrix                   dynamic abstractions
    spmv, spmm, spmm_t, dot, waxpby, axpy, norm2         algorithms
    kernel_route                                         measured backend="auto" route
    autotune                                             per-matrix format tuner
"""
from repro_torch.core.autotune import autotune
from repro_torch.core.convert import (SwitchPlan, convert, convert_execute,
                                      plan_switch, to_coo)
from repro_torch.core.dynamic import (DEFAULT_CANDIDATES, DynamicMatrix,
                                      SwitchDynamicMatrix)
from repro_torch.core.formats import (BSR, COO, CSR, DIA, ELL, SELL, Dense,
                                      Format, HYB, banded_coo, coo_from_arrays,
                                      coo_from_dense_np, dense_from_array,
                                      from_numpy, to_dense_np, to_numpy)
from repro_torch.core.ops import (axpy, dot, extract_diagonal, kernel_route, norm2,
                                  spmm, spmm_t, spmv, update_diagonal, waxpby)

__all__ = [
    "Format", "COO", "CSR", "DIA", "ELL", "BSR", "Dense", "HYB", "SELL",
    "from_numpy", "to_numpy", "coo_from_arrays", "coo_from_dense_np",
    "dense_from_array", "banded_coo", "to_dense_np",
    "SwitchPlan", "plan_switch", "convert_execute", "convert", "to_coo",
    "DynamicMatrix", "SwitchDynamicMatrix", "DEFAULT_CANDIDATES",
    "spmv", "spmm", "spmm_t", "dot", "waxpby", "axpy", "norm2", "extract_diagonal",
    "update_diagonal", "autotune", "kernel_route",
]
