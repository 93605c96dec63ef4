"""Percent: the SpMV kernels' launches in the traced part of the window,
each at 4 nnz + 8 n bytes (the work's, whatever the format stores), at the
card's HBM rate, over those kernels' device time by ``torch.profiler``."""
from harness.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, r"^(dia|csr|ell|sell)_spmv", "spmv")
