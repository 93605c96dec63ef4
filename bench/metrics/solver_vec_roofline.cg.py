"""Percent: the traced solves' active iterations, each at the 7 vector
passes of CG's algebra (28 n bytes), at the card's HBM rate, over the
device time of ``solver_vec``'s kernels (dot, update, direction, finish)
by ``torch.profiler``."""
from harness.readers import active_iters, kernel_roofline

PATTERN = r"^(dot|update|direction|finish)_kernel$"


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    return kernel_roofline(ctx, PATTERN, "solver_vec", active_iters(t["solves"]))
