"""Host milliseconds of a CG solve before its first block
(``LoopStats.preamble_ms``: the first residual, the dots, the state's
buffers); the mean over the window's untraced solves, from the port's
record of each solve."""
from harness.loops import mean


def read(ctx):
    return mean(ctx, "preamble_ms")
