"""Host milliseconds of a CG solve in the blocks it runs eagerly
(``LoopStats.eager_ms``: the first block on the card, its flag read left
out); the mean over the window's untraced solves, from the port's record
of each solve."""
from harness.loops import mean


def read(ctx):
    return mean(ctx, "eager_ms")
