"""Host milliseconds of an MG-PCG set in the blocks it runs eagerly
(``LoopStats.eager_ms``: the first block of two iterations on the card,
each with its V-cycle, its flag read left out); the mean over the
window's untraced solves, from the port's record of each solve."""
from harness.loops import mean


def read(ctx):
    return mean(ctx, "eager_ms")
