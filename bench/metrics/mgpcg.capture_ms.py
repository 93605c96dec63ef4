"""Host milliseconds of an MG-PCG set capturing its block (two V-cycles)
into a CUDA graph (``LoopStats.capture_ms``), whose private pool the
allocator fills with ``cudaMalloc``; the mean over the window's untraced
solves, from the port's record of each solve. None off the card."""
from harness.loops import mean


def read(ctx):
    return mean(ctx, "capture_ms", card_only=True)
