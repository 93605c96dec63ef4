"""The caching allocator's ``cudaMalloc`` and ``cudaFree`` calls in an MG-
PCG set (``LoopStats.device_allocs``: ``num_device_alloc +
num_device_free`` of ``torch.cuda.memory_stats``); the mean over the
window's untraced solves, from the port's record of each solve. None off
the card."""
from harness.loops import mean


def read(ctx):
    return mean(ctx, "device_allocs", card_only=True)
