"""Active iterations a solve (``CGResult.iters``), the mean over the window."""
from harness.readers import active_iters


def read(ctx):
    s = ctx["window"]["solves"]
    return active_iters(s) / len(s) if s else None
