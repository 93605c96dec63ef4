"""HPCG's rating: HPCG 3.1's operation count (``ReportResults.cpp``, in the
configuration's ``work.flops``) of the sets the window completed, over the
window's seconds."""
from harness.readers import active_iters


def read(ctx):
    w, flops = ctx["window"], ctx["work"]["flops"]
    if not w["solves"] or "per_set" not in flops:
        return None
    total = active_iters(w["solves"]) * flops["iter"] + len(w["solves"]) * flops["per_set"]
    return total / w["seconds"] / 1e9
