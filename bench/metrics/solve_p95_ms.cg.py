"""The 95th percentile (nearest rank) of the solve times of the window's
untraced part, each from the call to its result on the host,
synchronised. A per-layer reading: its spread between runs (bursts of
slower solves on the device) is too wide for an end-to-end bound."""
import math


def read(ctx):
    traced = len(ctx["trace"]["solves"]) if ctx["trace"] is not None else 0
    ms = sorted(s["ms"] for s in ctx["window"]["solves"][traced:])
    if not ms:
        return None
    return ms[math.ceil(0.95 * len(ms)) - 1]
