"""Time to solution: the window's wall time over the solves it completed."""


def read(ctx):
    w = ctx["window"]
    if not w["solves"]:
        return None
    return 1e3 * w["seconds"] / len(w["solves"])
