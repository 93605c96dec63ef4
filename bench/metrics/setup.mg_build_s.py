"""The multigrid hierarchy's build (``repro_torch.mg.build_hierarchy``: the
coarse grids, colour splits, every level's and block's selection and
conversion), by the host clock, synchronised."""


def read(ctx):
    return ctx["timers"].get("mg_build")
