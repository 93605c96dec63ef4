"""Set-up seconds: from the start of the process's script to the window,
by the host clock: kernels loaded (built, on a checkout's first run), the
matrix, selection, conversion, the hierarchy, the pool and one warm solve."""


def read(ctx):
    return ctx["setup_s"]
