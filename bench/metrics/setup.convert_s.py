"""Plan and conversion of the operator to the picked format
(``DynamicMatrix.plan`` and ``activate``), by the host clock, synchronised."""


def read(ctx):
    return ctx["timers"].get("convert")
