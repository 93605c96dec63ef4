"""Selection: the host seconds of the port's ``select.*`` spans during set-up
(``FormatPolicy.select`` of the operator, and inside ``build_hierarchy``
every level's ``select`` and colour blocks' ``select_batch``). A pick reads
the pattern's features on the host, so each span ends after the device work
it waited for."""


def read(ctx):
    spans = {k: v for k, v in ctx["spans"].items() if k.startswith("select.")}
    if not spans:
        return None
    return sum(v["total_us"] for v in spans.values()) * 1e-6
