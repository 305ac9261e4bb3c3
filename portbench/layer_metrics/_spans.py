"""Host time by program span, read from the spans-only unit of the traced
run (:func:`portbench.lib.spans.program_spans`) and divided by the slices it
finished: the self time of the layer's spans (their duration less their
children's), or all the time inside them. Nothing where the program has no
spans."""

from portbench.lib.spans import program_spans


def host_ms(ctx, names, key: str = "self_ns"):
    s = program_spans(ctx)
    if s is None or s["work"] == 0:
        return None
    t = s["totals"]
    return sum(t[n][key] for n in names if n in t) * 1e-6 / s["work"]


def count_per_slice(ctx, name: str):
    s = program_spans(ctx)
    if s is None or s["work"] == 0:
        return None
    return s["totals"].get(name, {"count": 0})["count"] / s["work"]
