"""Whole-step MFU: the analytic FLOPs of all the work the window finished,
over the window's host-clock time times the card's published bf16 peak, in
percent. Nothing where the card is not in the peak table."""

from portbench.counts.peaks import peaks


def read(ctx):
    p = peaks(ctx.get("device_name", ""))
    w = ctx["window"]
    if p is None or w.units == 0:
        return None
    return 100.0 * ctx["counts"]["flops"]["total"] * w.units / (w.seconds * p[0])
