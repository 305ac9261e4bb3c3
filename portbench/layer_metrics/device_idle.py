"""Device idle share of the untraced window, in percent: 100 (1 - busy /
unit), busy being the device time of the traced unit (the union of the
kernels, copies and sets the profiler saw; the device's work is the same
untraced) and unit the window's host-clock time per unit. The traced unit's
own length is stretched by the profiler and is not used."""


def read(ctx):
    t, w = ctx.get("trace"), ctx["window"]
    if t is None or t.busy_s <= 0 or w.units == 0:
        return None
    return 100.0 * (1.0 - t.busy_s / (w.seconds / w.units))
