"""Device busy time of the traced unit per slice it finished, in ms: the
work the card does for a slice, steadier than the host-clock rate that it
bounds from below."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or t.busy_s <= 0 or t.work == 0:
        return None
    return 1e3 * t.busy_s / t.work
