"""A hooked layer's share of its roofline in the traced window: the least
time its work could take on the card (the larger of its analytic FLOPs over
the bf16 peak and its bytes over the bandwidth, each input, weight and
output moved once) over the device time of the operations launched inside
the layer's ranges in the hooked unit, in percent."""

from portbench.counts.peaks import bound_seconds, peaks


def share(ctx, layer: str):
    t = ctx.get("trace")
    name = ctx.get("device_name", "")
    if t is None or peaks(name) is None:
        return None
    dev_s = t.layer_device_s.get(layer, 0.0)
    if dev_s <= 0:
        return None
    c = ctx["counts"]
    bound = bound_seconds(c["flops"][layer], c["bytes"][layer], name)
    return 100.0 * bound / dev_s
