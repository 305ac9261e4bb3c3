"""The SAM heads' host time per slice: self time of ``sam_heads``
(prompt encoder, mask decoder, object pointer)."""

from portbench.layer_metrics._spans import host_ms


def read(ctx):
    return host_ms(ctx, ("sam_heads",))
