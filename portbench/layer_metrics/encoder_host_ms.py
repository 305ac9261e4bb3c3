"""The image encoder's host time per slice: self time of
``image_encoder`` (the trunk, the FPN and the decoder's skip projections)."""

from portbench.layer_metrics._spans import host_ms


def read(ctx):
    return host_ms(ctx, ("image_encoder",))
