"""The memory encoder's host time per slice: self time of
``memory_encoder`` (the encoder and the frame's half of the roped-key cache)."""

from portbench.layer_metrics._spans import host_ms


def read(ctx):
    return host_ms(ctx, ("memory_encoder",))
