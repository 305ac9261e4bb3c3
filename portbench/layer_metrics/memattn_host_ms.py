"""The memory attention's host time per slice: self time of
``memory_attention`` (the readout's assembly and the module call, less the
bank reads inside it)."""

from portbench.layer_metrics._spans import host_ms


def read(ctx):
    return host_ms(ctx, ("memory_attention",))
