"""The memory attention's share of its roofline."""

from portbench.layer_metrics._roofline import share


def read(ctx):
    return share(ctx, "memory_attention")
