"""Host-blocking transfers per slice: the count of ``sync`` spans."""

from portbench.layer_metrics._spans import count_per_slice


def read(ctx):
    return count_per_slice(ctx, "sync")
