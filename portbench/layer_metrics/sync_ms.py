"""Host time per slice inside ``sync`` spans: the host-blocking
transfers, each of which waits for the card's queue to drain."""

from portbench.layer_metrics._spans import host_ms


def read(ctx):
    return host_ms(ctx, ("sync",), key="total_ns")
