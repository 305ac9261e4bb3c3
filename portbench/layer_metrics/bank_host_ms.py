"""The memory bank's host time per slice: self time of ``bank.read``
and ``bank.write`` (less the uploads inside them, which ``sync_ms`` reads)."""

from portbench.layer_metrics._spans import host_ms


def read(ctx):
    return host_ms(ctx, ("bank.read", "bank.write"))
