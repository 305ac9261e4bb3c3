"""The session loop's own host time per slice: self time of the
``propagate`` root and of each ``prompt_step`` and ``track_step``."""

from portbench.layer_metrics._spans import host_ms


def read(ctx):
    return host_ms(ctx, ("propagate", "prompt_step", "track_step"))
