"""The image encoder's (trunk and FPN laterals) share of its roofline."""

from portbench.layer_metrics._roofline import share


def read(ctx):
    return share(ctx, "image_encoder")
