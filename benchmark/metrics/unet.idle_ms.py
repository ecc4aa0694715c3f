"""Device idle time per step in the gaps closed by work launched inside the
port's "unet_forward" span (`benchmark/spans.py`): how long the card waited
on the UNet's host code."""

from benchmark import spans


def read(ctx):
    return spans.idle_ms(ctx, ("unet_forward",))
