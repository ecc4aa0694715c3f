"""Device idle time per step in the gaps closed by the UNet's work launched
inside the port's "unet.cross_attn" regions, both streams
(`benchmark/regions.py`): how long the card waited on the host code of the
cross-attention's small plain ops."""

from benchmark import regions


def read(ctx):
    return regions.idle_ms(ctx, ("unet.cross_attn",))
