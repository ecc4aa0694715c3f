"""Device time per step of the UNet's activities launched inside the port's
"unet.cross_attn" regions, both streams (each transformer block's norm2_i
and cross-attention over the GPT-2 states or the T5 sequence;
`benchmark/regions.py`)."""

from benchmark import regions


def read(ctx):
    return regions.device_ms(ctx, ("unet.cross_attn",))
