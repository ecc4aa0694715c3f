"""Device time per step of the UNet's activities launched inside the port's
"unet.self_attn" regions (each transformer block's norm1 and self-attention,
flash #9 at T >= 512; `benchmark/regions.py`)."""

from benchmark import regions


def read(ctx):
    return regions.device_ms(ctx, ("unet.self_attn",))
