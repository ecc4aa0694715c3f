"""AutoencoderKL (port of `diffmusic_tpu/models/vae.py`).

The decode path is the one every guided step differentiates. The encoder is
here because the JAX package has it and a checkpoint carries its weights; no
pipeline calls it. The mid-block attention of both (T = 4000 tokens x 512
channels, one head, at 10 s) is plain PyTorch by default (`vae_mid_attn=
"plain"`), as the JAX package's default routes it to plain XLA;
`vae_mid_attn="flash"` (`DIFFMUSIC_TPU_VAE_MID_ATTN=flash`, read by the JAX
package in the block both share) gives it `Attention(kernel="auto")`: the
flash kernel at head_dim 512 where T >= 512 (`kernels/attention.py`), with
the backward form `flash_bwd`. `gn_mode`, `conv2d_kernel` and `conv2d_bwd`
route the decoder's GroupNorms and 3x3 'same' convs (`models/layers.py`); the
decoder keeps the NCHW orientation (the JAX package's
`DIFFMUSIC_TPU_VAE_SWAP=0`).
"""

from typing import Optional

import torch
import torch.nn as nn

from ..inverse_problem.noise import randn
from .configs import VAEConfig
from .layers import Attention, Downsample2D, GroupNorm, ResnetBlock2D, Upsample2D, conv3x3

VAE_MID_ATTN = ("plain", "flash")


class VAEAttentionBlock(nn.Module):
    def __init__(self, channels: int, groups: int = 32, gn_mode: str = "plain",
                 mid_attn: str = "plain", flash_bwd: str = "f32"):
        super().__init__()
        if mid_attn not in VAE_MID_ATTN:
            raise ValueError(f"vae_mid_attn must be one of {VAE_MID_ATTN}, not {mid_attn!r}")
        self.group_norm = GroupNorm(groups, channels, 1e-6, gn_mode=gn_mode)
        self.attention = Attention(channels, heads=1, head_dim=channels,
                                   kernel="auto" if mid_attn == "flash" else "plain",
                                   flash_bwd=flash_bwd)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.attention(y)
        return x + y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class Encoder(nn.Module):
    """mel (B, C, H, W) -> (B, 2 * latent, H / s, W / s): mean, then logvar."""

    def __init__(self, cfg: VAEConfig, mid_attn: str = "plain", flash_bwd: str = "f32"):
        super().__init__()
        self.cfg = cfg
        g = cfg.norm_num_groups
        boc = cfg.block_out_channels
        self.conv_in = conv3x3(cfg.in_channels, boc[0])
        ch = boc[0]
        for i, out_ch in enumerate(boc):
            for j in range(cfg.layers_per_block):
                setattr(self, f"down_{i}_resnet_{j}", ResnetBlock2D(ch, out_ch, g))
                ch = out_ch
            if i != len(boc) - 1:
                setattr(self, f"down_{i}_downsample", Downsample2D(ch))
        self.mid_resnet_0 = ResnetBlock2D(ch, ch, g)
        self.mid_attn = VAEAttentionBlock(ch, g, mid_attn=mid_attn, flash_bwd=flash_bwd)
        self.mid_resnet_1 = ResnetBlock2D(ch, ch, g)
        self.conv_norm_out = GroupNorm(g, ch, 1e-6, use_silu=True)
        self.conv_out = conv3x3(ch, 2 * cfg.latent_channels)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)

    def forward(self, x):
        cfg = self.cfg
        x = self.conv_in(x)
        for i in range(len(cfg.block_out_channels)):
            for j in range(cfg.layers_per_block):
                x = getattr(self, f"down_{i}_resnet_{j}")(x)
            if i != len(cfg.block_out_channels) - 1:
                x = getattr(self, f"down_{i}_downsample")(x)
        x = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(x)))
        return self.quant_conv(self.conv_out(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, gn_mode: str = "plain", conv2d_kernel: bool = False,
                 conv2d_bwd: str = "plain", mid_attn: str = "plain", flash_bwd: str = "f32"):
        super().__init__()
        self.cfg = cfg
        g = cfg.norm_num_groups
        boc = cfg.block_out_channels
        ch = boc[-1]
        convs = dict(conv2d_kernel=conv2d_kernel, conv2d_bwd=conv2d_bwd)
        routes = dict(gn_mode=gn_mode, **convs)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)
        self.conv_in = conv3x3(cfg.latent_channels, ch, **convs)
        self.mid_resnet_0 = ResnetBlock2D(ch, ch, g, **routes)
        self.mid_attn = VAEAttentionBlock(ch, g, gn_mode, mid_attn, flash_bwd)
        self.mid_resnet_1 = ResnetBlock2D(ch, ch, g, **routes)
        for i, out_ch in enumerate(reversed(boc)):
            for j in range(cfg.layers_per_block + 1):
                setattr(self, f"up_{i}_resnet_{j}", ResnetBlock2D(ch, out_ch, g, **routes))
                ch = out_ch
            if i != len(boc) - 1:
                setattr(self, f"up_{i}_upsample", Upsample2D(ch, **convs))
        self.conv_norm_out = GroupNorm(g, ch, 1e-6, use_silu=True, gn_mode=gn_mode)
        self.conv_out = conv3x3(ch, cfg.out_channels, **convs)

    def forward(self, z):
        cfg = self.cfg
        x = self.conv_in(self.post_quant_conv(z))
        x = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(x)))
        for i in range(len(cfg.block_out_channels)):
            for j in range(cfg.layers_per_block + 1):
                x = getattr(self, f"up_{i}_resnet_{j}")(x)
            if i != len(cfg.block_out_channels) - 1:
                x = getattr(self, f"up_{i}_upsample")(x)
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    """NCHW at the API boundary, like the torch reference. The route flags
    are the decoder's (`vae_mid_attn` and `flash_bwd` the encoder's too)."""

    def __init__(self, cfg: VAEConfig, gn_mode: str = "plain", conv2d_kernel: bool = False,
                 conv2d_bwd: str = "plain", vae_mid_attn: str = "plain",
                 flash_bwd: str = "f32"):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder(cfg, gn_mode, conv2d_kernel, conv2d_bwd, vae_mid_attn, flash_bwd)
        # registered after the decoder, so that a seeded init draws the
        # decoder's weights as it did before the encoder was ported
        self.encoder = Encoder(cfg, vae_mid_attn, flash_bwd)

    def encode(self, x: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, C, H, W) mel -> (B, latent, H / s, W / s): the posterior's mean,
        or with a generator a sample of it (logvar clipped to [-30, 20])."""
        mean, logvar = self.encoder(x).chunk(2, dim=1)
        if generator is None:
            return mean
        std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
        return mean + std * randn(mean.shape, generator, mean.dtype, mean.device)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, latent, h, w) -> (B, C, H, W) mel."""
        return self.decoder(z)
