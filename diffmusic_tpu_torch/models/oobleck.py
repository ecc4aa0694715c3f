"""AutoencoderOobleck, the stable-audio-open waveform VAE (port of
`diffmusic_tpu/models/oobleck.py`).

The JAX package runs its 1-D convs channels-last; here they are
`nn.Conv1d` / `nn.ConvTranspose1d` on (B, C, T), the layout cuDNN takes, so
the public layout (B, C, T) is also the inner one. The snake activation is
computed in fp32 whatever the weights' dtype (sin^2 of a small alpha * x
underflows in bf16) and cast back. Module and parameter names follow the flax
tree, so `models/convert.py::from_flax` loads the JAX package's parameters;
Snake's alpha and beta are (1, C, 1), diffusers' layout (flax keeps them as
(1, 1, C)).
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .configs import OobleckConfig


class Snake1d(nn.Module):
    """x + 1 / (exp(beta) + 1e-9) * sin^2(exp(alpha) * x), with per-channel
    log-scale alpha and beta (diffusers Snake1d, logscale=True)."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(1, hidden_dim, 1))
        self.beta = nn.Parameter(torch.zeros(1, hidden_dim, 1))

    def forward(self, x):
        a = torch.exp(self.alpha.float())
        b = torch.exp(self.beta.float())
        xf = x.float()
        y = xf + (1.0 / (b + 1e-9)) * torch.sin(a * xf).square()
        return y.to(x.dtype)


class OobleckResidualUnit(nn.Module):
    """snake -> dilated conv (k=7) -> snake -> conv (k=1), residual."""

    def __init__(self, dimension: int, dilation: int = 1):
        super().__init__()
        pad = ((7 - 1) * dilation) // 2
        self.snake1 = Snake1d(dimension)
        self.conv1 = nn.Conv1d(dimension, dimension, 7, dilation=dilation, padding=pad)
        self.snake2 = Snake1d(dimension)
        self.conv2 = nn.Conv1d(dimension, dimension, 1)

    def forward(self, x):
        return x + self.conv2(self.snake2(self.conv1(self.snake1(x))))


class OobleckEncoderBlock(nn.Module):
    """3 residual units (dilations 1/3/9), then a strided conv: kernel 2s,
    padding ceil(s/2)."""

    def __init__(self, input_dim: int, output_dim: int, stride: int):
        super().__init__()
        self.res_unit1 = OobleckResidualUnit(input_dim, 1)
        self.res_unit2 = OobleckResidualUnit(input_dim, 3)
        self.res_unit3 = OobleckResidualUnit(input_dim, 9)
        self.snake1 = Snake1d(input_dim)
        self.conv1 = nn.Conv1d(input_dim, output_dim, 2 * stride, stride=stride,
                               padding=math.ceil(stride / 2))

    def forward(self, x):
        x = self.res_unit3(self.res_unit2(self.res_unit1(x)))
        return self.conv1(self.snake1(x))


class OobleckDecoderBlock(nn.Module):
    """Transposed-conv upsample, then 3 residual units (dilations 1/3/9).

    `ConvTranspose1d(k=2s, stride=s, padding=ceil(s/2))` is the torch form of
    the JAX package's `nn.ConvTranspose` with explicit (k-1-P, k-1-P)
    padding and `transpose_kernel=True`."""

    def __init__(self, input_dim: int, output_dim: int, stride: int):
        super().__init__()
        self.snake1 = Snake1d(input_dim)
        self.conv_t1 = nn.ConvTranspose1d(input_dim, output_dim, 2 * stride, stride=stride,
                                          padding=math.ceil(stride / 2))
        self.res_unit1 = OobleckResidualUnit(output_dim, 1)
        self.res_unit2 = OobleckResidualUnit(output_dim, 3)
        self.res_unit3 = OobleckResidualUnit(output_dim, 9)

    def forward(self, x):
        y = self.conv_t1(self.snake1(x))
        return self.res_unit3(self.res_unit2(self.res_unit1(y)))


class OobleckEncoder(nn.Module):
    """(B, audio_channels, T) -> (B, 2 * latent, T / hop)."""

    def __init__(self, cfg: OobleckConfig):
        super().__init__()
        self.cfg = cfg
        mults = (1,) + tuple(cfg.channel_multiples)
        hs = cfg.encoder_hidden_size
        self.conv1 = nn.Conv1d(cfg.audio_channels, hs, 7, padding=3)
        for i, stride in enumerate(cfg.downsampling_ratios):
            setattr(self, f"block_{i}",
                    OobleckEncoderBlock(hs * mults[i], hs * mults[i + 1], stride))
        self.snake1 = Snake1d(hs * mults[-1])
        self.conv2 = nn.Conv1d(hs * mults[-1], 2 * cfg.decoder_input_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv1(x)
        for i in range(len(self.cfg.downsampling_ratios)):
            h = getattr(self, f"block_{i}")(h)
        return self.conv2(self.snake1(h))


class OobleckDecoder(nn.Module):
    """(B, latent, T / hop) -> (B, audio_channels, T)."""

    def __init__(self, cfg: OobleckConfig):
        super().__init__()
        self.cfg = cfg
        mults = (1,) + tuple(cfg.channel_multiples)
        dc = cfg.decoder_channels
        self.conv1 = nn.Conv1d(cfg.decoder_input_channels, dc * mults[-1], 7, padding=3)
        ratios = tuple(reversed(cfg.downsampling_ratios))
        n = len(ratios)
        for i, stride in enumerate(ratios):
            setattr(self, f"block_{i}",
                    OobleckDecoderBlock(dc * mults[n - i], dc * mults[n - i - 1], stride))
        self.snake1 = Snake1d(dc)
        self.conv2 = nn.Conv1d(dc, cfg.audio_channels, 7, padding=3, bias=False)

    def forward(self, z):
        h = self.conv1(z)
        for i in range(len(self.cfg.downsampling_ratios)):
            h = getattr(self, f"block_{i}")(h)
        return self.conv2(self.snake1(h))


class AutoencoderOobleck(nn.Module):
    """encode: waveform -> (mean, std) of the diagonal-Gaussian latent, std =
    softplus(scale) + 1e-4 (diffusers OobleckDiagonalGaussianDistribution);
    decode: latent -> waveform. Layout (B, C, T)."""

    def __init__(self, cfg: OobleckConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = OobleckEncoder(cfg)
        self.decoder = OobleckDecoder(cfg)

    def encode(self, waveform) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, scale = self.encoder(waveform).chunk(2, dim=1)
        return mean, F.softplus(scale) + 1e-4

    def decode(self, latents) -> torch.Tensor:
        return self.decoder(latents)

    def forward(self, waveform, generator: Optional[torch.Generator] = None):
        mean, std = self.encode(waveform)
        z = mean if generator is None else mean + std * torch.randn(
            mean.shape, generator=generator, dtype=mean.dtype, device=generator.device
        ).to(mean.device)
        return self.decode(z), mean, std
