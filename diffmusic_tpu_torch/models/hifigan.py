"""HiFi-GAN vocoder, SpeechT5HifiGan-compatible (port of
`diffmusic_tpu/models/hifigan.py`).

Activations are (B, T, C), the kernels' layout, and every convolution weight
is kept in the kernels' math layout (k, Cin, Cout), so no per-call transposes
stand between the weights and the kernels. Routing follows the JAX package on
a TPU:
  - a resblock iteration (convs1_i, convs2_i) runs as ONE `conv1d_fused_pair`
    launch where `pair_ok` holds (128-aligned channels, pair weights <= 9 MB in
    the activation dtype: in bf16 every ch512 pair but k=11, and all ch256 and
    ch128 pairs);
  - the other resblock convs with 128-aligned channels run `conv1d_fused`;
  - upsamplers with `phase_ct_ok` channels (1024->512, 512->256, 256->128)
    run `phase_convtranspose`;
  - the 64- and 32-channel stages, conv_pre and conv_post are plain
    F.conv1d / F.conv_transpose1d (the plain versions beside the kernels).
`mask_kernel` (the JAX package's `DIFFMUSIC_TPU_MASK=pallas`, off by default
there too) routes the leaky-ReLU masks in the resblock kernels' backward to
the mask kernels where `mask_ok` holds (ch >= 128 with a long enough T: the
10-s slice's stages 0-2). `adjoint_kernel` (the JAX package's
`with_adjoint_weights`, off by default there too) runs the backward's adjoint
conv of each `conv1d_fused` call with 128-aligned channels (in bf16 the
ch512 k=11 convs) as the kernel's adjoint mode; the pairs keep their plain
adjoints.

Two more routes, off by default as in the JAX package, put whole resblock
stages on the canvas (`kernels/canvas.py`: pad once, slice once), checked in
the JAX order, stage rule first:
  - `stage_bwd` (`DIFFMUSIC_TPU_STAGE_BWD=1`): a stage where `stage_ok` holds
    (128 channels, the 10-s slice's stage 2) and every pair meets `pair_ok`
    runs `stage_resblocks_canvas`, whose backward is one kernel launch;
  - `canvas` (`DIFFMUSIC_TPU_CANVAS`): the other stages with 128-aligned
    channels (stages 0-2) run on the canvas; "xbwd" (`CANVAS=xbwd`) takes
    `conv1d_pair_canvas` where `pair_ok` holds and `conv1d_fused_canvas`
    with a plain backward for the rest (the ch512 k=11 convs); "kernel"
    (`CANVAS=1`) runs every resblock conv as `conv1d_fused_canvas`, whose
    backward launches the canvas kernel's adjoint mode.
The canvas convs mask their backward with a plain `where`: `mask_kernel`
applies to the stages off the canvas only.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.canvas import canvas_ok, from_canvas, to_canvas
from ..kernels.conv1d import (conv1d_fused, conv1d_fused_canvas, conv1d_fused_pair,
                              conv1d_pair_canvas, conv1d_plain, pair_ok)
from ..kernels.stage_bwd import stage_ok, stage_resblocks_canvas
from ..kernels.upsampler import (convtranspose_plain, output_length,
                                 phase_convtranspose, phase_ct_ok)
from .configs import HiFiGANConfig

CANVAS_MODES = ("off", "xbwd", "kernel")


class Conv1dParams(nn.Module):
    """A conv1d's parameters in math layout: weight (k, Cin, Cout), bias (Cout,).

    `fan_in` is the flax initializer's fan-in for this kernel (k * Cin, but
    k * Cout for the ConvTranspose upsamplers, whose flax kernels are laid out
    (k, Cout, Cin))."""

    def __init__(self, k: int, cin: int, cout: int, fan_in: Optional[int] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(k, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.fan_in = fan_in if fan_in is not None else k * cin


class ResidualBlock(nn.Module):
    """HifiGanResidualBlock: (lrelu -> dilated conv -> lrelu -> conv) + skip, xN."""

    def __init__(self, channels: int, kernel_size: int, dilations, slope: float,
                 mask_kernel: bool = False, adjoint_kernel: bool = False):
        super().__init__()
        self.channels, self.kernel_size = channels, kernel_size
        self.dilations, self.slope = tuple(dilations), slope
        self.mask_kernel, self.adjoint_kernel = mask_kernel, adjoint_kernel
        for i in range(len(self.dilations)):
            setattr(self, f"convs1_{i}", Conv1dParams(kernel_size, channels, channels))
            setattr(self, f"convs2_{i}", Conv1dParams(kernel_size, channels, channels))

    def pairs(self):
        """(w1, b1, w2, b2) per iteration."""
        return [(getattr(self, f"convs1_{i}").weight, getattr(self, f"convs1_{i}").bias,
                 getattr(self, f"convs2_{i}").weight, getattr(self, f"convs2_{i}").bias)
                for i in range(len(self.dilations))]

    def forward(self, x, signal_len: Optional[int] = None, canvas: str = "off"):
        """x: (B, T, C), or with `signal_len` the canvas of a signal of that
        length, run in the `canvas` mode "xbwd" or "kernel"."""
        c, k, s, mk = self.channels, self.kernel_size, self.slope, self.mask_kernel
        for i, d in enumerate(self.dilations):
            c1, c2 = getattr(self, f"convs1_{i}"), getattr(self, f"convs2_{i}")
            if signal_len is not None:
                if canvas == "xbwd" and pair_ok(k, c, c, x.dtype):
                    x = conv1d_pair_canvas(x, c1.weight, c1.bias, c2.weight, c2.bias,
                                           signal_len, d, s)
                else:
                    bwd = "plain" if canvas == "xbwd" else "kernel"
                    h = conv1d_fused_canvas(x, c1.weight, c1.bias, None, signal_len, d, s, bwd)
                    x = conv1d_fused_canvas(h, c2.weight, c2.bias, x, signal_len, 1, s, bwd)
            elif pair_ok(k, c, c, x.dtype):
                x = conv1d_fused_pair(x, c1.weight, c1.bias, c2.weight, c2.bias, d, s, mk)
            elif c % 128 == 0:
                ak = self.adjoint_kernel
                h = conv1d_fused(x, c1.weight, c1.bias, None, d, s, mk, ak)
                x = conv1d_fused(h, c2.weight, c2.bias, x, 1, s, mk, ak)
            else:
                h = conv1d_plain(x, c1.weight, c1.bias, d, s)
                x = conv1d_plain(h, c2.weight, c2.bias, 1, s, residual=x)
        return x


class SpeechT5HifiGan(nn.Module):
    def __init__(self, cfg: HiFiGANConfig, mask_kernel: bool = False, canvas: str = "off",
                 stage_bwd: bool = False, adjoint_kernel: bool = False):
        super().__init__()
        if canvas not in CANVAS_MODES:
            raise ValueError(f"canvas must be one of {CANVAS_MODES}, not {canvas!r}")
        self.cfg = cfg
        self.canvas, self.stage_bwd = canvas, stage_bwd
        uic = cfg.upsample_initial_channel
        self.conv_pre = Conv1dParams(7, cfg.model_in_dim, uic)
        for i, (rate, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            ch = uic // 2 ** (i + 1)
            setattr(self, f"upsampler_{i}", Conv1dParams(k, uic // 2 ** i, ch,
                                                         fan_in=k * ch))
            for j, (rk, dil) in enumerate(zip(cfg.resblock_kernel_sizes,
                                              cfg.resblock_dilation_sizes)):
                setattr(self, f"resblocks_{i * len(cfg.resblock_kernel_sizes) + j}",
                        ResidualBlock(ch, rk, dil, cfg.leaky_relu_slope, mask_kernel,
                                      adjoint_kernel))
        self.conv_post = Conv1dParams(7, uic // 2 ** len(cfg.upsample_rates), 1)
        if cfg.normalize_before:
            # the input mel's per-bin statistics, applied as (x - mean) / scale
            self.mean = nn.Parameter(torch.zeros(cfg.model_in_dim))
            self.scale = nn.Parameter(torch.ones(cfg.model_in_dim))

    def forward(self, spectrogram: torch.Tensor) -> torch.Tensor:
        """(B, T, model_in_dim) log-mel -> (B, T * hop_length) waveform."""
        cfg = self.cfg
        slope = cfg.leaky_relu_slope
        nk = len(cfg.resblock_kernel_sizes)
        if cfg.normalize_before:
            spectrogram = (spectrogram - self.mean) / self.scale
        x = conv1d_plain(spectrogram, self.conv_pre.weight, self.conv_pre.bias)
        for i, (rate, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            up = getattr(self, f"upsampler_{i}")
            cin, cout = up.weight.shape[1:]
            if phase_ct_ok(cin, cout):
                x = phase_convtranspose(x, up.weight, up.bias, rate, k,
                                        output_length(x.shape[1], rate, k), slope)
            else:
                x = convtranspose_plain(F.leaky_relu(x, slope),
                                        up.weight, up.bias, rate, k)
            blocks = [getattr(self, f"resblocks_{i * nk + j}") for j in range(nk)]
            t, ch = x.shape[1], x.shape[2]
            if (self.stage_bwd
                    and stage_ok(ch, cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes,
                                 x.dtype)
                    and all(pair_ok(k, ch, ch, x.dtype) for k in cfg.resblock_kernel_sizes)):
                params = [p for blk in blocks for p in blk.pairs()]
                x = from_canvas(stage_resblocks_canvas(
                    to_canvas(x), params, t, cfg.resblock_kernel_sizes,
                    cfg.resblock_dilation_sizes, slope), t)
                continue
            on_canvas = self.canvas != "off" and canvas_ok(ch, ch)
            if on_canvas:
                x = to_canvas(x)
            res = None
            for blk in blocks:
                out = blk(x, t, self.canvas) if on_canvas else blk(x)
                res = out if res is None else res + out
            x = res / nk
            if on_canvas:
                x = from_canvas(x, t)
        x = conv1d_plain(x, self.conv_post.weight, self.conv_post.bias, slope=slope)
        return torch.tanh(x)[..., 0]
