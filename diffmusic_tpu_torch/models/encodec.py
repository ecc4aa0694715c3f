"""EnCodec's SEANet encoder: the eval's `encodec-emb` embedders.

The JAX package runs transformers' `EncodecModel.encoder` on the CPU and
takes its continuous output, before quantisation
(`diffmusic_tpu/fadtk/model_loader.py::EncodecEmbModel`); this is the same
encoder written natively, with transformers' module names and indices, so
that an HF snapshot's `encoder.*` keys load as they are (weight norm folded,
`checkpoint.load_encodec_encoder`):

- each conv pads its input first: by kernel - stride on the left where
  `use_causal_conv` is set, split (right half rounded down) otherwise, plus
  on the right what makes the last window whole (`conv_padding`), in
  `pad_mode` (reflect, with zeros appended first for an input shorter than
  the pad); `norm_type` "time_group_norm" puts a one-group GroupNorm after
  the conv, "weight_norm" folds g / |v| into the weight at load;
- a conv, then per ratio (reversed `upsampling_ratios`) the residual blocks
  (ELU, conv k 3 with dilation growth^j to dim // compress, ELU, conv k 1
  back, plus a 1x1 conv shortcut), ELU and a strided conv doubling the
  channels; then the LSTM with its skip, ELU and the final conv to
  `hidden_size`.

No kernel of its own: cuDNN convs and `nn.LSTM`.
"""

from dataclasses import dataclass, fields
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass(frozen=True)
class EncodecConfig:
    """transformers EncodecConfig's encoder fields (defaults:
    facebook/encodec_24khz)."""
    sampling_rate: int = 24000
    audio_channels: int = 1
    hidden_size: int = 128
    num_filters: int = 32
    num_residual_layers: int = 1
    upsampling_ratios: Tuple[int, ...] = (8, 5, 4, 2)
    norm_type: str = "weight_norm"
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    use_causal_conv: bool = True
    pad_mode: str = "reflect"
    compress: int = 2
    num_lstm_layers: int = 2
    use_conv_shortcut: bool = True

    @classmethod
    def from_json(cls, c: dict) -> "EncodecConfig":
        kw = {f.name: c[f.name] for f in fields(cls) if f.name in c}
        if "upsampling_ratios" in kw:
            kw["upsampling_ratios"] = tuple(kw["upsampling_ratios"])
        cfg = cls(**kw)
        if cfg.norm_type not in ("weight_norm", "time_group_norm"):
            raise ValueError(f"EncodecConfig: norm_type {cfg.norm_type!r} is not supported")
        return cfg


def conv_padding(padding_total: int, extra: int, causal: bool) -> Tuple[int, int]:
    """(left, right) padding of a conv's input: all of kernel - stride on the
    left for a causal conv, else split with the right half rounded down; the
    extra frames that complete the last window on the right."""
    if causal:
        return padding_total, extra
    right = padding_total // 2
    return padding_total - right, right + extra


class EncodecConv1d(nn.Module):
    def __init__(self, cfg: EncodecConfig, cin: int, cout: int, kernel: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.causal, self.pad_mode = cfg.use_causal_conv, cfg.pad_mode
        self.conv = nn.Conv1d(cin, cout, kernel, stride, dilation=dilation)
        self.norm = nn.GroupNorm(1, cout) if cfg.norm_type == "time_group_norm" else None
        self.stride = stride
        self.kernel = (kernel - 1) * dilation + 1
        self.padding_total = self.kernel - stride

    def forward(self, x):
        length = x.shape[-1]
        frames = -(-(length - self.kernel + self.padding_total) // self.stride)
        extra = frames * self.stride + self.kernel - self.padding_total - length
        left, right = conv_padding(self.padding_total, extra, self.causal)
        if self.pad_mode == "reflect":
            short = max(max(left, right) - length + 1, 0)
            x = F.pad(F.pad(x, (0, short)), (left, right), mode="reflect")
            x = x[..., :x.shape[-1] - short]
        else:
            x = F.pad(x, (left, right), mode=self.pad_mode)
        x = self.conv(x)
        return x if self.norm is None else self.norm(x)


class EncodecResnetBlock(nn.Module):
    def __init__(self, cfg: EncodecConfig, dim: int, dilations: Tuple[int, int]):
        super().__init__()
        hidden = dim // cfg.compress
        kernels = (cfg.residual_kernel_size, 1)
        chans = ((dim, hidden), (hidden, dim))
        block = []
        for (cin, cout), k, d in zip(chans, kernels, dilations):
            block += [nn.ELU(), EncodecConv1d(cfg, cin, cout, k, dilation=d)]
        self.block = nn.ModuleList(block)
        self.shortcut = (EncodecConv1d(cfg, dim, dim, 1) if cfg.use_conv_shortcut
                         else nn.Identity())

    def forward(self, x):
        h = x
        for layer in self.block:
            h = layer(h)
        return self.shortcut(x) + h


class EncodecLSTM(nn.Module):
    def __init__(self, cfg: EncodecConfig, dim: int):
        super().__init__()
        self.lstm = nn.LSTM(dim, dim, cfg.num_lstm_layers)

    def forward(self, x):
        x = x.permute(2, 0, 1)
        return (self.lstm(x)[0] + x).permute(1, 2, 0)


class EncodecEncoder(nn.Module):
    """(B, audio_channels, L) audio -> (B, hidden_size, frames) embeddings."""

    def __init__(self, cfg: EncodecConfig):
        super().__init__()
        self.cfg = cfg
        layers = [EncodecConv1d(cfg, cfg.audio_channels, cfg.num_filters, cfg.kernel_size)]
        scale = 1
        for ratio in reversed(cfg.upsampling_ratios):
            dim = scale * cfg.num_filters
            layers += [EncodecResnetBlock(cfg, dim, (cfg.dilation_growth_rate ** j, 1))
                       for j in range(cfg.num_residual_layers)]
            layers += [nn.ELU(), EncodecConv1d(cfg, dim, 2 * dim, 2 * ratio, stride=ratio)]
            scale *= 2
        layers += [EncodecLSTM(cfg, scale * cfg.num_filters), nn.ELU(),
                   EncodecConv1d(cfg, scale * cfg.num_filters, cfg.hidden_size,
                                 cfg.last_kernel_size)]
        self.layers = nn.ModuleList(layers)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        if audio.shape[1] != self.cfg.audio_channels:
            raise ValueError(f"EnCodec's encoder takes audio_channels="
                             f"{self.cfg.audio_channels} channels, got {audio.shape[1]}")
        x = audio
        for layer in self.layers:
            x = layer(x)
        return x
