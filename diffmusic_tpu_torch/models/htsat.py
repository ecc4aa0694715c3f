"""CLAP audio tower: the HTSAT Swin transformer with its projection (port of
`diffmusic_tpu/models/htsat.py`).

transformers' `ClapAudioModelWithProjection` at inference: BatchNorm over the
mel bins with running statistics, `reshape_mel2img` (the time axis resized to
spec_size * freq_ratio and folded into the frequency axis), the 4x4 patch
conv, the Swin stages (window attention with a relative-position bias, the
shifted windows' -100/0 mask, PatchMerging), the final LayerNorm, the
frequency-grouped pooling and the two-layer projection. `features="frames"`
pools over frequency only and returns (B, T', projection_dim), the frame
features of the style-guidance gram matrix.

The input resolution is static, so the windows, shifts, masks and the resize
are built in numpy once per geometry. The resize is `jax.image.resize(...,
"bicubic")`'s rule, not `F.interpolate`'s: Keys cubic (a = -0.5) on
half-pixel centres, the weights renormalised where they leave the input
(`resize_matrix`), applied as a matmul so that gradients flow through it.
No kernel of its own: plain PyTorch. Attribute names follow the flax tree.
"""

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Dense


@dataclass(frozen=True)
class ClapAudioConfig:
    spec_size: int = 256
    patch_size: int = 4
    patch_stride: Tuple[int, int] = (4, 4)
    num_mel_bins: int = 64
    window_size: int = 8
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_attention_heads: Tuple[int, ...] = (4, 8, 16, 32)
    patch_embeds_hidden_size: int = 96
    mlp_ratio: float = 4.0
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5
    qkv_bias: bool = True

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.num_mel_bins

    @property
    def num_features(self) -> int:
        return int(self.patch_embeds_hidden_size * 2 ** (len(self.depths) - 1))


def tiny_clap_audio_config() -> ClapAudioConfig:
    return ClapAudioConfig(spec_size=64, patch_size=4, patch_stride=(4, 4),
                           num_mel_bins=16, window_size=4, depths=(1, 1),
                           num_attention_heads=(2, 2),
                           patch_embeds_hidden_size=16, projection_dim=16)


# ------------------------------------------------------------ static geometry

def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5, of |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=16)
def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of `jax.image.resize(..., "bicubic")`
    along one axis (scale_and_translate with antialias): sample points on
    half-pixel centres, the kernel widened by the scale when downsampling,
    each output's weights divided by their sum, and zero where the sample
    lies outside the input."""
    scale = n_out / n_in
    kernel_scale = max(1.0 / scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    w = _keys_cubic(np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0.0)
    return np.ascontiguousarray(w.T, dtype=np.float32)


@functools.lru_cache(maxsize=32)
def _on_device(make, *args, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """make(*args), a numpy array built once per geometry, as a tensor cached
    per device and dtype."""
    return torch.as_tensor(make(*args), dtype=dtype, device=device)


def bicubic_resize(x: torch.Tensor, dim: int, n_out: int) -> torch.Tensor:
    """x resized along `dim` to n_out by `resize_matrix` (a matmul)."""
    w = _on_device(resize_matrix, x.shape[dim], n_out, device=x.device, dtype=x.dtype)
    return torch.movedim(torch.movedim(x, dim, -1) @ w.T, -1, dim)


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/ws * W/ws, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def _window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


@functools.lru_cache(maxsize=16)
def _relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)  # (ws*ws, ws*ws)


@functools.lru_cache(maxsize=16)
def _shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Swin SW-MSA mask: (num_windows, ws*ws, ws*ws) additive (-100/0)."""
    img = np.zeros((h, w), np.float32)
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


# --------------------------------------------------------------------- layers

class WindowAttention(nn.Module):
    def __init__(self, cfg: ClapAudioConfig, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        ws = window_size
        self.query = Dense(dim, dim, bias=cfg.qkv_bias)
        self.key = Dense(dim, dim, bias=cfg.qkv_bias)
        self.value = Dense(dim, dim, bias=cfg.qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) * (2 * ws - 1), num_heads))
        self.output_dense = Dense(dim, dim)

    def forward(self, x, attn_mask=None):
        nw_b, n, c = x.shape
        heads = self.num_heads
        split = lambda a: a.reshape(nw_b, n, heads, c // heads).transpose(1, 2)
        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        scores = q @ k.transpose(-1, -2) / np.sqrt(c // heads)
        idx = _on_device(_relative_position_index, self.window_size, device=x.device,
                         dtype=torch.long)
        bias = self.relative_position_bias_table[idx.reshape(-1)].reshape(n, n, heads)
        scores = scores + bias.permute(2, 0, 1)[None]
        if attn_mask is not None:
            nw = attn_mask.shape[0]
            scores = (scores.reshape(nw_b // nw, nw, heads, n, n)
                      + attn_mask[None, :, None]).reshape(nw_b, heads, n, n)
        out = torch.softmax(scores, dim=-1) @ v
        return self.output_dense(out.transpose(1, 2).reshape(nw_b, n, c))


class SwinBlock(nn.Module):
    def __init__(self, cfg: ClapAudioConfig, dim: int, num_heads: int,
                 input_resolution: Tuple[int, int], shift_size: int):
        super().__init__()
        self.input_resolution = input_resolution
        self.window_size, self.shift_size = cfg.window_size, shift_size
        if min(input_resolution) <= cfg.window_size:
            # one window covers the stage (its bias table is sized for it)
            self.window_size, self.shift_size = min(input_resolution), 0
        self.layernorm_before = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.attention = WindowAttention(cfg, dim, num_heads, self.window_size)
        self.layernorm_after = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.intermediate_dense = Dense(dim, int(dim * cfg.mlp_ratio))
        self.output_dense = Dense(int(dim * cfg.mlp_ratio), dim)

    def forward(self, x):
        h, w = self.input_resolution
        ws, shift = self.window_size, self.shift_size
        b, n, c = x.shape
        y = self.layernorm_before(x).reshape(b, h, w, c)
        pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
        if pad_b or pad_r:
            y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        mask = None
        if shift > 0:
            y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
            mask = _on_device(_shift_attn_mask, hp, wp, ws, shift, device=y.device,
                              dtype=y.dtype)
        y = _window_reverse(self.attention(_window_partition(y, ws), mask), ws, hp, wp)
        if shift > 0:
            y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
        y = y[:, :h, :w, :].reshape(b, n, c)
        x = x + y
        z = self.output_dense(F.gelu(self.intermediate_dense(self.layernorm_after(x))))
        return x + z


class PatchMerging(nn.Module):
    def __init__(self, dim: int, input_resolution: Tuple[int, int]):
        super().__init__()
        self.input_resolution = input_resolution
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        h, w = self.input_resolution
        b, n, c = x.shape
        y = x.reshape(b, h, w, c)
        if h % 2 or w % 2:
            y = F.pad(y, (0, 0, 0, w % 2, 0, h % 2))
        y = torch.cat([y[:, 0::2, 0::2], y[:, 1::2, 0::2], y[:, 0::2, 1::2],
                       y[:, 1::2, 1::2]], dim=-1).reshape(b, -1, 4 * c)
        return self.reduction(self.norm(y))


class ClapAudioModelWithProjection(nn.Module):
    """(B, 1, T, num_mel_bins) log-mel -> (B, projection_dim) audio embeds,
    or (B, T', projection_dim) frame features with `features="frames"`."""

    def __init__(self, cfg: ClapAudioConfig):
        super().__init__()
        self.cfg = cfg
        m = cfg.num_mel_bins
        self.bn_scale = nn.Parameter(torch.ones(m))
        self.bn_bias = nn.Parameter(torch.zeros(m))
        self.register_buffer("bn_mean", torch.zeros(m))
        self.register_buffer("bn_var", torch.ones(m))
        pad = (cfg.patch_size - cfg.patch_stride[0]) // 2
        self.patch_embed_proj = nn.Conv2d(1, cfg.patch_embeds_hidden_size, cfg.patch_size,
                                          stride=cfg.patch_stride, padding=pad)
        self.patch_embed_norm = nn.LayerNorm(cfg.patch_embeds_hidden_size,
                                             eps=cfg.layer_norm_eps)
        grid = cfg.spec_size // cfg.patch_stride[0]
        res = (grid, grid)
        self.stages = []
        for i, depth in enumerate(cfg.depths):
            dim = int(cfg.patch_embeds_hidden_size * 2 ** i)
            for d in range(depth):
                shift = 0 if d % 2 == 0 else cfg.window_size // 2
                name = f"stage_{i}_block_{d}"
                setattr(self, name, SwinBlock(cfg, dim, cfg.num_attention_heads[i], res,
                                              shift))
                self.stages.append(name)
            if i < len(cfg.depths) - 1:
                name = f"stage_{i}_downsample"
                setattr(self, name, PatchMerging(dim, res))
                self.stages.append(name)
                res = ((res[0] + 1) // 2, (res[1] + 1) // 2)
        self.norm = nn.LayerNorm(cfg.num_features, eps=cfg.layer_norm_eps)
        self.projection_linear1 = Dense(cfg.num_features, cfg.projection_dim)
        self.projection_linear2 = Dense(cfg.projection_dim, cfg.projection_dim)

    def reshape_mel2img(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1, T, F) -> (B, 1, spec_size, spec_size): the time axis resized
        to spec_size * freq_ratio (and F to spec_size / freq_ratio) where
        shorter, then folded into the frequency axis."""
        cfg = self.cfg
        b, c, t, f = x.shape
        fr = cfg.freq_ratio
        spec_w, spec_h = cfg.spec_size * fr, cfg.spec_size // fr
        if t < spec_w:
            x, t = bicubic_resize(x, 2, spec_w), spec_w
        if f < spec_h:
            x, f = bicubic_resize(x, 3, spec_h), spec_h
        x = x.reshape(b, c * fr, t // fr, f).transpose(2, 3)
        return x.reshape(b, c, f * fr, t // fr)

    def forward(self, input_features: torch.Tensor, features: str = "pooled") -> torch.Tensor:
        cfg = self.cfg
        x = (input_features - self.bn_mean) / torch.sqrt(self.bn_var + 1e-5)
        x = self.reshape_mel2img(x * self.bn_scale + self.bn_bias)
        b = x.shape[0]
        x = self.patch_embed_proj(x)                          # (B, D, gh, gw)
        x = self.patch_embed_norm(x.flatten(2).transpose(1, 2))
        for name in self.stages:
            x = getattr(self, name)(x)
        x = self.norm(x)

        # the frequency-grouped pooling of ClapAudioEncoder's tail
        n_c = x.shape[-1]
        side = cfg.spec_size // 2 ** (len(cfg.depths) - 1) // cfg.patch_stride[0]
        c_freq_bin = side // cfg.freq_ratio
        y = x.transpose(1, 2).reshape(b, n_c, side // c_freq_bin, c_freq_bin, side)
        y = y.transpose(2, 3).reshape(b, n_c, c_freq_bin, -1)
        if features == "frames":
            pooled = y.mean(2).transpose(1, 2)                # (B, T', D)
        else:
            pooled = y.reshape(b, n_c, -1).mean(-1)
        return self.projection_linear2(F.relu(self.projection_linear1(pooled)))


def get_audio_features(model: ClapAudioModelWithProjection,
                       input_features: torch.Tensor) -> torch.Tensor:
    emb = model(input_features)
    return emb / emb.norm(dim=-1, keepdim=True)
