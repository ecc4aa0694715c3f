"""Building blocks of the MusicLDM and AudioLDM2 UNets and the VAE decoder
(port of `diffmusic_tpu/models/layers.py`).

NCHW at module boundaries (PyTorch idiom); the transformer blocks run on
(B, H*W, C) tokens in the same row-major (h, w) order as the JAX package's
NHWC reshape. Module attribute names follow the flax parameter tree, so
`models/convert.py::from_flax` only renames `kernel`/`scale` and transposes.
GroupNorm and the 3x3 'same' convs are plain PyTorch by default, as the JAX
default routing is plain XLA; two route flags mirror the JAX package's A/B
gates (read from the constructor, never from the environment):
  - `gn_mode` ("plain" | "fused" | "stats", `DIFFMUSIC_TPU_GN=xla|fused|stats`):
    "fused" runs `fused_gn_ok` geometries (C % 128 == 0, H*W*C <= 2**20) as
    the fused GroupNorm kernel, "stats" every 4-D GroupNorm through the
    moments kernel (`moments_ok`: C % 128 == 0, C <= 1024, H*W >= 8) with the
    normalise in plain PyTorch;
  - `conv2d_kernel` (`DIFFMUSIC_TPU_CONV2D=pallas`): `Conv2dSame` runs
    `conv2d_ok` geometries (odd k > 1, W <= 64, 512 % W == 0, H*W >= 512,
    128-aligned channels) as the conv2d kernel; with it, `conv2d_bwd`
    ("plain" | "kernel", `DIFFMUSIC_TPU_CONV2D_BWD=xla|pallas`) runs the
    backward's adjoint conv as the kernel too where `conv2d_ok` holds for it.
The port never swaps the VAE's spatial axes (`spatial_swap` is not ported),
so its routes are the JAX package's under `DIFFMUSIC_TPU_VAE_SWAP=0`: the VAE
decoder's convs at W = 16/32/64 are eligible, and the conv2d kernel runs
inside the guided gradient. The transformer blocks take the JAX package's
routes:
  - self-attention only, T >= 512 and inner == C: the fused block kernel;
  - dual-cross (AudioLDM2), T >= 512, inner == C and `fuse_cross` on: the
    fused block kernel's dual-cross mode;
  - `bsoft` (`DIFFMUSIC_TPU_BSOFT=1`) runs both fused modes with the bounded
    softmax (`kernels/transformer_block.py`); flash attention is untouched;
  - otherwise plain, where `attn1` with T == Tk >= 512 and no mask takes the
    flash attention kernel (`kernels/attention.py`), whose backward's form
    `Attention`'s `flash_bwd` picks ("f32" | "bf16").
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.attention import flash_attention
from ..kernels.conv2d import CONV2D_BWD, conv2d_ok, conv2d_same
from ..kernels.group_norm import (GN_MODES, fused_gn_ok, fused_group_norm, group_norm_plain,
                                  stats_group_norm)
from ..kernels.transformer_block import fused_transformer_block
from ..tracing import region


def timestep_embedding(timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers Timesteps semantics), fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class GroupNorm(nn.Module):
    """GroupNorm over NCHW with fp32 statistics (var = E[x^2] - mu^2, as the
    JAX package computes it) and an optional fused SiLU; output in x.dtype.
    `gn_mode` picks the route (module docstring)."""

    def __init__(self, num_groups: int, channels: int, eps: float, use_silu: bool = False,
                 gn_mode: str = "plain"):
        super().__init__()
        if gn_mode not in GN_MODES:
            raise ValueError(f"gn_mode must be one of {GN_MODES}, not {gn_mode!r}")
        self.num_groups, self.eps, self.use_silu = num_groups, eps, use_silu
        self.gn_mode = gn_mode
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        args = (x, self.weight, self.bias, self.num_groups, self.eps, self.use_silu)
        if self.gn_mode == "stats" and x.ndim == 4:
            return stats_group_norm(*args)
        if self.gn_mode == "fused" and fused_gn_ok(x):
            return fused_group_norm(*args)
        return group_norm_plain(*args)


class Conv2dSame(nn.Conv2d):
    """`nn.Conv2d(cin, cout, k, padding=k // 2)` (the JAX package's
    `Conv2DSame`, same parameter names), with the conv2d kernel's route when
    `conv2d_kernel` is on and `conv2d_ok` holds; `conv2d_bwd` is that
    route's backward ("plain" or "kernel", `kernels/conv2d.py`)."""

    def __init__(self, cin: int, cout: int, k: int = 3, conv2d_kernel: bool = False,
                 conv2d_bwd: str = "plain"):
        super().__init__(cin, cout, k, padding=k // 2)
        if conv2d_bwd not in CONV2D_BWD:
            raise ValueError(f"conv2d_bwd must be one of {CONV2D_BWD}, not {conv2d_bwd!r}")
        self.conv2d_kernel, self.conv2d_bwd = conv2d_kernel, conv2d_bwd

    def forward(self, x):
        if self.conv2d_kernel and conv2d_ok(x, self.weight):
            return conv2d_same(x, self.weight, self.bias, self.conv2d_bwd)
        return super().forward(x)


def conv3x3(cin: int, cout: int, conv2d_kernel: bool = False,
            conv2d_bwd: str = "plain") -> Conv2dSame:
    return Conv2dSame(cin, cout, 3, conv2d_kernel, conv2d_bwd)


class Dense(nn.Module):
    """flax `Dense`: weight in math layout (in, out), y = x @ weight + bias.

    The fused transformer block's kernel takes its weights in this layout, so
    they reach it without a transpose or a copy."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None

    def forward(self, x):
        # one fused matmul + bias, as nn.Linear; the transposed view is not copied
        return F.linear(x, self.weight.t(), self.bias)


class TimestepEmbedding(nn.Module):
    """linear -> silu -> linear projection of the sinusoidal embedding."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = Dense(in_dim, dim)
        self.linear_2 = Dense(dim, dim)

    def forward(self, t_emb):
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class ResnetBlock2D(nn.Module):
    """GroupNorm/SiLU/Conv x2 with a time-embedding shift and skip connection."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 32,
                 eps: float = 1e-5, temb_dim: Optional[int] = None, gn_mode: str = "plain",
                 conv2d_kernel: bool = False, conv2d_bwd: str = "plain"):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps, use_silu=True, gn_mode=gn_mode)
        self.conv1 = conv3x3(in_channels, out_channels, conv2d_kernel, conv2d_bwd)
        self.time_emb_proj = Dense(temb_dim, out_channels) if temb_dim else None
        self.norm2 = GroupNorm(groups, out_channels, eps, use_silu=True, gn_mode=gn_mode)
        self.conv2 = conv3x3(out_channels, out_channels, conv2d_kernel, conv2d_bwd)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


def dot_product_attention(q, k, v, bias=None):
    """softmax(q k^T / sqrt(D) + bias) v over (B, T, H, D) tensors
    (`jax.nn.dot_product_attention` layout): fp32 logits and softmax, the
    probabilities rounded to v's dtype for the product."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    if bias is not None:
        s = s + bias
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1).to(v.dtype), v)


def mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, Tk) key mask -> (B, 1, 1, Tk) fp32 additive logit bias, 0 / -1e9."""
    return torch.where(mask.bool()[:, None, None, :], 0.0, -1e9)


class Attention(nn.Module):
    """Multi-head attention: bias-free q/k/v projections (k/v from a context
    of `context_dim` features for cross-attention), biased output projection,
    softmax in fp32 over (B, T, C) tokens.

    kernel "auto" routes long unmasked self-attention (T == Tk >= 512) to the
    flash kernel, as the JAX package does; "plain" keeps it plain PyTorch (the
    VAE mid-block by default, as the JAX package's default routes it to plain
    XLA). `flash_bwd` is the flash kernel's backward form ("f32" or "bf16")."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None, kernel: str = "auto",
                 flash_bwd: str = "f32"):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim, self.kernel = heads, head_dim, kernel
        self.flash_bwd = flash_bwd
        self.to_q = Dense(dim, inner, bias=False)
        self.to_k = Dense(context_dim or dim, inner, bias=False)
        self.to_v = Dense(context_dim or dim, inner, bias=False)
        self.to_out = Dense(inner, dim)

    def forward(self, x, context=None, mask=None):
        context = x if context is None else context
        b, tq, _ = x.shape
        tk = context.shape[1]
        q = self.to_q(x).reshape(b, tq, self.heads, self.head_dim)
        k = self.to_k(context).reshape(b, tk, self.heads, self.head_dim)
        v = self.to_v(context).reshape(b, tk, self.heads, self.head_dim)
        if self.kernel == "auto" and mask is None and tq == tk and tq >= 512:
            o = flash_attention(q, k, v, self.flash_bwd)
        else:
            o = dot_product_attention(q, k, v, None if mask is None else mask_bias(mask))
        return self.to_out(o.reshape(b, tq, -1))


class FeedForward(nn.Module):
    """GEGLU feed-forward (diffusers FeedForward default), exact GELU."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.proj_in = Dense(dim, dim * mult * 2)
        self.proj_out = Dense(dim * mult, dim)

    def forward(self, x):
        h, gate = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(h * F.gelu(gate))


class BasicTransformerBlock(nn.Module):
    """Self-attention [+ one cross-attention stream per entry of `cross_dims`,
    the context's feature width] + GEGLU FF, pre-LayerNorm (eps 1e-6).

    AudioLDM2 has two streams: GPT-2 generated states, then the T5 sequence.
    Long sequences (T >= 512 with inner == C) run as one fused kernel launch
    when the block is self-attention only, or when `fuse_cross` is on (the
    JAX package's `DIFFMUSIC_TPU_FUSED_CROSS`, off by default there too).
    `bsoft` bounds the fused launches' self-attention softmax. Each sub-layer,
    or the fused launch, is a `tracing.region` (read by the benchmark's
    per-layer metrics of the UNet)."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 cross_dims: Tuple[int, ...] = (), fuse_cross: bool = False,
                 bsoft: bool = False):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        self.cross_dims, self.fuse_cross, self.bsoft = tuple(cross_dims), fuse_cross, bsoft
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = Attention(dim, heads, head_dim)
        for i, cdim in enumerate(self.cross_dims):
            setattr(self, f"norm2_{i}", nn.LayerNorm(dim, eps=1e-6))
            setattr(self, f"attn2_{i}", Attention(dim, heads, head_dim, context_dim=cdim))
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim)

    def fused_params(self) -> dict:
        """The block's parameters by the kernel's names."""
        a, ff = self.attn1, self.ff
        p = dict(ln1_scale=self.norm1.weight, ln1_bias=self.norm1.bias,
                 wq=a.to_q.weight, wk=a.to_k.weight, wv=a.to_v.weight,
                 wo=a.to_out.weight, bo=a.to_out.bias,
                 ln3_scale=self.norm3.weight, ln3_bias=self.norm3.bias,
                 wi=ff.proj_in.weight, bi=ff.proj_in.bias,
                 wo2=ff.proj_out.weight, bo2=ff.proj_out.bias)
        for i in range(len(self.cross_dims)):
            n, c = getattr(self, f"norm2_{i}"), getattr(self, f"attn2_{i}")
            p.update({f"ln2{i}_scale": n.weight, f"ln2{i}_bias": n.bias,
                      f"cwq{i}": c.to_q.weight, f"cwk{i}": c.to_k.weight,
                      f"cwv{i}": c.to_v.weight, f"cwo{i}": c.to_out.weight,
                      f"cbo{i}": c.to_out.bias})
        return p

    def forward(self, x, contexts=(), context_masks=()):
        masks = [context_masks[i] if i < len(context_masks) else None
                 for i in range(len(self.cross_dims))]
        fusable = x.shape[1] >= 512 and self.heads * self.head_dim == x.shape[-1]
        fuse_cross = (self.cross_dims and fusable and self.fuse_cross
                      and len(contexts) == len(self.cross_dims))
        if (not self.cross_dims and fusable) or fuse_cross:
            with region("unet.fused_block"):
                biases = tuple(
                    torch.zeros(x.shape[0], 1, ctx.shape[1], device=x.device) if m is None
                    else mask_bias(m)[:, 0] for ctx, m in zip(contexts, masks))
                return fused_transformer_block(x, self.fused_params(), self.heads,
                                               self.head_dim, tuple(contexts), biases,
                                               self.bsoft)
        with region("unet.self_attn"):
            x = x + self.attn1(self.norm1(x))
        for i, m in enumerate(masks):
            with region("unet.cross_attn", i):
                h = getattr(self, f"norm2_{i}")(x)
                x = x + getattr(self, f"attn2_{i}")(h, contexts[i], m)
        with region("unet.ff"):
            return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """GroupNorm -> proj_in -> transformer block over (H*W) tokens ->
    proj_out, with a residual around the whole stack."""

    def __init__(self, channels: int, heads: int, head_dim: int, groups: int = 32,
                 cross_dims: Tuple[int, ...] = (), fuse_cross: bool = False,
                 gn_mode: str = "plain", bsoft: bool = False):
        super().__init__()
        inner = heads * head_dim
        self.norm = GroupNorm(groups, channels, 1e-6, gn_mode=gn_mode)
        self.proj_in = Dense(channels, inner)
        self.block_0 = BasicTransformerBlock(inner, heads, head_dim, cross_dims, fuse_cross,
                                             bsoft)
        self.proj_out = Dense(inner, channels)

    def forward(self, x, contexts=(), context_masks=()):
        b, c, h, w = x.shape
        y = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.block_0(self.proj_in(y), contexts, context_masks)
        y = self.proj_out(y).reshape(b, h, w, c).permute(0, 3, 1, 2)
        # x first: the sum takes x's contiguous NCHW layout, not y's NHWC one
        return x + y


class Downsample2D(nn.Module):
    """diffusers pads (0, 1, 0, 1), then a stride-2 3x3 conv with no padding."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


def _nearest_index(size: int, target: int, device) -> torch.Tensor:
    """torch F.interpolate(mode="nearest") source rows: i -> floor(i*size/target)."""
    return (torch.arange(target, device=device) * size) // target


class Upsample2D(nn.Module):
    """Nearest upsampling to `out_hw` (default 2x), then a 3x3 conv."""

    def __init__(self, channels: int, conv2d_kernel: bool = False, conv2d_bwd: str = "plain"):
        super().__init__()
        self.conv = conv3x3(channels, channels, conv2d_kernel, conv2d_bwd)

    def forward(self, x, out_hw: Optional[Tuple[int, int]] = None):
        h, w = x.shape[2:]
        th, tw = out_hw if out_hw is not None else (2 * h, 2 * w)
        x = x.index_select(2, _nearest_index(h, th, x.device))
        x = x.index_select(3, _nearest_index(w, tw, x.device))
        return self.conv(x)
