"""The plain reference of the UNet, the VAE decoder and the HiFi-GAN vocoder.

A frozen copy of the mathematics of `diffmusic_tpu_torch/models/{layers,unet,
vae,hifigan}.py` on their plain paths, with every kernel route taken out:
NCHW convolutions and GroupNorms, the transformer blocks unfused, attention
as an explicit softmax over fp32 logits, the vocoder's resblocks as plain
dilated convolutions. Parameter names and layouts are the port's (Dense
weights (in, out), conv1d weights (k, Cin, Cout)), so the benchmark hands
both the same tensors. It imports nothing of the port.

Every matrix product and convolution takes its operands through
`Precision.q`, the identity for the reference proper.
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .precision import FP32, Precision


def timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding, cos first (flip_sin_to_cos), no frequency shift."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                 device=timesteps.device)
    args = timesteps.float()[:, None] * torch.exp(exponent / half)[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class Dense(nn.Module):
    """y = x @ weight + bias, weight (in, out)."""

    def __init__(self, p: Precision, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.p = p
        self.weight = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None

    def forward(self, x):
        return F.linear(self.p.q(x), self.p.q(self.weight).t(), self.bias)


class Conv2d(nn.Conv2d):
    def __init__(self, p: Precision, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0):
        super().__init__(cin, cout, k, stride=stride, padding=padding)
        self.p = p

    def forward(self, x):
        return F.conv2d(self.p.q(x), self.p.q(self.weight), self.bias, self.stride,
                        self.padding)


def conv3x3(p, cin, cout):
    return Conv2d(p, cin, cout, 3, padding=1)


class GroupNorm(nn.Module):
    """fp32 statistics, var = E[x^2] - mu^2, optional SiLU."""

    def __init__(self, groups: int, channels: int, eps: float, silu: bool = False):
        super().__init__()
        self.groups, self.eps, self.silu = groups, eps, silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        b, c = x.shape[:2]
        xg = x.float().reshape(b, self.groups, -1)
        mu = xg.mean(-1, keepdim=True)
        var = xg.square().mean(-1, keepdim=True) - mu * mu
        y = ((xg - mu) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        shape = (1, c) + (1,) * (x.ndim - 2)
        y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        return F.silu(y) if self.silu else y


def attention(p: Precision, q, k, v, bias=None):
    """softmax(q k^T / sqrt(D) + bias) v over (B, T, H, D), fp32 logits."""
    s = torch.einsum("bqhd,bkhd->bhqk", p.q(q), p.q(k)) / math.sqrt(q.shape[-1])
    if bias is not None:
        s = s + bias
    return torch.einsum("bhqk,bkhd->bqhd", p.q(s.softmax(-1)), p.q(v))


def mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, Tk) key mask -> (B, 1, 1, Tk) additive bias, 0 / -1e9."""
    return torch.where(mask.bool()[:, None, None, :], 0.0, -1e9)


class TimestepEmbedding(nn.Module):
    def __init__(self, p, in_dim, dim):
        super().__init__()
        self.linear_1, self.linear_2 = Dense(p, in_dim, dim), Dense(p, dim, dim)

    def forward(self, t):
        return self.linear_2(F.silu(self.linear_1(t)))


class ResnetBlock2D(nn.Module):
    def __init__(self, p, cin, cout, groups=32, eps=1e-5, temb_dim=None):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps, silu=True)
        self.conv1 = conv3x3(p, cin, cout)
        self.time_emb_proj = Dense(p, temb_dim, cout) if temb_dim else None
        self.norm2 = GroupNorm(groups, cout, eps, silu=True)
        self.conv2 = conv3x3(p, cout, cout)
        self.conv_shortcut = Conv2d(p, cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    def __init__(self, p, dim, heads, head_dim, context_dim=None):
        super().__init__()
        inner = heads * head_dim
        self.p, self.heads, self.head_dim = p, heads, head_dim
        self.to_q = Dense(p, dim, inner, bias=False)
        self.to_k = Dense(p, context_dim or dim, inner, bias=False)
        self.to_v = Dense(p, context_dim or dim, inner, bias=False)
        self.to_out = Dense(p, inner, dim)

    def forward(self, x, context=None, mask=None):
        context = x if context is None else context
        b, tq, _ = x.shape
        tk = context.shape[1]
        split = lambda a, t: a.reshape(b, t, self.heads, self.head_dim)
        o = attention(self.p, split(self.to_q(x), tq), split(self.to_k(context), tk),
                      split(self.to_v(context), tk), None if mask is None else mask_bias(mask))
        return self.to_out(o.reshape(b, tq, -1))


class FeedForward(nn.Module):
    def __init__(self, p, dim, mult=4):
        super().__init__()
        self.proj_in = Dense(p, dim, dim * mult * 2)
        self.proj_out = Dense(p, dim * mult, dim)

    def forward(self, x):
        h, gate = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(h * F.gelu(gate))


class BasicTransformerBlock(nn.Module):
    def __init__(self, p, dim, heads, head_dim, cross_dims=()):
        super().__init__()
        self.cross_dims = tuple(cross_dims)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = Attention(p, dim, heads, head_dim)
        for i, cdim in enumerate(self.cross_dims):
            setattr(self, f"norm2_{i}", nn.LayerNorm(dim, eps=1e-6))
            setattr(self, f"attn2_{i}", Attention(p, dim, heads, head_dim, context_dim=cdim))
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(p, dim)

    def forward(self, x, contexts=(), masks=()):
        x = x + self.attn1(self.norm1(x))
        for i in range(len(self.cross_dims)):
            m = masks[i] if i < len(masks) else None
            x = x + getattr(self, f"attn2_{i}")(getattr(self, f"norm2_{i}")(x), contexts[i], m)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    def __init__(self, p, channels, heads, head_dim, groups=32, cross_dims=()):
        super().__init__()
        inner = heads * head_dim
        self.norm = GroupNorm(groups, channels, 1e-6)
        self.proj_in = Dense(p, channels, inner)
        self.block_0 = BasicTransformerBlock(p, inner, heads, head_dim, cross_dims)
        self.proj_out = Dense(p, inner, channels)

    def forward(self, x, contexts=(), masks=()):
        b, c, h, w = x.shape
        y = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.proj_out(self.block_0(self.proj_in(y), contexts, masks))
        return x + y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class Downsample2D(nn.Module):
    def __init__(self, p, channels):
        super().__init__()
        self.conv = Conv2d(p, channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    """Nearest upsampling to `out_hw` (default 2x), then a 3x3 conv."""

    def __init__(self, p, channels):
        super().__init__()
        self.conv = conv3x3(p, channels, channels)

    def forward(self, x, out_hw=None):
        h, w = x.shape[2:]
        th, tw = out_hw if out_hw is not None else (2 * h, 2 * w)
        rows = (torch.arange(th, device=x.device) * h) // th
        cols = (torch.arange(tw, device=x.device) * w) // tw
        return self.conv(x.index_select(2, rows).index_select(3, cols))


# ----------------------------------------------------------------------- UNet
def _transformer(p, cfg, ch):
    hd = cfg["attention_head_dim"]
    return Transformer2DModel(p, ch, ch // hd, hd, cfg["norm_num_groups"],
                              tuple(cfg["cross_attention_dims"]))


class DownBlock(nn.Module):
    def __init__(self, p, cfg, cin, cout, temb_dim, attn, downsample):
        super().__init__()
        self.layers, self.attention = cfg["layers_per_block"], attn
        for i in range(self.layers):
            setattr(self, f"resnet_{i}", ResnetBlock2D(p, cin if i == 0 else cout, cout,
                                                       cfg["norm_num_groups"], temb_dim=temb_dim))
            if attn:
                setattr(self, f"attn_{i}", _transformer(p, cfg, cout))
        self.downsample = Downsample2D(p, cout) if downsample else None

    def forward(self, x, temb, ctx, masks):
        skips = []
        for i in range(self.layers):
            x = getattr(self, f"resnet_{i}")(x, temb)
            if self.attention:
                x = getattr(self, f"attn_{i}")(x, ctx, masks)
            skips.append(x)
        if self.downsample is not None:
            x = self.downsample(x)
            skips.append(x)
        return x, skips


class UpBlock(nn.Module):
    def __init__(self, p, cfg, cin, skip_chs, cout, temb_dim, attn, upsample):
        super().__init__()
        self.layers, self.attention = len(skip_chs), attn
        for i, sc in enumerate(skip_chs):
            setattr(self, f"resnet_{i}", ResnetBlock2D(p, (cin if i == 0 else cout) + sc, cout,
                                                       cfg["norm_num_groups"], temb_dim=temb_dim))
            if attn:
                setattr(self, f"attn_{i}", _transformer(p, cfg, cout))
        self.upsample = Upsample2D(p, cout) if upsample else None

    def forward(self, x, skips, temb, ctx, masks):
        for i in range(self.layers):
            x = getattr(self, f"resnet_{i}")(torch.cat([x, skips.pop()], dim=1), temb)
            if self.attention:
                x = getattr(self, f"attn_{i}")(x, ctx, masks)
        if self.upsample is not None:
            x = self.upsample(x, tuple(skips[-1].shape[2:]) if skips else None)
        return x


class MidBlock(nn.Module):
    def __init__(self, p, cfg, ch, temb_dim):
        super().__init__()
        g = cfg["norm_num_groups"]
        self.resnet_0 = ResnetBlock2D(p, ch, ch, g, temb_dim=temb_dim)
        self.attn = _transformer(p, cfg, ch)
        self.resnet_1 = ResnetBlock2D(p, ch, ch, g, temb_dim=temb_dim)

    def forward(self, x, temb, ctx, masks):
        return self.resnet_1(self.attn(self.resnet_0(x, temb), ctx, masks), temb)


class UNet(nn.Module):
    """`cfg`: the configuration file's "unet" group."""

    def __init__(self, cfg: dict, p: Precision = FP32):
        super().__init__()
        self.cfg = cfg
        boc = cfg["block_out_channels"]
        ted = boc[0] * 4
        self.time_embedding = TimestepEmbedding(p, boc[0], ted)
        temb_dim = ted
        self.class_embedding = None
        if cfg["class_embed_type"] == "simple_projection":
            self.class_embedding = Dense(p, cfg["projection_class_embeddings_input_dim"], ted)
            if cfg["class_embeddings_concat"]:
                temb_dim = 2 * ted
        self.conv_in = conv3x3(p, cfg["in_channels"], boc[0])
        skip_chs, ch = [boc[0]], boc[0]
        for i, cout in enumerate(boc):
            last = i == len(boc) - 1
            setattr(self, f"down_{i}", DownBlock(p, cfg, ch, cout, temb_dim,
                                                 cfg["has_attention"][i], not last))
            skip_chs += [cout] * (cfg["layers_per_block"] + (0 if last else 1))
            ch = cout
        self.mid = MidBlock(p, cfg, ch, temb_dim)
        for i, cout in enumerate(reversed(boc)):
            n = cfg["layers_per_block"] + 1
            mine, skip_chs = skip_chs[-n:][::-1], skip_chs[:-n]
            setattr(self, f"up_{i}", UpBlock(p, cfg, ch, mine, cout, temb_dim,
                                             cfg["has_attention"][len(boc) - 1 - i],
                                             i != len(boc) - 1))
            ch = cout
        self.conv_norm_out = GroupNorm(cfg["norm_num_groups"], ch, 1e-5, silu=True)
        self.conv_out = conv3x3(p, ch, cfg["out_channels"])

    def forward(self, x, timesteps, class_labels=None, contexts=(), masks=()):
        """x (B, C, H, W) fp32; timesteps (B,); `contexts` the cross streams
        and `masks` their key masks (None for none)."""
        boc = self.cfg["block_out_channels"]
        emb = self.time_embedding(timestep_embedding(timesteps, boc[0]))
        if self.class_embedding is not None:
            c = self.class_embedding(class_labels)
            emb = torch.cat([emb, c], -1) if self.cfg["class_embeddings_concat"] else emb + c
        x = self.conv_in(x)
        skips = [x]
        for i in range(len(boc)):
            x, s = getattr(self, f"down_{i}")(x, emb, contexts, masks)
            skips.extend(s)
        x = self.mid(x, emb, contexts, masks)
        for i in range(len(boc)):
            x = getattr(self, f"up_{i}")(x, skips, emb, contexts, masks)
        return self.conv_out(self.conv_norm_out(x))


# ------------------------------------------------------------ VAE decoder
class VAEAttentionBlock(nn.Module):
    def __init__(self, p, channels, groups):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, 1e-6)
        self.attention = Attention(p, channels, 1, channels)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.attention(self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c))
        return x + y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class Decoder(nn.Module):
    """`cfg`: the configuration file's "vae" group. Its parameters are the
    port's `AutoencoderKL.decoder.*`."""

    def __init__(self, cfg: dict, p: Precision = FP32):
        super().__init__()
        self.cfg = cfg
        g, boc = cfg["norm_num_groups"], cfg["block_out_channels"]
        ch = boc[-1]
        lat = cfg["latent_channels"]
        self.post_quant_conv = Conv2d(p, lat, lat, 1)
        self.conv_in = conv3x3(p, lat, ch)
        self.mid_resnet_0 = ResnetBlock2D(p, ch, ch, g)
        self.mid_attn = VAEAttentionBlock(p, ch, g)
        self.mid_resnet_1 = ResnetBlock2D(p, ch, ch, g)
        for i, cout in enumerate(reversed(boc)):
            for j in range(cfg["layers_per_block"] + 1):
                setattr(self, f"up_{i}_resnet_{j}", ResnetBlock2D(p, ch, cout, g))
                ch = cout
            if i != len(boc) - 1:
                setattr(self, f"up_{i}_upsample", Upsample2D(p, ch))
        self.conv_norm_out = GroupNorm(g, ch, 1e-6, silu=True)
        self.conv_out = conv3x3(p, ch, cfg["out_channels"])

    def forward(self, z):
        boc = self.cfg["block_out_channels"]
        x = self.conv_in(self.post_quant_conv(z))
        x = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(x)))
        for i in range(len(boc)):
            for j in range(self.cfg["layers_per_block"] + 1):
                x = getattr(self, f"up_{i}_resnet_{j}")(x)
            if i != len(boc) - 1:
                x = getattr(self, f"up_{i}_upsample")(x)
        return self.conv_out(self.conv_norm_out(x))


# ---------------------------------------------------------------- vocoder
class Conv1dParams(nn.Module):
    def __init__(self, k, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(k, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))


def conv1d(p, x, prm, dilation=1, slope=None, residual=None):
    """conv1d(leaky(x), w, dilation) + b [+ residual], 'same', on (B, T, C)."""
    h = F.leaky_relu(x, slope) if slope is not None else x
    k = prm.weight.shape[0]
    out = F.conv1d(p.q(h.transpose(1, 2)), p.q(prm.weight.permute(2, 1, 0)), prm.bias,
                   padding=(k - 1) * dilation // 2, dilation=dilation).transpose(1, 2)
    return out if residual is None else out + residual


class ResidualBlock(nn.Module):
    def __init__(self, channels, k, dilations):
        super().__init__()
        self.dilations = tuple(dilations)
        for i in range(len(self.dilations)):
            setattr(self, f"convs1_{i}", Conv1dParams(k, channels, channels))
            setattr(self, f"convs2_{i}", Conv1dParams(k, channels, channels))

    def forward(self, p, x, slope):
        for i, d in enumerate(self.dilations):
            h = conv1d(p, x, getattr(self, f"convs1_{i}"), d, slope)
            x = conv1d(p, h, getattr(self, f"convs2_{i}"), 1, slope, residual=x)
        return x


class Vocoder(nn.Module):
    """SpeechT5HifiGan; `cfg`: the configuration file's "vocoder" group."""

    def __init__(self, cfg: dict, p: Precision = FP32):
        super().__init__()
        self.cfg, self.p = cfg, p
        uic = cfg["upsample_initial_channel"]
        ks, ds = cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]
        self.conv_pre = Conv1dParams(7, cfg["model_in_dim"], uic)
        for i, k in enumerate(cfg["upsample_kernel_sizes"]):
            ch = uic // 2 ** (i + 1)
            setattr(self, f"upsampler_{i}", Conv1dParams(k, uic // 2 ** i, ch))
            for j, (rk, dil) in enumerate(zip(ks, ds)):
                setattr(self, f"resblocks_{i * len(ks) + j}", ResidualBlock(ch, rk, dil))
        self.conv_post = Conv1dParams(7, uic // 2 ** len(cfg["upsample_rates"]), 1)

    def forward(self, mel):
        """(B, T, model_in_dim) -> (B, T * hop) waveform."""
        cfg, p = self.cfg, self.p
        slope = cfg["leaky_relu_slope"]
        nk = len(cfg["resblock_kernel_sizes"])
        x = conv1d(p, mel, self.conv_pre)
        for i, (rate, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
            up = getattr(self, f"upsampler_{i}")
            x = F.conv_transpose1d(p.q(F.leaky_relu(x, slope).transpose(1, 2)),
                                   p.q(up.weight.permute(1, 2, 0)), up.bias, stride=rate,
                                   padding=(k - rate) // 2).transpose(1, 2)
            res = None
            for j in range(nk):
                out = getattr(self, f"resblocks_{i * nk + j}")(p, x, slope)
                res = out if res is None else res + out
            x = res / nk
        return torch.tanh(conv1d(p, x, self.conv_post, slope=slope))[..., 0]


def load(module: nn.Module, weights: dict, prefix: str = "") -> nn.Module:
    """`module` with the float32 copies of the named weights (those under
    `prefix`, the prefix stripped), frozen."""
    sd = {k[len(prefix):]: v for k, v in weights.items() if k.startswith(prefix)}
    module.load_state_dict({k: v.float() for k, v in sd.items()}, strict=True, assign=True)
    return module.requires_grad_(False).eval()
