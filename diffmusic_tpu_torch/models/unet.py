"""Conditional 2-D UNet (port of `diffmusic_tpu/models/unet.py`), NCHW at the
API boundary. Both model families:
  - MusicLDM: self-attention transformer blocks; the CLAP embedding enters as
    a class label (simple projection, concatenated with the time embedding);
  - AudioLDM2: no class embedding; every transformer block has two
    cross-attention streams, the GPT-2 generated states and the T5 sequence
    (with its attention mask). `fuse_cross` routes the long dual-cross blocks
    to the fused block kernel (the JAX package's DIFFMUSIC_TPU_FUSED_CROSS).
`gn_mode` and `conv2d_kernel` route the GroupNorms and the 3x3 'same' convs
(`conv2d_bwd` the convs' backward, which DITTO and optim_prompt run), and
`bsoft` bounds the fused blocks' softmax (`models/layers.py`), off by
default as in the JAX package.
"""

from typing import Optional

import torch
import torch.nn as nn

from .configs import UNetConfig
from .layers import (Dense, Downsample2D, GroupNorm, ResnetBlock2D, TimestepEmbedding,
                     Transformer2DModel, Upsample2D, conv3x3, timestep_embedding)


def _transformer(cfg: UNetConfig, ch: int, attn: dict, gn_mode: str) -> Transformer2DModel:
    """`attn`: the blocks' routes, `fuse_cross` and `bsoft`."""
    return Transformer2DModel(ch, ch // cfg.attention_head_dim, cfg.attention_head_dim,
                              cfg.norm_num_groups, cfg.cross_attention_dims,
                              gn_mode=gn_mode, **attn)


class DownBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, in_ch: int, out_ch: int, temb_dim: int,
                 attention: bool, add_downsample: bool, attn: dict, routes: dict):
        super().__init__()
        self.layers = cfg.layers_per_block
        for i in range(self.layers):
            setattr(self, f"resnet_{i}", ResnetBlock2D(
                in_ch if i == 0 else out_ch, out_ch, cfg.norm_num_groups,
                temb_dim=temb_dim, **routes))
            if attention:
                setattr(self, f"attn_{i}",
                        _transformer(cfg, out_ch, attn, routes["gn_mode"]))
        self.attention = attention
        self.downsample = Downsample2D(out_ch) if add_downsample else None

    def forward(self, x, temb, contexts, context_masks):
        skips = []
        for i in range(self.layers):
            x = getattr(self, f"resnet_{i}")(x, temb)
            if self.attention:
                x = getattr(self, f"attn_{i}")(x, contexts, context_masks)
            skips.append(x)
        if self.downsample is not None:
            x = self.downsample(x)
            skips.append(x)
        return x, skips


class UpBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, in_ch: int, skip_chs, out_ch: int,
                 temb_dim: int, attention: bool, add_upsample: bool, attn: dict,
                 routes: dict):
        super().__init__()
        self.layers = len(skip_chs)
        for i, skip_ch in enumerate(skip_chs):
            setattr(self, f"resnet_{i}", ResnetBlock2D(
                (in_ch if i == 0 else out_ch) + skip_ch, out_ch, cfg.norm_num_groups,
                temb_dim=temb_dim, **routes))
            if attention:
                setattr(self, f"attn_{i}",
                        _transformer(cfg, out_ch, attn, routes["gn_mode"]))
        self.attention = attention
        self.upsample = (Upsample2D(out_ch, routes["conv2d_kernel"], routes["conv2d_bwd"])
                         if add_upsample else None)

    def forward(self, x, skips, temb, contexts, context_masks):
        for i in range(self.layers):
            x = torch.cat([x, skips.pop()], dim=1)
            x = getattr(self, f"resnet_{i}")(x, temb)
            if self.attention:
                x = getattr(self, f"attn_{i}")(x, contexts, context_masks)
        if self.upsample is not None:
            # match the next skip's size (odd sizes ceil-divide on the way down)
            x = self.upsample(x, tuple(skips[-1].shape[2:]) if skips else None)
        return x


class MidBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, ch: int, temb_dim: int, attn: dict, routes: dict):
        super().__init__()
        g = cfg.norm_num_groups
        self.resnet_0 = ResnetBlock2D(ch, ch, g, temb_dim=temb_dim, **routes)
        self.attn = _transformer(cfg, ch, attn, routes["gn_mode"])
        self.resnet_1 = ResnetBlock2D(ch, ch, g, temb_dim=temb_dim, **routes)

    def forward(self, x, temb, contexts, context_masks):
        x = self.attn(self.resnet_0(x, temb), contexts, context_masks)
        return self.resnet_1(x, temb)


class UNet2DConditionModel(nn.Module):
    """NCHW in/out. MusicLDM: `class_labels` (B, 512) is the CLAP
    conditioning. AudioLDM2: `encoder_hidden_states` (B, 8, 768) are the GPT-2
    generated states, `encoder_hidden_states_1` (B, L, 1024) the T5 sequence,
    `encoder_attention_mask_1` (B, L) its mask."""

    def __init__(self, cfg: UNetConfig, fuse_cross: bool = False, gn_mode: str = "plain",
                 conv2d_kernel: bool = False, bsoft: bool = False, conv2d_bwd: str = "plain"):
        super().__init__()
        routes = dict(gn_mode=gn_mode, conv2d_kernel=conv2d_kernel, conv2d_bwd=conv2d_bwd)
        attn = dict(fuse_cross=fuse_cross, bsoft=bsoft)
        if len(cfg.cross_attention_dims) > 2:
            raise ValueError("the UNet takes at most two cross-attention streams")
        if cfg.class_embed_type not in (None, "simple_projection"):
            raise ValueError(f"class_embed_type {cfg.class_embed_type!r} is not ported")
        self.cfg = cfg
        boc = cfg.block_out_channels
        ted = cfg.time_embed_dim
        self.time_embedding = TimestepEmbedding(boc[0], ted)
        temb_dim = ted
        self.class_embedding = None
        if cfg.class_embed_type == "simple_projection":
            self.class_embedding = Dense(cfg.projection_class_embeddings_input_dim, ted)
            if cfg.class_embeddings_concat:
                temb_dim = 2 * ted
        self.conv_in = conv3x3(cfg.in_channels, boc[0], conv2d_kernel, conv2d_bwd)

        skip_chs = [boc[0]]
        ch = boc[0]
        for i, out_ch in enumerate(boc):
            last = i == len(boc) - 1
            setattr(self, f"down_{i}", DownBlock(cfg, ch, out_ch, temb_dim,
                                                 cfg.has_attention[i], not last, attn,
                                                 routes))
            skip_chs += [out_ch] * (cfg.layers_per_block + (0 if last else 1))
            ch = out_ch
        self.mid = MidBlock(cfg, ch, temb_dim, attn, routes)
        for i, out_ch in enumerate(reversed(boc)):
            rev_i = len(boc) - 1 - i
            n = cfg.layers_per_block + 1
            mine, skip_chs = skip_chs[-n:][::-1], skip_chs[:-n]
            setattr(self, f"up_{i}", UpBlock(cfg, ch, mine, out_ch, temb_dim,
                                             cfg.has_attention[rev_i],
                                             i != len(boc) - 1, attn, routes))
            ch = out_ch
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch, 1e-5, use_silu=True,
                                       gn_mode=gn_mode)
        self.conv_out = conv3x3(ch, cfg.out_channels, conv2d_kernel, conv2d_bwd)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                encoder_hidden_states_1: Optional[torch.Tensor] = None,
                encoder_attention_mask: Optional[torch.Tensor] = None,
                encoder_attention_mask_1: Optional[torch.Tensor] = None,
                class_labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        x = sample
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(x.shape[0])
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0])
        emb = self.time_embedding(t_emb.to(x.dtype))
        if self.class_embedding is not None:
            if class_labels is None:
                raise ValueError("this UNet is class-conditioned: pass class_labels")
            class_emb = self.class_embedding(class_labels.to(x.dtype))
            emb = (torch.cat([emb, class_emb], dim=-1) if cfg.class_embeddings_concat
                   else emb + class_emb)

        ctx = (encoder_hidden_states, encoder_hidden_states_1)[:len(cfg.cross_attention_dims)]
        masks = (encoder_attention_mask, encoder_attention_mask_1)

        x = self.conv_in(x)
        skips = [x]
        for i in range(len(cfg.block_out_channels)):
            x, s = getattr(self, f"down_{i}")(x, emb, ctx, masks)
            skips.extend(s)
        x = self.mid(x, emb, ctx, masks)
        for i in range(len(cfg.block_out_channels)):
            x = getattr(self, f"up_{i}")(x, skips, emb, ctx, masks)
        return self.conv_out(self.conv_norm_out(x))
