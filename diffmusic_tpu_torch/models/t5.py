"""T5 text encoder, flan-t5 style, encoder only (port of
`diffmusic_tpu/models/t5.py`).

AudioLDM2's second text encoder: its (B, L, d_model) sequence feeds both the
projection model and the UNet's second cross-attention stream. RMSNorm,
relative position biases computed by layer 0 and shared by every layer, no
1/sqrt(d_kv) scaling of the logits, gated-GELU (tanh) feed-forward.
"""

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .configs import T5Config
from .layers import Dense, mask_bias


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        var = x.float().square().mean(-1, keepdim=True)
        return (self.weight * (x * torch.rsqrt(var + self.eps))).to(self.weight.dtype)


def relative_position_bucket(relative_position, num_buckets=32, max_distance=128):
    """T5 bidirectional relative position bucketing (numpy, static shapes)."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)).astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_if_large)


class T5SelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = Dense(cfg.d_model, inner, bias=False)
        self.k = Dense(cfg.d_model, inner, bias=False)
        self.v = Dense(cfg.d_model, inner, bias=False)
        self.o = Dense(inner, cfg.d_model, bias=False)
        self.relative_attention_bias = (
            nn.Embedding(cfg.relative_attention_num_buckets, cfg.num_heads)
            if has_relative_bias else None)

    def forward(self, x, bias, position_bias=None):
        cfg = self.cfg
        b, t, _ = x.shape
        split = lambda a: a.reshape(b, t, cfg.num_heads, cfg.d_kv).transpose(1, 2)
        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        if self.relative_attention_bias is not None:
            pos = np.arange(t)
            buckets = relative_position_bucket(pos[None, :] - pos[:, None],   # key - query
                                               cfg.relative_attention_num_buckets,
                                               cfg.relative_attention_max_distance)
            position_bias = self.relative_attention_bias(
                torch.as_tensor(buckets, device=x.device)).permute(2, 0, 1)[None]
        scores = q @ k.transpose(-1, -2)          # T5 does not scale by sqrt(d_kv)
        if position_bias is not None:
            scores = scores + position_bias
        attn = (scores + bias).float().softmax(-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, t, -1)
        return self.o(out), position_bias


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        self.ln_attn = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.attn = T5SelfAttention(cfg, has_relative_bias)
        self.ln_ff = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        if cfg.is_gated_act:
            self.wi_0 = Dense(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = Dense(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = Dense(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = Dense(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x, bias, position_bias=None):
        attn_out, position_bias = self.attn(self.ln_attn(x), bias, position_bias)
        x = x + attn_out
        h = self.ln_ff(x)
        if self.cfg.is_gated_act:
            h = F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h)
        else:
            h = F.relu(self.wi(h))
        return x + self.wo(h), position_bias


class T5EncoderModel(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        for i in range(cfg.num_layers):
            setattr(self, f"block_{i}", T5Block(cfg, has_relative_bias=(i == 0)))
        self.final_layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        bias = mask_bias(attention_mask)
        x = self.shared(input_ids)
        position_bias = None
        for i in range(self.cfg.num_layers):
            x, position_bias = getattr(self, f"block_{i}")(x, bias, position_bias)
        return self.final_layer_norm(x)
