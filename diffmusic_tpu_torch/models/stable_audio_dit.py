"""StableAudioDiTModel and StableAudioProjectionModel, the stable-audio-open
diffusion transformer and its conditioning (port of
`diffmusic_tpu/models/stable_audio_dit.py`).

A 1-D DiT over Oobleck latents: partial rotary self-attention with
grouped-query KV heads, a T5 cross-attention stream, a prepended global
token (the duration conditioners plus the Fourier timestep embedding) and
SwiGLU feed-forwards. Tokens are (B, T, C) inside; the model's input and
output are (B, C, T). Attention is `F.scaled_dot_product_attention`, as the
JAX package leaves its `jax.nn.dot_product_attention` to XLA: no Pallas kernel
is on this path, so none is ported.

Two spellings differ from JAX's where a natural PyTorch one would be wrong:
  - `jnp.repeat(k, rep, axis=2)` is `repeat_interleave`: KV head j serves
    query heads [j*rep, (j+1)*rep) ([h0, h0, h1, h1]); `Tensor.repeat`
    tiles ([h0, h1, h0, h1]) and pairs the query heads with the wrong keys;
  - the rotary embedding rotates only the first `rotary_dim` channels of a
    head, in two halves ([r1 c - r2 s, r2 c + r1 s]), not interleaved pairs,
    and its tables cover T + 1 positions: the global token takes position 0.
Flax's Dense computes in the wider of its input's and its kernel's dtype:
`promoted_linear` keeps that rule where an fp32 input meets bf16 weights
(the Fourier time features, the duration conditioners).
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .configs import StableAudioDiTConfig, StableAudioProjectionConfig
from .layers import Dense


def promoted_linear(dense: Dense, x: torch.Tensor) -> torch.Tensor:
    """`dense(x)` in the promoted dtype of x and the weight (flax Dense's
    rule; F.linear takes one dtype)."""
    dt = torch.promote_types(x.dtype, dense.weight.dtype)
    bias = None if dense.bias is None else dense.bias.to(dt)
    return F.linear(x.to(dt), dense.weight.to(dt).t(), bias)


def rotary_tables(dim: int, length: int, theta: float = 10000.0, device=None):
    """1-D rotary cos / sin tables, (length, dim / 2) each, computed in
    float64 with numpy and stored as fp32 (diffusers get_1d_rotary_pos_embed,
    use_real=True)."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    angles = np.arange(length, dtype=np.float64)[:, None] * freqs[None, :]
    return (torch.as_tensor(np.cos(angles), dtype=torch.float32, device=device),
            torch.as_tensor(np.sin(angles), dtype=torch.float32, device=device))


def apply_partial_rotary(x, cos, sin, rotary_dim: int):
    """Rotate the first `rotary_dim` channels of each head, as two halves r1,
    r2 -> [r1 c - r2 s, r2 c + r1 s], in fp32; pass the rest through.

    x: (B, T, H, D); cos / sin: (T, rotary_dim / 2)."""
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    r1, r2 = rot.float().chunk(2, dim=-1)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    rotated = torch.cat([r1 * c - r2 * s, r2 * c + r1 * s], dim=-1)
    return torch.cat([rotated.to(x.dtype), rest], dim=-1)


def expand_kv_heads(kv: torch.Tensor, rep: int) -> torch.Tensor:
    """(B, T, H_kv, D) -> (B, T, H_kv * rep, D) as `jnp.repeat(kv, rep,
    axis=2)`: each KV head repeated in place ([h0, h0, h1, h1]), not the heads
    tiled (`Tensor.repeat`)."""
    return kv.repeat_interleave(rep, dim=2)


class GaussianFourierProjection(nn.Module):
    """Fixed Gaussian Fourier timestep features -> (B, 2 * embedding_size),
    cos then sin, fp32 (diffusers StableAudioGaussianFourierProjection:
    flip_sin_to_cos, log=False)."""

    def __init__(self, embedding_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(embedding_size))

    def forward(self, t):
        proj = 2.0 * math.pi * t.float()[:, None] * self.weight.detach()[None, :]
        return torch.cat([torch.cos(proj), torch.sin(proj)], dim=-1)


class GQAAttention(nn.Module):
    """Attention with fewer KV heads than query heads (grouped-query) and, in
    self-attention, the partial rotary embedding on q and k."""

    def __init__(self, dim: int, context_dim: int, heads: int, kv_heads: int, head_dim: int,
                 rotary_dim: int = 0):
        super().__init__()
        self.heads, self.kv_heads, self.head_dim = heads, kv_heads, head_dim
        self.rotary_dim = rotary_dim
        self.to_q = Dense(dim, heads * head_dim, bias=False)
        self.to_k = Dense(context_dim, kv_heads * head_dim, bias=False)
        self.to_v = Dense(context_dim, kv_heads * head_dim, bias=False)
        self.to_out = Dense(heads * head_dim, dim, bias=False)

    def forward(self, x, context=None, rope: Optional[Tuple] = None):
        context = x if context is None else context
        b, tq, tk = x.shape[0], x.shape[1], context.shape[1]
        q = self.to_q(x).reshape(b, tq, self.heads, self.head_dim)
        k = self.to_k(context).reshape(b, tk, self.kv_heads, self.head_dim)
        v = self.to_v(context).reshape(b, tk, self.kv_heads, self.head_dim)
        if rope is not None and self.rotary_dim > 0:
            cos, sin = rope
            q = apply_partial_rotary(q, cos[:tq], sin[:tq], self.rotary_dim)
            k = apply_partial_rotary(k, cos[:tk], sin[:tk], self.rotary_dim)
        if self.kv_heads != self.heads:
            rep = self.heads // self.kv_heads
            k, v = expand_kv_heads(k, rep), expand_kv_heads(v, rep)
        k, v = k.to(q.dtype), v.to(q.dtype)
        out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                             v.transpose(1, 2))
        return self.to_out(out.transpose(1, 2).reshape(b, tq, -1))


class SwiGLUFeedForward(nn.Module):
    """proj_in to 2 * 4 * dim, the first half times silu of the second half,
    proj_out."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.proj_in = Dense(dim, dim * mult * 2)
        self.proj_out = Dense(dim * mult, dim)

    def forward(self, x):
        h, gate = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(h * F.silu(gate))


class StableAudioDiTBlock(nn.Module):
    """Pre-LayerNorms (eps 1e-6): self-attention with rope, cross-attention
    without, the feed-forward; each residual."""

    def __init__(self, cfg: StableAudioDiTConfig):
        super().__init__()
        inner = cfg.inner_dim
        heads = (cfg.num_attention_heads, cfg.num_key_value_attention_heads,
                 cfg.attention_head_dim)
        self.norm1 = nn.LayerNorm(inner, eps=1e-6)
        self.attn1 = GQAAttention(inner, inner, *heads, rotary_dim=cfg.rotary_dim)
        self.norm2 = nn.LayerNorm(inner, eps=1e-6)
        self.attn2 = GQAAttention(inner, cfg.cross_attention_dim, *heads)
        self.norm3 = nn.LayerNorm(inner, eps=1e-6)
        self.ff = SwiGLUFeedForward(inner)

    def forward(self, x, context, rope):
        x = x + self.attn1(self.norm1(x), rope=rope)
        x = x + self.attn2(self.norm2(x), context=context)
        return x + self.ff(self.norm3(x))


class StableAudioDiTModel(nn.Module):
    """forward(latents (B, C, T), timestep (B,) fp32 c_noise,
    encoder_hidden_states (B, L, cross_attention_input_dim), global_states
    (B, global_states_input_dim)) -> the network output (B, C, T)."""

    def __init__(self, cfg: StableAudioDiTConfig):
        super().__init__()
        self.cfg = cfg
        inner = cfg.inner_dim
        self.cross_attention_proj_1 = Dense(cfg.cross_attention_input_dim,
                                            cfg.cross_attention_dim, bias=False)
        self.cross_attention_proj_2 = Dense(cfg.cross_attention_dim, cfg.cross_attention_dim,
                                            bias=False)
        self.global_proj_1 = Dense(cfg.global_states_input_dim, inner, bias=False)
        self.global_proj_2 = Dense(inner, inner, bias=False)
        self.time_proj = GaussianFourierProjection(cfg.time_proj_dim // 2)
        self.timestep_proj_1 = Dense(cfg.time_proj_dim, inner)
        self.timestep_proj_2 = Dense(inner, inner)
        self.preprocess_conv = Dense(cfg.in_channels, cfg.in_channels, bias=False)
        self.proj_in = Dense(cfg.in_channels, inner, bias=False)
        for i in range(cfg.num_layers):
            setattr(self, f"block_{i}", StableAudioDiTBlock(cfg))
        self.proj_out = Dense(inner, cfg.out_channels, bias=False)
        self.postprocess_conv = Dense(cfg.out_channels, cfg.out_channels, bias=False)
        self._rope = {}

    def forward(self, latents, timestep, encoder_hidden_states, global_states):
        cfg = self.cfg
        ctx = self.cross_attention_proj_2(F.silu(
            self.cross_attention_proj_1(encoder_hidden_states)))
        glob = self.global_proj_2(F.silu(self.global_proj_1(global_states)))
        t_emb = promoted_linear(self.timestep_proj_1, self.time_proj(timestep))
        glob = glob + promoted_linear(self.timestep_proj_2, F.silu(t_emb))   # (B, inner)

        # tokens: the residual token-wise preprocess, then the projection in
        x = latents.transpose(1, 2)
        x = self.proj_in(x + self.preprocess_conv(x))
        # the fp32 time features go to the token dtype before the concat: a
        # mixed-dtype concat would carry the whole stream in fp32
        x = torch.cat([glob[:, None, :].to(x.dtype), x], dim=1)

        key = (x.shape[1], x.device)
        if key not in self._rope:   # constants of the sampler, made once a length
            self._rope[key] = rotary_tables(cfg.rotary_dim, x.shape[1], device=x.device)
        rope = self._rope[key]
        for i in range(cfg.num_layers):
            x = getattr(self, f"block_{i}")(x, ctx, rope)

        x = self.proj_out(x)[:, 1:, :]   # drop the global token
        x = x + self.postprocess_conv(x)
        return x.transpose(1, 2)


class NumberConditioner(nn.Module):
    """A learned embedding of a scalar (seconds_start / seconds_total):
    clamp, normalise to [0, 1], [v, sin, cos] Fourier features, linear
    (diffusers StableAudioNumberConditioner)."""

    def __init__(self, dim: int, min_value: float, max_value: float):
        super().__init__()
        self.min_value, self.max_value = min_value, max_value
        self.weight = nn.Parameter(torch.zeros(dim // 2))
        self.proj = Dense(2 * (dim // 2) + 1, dim)

    def forward(self, value):
        v = torch.as_tensor(value, dtype=torch.float32, device=self.weight.device)
        v = (v.clamp(self.min_value, self.max_value) - self.min_value) / (
            self.max_value - self.min_value)
        ang = 2.0 * math.pi * v[:, None] * self.weight.detach()[None, :]
        feats = torch.cat([v[:, None], torch.sin(ang), torch.cos(ang)], dim=-1)
        return promoted_linear(self.proj, feats)


class StableAudioProjectionModel(nn.Module):
    """Text projection and the two duration conditioners -> (text hidden
    states, global states) (diffusers StableAudioProjectionModel)."""

    def __init__(self, cfg: StableAudioProjectionConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.conditioning_dim
        self.text_projection = Dense(cfg.text_encoder_dim, d)
        self.start_number_conditioner = NumberConditioner(d, cfg.min_value, cfg.max_value)
        self.end_number_conditioner = NumberConditioner(d, cfg.min_value, cfg.max_value)

    def forward(self, text_hidden_states, seconds_start, seconds_total):
        text = promoted_linear(self.text_projection, text_hidden_states)
        global_states = torch.cat([self.start_number_conditioner(seconds_start),
                                   self.end_number_conditioner(seconds_total)], dim=-1)
        return text, global_states
