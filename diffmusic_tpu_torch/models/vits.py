"""VITS text encoder: the transcription stream of AudioLDM2's TTS variant (port
of `diffmusic_tpu/models/vits.py`).

transformers' `VitsModel.text_encoder`: token embeddings scaled by
sqrt(hidden), self-attention with windowed relative-position keys and values
(window 4, zero outside it), and conv1d (k 3) feed-forwards under the padding
mask. Its hidden states take T5's place as the UNet's second cross-attention
stream. No kernel of its own: plain PyTorch. Attribute names follow the flax
tree.
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Dense


@dataclass(frozen=True)
class VitsConfig:
    vocab_size: int = 38
    hidden_size: int = 192
    num_hidden_layers: int = 6
    num_attention_heads: int = 2
    ffn_dim: int = 768
    ffn_kernel_size: int = 3
    window_size: int = 4
    layer_norm_eps: float = 1e-5


def tiny_vits_config() -> VitsConfig:
    return VitsConfig(vocab_size=64, hidden_size=16, num_hidden_layers=2,
                      num_attention_heads=2, ffn_dim=32)


def _relative_to_absolute(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T-1) relative logits -> (B, H, T, T) absolute."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(b, h, t * 2 * t)
    x = F.pad(x, (0, t - 1)).reshape(b, h, t + 1, 2 * t - 1)
    return x[:, :, :t, t - 1:]


def _absolute_to_relative(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, T) attention -> (B, H, T, 2T-1) relative."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, t - 1)).reshape(b, h, t * (2 * t - 1))
    return F.pad(x, (t, 0)).reshape(b, h, t, 2 * t)[:, :, :, 1:]


class VitsAttention(nn.Module):
    def __init__(self, cfg: VitsConfig):
        super().__init__()
        self.cfg = cfg
        c, hd = cfg.hidden_size, cfg.hidden_size // cfg.num_attention_heads
        self.q_proj, self.k_proj, self.v_proj = Dense(c, c), Dense(c, c), Dense(c, c)
        self.emb_rel_k = nn.Parameter(torch.zeros(1, 2 * cfg.window_size + 1, hd))
        self.emb_rel_v = nn.Parameter(torch.zeros(1, 2 * cfg.window_size + 1, hd))
        self.out_proj = Dense(c, c)

    def _relative(self, table: torch.Tensor, t: int) -> torch.Tensor:
        """(2T-1, hd): the table at distances -(T-1)..T-1, zero outside the
        window (clamping would reuse the edge embedding)."""
        w = self.cfg.window_size
        pos = np.arange(2 * t - 1) - (t - 1)
        idx = torch.as_tensor(np.clip(pos, -w, w) + w, device=table.device)
        valid = torch.as_tensor(np.abs(pos) <= w, dtype=table.dtype, device=table.device)
        return table[0, idx] * valid[:, None]

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        heads, hd = cfg.num_attention_heads, cfg.hidden_size // cfg.num_attention_heads
        b, t, _ = x.shape
        split = lambda a: a.reshape(b, t, heads, hd).transpose(1, 2)
        q = split(self.q_proj(x)) / np.sqrt(hd)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        scores = q @ k.transpose(-1, -2)
        scores = scores + _relative_to_absolute(q @ self._relative(self.emb_rel_k, t).T)
        scores = scores + torch.where(mask[:, None, None, :], 0.0, -1e9).to(scores.dtype)
        attn = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        out = attn @ v + _absolute_to_relative(attn) @ self._relative(self.emb_rel_v, t)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, cfg.hidden_size))


class VitsFeedForward(nn.Module):
    def __init__(self, cfg: VitsConfig):
        super().__init__()
        k = cfg.ffn_kernel_size
        self.conv_1 = nn.Conv1d(cfg.hidden_size, cfg.ffn_dim, k, padding=(k - 1) // 2)
        self.conv_2 = nn.Conv1d(cfg.ffn_dim, cfg.hidden_size, k, padding=(k - 1) // 2)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        m = mask[:, None, :].to(x.dtype)                  # (B, 1, T)
        h = F.relu(self.conv_1(x.transpose(1, 2) * m))
        return (self.conv_2(h * m) * m).transpose(1, 2)


class VitsTextEncoder(nn.Module):
    """(input_ids, attention_mask) -> (B, L, hidden) conditioning states."""

    def __init__(self, cfg: VitsConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        for i in range(cfg.num_hidden_layers):
            setattr(self, f"layers_{i}_attention", VitsAttention(cfg))
            setattr(self, f"layers_{i}_layer_norm",
                    nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps))
            setattr(self, f"layers_{i}_feed_forward", VitsFeedForward(cfg))
            setattr(self, f"layers_{i}_final_layer_norm",
                    nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps))

    def forward(self, input_ids: torch.Tensor, attention_mask=None) -> torch.Tensor:
        cfg = self.cfg
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        mask = attention_mask.bool()
        keep = mask[..., None]
        x = self.embed_tokens(input_ids) * float(np.sqrt(np.float32(cfg.hidden_size)))
        x = x * keep
        for i in range(cfg.num_hidden_layers):
            h = getattr(self, f"layers_{i}_attention")(x, mask)
            x = getattr(self, f"layers_{i}_layer_norm")(x + h)
            h = getattr(self, f"layers_{i}_feed_forward")(x, mask)
            x = getattr(self, f"layers_{i}_final_layer_norm")(x + h)
        return x * keep
