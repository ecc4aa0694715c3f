"""GPT-2 driven in embedding space (port of `diffmusic_tpu/models/gpt2.py`).

AudioLDM2 feeds the projected prompt sequence to GPT2Model as input
embeddings, and at each of 8 steps appends the last hidden state and runs
again (`generate_hidden_states`), at a static length L0 + 8 with a growing
attention mask, as the JAX package does.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .configs import GPT2Config
from .layers import Dense, dot_product_attention


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        d = cfg.n_embd
        self.heads = cfg.n_head
        self.ln_1 = nn.LayerNorm(d, eps=cfg.layer_norm_epsilon)
        self.c_attn = Dense(d, 3 * d)
        self.attn_c_proj = Dense(d, d)
        self.ln_2 = nn.LayerNorm(d, eps=cfg.layer_norm_epsilon)
        self.c_fc = Dense(d, 4 * d)
        self.mlp_c_proj = Dense(4 * d, d)

    def forward(self, x, bias):
        b, t, d = x.shape
        q, k, v = (a.reshape(b, t, self.heads, d // self.heads)
                   for a in self.c_attn(self.ln_1(x)).chunk(3, dim=-1))
        x = x + self.attn_c_proj(dot_product_attention(q, k, v, bias).reshape(b, t, d))
        h = F.gelu(self.c_fc(self.ln_2(x)), approximate="tanh")   # gelu_new
        return x + self.mlp_c_proj(h)


class GPT2Model(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        self.wpe = nn.Embedding(cfg.n_positions, cfg.n_embd)
        for i in range(cfg.n_layer):
            setattr(self, f"h_{i}", GPT2Block(cfg))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon)

    def forward(self, inputs_embeds: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, n_embd) input embeddings -> (B, T, n_embd) hidden states."""
        b, t, _ = inputs_embeds.shape
        if attention_mask is None:
            attention_mask = torch.ones(b, t, dtype=torch.long, device=inputs_embeds.device)
        # positions count only attended tokens (matters for padded CFG rows)
        positions = (torch.cumsum(attention_mask.long(), dim=1) - 1).clamp_min(0)
        x = inputs_embeds + self.wpe(positions)
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        allowed = causal[None, None] & attention_mask.bool()[:, None, None, :]
        bias = torch.where(allowed, 0.0, -1e9)
        for i in range(self.cfg.n_layer):
            x = getattr(self, f"h_{i}")(x, bias)
        return self.ln_f(x)


def generate_hidden_states(model: GPT2Model, inputs_embeds: torch.Tensor,
                           attention_mask: Optional[torch.Tensor] = None,
                           max_new_tokens: int = 8) -> torch.Tensor:
    """Embedding-space autoregression at the static length L0 + max_new_tokens:
    each step runs the model over the whole sequence and writes the hidden
    state at the last attended position into the next slot. Returns the
    (B, max_new_tokens, n_embd) generated states."""
    b, l0, d = inputs_embeds.shape
    if attention_mask is None:
        attention_mask = torch.ones(b, l0, dtype=torch.long, device=inputs_embeds.device)
    seq = torch.cat([inputs_embeds, inputs_embeds.new_zeros(b, max_new_tokens, d)], dim=1)
    mask = torch.cat([attention_mask, attention_mask.new_zeros(b, max_new_tokens)], dim=1)
    for i in range(max_new_tokens):
        hidden = model(seq, mask)
        last = mask.sum(1) - 1                                      # (B,)
        nxt = hidden[torch.arange(b, device=hidden.device), last]   # (B, d)
        seq, mask = seq.clone(), mask.clone()
        seq[:, l0 + i] = nxt
        mask[:, l0 + i] = 1
    return seq[:, -max_new_tokens:]
