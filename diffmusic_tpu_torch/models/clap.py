"""CLAP text tower: RoBERTa encoder + pooler + 2-layer projection (port of
`diffmusic_tpu/models/clap.py`).

`ClapTextModelWithProjection(ids, mask)` returns the (B, projection_dim) text
embeds; MusicLDM normalises them into its class label, AudioLDM2 into the
first stream of its projection model. Attribute names follow the flax tree.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .configs import ClapTextConfig
from .layers import Dense, dot_product_attention, mask_bias


class TextEmbeddings(nn.Module):
    def __init__(self, cfg: ClapTextConfig):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids):
        pad = self.cfg.pad_token_id
        # RoBERTa position ids: pad_token_id + running count of non-pad tokens
        mask = (input_ids != pad).long()
        position_ids = torch.cumsum(mask, dim=-1) * mask + pad
        x = (self.word_embeddings(input_ids) + self.position_embeddings(position_ids)
             + self.token_type_embeddings(torch.zeros_like(input_ids)))
        return self.LayerNorm(x)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ClapTextConfig):
        super().__init__()
        h = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q, self.k, self.v = Dense(h, h), Dense(h, h), Dense(h, h)
        self.attn_out = Dense(h, h)
        self.attn_ln = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.ff_in = Dense(h, cfg.intermediate_size)
        self.ff_out = Dense(cfg.intermediate_size, h)
        self.ff_ln = nn.LayerNorm(h, eps=cfg.layer_norm_eps)

    def forward(self, x, bias):
        b, t, h = x.shape
        split = lambda a: a.reshape(b, t, self.heads, h // self.heads)
        attn = dot_product_attention(split(self.q(x)), split(self.k(x)), split(self.v(x)), bias)
        x = self.attn_ln(x + self.attn_out(attn.reshape(b, t, h)))
        return self.ff_ln(x + self.ff_out(F.gelu(self.ff_in(x))))


class ClapTextModelWithProjection(nn.Module):
    def __init__(self, cfg: ClapTextConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = TextEmbeddings(cfg)
        for i in range(cfg.num_hidden_layers):
            setattr(self, f"layer_{i}", EncoderLayer(cfg))
        self.pooler = Dense(cfg.hidden_size, cfg.hidden_size)
        self.projection_linear1 = Dense(cfg.hidden_size, cfg.projection_dim)
        self.projection_linear2 = Dense(cfg.projection_dim, cfg.projection_dim)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        bias = mask_bias(attention_mask)
        x = self.embeddings(input_ids)
        for i in range(self.cfg.num_hidden_layers):
            x = getattr(self, f"layer_{i}")(x, bias)
        pooled = torch.tanh(self.pooler(x[:, 0]))        # RoBERTa pooler over CLS
        return self.projection_linear2(F.relu(self.projection_linear1(pooled)))


def get_text_features(model: ClapTextModelWithProjection, input_ids: torch.Tensor,
                      attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L2-normalised text embeds, as `ClapModel.get_text_features` returns them
    (the JAX package's `models/clap.py::get_text_features`), in fp32 whatever
    the tower's dtype."""
    emb = model(input_ids, attention_mask).float()
    return emb / emb.norm(dim=-1, keepdim=True)
