"""The plain reference of the text stacks: the CLAP text tower (RoBERTa and
its projection), the flan-T5 encoder, AudioLDM2's projection model and GPT-2
driven in embedding space. A frozen copy of the mathematics of
`diffmusic_tpu_torch/models/{clap,t5,projection,gpt2}.py` and of the
pipelines' prompt encoding, with the port's parameter names. It imports
nothing of the port.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .models import Dense, attention, mask_bias
from .precision import FP32, Precision


def byte_tokenizer(texts, maxlen: int = 12):
    """<s> (0), the UTF-8 bytes mapped into [2, 252), </s> (2), padding (1):
    (ids, mask) int64 numpy arrays, (len(texts), maxlen)."""
    ids = np.ones((len(texts), maxlen), np.int64)
    mask = np.zeros((len(texts), maxlen), np.int64)
    for i, t in enumerate(texts):
        row = [0] + [2 + (c % 250) for c in t.encode("utf-8")[:maxlen - 2]] + [2]
        ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    return ids, mask


# ------------------------------------------------------------------ CLAP text
class TextEmbeddings(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        h = cfg["hidden_size"]
        self.pad = cfg["pad_token_id"]
        self.word_embeddings = nn.Embedding(cfg["vocab_size"], h)
        self.position_embeddings = nn.Embedding(cfg["max_position_embeddings"], h)
        self.token_type_embeddings = nn.Embedding(cfg["type_vocab_size"], h)
        self.LayerNorm = nn.LayerNorm(h, eps=cfg["layer_norm_eps"])

    def forward(self, ids):
        mask = (ids != self.pad).long()
        pos = torch.cumsum(mask, dim=-1) * mask + self.pad
        return self.LayerNorm(self.word_embeddings(ids) + self.position_embeddings(pos)
                              + self.token_type_embeddings(torch.zeros_like(ids)))


class ClapLayer(nn.Module):
    def __init__(self, p, cfg):
        super().__init__()
        h, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.p, self.heads = p, cfg["num_attention_heads"]
        self.q, self.k, self.v = Dense(p, h, h), Dense(p, h, h), Dense(p, h, h)
        self.attn_out = Dense(p, h, h)
        self.attn_ln = nn.LayerNorm(h, eps=eps)
        self.ff_in = Dense(p, h, cfg["intermediate_size"])
        self.ff_out = Dense(p, cfg["intermediate_size"], h)
        self.ff_ln = nn.LayerNorm(h, eps=eps)

    def forward(self, x, bias):
        b, t, h = x.shape
        split = lambda a: a.reshape(b, t, self.heads, h // self.heads)
        o = attention(self.p, split(self.q(x)), split(self.k(x)), split(self.v(x)), bias)
        x = self.attn_ln(x + self.attn_out(o.reshape(b, t, h)))
        return self.ff_ln(x + self.ff_out(F.gelu(self.ff_in(x))))


class ClapText(nn.Module):
    """`cfg`: the configuration file's "clap_text" group."""

    def __init__(self, cfg, p: Precision = FP32):
        super().__init__()
        self.n = cfg["num_hidden_layers"]
        self.embeddings = TextEmbeddings(cfg)
        for i in range(self.n):
            setattr(self, f"layer_{i}", ClapLayer(p, cfg))
        h, d = cfg["hidden_size"], cfg["projection_dim"]
        self.pooler = Dense(p, h, h)
        self.projection_linear1 = Dense(p, h, d)
        self.projection_linear2 = Dense(p, d, d)

    def forward(self, ids, mask):
        """The L2-normalised text embedding, (B, projection_dim)."""
        bias = mask_bias(mask)
        x = self.embeddings(ids)
        for i in range(self.n):
            x = getattr(self, f"layer_{i}")(x, bias)
        emb = self.projection_linear2(F.relu(self.projection_linear1(
            torch.tanh(self.pooler(x[:, 0])))))
        return emb / emb.norm(dim=-1, keepdim=True)


# ------------------------------------------------------------------------- T5
class RMSNorm(nn.Module):
    def __init__(self, dim, eps):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return self.weight * (x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps))


def relative_position_bucket(rel, num_buckets, max_distance):
    num_buckets //= 2
    ret = (rel > 0).astype(np.int64) * num_buckets
    n = np.abs(rel)
    max_exact = num_buckets // 2
    large = max_exact + (np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).astype(np.int64)
    return ret + np.where(n < max_exact, n, np.minimum(large, num_buckets - 1))


class T5Attention(nn.Module):
    def __init__(self, p, cfg, relative):
        super().__init__()
        self.p, self.cfg = p, cfg
        inner = cfg["num_heads"] * cfg["d_kv"]
        self.q = Dense(p, cfg["d_model"], inner, bias=False)
        self.k = Dense(p, cfg["d_model"], inner, bias=False)
        self.v = Dense(p, cfg["d_model"], inner, bias=False)
        self.o = Dense(p, inner, cfg["d_model"], bias=False)
        self.relative_attention_bias = (nn.Embedding(cfg["relative_attention_num_buckets"],
                                                     cfg["num_heads"]) if relative else None)

    def forward(self, x, bias, pos_bias):
        cfg, p = self.cfg, self.p
        b, t, _ = x.shape
        split = lambda a: a.reshape(b, t, cfg["num_heads"], cfg["d_kv"]).transpose(1, 2)
        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        if self.relative_attention_bias is not None:
            pos = np.arange(t)
            buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                               cfg["relative_attention_num_buckets"],
                                               cfg["relative_attention_max_distance"])
            pos_bias = self.relative_attention_bias(
                torch.as_tensor(buckets, device=x.device)).permute(2, 0, 1)[None]
        s = p.q(q) @ p.q(k).transpose(-1, -2) + pos_bias + bias     # no 1/sqrt(d_kv)
        out = (p.q(s.softmax(-1)) @ p.q(v)).transpose(1, 2).reshape(b, t, -1)
        return self.o(out), pos_bias


class T5Block(nn.Module):
    def __init__(self, p, cfg, relative):
        super().__init__()
        d, eps = cfg["d_model"], cfg["layer_norm_epsilon"]
        self.ln_attn = RMSNorm(d, eps)
        self.attn = T5Attention(p, cfg, relative)
        self.ln_ff = RMSNorm(d, eps)
        self.wi_0 = Dense(p, d, cfg["d_ff"], bias=False)
        self.wi_1 = Dense(p, d, cfg["d_ff"], bias=False)
        self.wo = Dense(p, cfg["d_ff"], d, bias=False)

    def forward(self, x, bias, pos_bias):
        a, pos_bias = self.attn(self.ln_attn(x), bias, pos_bias)
        x = x + a
        h = self.ln_ff(x)
        return x + self.wo(F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h)), pos_bias


class T5Encoder(nn.Module):
    """`cfg`: the configuration file's "t5" group (gated GELU)."""

    def __init__(self, cfg, p: Precision = FP32):
        super().__init__()
        if not cfg["is_gated_act"]:
            raise ValueError("the reference T5 is flan-T5's gated-GELU encoder")
        self.n = cfg["num_layers"]
        self.shared = nn.Embedding(cfg["vocab_size"], cfg["d_model"])
        for i in range(self.n):
            setattr(self, f"block_{i}", T5Block(p, cfg, i == 0))
        self.final_layer_norm = RMSNorm(cfg["d_model"], cfg["layer_norm_epsilon"])

    def forward(self, ids, mask):
        bias = mask_bias(mask)
        x, pos_bias = self.shared(ids), None
        for i in range(self.n):
            x, pos_bias = getattr(self, f"block_{i}")(x, bias, pos_bias)
        return self.final_layer_norm(x)


# ---------------------------------------------------------- projection, GPT-2
class Projection(nn.Module):
    """`cfg`: the configuration file's "projection" group."""

    def __init__(self, cfg, p: Precision = FP32):
        super().__init__()
        d = cfg["langauge_model_dim"]
        self.projection = Dense(p, cfg["text_encoder_dim"], d)
        self.projection_1 = Dense(p, cfg["text_encoder_1_dim"], d)
        for name in ("sos_embed", "eos_embed", "sos_embed_1", "eos_embed_1"):
            setattr(self, name, nn.Parameter(torch.zeros(d)))

    def forward(self, h0, h1, m0, m1):
        def wrap(h, m, sos, eos):
            b = h.shape[0]
            ones = torch.ones(b, 1, dtype=m.dtype, device=m.device)
            return (torch.cat([sos.expand(b, 1, -1), h, eos.expand(b, 1, -1)], 1),
                    torch.cat([ones, m, ones], -1))
        a, ma = wrap(self.projection(h0), m0, self.sos_embed, self.eos_embed)
        c, mc = wrap(self.projection_1(h1), m1, self.sos_embed_1, self.eos_embed_1)
        return torch.cat([a, c], 1), torch.cat([ma, mc], -1)


class GPT2Block(nn.Module):
    def __init__(self, p, cfg):
        super().__init__()
        d, eps = cfg["n_embd"], cfg["layer_norm_epsilon"]
        self.p, self.heads = p, cfg["n_head"]
        self.ln_1 = nn.LayerNorm(d, eps=eps)
        self.c_attn = Dense(p, d, 3 * d)
        self.attn_c_proj = Dense(p, d, d)
        self.ln_2 = nn.LayerNorm(d, eps=eps)
        self.c_fc = Dense(p, d, 4 * d)
        self.mlp_c_proj = Dense(p, 4 * d, d)

    def forward(self, x, bias):
        b, t, d = x.shape
        q, k, v = (a.reshape(b, t, self.heads, d // self.heads)
                   for a in self.c_attn(self.ln_1(x)).chunk(3, dim=-1))
        x = x + self.attn_c_proj(attention(self.p, q, k, v, bias).reshape(b, t, d))
        return x + self.mlp_c_proj(F.gelu(self.c_fc(self.ln_2(x)), approximate="tanh"))


class GPT2(nn.Module):
    """`cfg`: the configuration file's "gpt2" group."""

    def __init__(self, cfg, p: Precision = FP32):
        super().__init__()
        self.n = cfg["n_layer"]
        self.wpe = nn.Embedding(cfg["n_positions"], cfg["n_embd"])
        for i in range(self.n):
            setattr(self, f"h_{i}", GPT2Block(p, cfg))
        self.ln_f = nn.LayerNorm(cfg["n_embd"], eps=cfg["layer_norm_epsilon"])

    def forward(self, x, mask):
        t = x.shape[1]
        pos = (torch.cumsum(mask.long(), dim=1) - 1).clamp_min(0)
        x = x + self.wpe(pos)
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        bias = torch.where(causal[None, None] & mask.bool()[:, None, None, :], 0.0, -1e9)
        for i in range(self.n):
            x = getattr(self, f"h_{i}")(x, bias)
        return self.ln_f(x)

    def generate(self, embeds, mask, n: int):
        """Embedding-space autoregression at the static length L0 + n: the
        (B, n, d) states written one by one at the last attended position."""
        b, l0, d = embeds.shape
        seq = torch.cat([embeds, embeds.new_zeros(b, n, d)], 1)
        mask = torch.cat([mask, mask.new_zeros(b, n)], 1)
        rows = torch.arange(b, device=seq.device)
        for i in range(n):
            nxt = self(seq, mask)[rows, mask.sum(1) - 1]
            seq, mask = seq.clone(), mask.clone()
            seq[:, l0 + i] = nxt
            mask[:, l0 + i] = 1
        return seq[:, -n:]


# --------------------------------------------------------- prompt encoding
def tokens(texts, device, maxlen):
    ids, mask = byte_tokenizer(texts, maxlen)
    return torch.as_tensor(ids, device=device), torch.as_tensor(mask, device=device)


def musicldm_condition(clap: ClapText, text: str, maxlen: int, device) -> torch.Tensor:
    """MusicLDM's class label of one prompt, (1, projection_dim)."""
    return clap(*tokens([text], device, maxlen))


def audioldm2_condition(models: dict, text: str, maxlen: int, n_generated: int, device):
    """AudioLDM2's two streams of one prompt: (GPT-2 states (1, n, d), the T5
    sequence (1, L, d_model), its mask (1, L))."""
    ids, mask = tokens([text], device, maxlen)
    clap = models["clap_text"](ids, mask)[:, None]
    seq = models["t5"](ids, mask)
    projected, pmask = models["projection"](clap, seq, torch.ones(1, 1, dtype=mask.dtype,
                                                                  device=device), mask)
    return models["gpt2"].generate(projected, pmask, n_generated), seq, mask
