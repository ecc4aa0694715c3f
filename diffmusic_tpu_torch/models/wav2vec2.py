"""wav2vec2, HuBERT and WavLM: the self-supervised speech encoders of the
eval's `w2v2-*`, `hubert-*`, `wavlm-*` and `MERT-v1-95M*` embedders.

The JAX package runs transformers' torch `AutoModel` for these on the CPU
(`diffmusic_tpu/fadtk/model_loader.py::_HFFeatureLoader`); this is the same
network written natively, with transformers' module names, so that an HF
snapshot's state dict loads as it is (weight norm folded,
`checkpoint.load_wav2vec2`). One module covers the family:

- the conv feature encoder: 7 convs, GELU after each; `feat_extract_norm`
  "group" puts a GroupNorm (one group a channel) on the first conv, "layer"
  a LayerNorm over the channels on every conv;
- the feature projection: LayerNorm (HuBERT: only with `feat_proj_layer_norm`)
  and a linear map to the model width;
- the positional conv: grouped, kernel 128, padded k // 2 each side, one
  trailing frame removed for an even kernel, GELU;
- post-LN layers (`do_stable_layer_norm` False: the encoder's LayerNorm
  before the first layer) or pre-LN layers (True: the LayerNorm after the
  last);
- WavLM: a gated relative position bias. Layer 0 alone holds the bucket
  embedding and computes the (heads, T, T) bias; every layer gates it with
  its own `gru_rel_pos_linear` and `gru_rel_pos_const`, and hands layer 0's
  bias on, ungated (`pass_on_bias`).

`forward` returns transformers' `hidden_states`: entry 0 is the first layer's
input, entry i the output of layer i; in the pre-LN variant the last entry
alone is taken after the final LayerNorm (`stable_last`). No kernel of its
own: cuDNN convs and SDPA.
"""

import math
from dataclasses import dataclass, fields
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass(frozen=True)
class Wav2Vec2Config:
    """The fields of transformers' Wav2Vec2Config / HubertConfig / WavLMConfig
    that the encoder reads (defaults: facebook/wav2vec2-base)."""
    model_type: str = "wav2vec2"          # "wav2vec2", "hubert" or "wavlm"
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"              # exact GELU, the only activation read
    layer_norm_eps: float = 1e-5
    feat_extract_norm: str = "group"
    feat_extract_activation: str = "gelu"
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = False
    feat_proj_layer_norm: bool = True     # HuBERT's switch; wav2vec2 and WavLM always have it
    num_buckets: int = 320                # WavLM
    max_bucket_distance: int = 800        # WavLM

    @classmethod
    def from_json(cls, c: dict) -> "Wav2Vec2Config":
        """From an HF config.json; refuses the options this encoder does not
        compute (an adapter, HuBERT's BatchNorm positional conv, an activation
        other than GELU, a model type other than the three)."""
        if c.get("model_type") not in ("wav2vec2", "hubert", "wavlm"):
            raise ValueError(f"not a wav2vec2 / HuBERT / WavLM config: model_type "
                             f"{c.get('model_type')!r}")
        for switch in ("add_adapter", "conv_pos_batch_norm"):
            if c.get(switch):
                raise ValueError(f"Wav2Vec2Config: {switch} is not supported")
        kw = {f.name: c[f.name] for f in fields(cls) if f.name in c}
        for k in ("conv_dim", "conv_stride", "conv_kernel"):
            if k in kw:
                kw[k] = tuple(kw[k])
        cfg = cls(**kw)
        for act in (cfg.hidden_act, cfg.feat_extract_activation):
            if act != "gelu":
                raise ValueError(f"Wav2Vec2Config: activation {act!r} is not supported")
        if cfg.feat_extract_norm not in ("group", "layer"):
            raise ValueError(f"feat_extract_norm {cfg.feat_extract_norm!r}: 'group' or 'layer'")
        return cfg


def stable_last(pre_norm: torch.Tensor, post_norm: torch.Tensor) -> torch.Tensor:
    """The pre-LN encoder's last `hidden_states` entry: taken after its final
    LayerNorm, as transformers takes it."""
    return post_norm


def pass_on_bias(bias: torch.Tensor, gated: torch.Tensor) -> torch.Tensor:
    """The bias a WavLM layer hands to the next: layer 0's, ungated."""
    return bias


class ConvLayer(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, i: int):
        super().__init__()
        cin = cfg.conv_dim[i - 1] if i > 0 else 1
        cout = cfg.conv_dim[i]
        self.conv = nn.Conv1d(cin, cout, cfg.conv_kernel[i], stride=cfg.conv_stride[i],
                              bias=cfg.conv_bias)
        self.norm = (cfg.feat_extract_norm if cfg.feat_extract_norm == "layer" or i == 0
                     else None)
        if self.norm == "group":
            self.layer_norm = nn.GroupNorm(cout, cout, affine=True)
        elif self.norm == "layer":
            self.layer_norm = nn.LayerNorm(cout, elementwise_affine=True)

    def forward(self, x):
        x = self.conv(x)
        if self.norm == "group":
            x = self.layer_norm(x)
        elif self.norm == "layer":
            x = self.layer_norm(x.transpose(1, 2)).transpose(1, 2)
        return F.gelu(x)


class FeatureEncoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.conv_layers = nn.ModuleList(ConvLayer(cfg, i) for i in range(len(cfg.conv_dim)))

    def forward(self, audio):
        x = audio[:, None]
        for layer in self.conv_layers:
            x = layer(x)
        return x


class FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.has_norm = cfg.feat_proj_layer_norm or cfg.model_type != "hubert"
        if self.has_norm:
            self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x):
        return self.projection(self.layer_norm(x) if self.has_norm else x)


class PositionalConv(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)
        self.remove = 1 if k % 2 == 0 else 0

    def forward(self, h):
        x = self.conv(h.transpose(1, 2))
        if self.remove:
            x = x[:, :, :-self.remove]
        return F.gelu(x).transpose(1, 2)


def relative_buckets(t: int, num_buckets: int, max_distance: int, device) -> torch.Tensor:
    """WavLM's (T, T) bucket of each key offset j - i: half the buckets a
    direction, exact below a quarter of them, logarithmic up to
    `max_distance`."""
    rel = torch.arange(t, device=device)[None, :] - torch.arange(t, device=device)[:, None]
    half = num_buckets // 2
    buckets = (rel > 0).long() * half
    rel = rel.abs()
    exact = half // 2
    large = torch.log(rel.float() / exact) / math.log(max_distance / exact) * (half - exact)
    large = torch.clamp_max((exact + large).long(), half - 1)
    return buckets + torch.where(rel < exact, rel, large)


class Attention(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, rel_bias: bool):
        super().__init__()
        c, self.heads = cfg.hidden_size, cfg.num_attention_heads
        self.q_proj, self.k_proj = nn.Linear(c, c), nn.Linear(c, c)
        self.v_proj, self.out_proj = nn.Linear(c, c), nn.Linear(c, c)
        self.wavlm = cfg.model_type == "wavlm"
        if self.wavlm:
            self.num_buckets, self.max_distance = cfg.num_buckets, cfg.max_bucket_distance
            self.gru_rel_pos_const = nn.Parameter(torch.ones(1, self.heads, 1, 1))
            self.gru_rel_pos_linear = nn.Linear(c // self.heads, 8)
            if rel_bias:
                self.rel_attn_embed = nn.Embedding(cfg.num_buckets, self.heads)

    def forward(self, x, bias: Optional[torch.Tensor] = None):
        b, t, c = x.shape
        split = lambda y: y.view(b, t, self.heads, c // self.heads).transpose(1, 2)  # noqa: E731
        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        mask = None
        if self.wavlm:
            if bias is None:   # layer 0: (1, H, T, T)
                idx = relative_buckets(t, self.num_buckets, self.max_distance, x.device)
                bias = self.rel_attn_embed(idx).permute(2, 0, 1)[None]
            g = self.gru_rel_pos_linear(split(x)).view(b, self.heads, t, 2, 4).sum(-1)
            gate_a, gate_b = torch.sigmoid(g).chunk(2, dim=-1)
            mask = (gate_a * (gate_b * self.gru_rel_pos_const - 1.0) + 2.0) * bias
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        out = self.out_proj(o.transpose(1, 2).reshape(b, t, c))
        return out, (pass_on_bias(bias, mask) if self.wavlm else None)


class FeedForward(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, rel_bias: bool):
        super().__init__()
        self.attention = Attention(cfg, rel_bias)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.stable = cfg.do_stable_layer_norm

    def forward(self, h, bias=None):
        if self.stable:
            a, bias = self.attention(self.layer_norm(h), bias)
            h = h + a
            return h + self.feed_forward(self.final_layer_norm(h)), bias
        a, bias = self.attention(h, bias)
        h = self.layer_norm(h + a)
        return self.final_layer_norm(h + self.feed_forward(h)), bias


class Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = PositionalConv(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg, rel_bias=i == 0)
                                    for i in range(cfg.num_hidden_layers))
        self.stable = cfg.do_stable_layer_norm

    def forward(self, h) -> List[torch.Tensor]:
        h = h + self.pos_conv_embed(h)
        if not self.stable:
            h = self.layer_norm(h)
        states, bias = [], None
        for layer in self.layers:
            states.append(h)
            h, bias = layer(h, bias)
        states.append(stable_last(h, self.layer_norm(h)) if self.stable else h)
        return states


class Wav2Vec2Model(nn.Module):
    """Raw audio (B, L) -> `hidden_states`, num_hidden_layers + 1 tensors of
    (B, frames, hidden_size). The audio is fed as it is: no zero-mean /
    unit-variance normalisation, as the JAX package's loader feeds it."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = FeatureEncoder(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.encoder = Encoder(cfg)

    def forward(self, audio: torch.Tensor) -> List[torch.Tensor]:
        x = self.feature_extractor(audio).transpose(1, 2)
        return self.encoder(self.feature_projection(x))
