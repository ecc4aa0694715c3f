"""Whisper's encoder and its log-mel features: the eval's `whisper-*`
embedders.

The JAX package runs transformers' `WhisperFeatureExtractor` and
`WhisperModel.encoder` on the CPU
(`diffmusic_tpu/fadtk/model_loader.py::WhisperModel`); this is the same
computation written natively, with transformers' module names
(`checkpoint.load_whisper_encoder`):

- the features (`log_mel_features`): the clip padded with zeros or cut to
  `n_samples` (30 s), the power STFT (n_fft 400, hop 160, periodic Hann,
  centred with reflect padding), its last frame dropped (`drop_last_frame`),
  `feature_size` Slaney-scale, Slaney-normed mel filters up to 8 kHz (built
  with `ops/mel.py::mel_filterbank`: the preprocessor config stores none),
  log10 with a floor of 1e-10, clamped to the clip's maximum - 8, then
  (x + 4) / 4;
- the encoder: two convs with GELU (the second of stride 2), the stored
  sinusoidal positions added, pre-LN layers (exact GELU feed-forwards), a
  final LayerNorm. 3000 feature frames give 1500 output frames.

No kernel of its own: cuFFT, cuDNN convs and SDPA.
"""

import functools
from dataclasses import dataclass, fields

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.mel import mel_filterbank


@dataclass(frozen=True)
class WhisperFeatureConfig:
    """preprocessor_config.json's fields (WhisperFeatureExtractor's defaults)."""
    feature_size: int = 80
    sampling_rate: int = 16000
    hop_length: int = 160
    n_fft: int = 400
    n_samples: int = 480000
    padding_value: float = 0.0

    @classmethod
    def from_json(cls, c: dict) -> "WhisperFeatureConfig":
        if c.get("dither", 0.0) != 0.0:
            raise ValueError("WhisperFeatureConfig: dither (random noise in the features) is "
                             "not supported")
        return cls(**{f.name: c[f.name] for f in fields(cls) if f.name in c})


@dataclass(frozen=True)
class WhisperEncoderConfig:
    """WhisperConfig's encoder fields (defaults: openai/whisper-tiny)."""
    d_model: int = 384
    encoder_layers: int = 4
    encoder_attention_heads: int = 6
    encoder_ffn_dim: int = 1536
    num_mel_bins: int = 80
    max_source_positions: int = 1500
    activation_function: str = "gelu"

    @classmethod
    def from_json(cls, c: dict) -> "WhisperEncoderConfig":
        cfg = cls(**{f.name: c[f.name] for f in fields(cls) if f.name in c})
        if cfg.activation_function != "gelu":
            raise ValueError(f"WhisperEncoderConfig: activation {cfg.activation_function!r} "
                             f"is not supported")
        return cfg


def drop_last_frame(power: torch.Tensor) -> torch.Tensor:
    """The STFT's frames without the last one, as the extractor keeps them."""
    return power[..., :-1]


@functools.lru_cache(maxsize=8)
def _mel_filters(cfg: WhisperFeatureConfig, device, dtype) -> torch.Tensor:
    fb = mel_filterbank(cfg.n_fft // 2 + 1, cfg.feature_size, cfg.sampling_rate, 0.0, 8000.0,
                        norm="slaney", mel_scale="slaney")
    return torch.as_tensor(fb, device=device, dtype=dtype)


def log_mel_features(audio: torch.Tensor, cfg: WhisperFeatureConfig) -> torch.Tensor:
    """(B, L) fp32 audio at `sampling_rate` -> (B, feature_size,
    n_samples / hop_length) log-mel features."""
    n = cfg.n_samples
    audio = audio[:, :n]
    if audio.shape[1] < n:
        audio = F.pad(audio, (0, n - audio.shape[1]), value=cfg.padding_value)
    window = torch.hann_window(cfg.n_fft, device=audio.device)
    spec = torch.stft(audio, cfg.n_fft, cfg.hop_length, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = drop_last_frame(spec.abs() ** 2)
    mel = _mel_filters(cfg, audio.device, power.dtype).T @ power
    log_spec = torch.clamp(mel, min=1e-10).log10()
    peak = log_spec.amax(dim=(1, 2), keepdim=True)
    return (torch.maximum(log_spec, peak - 8.0) + 4.0) / 4.0


class WhisperAttention(nn.Module):
    def __init__(self, cfg: WhisperEncoderConfig):
        super().__init__()
        c, self.heads = cfg.d_model, cfg.encoder_attention_heads
        self.q_proj, self.v_proj, self.out_proj = nn.Linear(c, c), nn.Linear(c, c), nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c, bias=False)

    def forward(self, x):
        b, t, c = x.shape
        split = lambda y: y.view(b, t, self.heads, c // self.heads).transpose(1, 2)  # noqa: E731
        o = F.scaled_dot_product_attention(split(self.q_proj(x)), split(self.k_proj(x)),
                                           split(self.v_proj(x)))
        return self.out_proj(o.transpose(1, 2).reshape(b, t, c))


class WhisperEncoderLayer(nn.Module):
    def __init__(self, cfg: WhisperEncoderConfig):
        super().__init__()
        self.self_attn = WhisperAttention(cfg)
        self.self_attn_layer_norm = nn.LayerNorm(cfg.d_model)
        self.fc1 = nn.Linear(cfg.d_model, cfg.encoder_ffn_dim)
        self.fc2 = nn.Linear(cfg.encoder_ffn_dim, cfg.d_model)
        self.final_layer_norm = nn.LayerNorm(cfg.d_model)

    def forward(self, h):
        h = h + self.self_attn(self.self_attn_layer_norm(h))
        return h + self.fc2(F.gelu(self.fc1(self.final_layer_norm(h))))


class WhisperEncoder(nn.Module):
    """(B, num_mel_bins, 2 max_source_positions) features -> the last hidden
    state, (B, max_source_positions, d_model)."""

    def __init__(self, cfg: WhisperEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.conv1 = nn.Conv1d(cfg.num_mel_bins, cfg.d_model, 3, padding=1)
        self.conv2 = nn.Conv1d(cfg.d_model, cfg.d_model, 3, stride=2, padding=1)
        self.embed_positions = nn.Embedding(cfg.max_source_positions, cfg.d_model)
        self.layers = nn.ModuleList(WhisperEncoderLayer(cfg) for _ in range(cfg.encoder_layers))
        self.layer_norm = nn.LayerNorm(cfg.d_model)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        want = 2 * self.cfg.max_source_positions
        if features.shape[-1] != want:
            raise ValueError(f"Whisper expects {want} feature frames, got {features.shape[-1]}")
        h = F.gelu(self.conv2(F.gelu(self.conv1(features)))).transpose(1, 2)
        h = h + self.embed_positions.weight
        for layer in self.layers:
            h = layer(h)
        return self.layer_norm(h)
