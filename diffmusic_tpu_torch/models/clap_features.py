"""CLAP audio features: waveform -> (B, 1, T, 64) log-mel input_features, and
the embedding callables built on the HTSAT tower (port of
`diffmusic_tpu/models/clap_features.py`).

transformers' ClapFeatureExtractor in the non-fusion configuration of
laion/clap-htsat-unfused, in plain PyTorch and differentiable, so that the
style-guidance gram loss backpropagates through it: 16 -> 48 kHz, "repeatpad"
to 10 s, |STFT|^2 (Hann, centre, reflect), the Slaney filterbank, 10 log10
and the top-dB clamp at 80 dB below the maximum. That maximum is taken over
the whole batch, as the JAX package takes it: the N candidates of
`score_waveforms` share one clamp, and under a mesh's sharded batch the
ranks' clips share one too (`parallel.mesh.batch_max`).
"""

import functools
from dataclasses import dataclass, replace
from typing import Optional

import torch

from ..ops.mel import mel_filterbank
from ..ops.resample import resample
from ..ops.stft import spectrogram
from ..parallel.mesh import batch_max
from .htsat import ClapAudioModelWithProjection, tiny_clap_audio_config


@dataclass(frozen=True)
class ClapFeatureConfig:
    sampling_rate: int = 48000
    hop_length: int = 480
    fft_window_size: int = 1024
    feature_size: int = 64
    frequency_min: float = 0.0
    frequency_max: float = 14000.0
    max_length_s: float = 10.0

    @property
    def nb_max_samples(self) -> int:
        return int(self.max_length_s * self.sampling_rate)


@functools.lru_cache(maxsize=8)
def _slaney_filterbank(cfg: ClapFeatureConfig, device: torch.device,
                       dtype: torch.dtype) -> torch.Tensor:
    fb = mel_filterbank(cfg.fft_window_size // 2 + 1, cfg.feature_size, cfg.sampling_rate,
                        f_min=cfg.frequency_min, f_max=cfg.frequency_max, norm="slaney",
                        mel_scale="slaney")
    return torch.as_tensor(fb, dtype=dtype, device=device)


def clap_mel_features(wav: torch.Tensor,
                      cfg: ClapFeatureConfig = ClapFeatureConfig()) -> torch.Tensor:
    """(B, L) waveform at cfg.sampling_rate -> (B, 1, T, feature_size) log-mel dB,
    clamped at 80 dB below the batch's maximum."""
    spec = spectrogram(wav, cfg.fft_window_size, cfg.hop_length, cfg.fft_window_size,
                       power=2.0, center=True, use_hann=True)            # (B, F, T)
    mel = torch.einsum("bft,fm->bmt", spec,
                       _slaney_filterbank(cfg, spec.device, spec.dtype))
    db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    db = torch.maximum(db, batch_max(db) - 80.0)
    return db.transpose(1, 2)[:, None]


def prepare_clap_input(wav_16k: torch.Tensor,
                       cfg: ClapFeatureConfig = ClapFeatureConfig()) -> torch.Tensor:
    """16 kHz waveform (B, L) -> CLAP input_features: resampled to
    cfg.sampling_rate, "repeatpad" (whole tiles, then zeros) or truncated to
    max_length_s, then `clap_mel_features`."""
    wav = resample(wav_16k, 16000, cfg.sampling_rate)
    n, want = wav.shape[-1], cfg.nb_max_samples
    if n < want:
        n_repeat = want // n
        wav = torch.cat([wav.repeat(1, n_repeat),
                         wav.new_zeros(wav.shape[0], want - n_repeat * n)], dim=1)
    else:
        wav = wav[:, :want]
    return clap_mel_features(wav, cfg)


class ClapEmbed:
    """waveform (B, L) at 16 kHz -> L2-normalised CLAP audio features through
    `tower`: pooled (B, D), or per frame (B, T', D) with features="frames".
    The tower runs in its own dtype (fp32: it sits in the guided loss head)."""

    def __init__(self, tower: ClapAudioModelWithProjection,
                 cfg: ClapFeatureConfig = ClapFeatureConfig(), features: str = "pooled"):
        self.tower, self.cfg, self.features = tower, cfg, features

    def __call__(self, wav_16k) -> torch.Tensor:
        p = next(self.tower.parameters())
        wav = torch.as_tensor(wav_16k, device=p.device).to(p.dtype)
        emb = self.tower(prepare_clap_input(wav, self.cfg), features=self.features)
        return emb / emb.norm(dim=-1, keepdim=True)


def make_clap_audio_embed(tower: ClapAudioModelWithProjection,
                          cfg: ClapFeatureConfig = ClapFeatureConfig()) -> ClapEmbed:
    """The pooled embedding: prompt_type="clap" and `score_waveforms`."""
    return ClapEmbed(tower, cfg, "pooled")


def make_clap_frame_embed(tower: ClapAudioModelWithProjection,
                          cfg: ClapFeatureConfig = ClapFeatureConfig()) -> ClapEmbed:
    """The frame features behind `StyleGuidanceOperator`'s gram matrix."""
    return ClapEmbed(tower, cfg, "frames")


def tiny_clap_feature_config() -> ClapFeatureConfig:
    """16 kHz, a 1-s window, 16 mel bins: `tiny_clap_audio_config`'s input,
    with no resampling."""
    return ClapFeatureConfig(sampling_rate=16000, hop_length=160, fft_window_size=256,
                             feature_size=16, frequency_max=8000.0, max_length_s=1.0)


def random_clap_audio_embeds(a_cfg, f_cfg: ClapFeatureConfig, seed: int, device="cuda"):
    """A seeded flax-style random tower (fp32, frozen, on `device`) ->
    (pooled embed, frame embed)."""
    from .convert import init_flax_style
    tower = init_flax_style(ClapAudioModelWithProjection(a_cfg), seed)
    tower = tower.to(device=device, dtype=torch.float32).requires_grad_(False).eval()
    return make_clap_audio_embed(tower, f_cfg), make_clap_frame_embed(tower, f_cfg)


def make_tiny_clap_audio_embeds(seed: int, projection_dim: Optional[int] = None,
                                device="cuda"):
    """`random_clap_audio_embeds` of the tiny tower and features;
    `projection_dim` is the tiny CLAP text tower's, as CLAP's audio and text
    embeddings share one space."""
    a_cfg = tiny_clap_audio_config()
    if projection_dim is not None:
        a_cfg = replace(a_cfg, projection_dim=projection_dim)
    return random_clap_audio_embeds(a_cfg, tiny_clap_feature_config(), seed, device)
