"""Degradation operators A(x) (port of `diffmusic_tpu/inverse_problem/operator.py`).

Interface:
  - forward(audio, generator):  the measurement model A(.)
  - transform(audio):           map into the supervision space (mel dB)
  - inverse_transform(mel, vocoder): latent mel -> waveform via the vocoder

Ported: identity, inpainting (box, random and periodic masks), phase
retrieval, super-resolution, dereverberation and style guidance (the gram
matrix of CLAP frame features). The random mask and the reverb impulse
response are drawn once, at construction, from a `torch.Generator`
(`mask_generator`, `ir_generator`) in place of the JAX package's keys.
"""

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.filters import convolve1d, generate_impulse_response
from ..ops.masks import box_mask, periodic_mask, random_mask
from ..ops.mel import MelScale, MelSpectrogram, amplitude_to_db
from ..ops.resample import resample
from ..ops.stft import spectrogram
from .noise import BaseNoise, GaussianNoise


def _squeeze_mel(mel: torch.Tensor) -> torch.Tensor:
    """(B, 1, T, n_mels) -> (B, T, n_mels): drop the channel axis for the vocoder."""
    return mel[:, 0] if mel.ndim == 4 else mel


def _default_wav2mel(sample_rate: int = 16000) -> MelSpectrogram:
    return MelSpectrogram(sample_rate=sample_rate, n_fft=1024, hop_length=160,
                          win_length=1024, n_mels=64, power=2.0)


def _clamped_db_mel(audio: torch.Tensor, sample_rate: int = 16000) -> torch.Tensor:
    """The default mel in dB, clamped to [-80, 80]."""
    mel = _default_wav2mel(sample_rate)(audio)
    return torch.clamp(amplitude_to_db(mel, "power"), -80.0, 80.0)


class BaseOperator:
    noiser: BaseNoise

    def transform(self, data):
        raise NotImplementedError

    def inverse_transform(self, mel_spectrogram: torch.Tensor,
                          vocoder: Callable) -> torch.Tensor:
        """mel (B, 1, T, n_mels) or (B, T, n_mels) -> waveform (B, L)."""
        return vocoder(_squeeze_mel(mel_spectrogram))

    def forward(self, data, generator=None):
        raise NotImplementedError


@dataclass(frozen=True)
class IdentityOperator(BaseOperator):
    """A(x) = x; transform clamps the dB mel to [-80, 80]."""
    sample_rate: int = 16000
    noiser: BaseNoise = field(default_factory=GaussianNoise)

    def transform(self, audio):
        return _clamped_db_mel(audio, self.sample_rate)

    def forward(self, data, generator=None):
        return data


def _seeded(generator: Optional[torch.Generator]) -> torch.Generator:
    """The generator, or the JAX package's default key's stand-in: seed 0."""
    return generator if generator is not None else torch.Generator().manual_seed(0)


@dataclass(frozen=True)
class MusicInpaintingOperator(BaseOperator):
    """A(x) = mask * x with a box, random or periodic time-domain mask. Its
    transform has no clamp, as in the reference."""
    audio_length_in_s: float = 5.0
    sample_rate: int = 16000
    mask_type: str = "box"
    start_inpainting_s: Optional[float] = None
    end_inpainting_s: Optional[float] = None
    mask_percentage: float = 0.3
    mask_duration_s: float = 0.1
    interval_s: float = 1.0
    noiser: BaseNoise = field(default_factory=GaussianNoise)
    mask_generator: Optional[torch.Generator] = None  # mask_type="random" only
    mask: np.ndarray = field(init=False, repr=False)

    def __post_init__(self):
        total = int(self.audio_length_in_s * self.sample_rate)
        if self.mask_type == "box":
            m = box_mask(total, self.sample_rate, self.start_inpainting_s,
                         self.end_inpainting_s)
        elif self.mask_type == "random":
            m = random_mask(_seeded(self.mask_generator), total, self.sample_rate,
                            self.mask_percentage, self.mask_duration_s)
        elif self.mask_type == "periodic":
            m = periodic_mask(total, self.sample_rate, self.interval_s,
                              self.mask_duration_s)
        else:
            raise ValueError(f"Unknown mask type: {self.mask_type}")
        object.__setattr__(self, "mask", m)

    def transform(self, audio):
        return amplitude_to_db(_default_wav2mel(self.sample_rate)(audio), "power")

    def forward(self, data, generator=None):
        n = data.shape[-1]
        mask = torch.as_tensor(self.mask[..., :n], dtype=data.dtype,
                               device=data.device)
        return self.noiser(data * mask, generator)


@dataclass(frozen=True)
class PhaseRetrievalOperator(BaseOperator):
    """A(x) = |STFT(x)| with a rectangular window; the transform is a MelScale
    of the magnitude (no dB), clamped to [-80, 80]."""
    n_fft: int = 1024
    hop_length: int = 160
    win_length: int = 1024
    sample_rate: int = 16000
    noiser: BaseNoise = field(default_factory=GaussianNoise)

    def transform(self, magnitude):
        mel = MelScale(n_mels=64, sample_rate=self.sample_rate,
                       n_stft=self.n_fft // 2 + 1)(magnitude)
        return torch.clamp(mel, -80.0, 80.0)

    def forward(self, data, generator=None):
        mag = spectrogram(data, self.n_fft, self.hop_length, self.win_length,
                          power=1.0, center=True, use_hann=False)
        return self.noiser(mag, generator)


@dataclass(frozen=True)
class SuperResolutionOperator(BaseOperator):
    """A(x) = x downsampled by `scale` (windowed-sinc resampling); the
    transform is the clamped dB mel."""
    sample_rate: int = 16000
    scale: int = 10
    noiser: BaseNoise = field(default_factory=GaussianNoise)

    def transform(self, audio):
        return _clamped_db_mel(audio)

    def forward(self, data, generator=None):
        low = resample(data, self.sample_rate, self.sample_rate // self.scale)
        return self.noiser(low, generator)


@dataclass(frozen=True)
class MusicDereverberationOperator(BaseOperator):
    """A(x) = x correlated with a random cumsum impulse response, drawn once
    from `ir_generator` at construction (the JAX package's divergence from
    the reference, which redraws it on every call); the transform is the
    clamped dB mel. The response is copied to a device once per (device,
    dtype) and kept there (`response`): a step's loss makes no copy from host
    memory, and so no stream synchronise."""
    ir_length: int = 800
    decay_factor: float = 0.85
    noiser: BaseNoise = field(default_factory=GaussianNoise)
    ir_generator: Optional[torch.Generator] = None
    ir: np.ndarray = field(init=False, repr=False)

    def __post_init__(self):
        ir = generate_impulse_response(_seeded(self.ir_generator), self.ir_length,
                                       self.decay_factor)
        object.__setattr__(self, "ir", ir.cpu().numpy())
        object.__setattr__(self, "_on_device", {})

    def response(self, device, dtype):
        """`ir` on `device` in `dtype`, made on the first call and reused
        while `ir` is the same array."""
        held = self._on_device.get((device, dtype))
        if held is None or held[0] is not self.ir:
            held = self._on_device[(device, dtype)] = (
                self.ir, torch.as_tensor(self.ir, dtype=dtype, device=device))
        return held[1]

    def transform(self, audio):
        return _clamped_db_mel(audio)

    def forward(self, data, generator=None):
        return self.noiser(convolve1d(data, self.response(data.device, data.dtype)),
                           generator)


@dataclass(frozen=True)
class StyleGuidanceOperator(BaseOperator):
    """A(x) = x; transform = the gram matrix of the CLAP frame features,
    einsum("btd,bte->bde") / T'. `clap_embed` maps a 16-kHz waveform to
    (B, T', D) frame features (a pipeline's `clap_frame_embed`)."""
    clap_embed: Optional[Callable] = None
    noiser: BaseNoise = field(default_factory=GaussianNoise)

    def transform(self, audio: torch.Tensor) -> torch.Tensor:
        if self.clap_embed is None:
            raise ValueError("StyleGuidanceOperator requires a clap_embed callable")
        feats = self.clap_embed(audio)
        return torch.einsum("btd,bte->bde", feats, feats) / feats.shape[1]

    def forward(self, data, generator=None):
        return data
