"""Degradation operators A(x) (port of `diffmusic_tpu/inverse_problem/operator.py`).

Interface:
  - forward(audio, generator):  the measurement model A(.)
  - transform(audio):           map into the supervision space (mel dB)
  - inverse_transform(mel, vocoder): latent mel -> waveform via the vocoder

Ported so far: identity and box-mask inpainting. Phase retrieval,
super-resolution, dereverberation and style guidance are still to be ported.
"""

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.masks import box_mask
from ..ops.mel import MelSpectrogram, amplitude_to_db
from .noise import BaseNoise, GaussianNoise


def _squeeze_mel(mel: torch.Tensor) -> torch.Tensor:
    """(B, 1, T, n_mels) -> (B, T, n_mels): drop the channel axis for the vocoder."""
    return mel[:, 0] if mel.ndim == 4 else mel


def _default_wav2mel(sample_rate: int = 16000) -> MelSpectrogram:
    return MelSpectrogram(sample_rate=sample_rate, n_fft=1024, hop_length=160,
                          win_length=1024, n_mels=64, power=2.0)


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
        mel = _default_wav2mel(self.sample_rate)(audio)
        return torch.clamp(amplitude_to_db(mel, "power"), -80.0, 80.0)

    def forward(self, data, generator=None):
        return data


@dataclass(frozen=True)
class MusicInpaintingOperator(BaseOperator):
    """A(x) = mask * x with a box time-domain mask. Its transform has no clamp,
    as in the reference."""
    audio_length_in_s: float = 5.0
    sample_rate: int = 16000
    mask_type: str = "box"
    start_inpainting_s: Optional[float] = None
    end_inpainting_s: Optional[float] = None
    noiser: BaseNoise = field(default_factory=GaussianNoise)
    mask: np.ndarray = field(init=False, repr=False)

    def __post_init__(self):
        if self.mask_type != "box":
            raise ValueError(
                f"mask type {self.mask_type!r} is not ported yet (only 'box')")
        total = int(self.audio_length_in_s * self.sample_rate)
        object.__setattr__(self, "mask", box_mask(
            total, self.sample_rate, self.start_inpainting_s,
            self.end_inpainting_s))

    def transform(self, audio):
        return amplitude_to_db(_default_wav2mel(self.sample_rate)(audio), "power")

    def forward(self, data, generator=None):
        n = data.shape[-1]
        mask = torch.as_tensor(self.mask[..., :n], dtype=data.dtype,
                               device=data.device)
        return self.noiser(data * mask, generator)
