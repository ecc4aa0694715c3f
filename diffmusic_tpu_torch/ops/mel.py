"""Mel-scale transforms (torchaudio-compatible math in plain PyTorch).

Port of `diffmusic_tpu/ops/mel.py` (`MelScale`, `InverseMelScale`,
`MelSpectrogram`, `amplitude_to_db`, `Wav2Mel`). The filterbank helpers are numpy, copied here because the JAX
module imports jax. The gradient of the mel transform is plain autograd: the
JAX package's scatter-free VJP exists for XLA on a TPU, not for the card.
"""

import functools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .stft import spectrogram


def _hz_to_mel(f, mel_scale: str = "htk"):
    f = np.asarray(f, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # slaney
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mels)


def _mel_to_hz(m, mel_scale: str = "htk"):
    m = np.asarray(m, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    freqs)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                   f_min: float = 0.0, f_max: Optional[float] = None,
                   norm: Optional[str] = None, mel_scale: str = "htk") -> np.ndarray:
    """Triangular mel filterbank, shape (n_freqs, n_mels) (torchaudio
    melscale_fbanks with htk scale and no norm by default)."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_min, m_max = _hz_to_mel(f_min, mel_scale), _hz_to_mel(f_max, mel_scale)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = _mel_to_hz(m_pts, mel_scale)

    f_diff = np.diff(f_pts)                                # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]           # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))

    if norm == "slaney":
        enorm = 2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _filterbank_tensor(n_freqs: int, n_mels: int, sample_rate: int,
                       f_min: float, f_max, device: torch.device,
                       dtype: torch.dtype) -> torch.Tensor:
    fb = mel_filterbank(n_freqs, n_mels, sample_rate, f_min, f_max)
    return torch.as_tensor(fb, dtype=dtype, device=device)


def amplitude_to_db(x: torch.Tensor, stype: str = "power",
                    top_db: Optional[float] = None) -> torch.Tensor:
    """torchaudio.transforms.AmplitudeToDB: 10 (or 20) * log10(clamp(x, 1e-10))."""
    multiplier = 10.0 if stype == "power" else 20.0
    db = multiplier * torch.log10(torch.clamp(x, min=1e-10))
    if top_db is not None:
        db = torch.maximum(db, db.max() - top_db)
    return db


@functools.lru_cache(maxsize=16)
def _matrix_tensor(matrix, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """`matrix()` (a bound method of a frozen transform) as a tensor, cached
    per transform, device and dtype."""
    return torch.as_tensor(matrix(), dtype=dtype, device=device)


@dataclass(frozen=True)
class MelScale:
    """Project a (..., n_freqs, time) spectrogram to (..., n_mels, time)."""
    n_mels: int = 64
    sample_rate: int = 16000
    n_stft: int = 513
    f_min: float = 0.0
    f_max: Optional[float] = None
    norm: Optional[str] = None
    mel_scale: str = "htk"

    def filterbank(self) -> np.ndarray:
        return mel_filterbank(self.n_stft, self.n_mels, self.sample_rate,
                              self.f_min, self.f_max, self.norm, self.mel_scale)

    def __call__(self, spec: torch.Tensor) -> torch.Tensor:
        fb = _matrix_tensor(self.filterbank, spec.device, spec.dtype)
        return torch.einsum("...ft,fm->...mt", spec, fb)


@dataclass(frozen=True)
class InverseMelScale:
    """mel -> linear spectrogram through the filterbank's pseudo-inverse (the
    JAX package's one-matmul form, not torchaudio's iterative solver)."""
    n_stft: int = 513
    n_mels: int = 64
    sample_rate: int = 16000
    f_min: float = 0.0
    f_max: Optional[float] = None
    norm: Optional[str] = None
    mel_scale: str = "htk"

    def pinv(self) -> np.ndarray:
        fb = mel_filterbank(self.n_stft, self.n_mels, self.sample_rate,
                            self.f_min, self.f_max, self.norm, self.mel_scale)
        return np.linalg.pinv(fb).astype(np.float32)  # (n_mels, n_freqs)

    def __call__(self, mel: torch.Tensor) -> torch.Tensor:
        """(..., n_mels, T) -> (..., n_freqs, T), clamped to >= 0."""
        pinv = _matrix_tensor(self.pinv, mel.device, mel.dtype)
        return torch.clamp(torch.einsum("...mt,mf->...ft", mel, pinv), min=0.0)


@dataclass(frozen=True)
class MelSpectrogram:
    """(..., L) waveform -> (..., n_mels, num_frames) mel power spectrogram:
    Hann window, centre/reflect padding, htk mels, no norm."""
    sample_rate: int = 16000
    n_fft: int = 1024
    hop_length: int = 160
    win_length: int = 1024
    n_mels: int = 64
    power: float = 2.0
    f_min: float = 0.0
    f_max: Optional[float] = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        spec = spectrogram(x, self.n_fft, self.hop_length, self.win_length,
                           power=self.power, center=True, use_hann=True)
        fb = _filterbank_tensor(self.n_fft // 2 + 1, self.n_mels,
                                self.sample_rate, self.f_min, self.f_max,
                                spec.device, spec.dtype)
        # (..., n_freqs, T) -> (..., n_mels, T)
        return torch.einsum("...ft,fm->...mt", spec, fb)


@dataclass(frozen=True)
class Wav2Mel:
    """MelSpectrogram + AmplitudeToDB(power)."""
    sample_rate: int = 16000
    n_fft: int = 1024
    hop_length: int = 160
    win_length: int = 1024
    n_mels: int = 64
    power: float = 2.0
    mel: MelSpectrogram = field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "mel", MelSpectrogram(
            self.sample_rate, self.n_fft, self.hop_length, self.win_length,
            self.n_mels, self.power))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return amplitude_to_db(self.mel(x), stype="power")
