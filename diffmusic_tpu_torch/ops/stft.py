"""Onesided STFT power spectrogram as a matmul-DFT on frames.

Port of `diffmusic_tpu/ops/stft.py` (`hann_window`, `_dft_basis`,
`frame_signal`, `spectrogram`): `torch.stft` semantics with `center=True` and
reflect padding, computed as `frames @ basis` so that the CPU result matches the
JAX package to float32 rounding and the gradient is plain autograd.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window(periodic=True))."""
    n = np.arange(win_length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    return torch.as_tensor(w, dtype=dtype, device=device)


def _dft_basis(n_fft: int, dtype=np.float32):
    """Real/imag DFT basis of the onesided transform: (n_fft, n_fft//2+1) each."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_freqs)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(dtype), (-np.sin(ang)).astype(dtype)


@functools.lru_cache(maxsize=16)
def _basis(n_fft: int, device: torch.device, dtype: torch.dtype):
    """(cos, sin) DFT bases as tensors, cached per device and dtype."""
    cos_b, sin_b = _dft_basis(n_fft)
    return (torch.as_tensor(cos_b, dtype=dtype, device=device),
            torch.as_tensor(sin_b, dtype=dtype, device=device))


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int,
                 center: bool = True, pad_mode: str = "reflect") -> torch.Tensor:
    """(..., L) -> (..., num_frames, n_fft); num_frames = 1 + L // hop when
    center=True (torch.stft convention)."""
    batch = x.shape[:-1]
    x = x.reshape(-1, 1, x.shape[-1])
    if center:
        x = F.pad(x, (n_fft // 2, n_fft // 2), mode=pad_mode)
    frames = x[:, 0].unfold(-1, n_fft, hop_length)
    return frames.reshape(*batch, frames.shape[-2], n_fft)


def spectrogram(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 160,
                win_length: int = 1024, power: float = 2.0, center: bool = True,
                use_hann: bool = True) -> torch.Tensor:
    """|STFT|^power (torchaudio.transforms.Spectrogram semantics).

    Returns (..., n_freqs, num_frames)."""
    if win_length > n_fft:
        raise ValueError("win_length must not exceed n_fft")
    frames = frame_signal(x, n_fft, hop_length, center)
    if use_hann:
        # window the frames, then the plain basis: the JAX package's order, so
        # that both round alike
        w = hann_window(win_length, frames.dtype, frames.device)
        if win_length < n_fft:
            lpad = (n_fft - win_length) // 2
            w = F.pad(w, (lpad, n_fft - win_length - lpad))
        frames = frames * w
    cos_b, sin_b = _basis(n_fft, frames.device, frames.dtype)
    re = (frames @ cos_b).transpose(-1, -2)
    im = (frames @ sin_b).transpose(-1, -2)
    mag_sq = re * re + im * im
    if power == 2.0:
        return mag_sq
    if power == 1.0:
        return torch.sqrt(mag_sq + 1e-24)
    return torch.pow(mag_sq + 1e-24, power / 2.0)
