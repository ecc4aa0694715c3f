"""Onesided STFT, its power spectrogram and its inverse as matmul-DFTs on frames.

Port of `diffmusic_tpu/ops/stft.py` (`hann_window`, `_dft_basis`,
`frame_signal`, `stft`, `spectrogram`, `magphase_spectrogram`, `istft`,
`overlap_add`): `torch.stft` / `torch.istft` semantics with `center=True` and
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


def _padded_window(win_length: int, n_fft: int, use_hann: bool, dtype, device):
    """The window, Hann or rectangular, zero-padded to n_fft at the centre."""
    w = (hann_window(win_length, dtype, device) if use_hann
         else torch.ones(win_length, dtype=dtype, device=device))
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        w = F.pad(w, (lpad, n_fft - win_length - lpad))
    return w


def stft(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 160,
         win_length: int = 1024, center: bool = True, use_hann: bool = False):
    """Onesided STFT: (real, imag), each (..., n_freqs, num_frames).
    use_hann=False is `torch.stft(window=None)`, a rectangular window."""
    if win_length > n_fft:
        raise ValueError("win_length must not exceed n_fft")
    frames = frame_signal(x, n_fft, hop_length, center)
    if use_hann:
        # window the frames, then the plain basis: the JAX package's order, so
        # that both round alike
        frames = frames * _padded_window(win_length, n_fft, True, frames.dtype,
                                         frames.device)
    cos_b, sin_b = _basis(n_fft, frames.device, frames.dtype)
    return (frames @ cos_b).transpose(-1, -2), (frames @ sin_b).transpose(-1, -2)


def spectrogram(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 160,
                win_length: int = 1024, power: float = 2.0, center: bool = True,
                use_hann: bool = True) -> torch.Tensor:
    """|STFT|^power (torchaudio.transforms.Spectrogram semantics).

    Returns (..., n_freqs, num_frames)."""
    re, im = stft(x, n_fft, hop_length, win_length, center, use_hann)
    mag_sq = re * re + im * im
    if power == 2.0:
        return mag_sq
    if power == 1.0:
        return torch.sqrt(mag_sq + 1e-24)
    return torch.pow(mag_sq + 1e-24, power / 2.0)


def magphase_spectrogram(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 160,
                         win_length: int = 1024, center: bool = True):
    """(magnitude, phase) of the rectangular-window STFT."""
    re, im = stft(x, n_fft, hop_length, win_length, center, use_hann=False)
    return torch.sqrt(re * re + im * im + 1e-24), torch.atan2(im, re)


@functools.lru_cache(maxsize=16)
def _inverse_basis(n_fft: int, device: torch.device, dtype: torch.dtype):
    """(cos, sin) inverse real-DFT bases, (n_fft, n_freqs) each, with the
    onesided storage's interior bins (and an odd n_fft's last) counted twice."""
    cos_b, sin_b = _dft_basis(n_fft)
    n_freqs = n_fft // 2 + 1
    scale = np.ones((n_freqs,), np.float32)
    scale[1:-1] = 2.0
    if n_fft % 2 == 1:
        scale[-1] = 2.0
    return tuple(torch.as_tensor((b * scale[None, :] / n_fft).astype(np.float32),
                                 dtype=dtype, device=device) for b in (cos_b, sin_b))


def istft(re: torch.Tensor, im: torch.Tensor, n_fft: int = 1024, hop_length: int = 160,
          win_length: int = 1024, center: bool = True, use_hann: bool = False,
          length=None) -> torch.Tensor:
    """Inverse onesided STFT (`torch.istft` semantics) of (..., n_freqs,
    num_frames) real and imaginary parts: inverse-DFT matmuls, the window,
    overlap-add, division by the window's squared envelope (floored at
    1e-11) and the centre crop."""
    if re.shape[-2] != n_fft // 2 + 1:
        raise ValueError(f"expected {n_fft // 2 + 1} frequency bins, got {re.shape[-2]}")
    num_frames = re.shape[-1]
    inv_cos, inv_sin = _inverse_basis(n_fft, re.device, re.dtype)
    frames = re.transpose(-1, -2) @ inv_cos.T + im.transpose(-1, -2) @ inv_sin.T
    w = _padded_window(win_length, n_fft, use_hann, frames.dtype, frames.device)
    y = overlap_add(frames * w, hop_length)
    env = overlap_add((w * w).float().expand(num_frames, n_fft), hop_length)
    y = y / torch.clamp(env, min=1e-11).to(y.dtype)
    if center:
        y = y[..., n_fft // 2:]
        return y[..., :hop_length * (num_frames - 1) if length is None else length]
    return y if length is None else y[..., :length]


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """(..., T, n_fft) -> (..., (T - 1) * hop + n_fft): frame t added at
    offset t * hop (the adjoint of `frame_signal` without its padding).
    Shifted-sum form: each frame is cut into ceil(n_fft / hop) hop-sized
    chunks, and chunk c of every frame lands at row t + c of a
    (T + k - 1, hop) grid."""
    *batch, t, n_fft = frames.shape
    k = -(-n_fft // hop_length)
    fr = F.pad(frames, (0, k * hop_length - n_fft)).reshape(*batch, t, k, hop_length)
    out = frames.new_zeros(*batch, t + k - 1, hop_length)
    for c in range(k):
        out[..., c:c + t, :] += fr[..., :, c, :]
    return out.reshape(*batch, (t + k - 1) * hop_length)[..., :(t - 1) * hop_length + n_fft]
