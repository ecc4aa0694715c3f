"""Polyphase windowed-sinc resampling (torchaudio.transforms.Resample math).

Port of `diffmusic_tpu/ops/resample.py`: `resample_kernel` is a numpy copy,
and `resample` is one strided `F.conv1d` of the phases' kernels followed by
the interleave of the phases, on the tensor's device.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F


def resample_kernel(orig_freq: int, new_freq: int,
                    lowpass_filter_width: int = 6, rolloff: float = 0.99):
    """Sinc-interp kernel with Hann window (torchaudio default method).

    Returns (kernel, width, orig, new): kernel has shape (new, kernel_width)
    with the gcd-reduced rates orig and new; width is the one-sided pad in
    input samples.
    """
    gcd = math.gcd(int(orig_freq), int(new_freq))
    orig = int(orig_freq) // gcd
    new = int(new_freq) // gcd

    base_freq = min(orig, new) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig / base_freq))

    idx = np.arange(-width, width + orig, dtype=np.float64) / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx[None, :]
    t = t * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t = t * np.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel = kernel * window * (base_freq / orig)
    return kernel.astype(np.float32), width, orig, new


def resample(x: torch.Tensor, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 6, rolloff: float = 0.99) -> torch.Tensor:
    """Resample (..., L) -> (..., ceil(L * new / orig))."""
    if orig_freq == new_freq:
        return x
    kernel, width, orig, new = resample_kernel(orig_freq, new_freq,
                                               lowpass_filter_width, rolloff)
    length = x.shape[-1]
    batch_shape = x.shape[:-1]
    xb = F.pad(x.reshape(-1, 1, length), (width, width + orig))
    k = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)[:, None, :]  # (new, 1, Kw)
    y = F.conv1d(xb, k, stride=orig)                 # (B, new, L // orig + 1)
    # interleave the phases: (B, new, frames) -> (B, frames * new)
    y = y.transpose(1, 2).reshape(xb.shape[0], -1)
    target_length = int(math.ceil(new * length / orig))
    return y[:, :target_length].reshape(*batch_shape, target_length)
