"""Shared pipeline machinery (port of `diffmusic_tpu/pipelines/base.py`):
geometry, initial latents, the denoise loop, the NaN retry and the
phase-aware mel -> waveform.

The JAX package compiles the denoise loop into one `lax.scan`; here it is a
Python loop, with the UNet under `torch.no_grad()` and the guided step taking
its own gradient.
"""

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..inverse_problem.noise import randn
from ..ops.mel import InverseMelScale
from ..ops.stft import istft


@dataclass
class AudioPipelineOutput:
    audios: np.ndarray


def compute_geometry(audio_length_in_s: float, sampling_rate: int,
                     hop_length: int, vae_scale_factor: int):
    """Spectrogram height + original waveform length."""
    height = int(audio_length_in_s / (hop_length / sampling_rate))
    original_waveform_length = int(audio_length_in_s * sampling_rate)
    if height % vae_scale_factor != 0:
        height = int(np.ceil(height / vae_scale_factor)) * vae_scale_factor
    return height, original_waveform_length


def prepare_latents(generator: torch.Generator, batch: int, channels: int,
                    height: int, width: int, vae_scale_factor: int,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    shape = (batch, channels, height // vae_scale_factor, width // vae_scale_factor)
    return randn(shape, generator, dtype, device)


def run_denoise_loop(step_fn, model_fn, latents: torch.Tensor, timesteps,
                     generator: Optional[torch.Generator] = None,
                     callback: Optional[Callable] = None):
    """`prev, x0, loss = step_fn(model_fn(x, t), t, x, generator)` over the
    timesteps. Returns (final latents, per-step losses (n,) fp32).

    callback(step_index, timestep, latents), if given, runs after each step."""
    x = latents
    losses = []
    for i, t in enumerate(timesteps):
        t = int(t)
        with torch.no_grad():
            eps = model_fn(x, t)
        x, _x0, loss = step_fn(eps, t, x, generator)
        losses.append(loss.float())
        if callback is not None:
            callback(i, t, x)
    return x, torch.stack(losses)


def denoise_with_nan_retry(run_fn, init_latents: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           max_retries: int = 10):
    """Rerun from fresh latents while the result holds NaNs, at most
    `max_retries` times (reference pipeline_musicldm.py:742-756)."""
    latents = init_latents
    for _ in range(max_retries + 1):
        final, losses = run_fn(latents)
        if not bool(torch.isnan(losses[-1])) and not bool(torch.isnan(final).any()):
            return final, losses
        latents = randn(init_latents.shape, generator, init_latents.dtype,
                        init_latents.device)
    return final, losses


def mel_spectrogram_to_waveform_with_phase(mel, phase: torch.Tensor, n_fft: int = 1024,
                                           hop_length: int = 160, win_length: int = 1024,
                                           sample_rate: int = 16000,
                                           original_waveform_length: int = 0,
                                           linear_magnitude: Optional[torch.Tensor] = None
                                           ) -> torch.Tensor:
    """Phase-aware mel -> waveform: the linear magnitude (given, or the mel's
    pinv inversion), the known phase, the rectangular-window `istft`, then
    cropped or zero-padded to `original_waveform_length` (if > 0).

    mel: (B, 1, T, n_mels) or (B, T, n_mels) magnitude-scale mel (unused when
    `linear_magnitude` is given); phase and linear_magnitude: (..., n_freqs,
    frames)."""
    if linear_magnitude is not None:
        linear = linear_magnitude
    else:
        if mel.ndim == 4:
            mel = mel[:, 0]
        mel = mel.transpose(-1, -2)   # (B, n_mels, T)
        linear = InverseMelScale(n_stft=n_fft // 2 + 1, n_mels=mel.shape[-2],
                                 sample_rate=sample_rate)(mel)
    frames = min(linear.shape[-1], phase.shape[-1])
    linear, phase = linear[..., :frames], phase[..., :frames]
    wav = istft(linear * torch.cos(phase), linear * torch.sin(phase), n_fft=n_fft,
                hop_length=hop_length, win_length=win_length)
    if original_waveform_length > 0:
        wav = wav[..., :original_waveform_length]
        if wav.shape[-1] < original_waveform_length:
            wav = F.pad(wav, (0, original_waveform_length - wav.shape[-1]))
    return wav
