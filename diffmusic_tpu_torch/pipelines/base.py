"""Shared pipeline machinery (port of `diffmusic_tpu/pipelines/base.py`):
geometry, initial latents, the denoise loop, the NaN retry, DITTO's outer
loop, the mel PNG and the phase-aware mel -> waveform.

The JAX package compiles the denoise loop into one `lax.scan`; here it is a
Python loop. The guided loop runs the UNet under `torch.no_grad()` and each
guided step takes its own gradient; DITTO's chain is differentiated whole,
one `torch.utils.checkpoint` per step (JAX's `jax.checkpoint(body)`).
"""

import functools
import struct
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..inverse_problem.noise import randn
from ..ops.mel import InverseMelScale
from ..ops.stft import istft
from ..parallel import mesh as pmesh
from ..tracing import annotate


@dataclass
class AudioPipelineOutput:
    audios: np.ndarray


def byte_tokenizer(texts, maxlen: int = 12):
    """A vocabulary-free tokenizer for random-weight runs (the JAX tiny
    pipelines' own): <s> (0), the prompt's UTF-8 bytes mapped into
    [2, 252), </s> (2), then padding (1). Returns numpy (ids,
    attention_mask), (len(texts), maxlen) int32."""
    ids = np.ones((len(texts), maxlen), np.int32)
    mask = np.zeros((len(texts), maxlen), np.int32)
    for i, t in enumerate(texts):
        row = [0] + [2 + (c % 250) for c in t.encode("utf-8")[:maxlen - 2]] + [2]
        ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    return ids, mask


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


def _progress_print(t, loss):
    print(f"  t={int(t):4d}  distance: {float(loss):.6f}")


def run_denoise_loop(step_fn, model_fn, latents: torch.Tensor, timesteps,
                     generator: Optional[torch.Generator] = None,
                     callback: Optional[Callable] = None, callback_steps: int = 1,
                     progress: bool = False, grad: bool = False, remat: bool = False,
                     draws=None):
    """`prev, x0, loss = step_fn(model_fn(x, t), t, x, generator)` over the
    timesteps. Returns (final latents, per-step losses (n,) fp32).

    By default the UNet runs under `torch.no_grad()` (a guided step takes its
    own gradient). With `grad` the whole chain is differentiable with
    respect to `latents`; `remat` then runs each step (UNet and step) under
    a non-reentrant `torch.utils.checkpoint`, which keeps one latent per step
    and recomputes the step in the backward. A checkpoint restores the global
    RNG in its recompute, not a generator passed in, so such a chain takes
    its steps' draws made beforehand: `draws[i]` goes to step i in the
    generator's place.

    Each step's model call is a "unet_forward" range and its step a
    "guided_step" range (`tracing.annotate`), as in the JAX package; each
    carries the step's (index, timestep) to the spans recorded inside it.

    `progress` prints each step's timestep and loss (a host read a step);
    callback(step_index, timestep, latents), if given, runs after every
    `callback_steps`-th step."""
    if remat and not grad:
        raise ValueError("remat recomputes a differentiated chain: pass grad=True")
    if grad and generator is not None:
        raise ValueError("a differentiated chain takes its draws in `draws`, not a generator")
    x = latents
    losses = []
    for i, t in enumerate(timesteps):
        t = int(t)
        arg = draws[i] if draws is not None else generator
        if grad:
            def body(x_in, arg_in, t=t, i=i):
                with annotate("unet_forward", (i, t)):
                    eps = model_fn(x_in, t)
                with annotate("guided_step", (i, t)):
                    prev, _x0, loss = step_fn(eps, t, x_in, arg_in)
                return prev, loss
            with torch.enable_grad():
                x, loss = (checkpoint(body, x, arg, use_reentrant=False) if remat
                           else body(x, arg))
        else:
            with torch.no_grad(), annotate("unet_forward", (i, t)):
                eps = model_fn(x, t)
            with annotate("guided_step", (i, t)):
                x, _x0, loss = step_fn(eps, t, x, arg)
        losses.append(loss.detach().float())
        if progress:
            _progress_print(t, loss)
        if callback is not None and i % max(1, callback_steps) == 0:
            callback(i, t, x.detach() if grad else x)
    return x, torch.stack(losses)


def denoise_with_nan_retry(run_fn, init_latents: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           max_retries: int = 10):
    """Rerun from fresh latents while the result holds NaNs, at most
    `max_retries` times (reference pipeline_musicldm.py:742-756). Under a
    mesh's sharded batch the whole batch decides, as in JAX: a NaN in one
    rank's clip redraws every rank's (`parallel.mesh.batch_any`,
    `batch_randn`)."""
    latents = init_latents
    for _ in range(max_retries + 1):
        final, losses = run_fn(latents)
        if not pmesh.batch_any(torch.isnan(losses[-1]) | torch.isnan(final).any()):
            return final, losses
        latents = pmesh.batch_randn(init_latents.shape, generator, init_latents.dtype,
                                    init_latents.device)
    return final, losses


def run_ditto(loss_of_init, init_latents: torch.Tensor, optim_outer_loop: int,
              lr: float):
    """DITTO: plain SGD on the initial latents through the whole chain, as
    `torch.optim.SGD([init_latents], lr)`. `loss_of_init(init)` -> (loss,
    final latents), differentiable with respect to `init`. Returns (the last
    iteration's final latents, the loss of each iteration (n,) fp32)."""
    latents = init_latents.detach()
    losses, final = [], None
    for _ in range(optim_outer_loop):
        with torch.enable_grad():
            leaf = latents.detach().requires_grad_(True)
            loss, final = loss_of_init(leaf)
            (grad,) = torch.autograd.grad(loss, leaf)
        losses.append(loss.detach().float())
        latents = latents - lr * grad
    return final.detach(), torch.stack(losses)


@functools.cache
def have_matplotlib() -> bool:
    """Whether matplotlib imports here; decided, and printed, at the first PNG."""
    try:
        import matplotlib   # noqa: F401
        found = True
    except ImportError:
        found = False
    print(f"save_mel_spectrogram: "
          f"{'matplotlib' if found else 'no matplotlib: 8-bit grey PNGs, no axes'}")
    return found


def write_grey_png(path, image: np.ndarray) -> None:
    """An 8-bit greyscale PNG of a (height, width) uint8 image, top row first."""
    h, w = image.shape
    raw = b"".join(b"\x00" + image[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def save_mel_spectrogram(mel: np.ndarray, path, sample_rate: int = 16000,
                         hop_length: int = 160, gt_mel_spectrogram=None,
                         gt_sample_rate: int = 16000):
    """Save a (T, n_mels) dB mel spectrogram as a PNG with matplotlib, as the
    JAX package does (magma, [-80, 80] dB, axes and colour bar; with a
    ground-truth mel the frequency axis is clamped to its Nyquist band).
    Without matplotlib: the dB mel clipped to [-80, 80] as an 8-bit grey
    image, low frequencies at the bottom, no axes."""
    mel = np.asarray(mel)
    while mel.ndim > 2:
        mel = mel[0]
    if not have_matplotlib():
        img = np.round((np.clip(mel.T[::-1], -80.0, 80.0) + 80.0) * (255.0 / 160.0))
        write_grey_png(Path(path), img.astype(np.uint8))
        return
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(10, 4))
    extent = [0, mel.shape[0] * hop_length / sample_rate, 0, sample_rate / 2]
    im = ax.imshow(mel.T, aspect="auto", origin="lower", extent=extent, cmap="magma",
                   vmin=-80, vmax=80)
    fig.colorbar(im, ax=ax, label="Amplitude (dB)")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("freq (Hz)")
    if gt_mel_spectrogram is not None:
        ax.set_ylim(0, gt_sample_rate / 2)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


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
