"""The plain reference of the guided loss head: the operators A(.), the
supervision transform (a Hann-window power mel in dB, torchaudio's
semantics with `center=True` and reflect padding) and the per-clip
Frobenius loss. A frozen copy of the mathematics of
`diffmusic_tpu_torch/{ops/stft.py,ops/mel.py,ops/filters.py,
inverse_problem/operator.py}` and `pipelines/musicldm.py::per_clip_loss`. It
imports nothing of the port.
"""

import numpy as np
import torch
import torch.nn.functional as F

N_FFT, HOP, WIN, N_MELS = 1024, 160, 1024, 64


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int) -> np.ndarray:
    """Triangular HTK filterbank without norm, (n_freqs, n_mels)."""
    freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    f_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sample_rate / 2.0), n_mels + 2))
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def db_mel(audio: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """10 log10(max(mel power, 1e-10)) of (B, L) audio: (B, n_mels, frames)."""
    x = F.pad(audio[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP)                                # (B, T, n_fft)
    n = np.arange(WIN)
    window = torch.as_tensor(0.5 - 0.5 * np.cos(2.0 * np.pi * n / WIN), dtype=audio.dtype,
                             device=audio.device)
    frames = frames * window
    k = np.arange(N_FFT // 2 + 1)[None, :]
    ang = 2.0 * np.pi * np.arange(N_FFT)[:, None] * k / N_FFT
    cos_b = torch.as_tensor(np.cos(ang).astype(np.float32), dtype=audio.dtype,
                            device=audio.device)
    sin_b = torch.as_tensor((-np.sin(ang)).astype(np.float32), dtype=audio.dtype,
                            device=audio.device)
    re, im = frames @ cos_b, frames @ sin_b                          # (B, T, n_freqs)
    power = (re * re + im * im).transpose(-1, -2)
    fb = torch.as_tensor(mel_filterbank(N_FFT // 2 + 1, N_MELS, sample_rate),
                         dtype=audio.dtype, device=audio.device)
    mel = torch.einsum("...ft,fm->...mt", power, fb)
    return 10.0 * torch.log10(torch.clamp(mel, min=1e-10))


def impulse_response(seed: int, length: int, decay: float) -> torch.Tensor:
    """The dereverberation operator's response: the cumulative sum of `length`
    normal draws of a CPU generator seeded with `seed`, times `decay`, scaled
    to a peak of 1."""
    noise = torch.randn(length, generator=torch.Generator().manual_seed(seed))
    ir = torch.cumsum(noise, 0) * decay
    return ir / ir.abs().max()


class Operator:
    """A(.) and the supervision transform of one traffic mix's task:
    "music_inpainting" (a box mask in time; the dB mel unclamped) or
    "music_dereverberation" (cross-correlation with the response, padded by
    half its length; the dB mel clamped to [-80, 80])."""

    def __init__(self, task: dict, length: int, sample_rate: int, ir_seed: int, device):
        self.kind, self.sample_rate = task["name"], sample_rate
        if self.kind == "music_inpainting":
            mask = np.ones((1, length), np.float32)
            mask[:, int(task["start_frac"] * length):int(task["end_frac"] * length)] = 0.0
            self.mask = torch.as_tensor(mask, device=device)
        elif self.kind == "music_dereverberation":
            self.ir = impulse_response(ir_seed, task["ir_length"], task["decay"]).to(device)
        elif self.kind != "music_generation":
            raise ValueError(f"no reference operator for task {self.kind!r}")

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        if self.kind == "music_inpainting":
            return audio * self.mask[..., :audio.shape[-1]].to(audio.dtype)
        if self.kind == "music_dereverberation":
            k = self.ir.to(audio.dtype)
            return F.conv1d(audio[:, None], k[None, None], padding=k.shape[0] // 2)[:, 0]
        return audio

    def transform(self, audio: torch.Tensor) -> torch.Tensor:
        db = db_mel(audio, self.sample_rate)
        return db if self.kind == "music_inpainting" else torch.clamp(db, -80.0, 80.0)


def per_clip_loss(target: torch.Tensor, op: Operator, audio: torch.Tensor) -> torch.Tensor:
    """sum over clips of || target - transform(A(audio)) ||_F."""
    diff = target - op.transform(op.forward(audio))
    return diff.reshape(diff.shape[0], -1).square().sum(1).sqrt().sum()
