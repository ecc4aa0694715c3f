"""Log-spectral distance (reference: diffmusic/metrics/lsd.py:17-40).

Exact reference formula: LSD = mean over frames of
sqrt(mean over freq of (log10(|STFT_bg| + eps) - log10(|STFT_ev| + eps))^2),
with librosa.stft conventions — periodic Hann window of n_fft, center=True,
ZERO pad (librosa's pad_mode='constant'), onesided rFFT. Implemented in plain
numpy (host-side metric, like the reference's librosa path); parity with a
torch.stft replication of the reference is tested at 1e-6
(tests/test_metrics.py::TestLSDReferenceParity).

A copy of `diffmusic_tpu/metrics/lsd.py` (numpy only): the JAX package's
`metrics/__init__.py` imports jax, so the port keeps its own.
"""

from dataclasses import dataclass
from typing import Sequence

import numpy as np


def _periodic_hann(n: int) -> np.ndarray:
    # scipy.signal.get_window('hann', n, fftbins=True), librosa's default
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


@dataclass
class LogSpectralDistance:
    sample_rate: int = 16000
    n_fft: int = 1024
    hop_length: int = 160
    eps: float = 1e-10

    def _log_spec(self, wav: np.ndarray) -> np.ndarray:
        """log10(|STFT| + eps), STFT framed exactly like librosa.stft:
        center zero-pad n_fft//2, periodic hann of n_fft, hop hop_length."""
        x = np.asarray(wav, np.float32).reshape(-1)
        pad = self.n_fft // 2
        x = np.pad(x, (pad, pad))
        n_frames = 1 + (x.size - self.n_fft) // self.hop_length
        idx = (np.arange(self.n_fft)[None, :]
               + self.hop_length * np.arange(n_frames)[:, None])
        frames = x[idx] * _periodic_hann(self.n_fft)[None, :].astype(np.float32)
        mag = np.abs(np.fft.rfft(frames, self.n_fft, axis=1)).T  # (F, T)
        return np.log10(mag + self.eps)

    def score(self, background: Sequence[np.ndarray],
              eval_set: Sequence[np.ndarray]) -> float:
        total, n = 0.0, min(len(background), len(eval_set))
        for bg, ev in zip(background[:n], eval_set[:n]):
            m = min(np.size(bg), np.size(ev))
            # the reference sanitizes the eval waveform, not the spectrogram
            # (metrics/lsd.py:22)
            ev = np.nan_to_num(np.asarray(ev, np.float64),
                               nan=0.0, posinf=1.0, neginf=-1.0)
            a = self._log_spec(np.asarray(bg).reshape(-1)[:m])
            b = self._log_spec(np.asarray(ev).reshape(-1)[:m])
            # sqrt of mean over freq, then mean over frames (lsd.py:33-35)
            d = np.sqrt(np.mean((a - b) ** 2, axis=0))
            total += float(d.mean())
        return total / max(n, 1)
