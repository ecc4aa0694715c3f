"""Audio embedding models for FAD/KL evaluation.

Port of `diffmusic_tpu/metrics/embeddings.py`. The default embedder is
deterministic and needs no download: per ~0.96 s window, the mean and the
population deviation of 40 MFCCs and of their deltas, a 160-d vector
(VGGish-like framing: 16 kHz, 25 ms / 10 ms frames, 96-frame windows at a
48-frame hop). Its mel runs on the fused mel spectrogram kernel
(`kernels/mel.py`) on the card, or its plain version on the CPU.

Interface: model(waveform_16k: (n,) float32) -> (num_frames, dim) numpy.
"""

import numpy as np
import torch

from ..kernels.mel import fused_mel_spectrogram


def _dct_matrix(n_filters: int, n_coeffs: int) -> np.ndarray:
    """Orthonormal type-II DCT matrix (n_filters, n_coeffs)."""
    n = np.arange(n_filters)[:, None]
    k = np.arange(n_coeffs)[None, :]
    m = np.cos(np.pi / n_filters * (n + 0.5) * k)
    m *= np.sqrt(2.0 / n_filters)
    m[:, 0] *= np.sqrt(0.5)
    return m.astype(np.float32)


class MFCCStackEmbedding:
    """The 160-d MFCC statistics embedder, on `device` ("cuda" by default)."""

    name = "mfcc-stack"

    def __init__(self, device="cuda", sample_rate: int = 16000, n_mels: int = 64,
                 n_mfcc: int = 40, window_frames: int = 96, hop_frames: int = 48):
        self.device = torch.device(device)
        self.sample_rate = sample_rate
        self.n_mels = n_mels
        self.n_mfcc = n_mfcc
        self.window_frames = window_frames
        self.hop_frames = hop_frames
        self.dct = torch.as_tensor(_dct_matrix(n_mels, n_mfcc), device=self.device)

    @property
    def dim(self) -> int:
        return 4 * self.n_mfcc

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L) waveforms -> (B, windows, 4 * n_mfcc)."""
        mel = fused_mel_spectrogram(x, 400, 160, 400, self.n_mels, self.sample_rate,
                                    125.0, 7500.0)                     # (B, n_mels, T)
        mfcc = torch.log(mel + 1e-6).transpose(1, 2) @ self.dct        # (B, T, n_mfcc)
        if mfcc.shape[1] < self.window_frames:
            mfcc = torch.nn.functional.pad(mfcc, (0, 0, 0, self.window_frames - mfcc.shape[1]))
        w = mfcc.unfold(1, self.window_frames, self.hop_frames)        # (B, W, n_mfcc, 96)
        d = torch.diff(w, dim=-1)
        # population deviations (jnp.std), not torch's default correction=1
        return torch.cat([w.mean(-1), w.std(-1, correction=0),
                          d.mean(-1), d.std(-1, correction=0)], dim=-1)

    def batch_embed(self, wavs: np.ndarray) -> np.ndarray:
        """A (B, L) batch of equal-length waveforms -> (B, windows, dim) numpy."""
        x = torch.as_tensor(np.asarray(wavs, np.float32), device=self.device)
        with torch.no_grad():
            return self.embed(x).cpu().numpy()

    def __call__(self, wav: np.ndarray) -> np.ndarray:
        wav = np.asarray(wav, np.float32).reshape(-1)
        return self.batch_embed(wav[None])[0]


def get_embedding_model(name: str = "mfcc-stack", checkpoint_dir=None, device="cuda"):
    """'mfcc-stack' needs no weights; 'vggish' runs from a local torchvggish
    state dict (`fadtk/model_loader.py::VGGishModel`); no other embedder is
    ported yet."""
    if name == "mfcc-stack":
        return MFCCStackEmbedding(device)
    from ..fadtk.model_loader import get_model
    m = get_model(name, checkpoint_dir=checkpoint_dir, device=device)
    m.load_model()
    m.loaded = True

    def embed(wav: np.ndarray) -> np.ndarray:
        return m.get_embedding(np.asarray(wav, np.float32).reshape(-1))

    embed.name = name
    embed.dim = m.num_features
    return embed
