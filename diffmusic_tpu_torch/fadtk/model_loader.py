"""Embedding models for FAD evaluation (port of
`diffmusic_tpu/fadtk/model_loader.py`).

Every loader has `name`, `sr`, `load_model()` and `get_embedding(audio) ->
(frames, dim)`, the registry surface of the vendored fadtk the reference
evaluates with (fadtk/model_loader.py:21-86). Ported: `mfcc-stack` (no
weights) and `vggish` (the native network from a local torchvggish state
dict). Weights come from a local checkpoint directory (`checkpoint_dir`, else
the `DIFFMUSIC_TPU_CHECKPOINTS` environment variable); a missing checkpoint
raises naming the expected path. Every other embedder of the JAX package's
zoo raises `NotImplementedError`; none falls back to another embedder.
"""

import os
from abc import ABC, abstractmethod
from pathlib import Path
from typing import List, Optional

import numpy as np

# the JAX package's zoo beyond the ported loaders (ROADMAP.md, Queue 1 item 12)
NOT_PORTED = ("clap-laion", "encodec-emb", "MERT-v1-95M", "w2v2-", "hubert-", "wavlm-",
              "whisper-", "dac-44kHz", "cdpam-", "clap-2023")


def _checkpoint_root(checkpoint_dir=None) -> Optional[Path]:
    d = checkpoint_dir or os.environ.get("DIFFMUSIC_TPU_CHECKPOINTS")
    return Path(d) if d else None


class ModelLoader(ABC):
    """Embedding model interface (reference fadtk/model_loader.py:21-86),
    on `device`."""

    def __init__(self, name: str, num_features: int, sr: int,
                 audio_len: Optional[float] = None, device="cuda"):
        self.name = name
        self.num_features = num_features
        self.sr = sr
        self.audio_len = audio_len
        self.device = device
        self.model = None
        self.loaded = False

    def get_embedding(self, audio: np.ndarray) -> np.ndarray:
        if not self.loaded:
            self.load_model()
            self.loaded = True
        return np.asarray(self._get_embedding(audio), np.float32)

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        return self.get_embedding(audio)

    @abstractmethod
    def load_model(self):
        ...

    @abstractmethod
    def _get_embedding(self, audio: np.ndarray) -> np.ndarray:
        ...

    def load_wav(self, wav_file):
        """A file as mono float32 at `sr` (scipy's polyphase resampler, as
        the JAX package's loader)."""
        from ..data import read_audio
        wav, sr = read_audio(wav_file)
        wav = wav.mean(axis=0)
        if sr != self.sr:
            from scipy.signal import resample_poly
            wav = resample_poly(wav, self.sr, sr)
        return wav.astype(np.float32)


class MFCCStackLoader(ModelLoader):
    """The deterministic default (metrics/embeddings.py)."""

    def __init__(self, device="cuda"):
        super().__init__("mfcc-stack", 160, 16000, device=device)

    def load_model(self):
        from ..metrics.embeddings import MFCCStackEmbedding
        self.model = MFCCStackEmbedding(self.device)

    def _get_embedding(self, audio):
        return self.model(audio)


class VGGishModel(ModelLoader):
    """VGGish (reference diffmusic/metrics/fad.py:59 pulls it from torch.hub):
    the native network (metrics/vggish.py) from `vggish.pth`, `vggish.npz`
    or `weights.pth`, a torchvggish state dict, under `<checkpoints>/vggish/`."""

    subdir = "vggish"

    def __init__(self, checkpoint_dir=None, device="cuda"):
        super().__init__("vggish", 128, 16000, device=device)
        self.checkpoint_dir = checkpoint_dir

    def _resolve(self) -> Path:
        root = _checkpoint_root(self.checkpoint_dir)
        if root is None:
            raise FileNotFoundError(
                f"Embedding model '{self.name}' needs local weights. Set "
                f"DIFFMUSIC_TPU_CHECKPOINTS=<dir> containing '{self.subdir}', or pass "
                f"checkpoint_dir=.")
        path = root / self.subdir
        if not path.exists():
            raise FileNotFoundError(
                f"Embedding model '{self.name}': expected checkpoint at {path}")
        return path

    def load_model(self):
        path = self._resolve()
        for fname in ("vggish.pth", "vggish.npz", "weights.pth"):
            if (path / fname).exists():
                from ..metrics.vggish import load_vggish
                self.model, self.pca = load_vggish(path / fname, self.device)
                return
        raise FileNotFoundError(
            f"Embedding model 'vggish': no vggish.pth, vggish.npz or weights.pth in {path}")

    def _get_embedding(self, audio):
        from ..metrics.vggish import vggish_embedding
        return vggish_embedding(self.model, self.pca, np.asarray(audio, np.float32))


def get_all_models(checkpoint_dir=None, device="cuda") -> List[ModelLoader]:
    """The ported loaders. Lazy: enumeration never touches disk."""
    return [MFCCStackLoader(device), VGGishModel(checkpoint_dir, device)]


def get_model(name: str, checkpoint_dir=None, device="cuda") -> ModelLoader:
    for m in get_all_models(checkpoint_dir, device):
        if m.name == name:
            return m
    if name.startswith(NOT_PORTED):
        raise NotImplementedError(
            f"Embedding model '{name}' is not ported to PyTorch yet (ROADMAP.md, Queue 1 "
            f"item 12); ported: mfcc-stack, vggish")
    raise ValueError(f"Unknown embedding model '{name}'. Ported: mfcc-stack, vggish")
