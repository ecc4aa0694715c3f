"""Embedding models for FAD evaluation (port of
`diffmusic_tpu/fadtk/model_loader.py`).

Every loader has `name`, `sr`, `load_model()` and `get_embedding(audio) ->
(frames, dim)`, the registry surface of the vendored fadtk the reference
evaluates with (fadtk/model_loader.py:21-86). Ported: `mfcc-stack` (no
weights), `vggish` (the native network from a local torchvggish state dict)
and `clap-laion-audio` / `clap-laion-music` (the port's HTSAT tower from a
local CLAP directory, `<checkpoints>/clap/`, fed 16 kHz audio that it
resamples to 48 kHz itself, as the JAX package's loader does: PARITY.md).
Weights come from a local checkpoint directory (`checkpoint_dir`, else the
`DIFFMUSIC_TPU_CHECKPOINTS` environment variable); a missing checkpoint
raises naming the expected path. Every other embedder of the JAX package's
zoo raises `NotImplementedError`; none falls back to another embedder.
"""

import os
from abc import ABC, abstractmethod
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

PORTED = "mfcc-stack, vggish, clap-laion-audio, clap-laion-music"
# the JAX package's zoo beyond the ported loaders (ROADMAP.md, Queue 1 item 8)
NOT_PORTED = ("encodec-emb", "MERT-v1-95M", "w2v2-", "hubert-", "wavlm-",
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


class _LocalCheckpointLoader(ModelLoader):
    """A loader whose weights live under `<checkpoints>/<subdir>`."""

    subdir = ""

    def __init__(self, name, num_features, sr, checkpoint_dir=None, device="cuda"):
        super().__init__(name, num_features, sr, device=device)
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


class VGGishModel(_LocalCheckpointLoader):
    """VGGish (reference diffmusic/metrics/fad.py:59 pulls it from torch.hub):
    the native network (metrics/vggish.py) from `vggish.pth`, `vggish.npz`
    or `weights.pth`, a torchvggish state dict, under `<checkpoints>/vggish/`."""

    subdir = "vggish"

    def __init__(self, checkpoint_dir=None, device="cuda"):
        super().__init__("vggish", 128, 16000, checkpoint_dir, device)

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


class CLAPLaionModel(_LocalCheckpointLoader):
    """LAION-CLAP audio embeddings through the port's HTSAT tower, read from
    a local CLAP directory (`<checkpoints>/clap/`: a ClapModel or
    ClapAudioModelWithProjection config.json and safetensors). The declared
    rate is 16 kHz: `prepare_clap_input` resamples to 48 kHz itself (the
    reference's laion_clap takes 48 kHz directly)."""

    subdir = "clap"

    def __init__(self, type: str = "audio", checkpoint_dir=None, device="cuda"):
        super().__init__(f"clap-laion-{type}", 512, 16000, checkpoint_dir, device)
        self.type = type

    def load_model(self):
        from ..models import checkpoint as ckpt
        from ..models.clap_features import make_clap_audio_embed
        from ..models.htsat import ClapAudioModelWithProjection
        path = self._resolve()
        cfg = ckpt.clap_audio_config_from_json(ckpt._cfg(path))
        tree = ckpt.clap_audio_tree(ckpt._load_module_sd(path), cfg)
        with torch.device("meta"):
            tower = ClapAudioModelWithProjection(cfg)
        self.model = make_clap_audio_embed(ckpt._build(tower, tree, cfg, self.device,
                                                       torch.float32))

    @torch.no_grad()
    def _get_embedding(self, audio):
        # the reference's frame contract (fadtk/model_loader.py:391-412): the
        # int16 round trip, 10-s chunks at a 1-s hop (the tail zero-padded),
        # one embedding a chunk; the chunks go through the tower as one batch
        x = np.asarray(audio, np.float32)
        x = (np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16) / 32767.0
        chunk, hop = 10 * self.sr, self.sr
        rows = [np.pad(x[i:i + chunk], (0, max(chunk - len(x[i:i + chunk]), 0)))
                for i in range(0, max(len(x), 1), hop)]
        return self.model(torch.from_numpy(np.stack(rows).astype(np.float32))).cpu().numpy()


def get_all_models(checkpoint_dir=None, device="cuda") -> List[ModelLoader]:
    """The ported loaders. Lazy: enumeration never touches disk."""
    return [MFCCStackLoader(device), VGGishModel(checkpoint_dir, device),
            CLAPLaionModel("audio", checkpoint_dir, device),
            CLAPLaionModel("music", checkpoint_dir, device)]


def get_model(name: str, checkpoint_dir=None, device="cuda") -> ModelLoader:
    for m in get_all_models(checkpoint_dir, device):
        if m.name == name:
            return m
    if name.startswith(NOT_PORTED):
        raise NotImplementedError(
            f"Embedding model '{name}' is not ported to PyTorch yet (ROADMAP.md, Queue 1 "
            f"item 8); ported: {PORTED}")
    raise ValueError(f"Unknown embedding model '{name}'. Ported: {PORTED}")
