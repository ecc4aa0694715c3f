"""Embedding models for FAD evaluation (port of
`diffmusic_tpu/fadtk/model_loader.py`).

Every loader has `name`, `sr`, `load_model()` and `get_embedding(audio) ->
(frames, dim)`, the registry surface of the vendored fadtk the reference
evaluates with (fadtk/model_loader.py:21-86), and runs on `device`.
`get_all_models` lists the JAX package's 147 names in its order, with the same
`sr`, `num_features` and weights directory (`<checkpoints>/<subdir>`):

- `mfcc-stack` (no weights);
- `vggish`: the native network from a torchvggish state dict;
- `clap-laion-audio` / `-music`: the port's HTSAT tower, fed 16 kHz audio
  that it resamples to 48 kHz itself, as the JAX package's loader does
  (PARITY.md);
- `encodec-emb` / `-48k`, `MERT-v1-95M*`, `w2v2-*`, `hubert-*`, `wavlm-*`,
  `whisper-*`: the networks the JAX package runs through transformers,
  written natively (`models/wav2vec2.py`, `models/whisper.py`,
  `models/encodec.py`) and read from the same HF snapshots
  (`models/checkpoint.py::load_wav2vec2` etc.), with TF32 off
  (`full_fp32`): fp32 throughout, as the JAX package's CPU path;
- `dac-44kHz`, `cdpam-*`, `clap-2023`: the JAX package's loaders around the
  `dac`, `cdpam` and `msclap` packages, which raise ImportError where the
  package is missing.

Weights come from a local checkpoint directory (`checkpoint_dir`, else the
`DIFFMUSIC_TPU_CHECKPOINTS` environment variable); a missing checkpoint raises
naming the expected path. No loader falls back to another embedder.
"""

import contextlib
import os
from abc import ABC, abstractmethod
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def full_fp32():
    """cuDNN's convolutions and cuBLAS's matmuls in full fp32 (TF32 off)
    inside the block, the switches restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


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


class _HFFeatureLoader(_LocalCheckpointLoader):
    """Hidden-state embeddings of a wav2vec2 / HuBERT / WavLM snapshot (the
    w2v2, HuBERT, WavLM and MERT family; reference fadtk/model_loader.py:524-632).
    The unsuffixed names mean the final layer, resolved against the loaded
    depth (the JAX package's rule, so that snapshots of any depth keep it).
    The audio is fed raw, without the feature extractor's normalisation, as
    the JAX package feeds it."""

    def __init__(self, name, num_features, sr, subdir, layer=None, checkpoint_dir=None,
                 final_layer=False, device="cuda"):
        super().__init__(name, num_features, sr, checkpoint_dir, device)
        self.subdir = subdir
        self.layer = layer
        self.final_layer = final_layer

    def load_model(self):
        from ..models.checkpoint import load_wav2vec2
        self.model = load_wav2vec2(self._resolve(), self.device)
        if self.final_layer:
            self.layer = self.model.cfg.num_hidden_layers

    @torch.no_grad()
    def _get_embedding(self, audio):
        x = torch.as_tensor(np.asarray(audio, np.float32), device=self.device)[None]
        with full_fp32():
            states = self.model(x)
        return states[-1 if self.layer is None else self.layer][0].cpu().numpy()


def _size_tag(prefix: str, size: str, layer: Optional[int], last: int) -> str:
    """The reference's naming (fadtk/model_loader.py:532): the final layer is
    the unsuffixed name, any other layer a -{layer} suffix."""
    return f"{prefix}-{size}" + ("" if layer in (None, last) else f"-{layer}")


class W2V2Model(_HFFeatureLoader):
    """wav2vec2 base / large per layer (reference fadtk/model_loader.py:524-558)."""

    def __init__(self, size: str = "base", layer: Optional[int] = None, checkpoint_dir=None,
                 device="cuda"):
        last = 12 if size == "base" else 24
        super().__init__(_size_tag("w2v2", size, layer, last), 768 if size == "base" else 1024,
                         16000, f"wav2vec2-{size}-960h", layer, checkpoint_dir,
                         final_layer=layer in (None, last), device=device)


class HuBERTModel(_HFFeatureLoader):
    def __init__(self, size: str = "base", layer: Optional[int] = None, checkpoint_dir=None,
                 device="cuda"):
        last = 12 if size == "base" else 24
        super().__init__(_size_tag("hubert", size, layer, last),
                         768 if size == "base" else 1024, 16000, f"hubert-{size}-ls960", layer,
                         checkpoint_dir, final_layer=layer in (None, last), device=device)


class WavLMModel(_HFFeatureLoader):
    def __init__(self, size: str = "base", layer: Optional[int] = None, checkpoint_dir=None,
                 device="cuda"):
        last = 12 if "base" in size else 24
        super().__init__(_size_tag("wavlm", size, layer, last),
                         768 if "base" in size else 1024, 16000, f"wavlm-{size}", layer,
                         checkpoint_dir, final_layer=layer in (None, last), device=device)


class MERTModel(_HFFeatureLoader):
    """MERT-v1-95M per layer (reference fadtk/model_loader.py:254-287), from a
    snapshot of model_type 'hubert'; MERT's own 'mert_model' type raises
    NotImplementedError, as the JAX package's AutoModel cannot load it
    either (ROADMAP Queue 3)."""

    def __init__(self, layer: int = 12, checkpoint_dir=None, device="cuda"):
        super().__init__(f"MERT-v1-95M-{layer}" if layer != 12 else "MERT-v1-95M", 768, 24000,
                         "MERT-v1-95M", layer, checkpoint_dir, final_layer=layer == 12,
                         device=device)


class WhisperModel(_LocalCheckpointLoader):
    """Whisper encoder embeddings (reference fadtk/model_loader.py:635-671):
    the log-mel features of the clip padded or cut to 30 s, through the
    encoder, `last_hidden_state[0]` (1500 frames)."""

    DIMS = {"tiny": 384, "base": 512, "small": 768, "medium": 1024, "large": 1280}

    def __init__(self, size: str = "tiny", checkpoint_dir=None, device="cuda"):
        super().__init__(f"whisper-{size}", self.DIMS[size], 16000, checkpoint_dir, device)
        self.subdir = f"whisper-{size}"

    def load_model(self):
        from ..models.checkpoint import load_whisper_encoder
        self.model, self.features = load_whisper_encoder(self._resolve(), self.device)

    @torch.no_grad()
    def _get_embedding(self, audio):
        from ..models.whisper import log_mel_features
        x = torch.as_tensor(np.asarray(audio, np.float32), device=self.device)[None]
        with full_fp32():
            h = self.model(log_mel_features(x, self.features))
        return h[0].cpu().numpy()


class EncodecEmbModel(_LocalCheckpointLoader):
    """EnCodec's continuous pre-quantisation embeddings (reference
    fadtk/model_loader.py:111-186): the encoder's output, (frames, 128). The
    clip goes in as one channel, as the JAX package feeds it, so a 2-channel
    snapshot (facebook/encodec_48khz) raises a ValueError naming
    `audio_channels` (the JAX package's fails in its first conv)."""

    def __init__(self, variant: str = "24k", checkpoint_dir=None, device="cuda"):
        super().__init__(f"encodec-emb{'' if variant == '24k' else '-48k'}", 128,
                         24000 if variant == "24k" else 48000, checkpoint_dir, device)
        self.subdir = f"encodec_{variant}"

    def load_model(self):
        from ..models.checkpoint import load_encodec_encoder
        self.model = load_encodec_encoder(self._resolve(), self.device)

    @torch.no_grad()
    def _get_embedding(self, audio):
        x = torch.as_tensor(np.asarray(audio, np.float32), device=self.device)[None, None]
        with full_fp32():
            emb = self.model(x)   # (1, 128, frames)
        return emb[0].T.cpu().numpy()


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


class DACModel(_LocalCheckpointLoader):
    """Descript audio codec encoder embeddings (reference
    fadtk/model_loader.py:189-251), through the `dac` package and
    `<checkpoints>/dac_44khz/weights.pth`; load_model raises ImportError where
    the package is missing. As in the JAX package, the loudness is an RMS dBFS
    proxy for -16 LUFS (audiotools is absent; PARITY.md); 5-s windows at 50 %
    overlap."""

    def __init__(self, checkpoint_dir=None, device="cuda"):
        super().__init__("dac-44kHz", 1024, 44100, checkpoint_dir, device)
        self.subdir = "dac_44khz"

    def load_model(self):
        try:
            import dac
        except ImportError as e:
            raise ImportError(
                "Embedding model 'dac-44kHz' needs the descript-audio-codec "
                "package (`dac`), which is not installed in this image") from e
        self.model = dac.DAC.load(str(self._resolve() / "weights.pth")).to(self.device).eval()

    @torch.no_grad()
    def _get_embedding(self, audio):
        audio = np.asarray(audio, np.float32)
        rms = float(np.sqrt(np.mean(audio ** 2))) if audio.size else 0.0
        if rms > 0:
            gain = 10.0 ** ((-16.0 - 20.0 * np.log10(rms)) / 20.0)
            audio = np.clip(audio * gain, -1.0, 1.0)
        win = 5 * self.sr
        frames = []
        for start in range(0, max(len(audio), 1), win // 2):
            chunk = audio[start:start + win]
            if len(chunk) == 0:
                break
            x = self.model.preprocess(torch.from_numpy(chunk)[None, None].to(self.device),
                                      self.sr)
            frames.append(self.model.encoder(x)[0].T.cpu().numpy())   # (frames, 1024)
            if start + win >= len(audio):
                break
        return np.concatenate(frames, axis=0)


class CdpamModel(_LocalCheckpointLoader):
    """CDPAM perceptual embeddings (reference fadtk/model_loader.py:420-459),
    through the `cdpam` package (ImportError where it is missing): one
    L2-normalised embedding a 1-s window."""

    def __init__(self, mode: str = "acoustic", checkpoint_dir=None, device="cuda"):
        super().__init__(f"cdpam-{mode}", 512, 22050, checkpoint_dir, device)
        self.mode = mode
        self.subdir = "cdpam"

    def load_model(self):
        try:
            import cdpam
        except ImportError as e:
            raise ImportError(
                "Embedding model 'cdpam-*' needs the `cdpam` package, which "
                "is not installed in this image") from e
        self.model = cdpam.CDPAM(dev=self.device)

    @torch.no_grad()
    def _get_embedding(self, audio):
        audio = np.asarray(audio, np.float32)
        frames = []
        for start in range(0, max(len(audio), 1), self.sr):
            chunk = audio[start:start + self.sr]
            if len(chunk) == 0:
                continue
            x = torch.from_numpy(np.round(chunk * 32768.0)).float()[None].to(self.device)
            _, acoustic, content = self.model.model.base_encoder.forward(x.unsqueeze(1))
            h = acoustic if self.mode == "acoustic" else content
            frames.append(torch.nn.functional.normalize(h, dim=1).cpu().numpy())
        return np.concatenate(frames, axis=0)


class MSCLAPModel(_LocalCheckpointLoader):
    """Microsoft CLAP 2023 audio embeddings (reference
    fadtk/model_loader.py:462-521), through the `msclap` package (ImportError
    where it is missing): 7-s windows at a 1-s hop."""

    def __init__(self, year: str = "2023", checkpoint_dir=None, device="cuda"):
        super().__init__(f"clap-{year}", 1024, 44100, checkpoint_dir, device)
        self.year = year
        self.subdir = f"msclap_{year}"

    def load_model(self):
        try:
            from msclap import CLAP
        except ImportError as e:
            raise ImportError(
                "Embedding model 'clap-2023' needs the `msclap` package, "
                "which is not installed in this image") from e
        self.model = CLAP(model_fp=str(self._resolve() / "CLAP_weights.pth"),
                          version=self.year, use_cuda=str(self.device) != "cpu")

    def _get_embedding(self, audio):
        import tempfile
        from scipy.io import wavfile
        audio = np.asarray(audio, np.float32)
        win, hop = 7 * self.sr, self.sr
        frames = []
        for start in range(0, max(len(audio), 1), hop):
            chunk = audio[start:start + win]
            if len(chunk) == 0:
                break
            with tempfile.NamedTemporaryFile(suffix=".wav") as f:   # msclap reads files
                wavfile.write(f.name, self.sr, chunk)
                emb = np.asarray(self.model.get_audio_embeddings([f.name])[0])
            frames.append(emb[None] if emb.ndim == 1 else emb)
            if start + win >= len(audio):
                break
        return np.concatenate(frames, axis=0)


def get_all_models(checkpoint_dir=None, device="cuda") -> List[ModelLoader]:
    """The zoo, in the JAX package's order (reference
    fadtk/model_loader.py:675-700). Lazy: enumeration never touches disk."""
    c, d = checkpoint_dir, device
    return [
        MFCCStackLoader(d), VGGishModel(c, d),
        CLAPLaionModel("audio", c, d), CLAPLaionModel("music", c, d),
        EncodecEmbModel("24k", c, d), EncodecEmbModel("48k", c, d),
        *(MERTModel(layer, c, d) for layer in range(1, 13)),
        *(W2V2Model("base", layer, c, d) for layer in range(1, 13)),
        *(W2V2Model("large", layer, c, d) for layer in range(1, 25)),
        *(HuBERTModel("base", layer, c, d) for layer in range(1, 13)),
        *(HuBERTModel("large", layer, c, d) for layer in range(1, 25)),
        *(WavLMModel("base", layer, c, d) for layer in range(1, 13)),
        *(WavLMModel("base-plus", layer, c, d) for layer in range(1, 13)),
        *(WavLMModel("large", layer, c, d) for layer in range(1, 25)),
        *(WhisperModel(size, c, d) for size in WhisperModel.DIMS),
        DACModel(c, d), CdpamModel("acoustic", c, d), CdpamModel("content", c, d),
        MSCLAPModel("2023", c, d),
    ]


def get_model(name: str, checkpoint_dir=None, device="cuda") -> ModelLoader:
    models = get_all_models(checkpoint_dir, device)
    for m in models:
        if m.name == name:
            return m
    known = ", ".join(m.name for m in models)
    raise ValueError(f"Unknown embedding model '{name}'. Known: {known}")
