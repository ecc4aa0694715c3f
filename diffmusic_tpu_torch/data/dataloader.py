"""Dataset registry + WAV/MP3/Opus datasets: a copy of
`diffmusic_tpu/data/dataloader.py` on the port's `io.py` and `codecs.py`.

A decorator registry keyed by file `type`, datasets yielding (float32 (1, L)
waveform, file_name) -- mono mix, `resample_poly` to the dataset's rate, the
crop to [start_s, end_s), zero padding to the clip length -- and a batch-1
sequential loader. Decoding is host work, in numpy.
"""

from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
from scipy.signal import resample_poly

from .io import read_wav

__DATASET__: Dict[str, Callable] = {}


def register_dataset(type: str) -> Callable:
    def wrapper(cls):
        if __DATASET__.get(type) is not None:
            raise NameError(f"Dataset type {type} is already registered.")
        __DATASET__[type] = cls
        return cls
    return wrapper


def get_dataset(name: str, type: str, root: str, **kwargs):
    if __DATASET__.get(type) is None:
        raise NameError(f"Dataset type {type} is not defined.")
    return __DATASET__[type](root=root, name=name, **kwargs)


class _BaseAudioDataset:
    """Shared decode -> mono -> resample -> crop -> pad pipeline."""

    EXTENSIONS: Tuple[str, ...] = ()

    def __init__(self, root: str, sample_rate: int = 16000,
                 audio_length_in_s: float = 5.0, start_s: float = 0.0,
                 end_s: Optional[float] = None, transforms=None,
                 name: str = "", **_):
        self.root = Path(root)
        self.sample_rate = int(sample_rate)
        self.audio_length_in_s = float(audio_length_in_s)
        self.start_s = float(start_s)
        self.end_s = float(end_s) if end_s is not None else None
        self.transforms = transforms
        self.name = name
        self.files: List[Path] = sorted(
            p for ext in self.EXTENSIONS for p in self.root.glob(f"*{ext}"))

    def __len__(self) -> int:
        return len(self.files)

    def _decode(self, path: Path) -> Tuple[np.ndarray, int]:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, str]:
        path = self.files[idx]
        wav, sr = self._decode(path)
        wav = wav.mean(axis=0, keepdims=True)  # mono mix
        if sr != self.sample_rate:
            wav = resample_poly(wav, self.sample_rate, sr, axis=-1)
        start = int(round(self.start_s * self.sample_rate))
        end = (int(round(self.end_s * self.sample_rate))
               if self.end_s is not None else wav.shape[-1])
        wav = wav[:, start:end]
        target = int(round(self.audio_length_in_s * self.sample_rate))
        if wav.shape[-1] < target:  # every clip has the configured length
            wav = np.pad(wav, ((0, 0), (0, target - wav.shape[-1])))
        wav = wav[:, :target].astype(np.float32)
        if self.transforms is not None:
            wav = self.transforms(wav)
        return wav, path.name


@register_dataset("wav")
class WAVDataset(_BaseAudioDataset):
    EXTENSIONS = (".wav", ".WAV")

    def _decode(self, path: Path) -> Tuple[np.ndarray, int]:
        return read_wav(path)


@register_dataset("mp3")
class MP3Dataset(_BaseAudioDataset):
    """MP3 decode on libmpg123 via ctypes (data/codecs.py); pydub is the
    fallback where libmpg123 is absent and pydub is installed."""

    EXTENSIONS = (".mp3", ".MP3")

    def _decode(self, path: Path) -> Tuple[np.ndarray, int]:
        from .codecs import decode_mp3, have_mp3
        if have_mp3():
            return decode_mp3(path)
        try:
            from pydub import AudioSegment  # optional dependency
        except ImportError as e:
            raise RuntimeError(
                "MP3 decoding needs libmpg123 (not found on this system) or "
                "pydub/ffmpeg (not installed); convert inputs to WAV.") from e
        seg = AudioSegment.from_mp3(str(path))
        arr = np.array(seg.get_array_of_samples(), dtype=np.float32)
        arr = arr.reshape(-1, seg.channels).T / float(1 << (8 * seg.sample_width - 1))
        return arr, seg.frame_rate


@register_dataset("opus")
class OpusDataset(_BaseAudioDataset):
    """Ogg/Opus decode: a pure-python Ogg demuxer + libopus via ctypes
    (data/codecs.py)."""

    EXTENSIONS = (".opus", ".ogg", ".OPUS", ".OGG")

    def _decode(self, path: Path) -> Tuple[np.ndarray, int]:
        from .codecs import decode_opus
        return decode_opus(path)


class _SequentialLoader:
    """Batch-1 sequential loader (the CLI's get_dataloader(batch=1, workers=0))."""

    def __init__(self, dataset, batch_size: int = 1):
        assert batch_size == 1, "inference is batch-1"
        self.dataset = dataset

    def __len__(self) -> int:
        return len(self.dataset)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, str]]:
        for i in range(len(self.dataset)):
            yield self.dataset[i]


def get_dataloader(dataset, batch_size: int = 1, num_workers: int = 0,
                   train: bool = False) -> _SequentialLoader:
    return _SequentialLoader(dataset, batch_size=batch_size)
