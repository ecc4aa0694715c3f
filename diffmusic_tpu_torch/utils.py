"""Host-side audio utilities: the threaded multi-file loader of the eval path.

Port of `diffmusic_tpu/utils.py` (`load_audio_task`, `load_audio_files`).
Decoding and resampling are host work, so they run on the CPU; the
resampler is the port's `ops/resample.py`.
"""

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from .data import read_wav
from .ops.resample import resample


def load_audio_task(fname, sample_rate: int, channels: int = 1) -> np.ndarray:
    """One WAV file, downmixed to mono (channels=1) and resampled to
    `sample_rate`, as float32."""
    wav, sr = read_wav(fname)
    wav = wav.mean(axis=0) if channels == 1 else wav
    if sr != sample_rate:
        with torch.no_grad():
            wav = resample(torch.from_numpy(np.atleast_2d(wav).astype(np.float32)), sr,
                           sample_rate).numpy()
        wav = wav[0] if channels == 1 else wav
    return wav.astype(np.float32)


def load_audio_files(directory, sample_rate: int = 16000,
                     max_workers: int = 8) -> Tuple[List[np.ndarray], List[str]]:
    """Every `*.wav` of `directory` in name order, loaded on a thread pool
    (the reference's eval loader, utils.py:55-73): (waveforms, file names)."""
    files = sorted(Path(directory).glob("*.wav"))
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        waves = list(pool.map(lambda f: load_audio_task(f, sample_rate), files))
    return waves, [f.name for f in files]
