"""WAV read/write on the stdlib `wave` module (no soundfile or torchaudio needed).

A copy of `diffmusic_tpu/data/io.py` (numpy only): the port imports nothing of
the JAX package.

Supports 16/24/32-bit PCM and IEEE float32 WAVs. Arrays use the (channels, samples)
float32 convention of the reference loaders (diffmusic/data/dataloader.py:73-83).
"""

import struct
import wave
from pathlib import Path
from typing import Tuple, Union

import numpy as np

PathLike = Union[str, Path]

# wave only does PCM; detect IEEE-float WAVs from the fmt chunk ourselves.
_WAVE_FORMAT_IEEE_FLOAT = 3


def _read_float32_wav(path: PathLike) -> Tuple[np.ndarray, int]:
    """Minimal RIFF parser for format-3 (IEEE float) WAVs that `wave` rejects."""
    raw = Path(path).read_bytes()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"not a RIFF/WAVE file: {path}")
    pos, n_channels, sample_rate, bits, data = 12, 1, 16000, 32, b""
    while pos + 8 <= len(raw):
        cid, size = raw[pos:pos + 4], struct.unpack("<I", raw[pos + 4:pos + 8])[0]
        body = raw[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            _, n_channels, sample_rate, _, _, bits = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    arr = np.frombuffer(data, dtype="<f4" if bits == 32 else "<f8").astype(np.float32)
    return arr.reshape(-1, n_channels).T, sample_rate


def read_wav(path: PathLike) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 array of shape (channels, samples), sample_rate)."""
    try:
        with wave.open(str(path), "rb") as f:
            n_channels = f.getnchannels()
            sample_rate = f.getframerate()
            sampwidth = f.getsampwidth()
            frames = f.readframes(f.getnframes())
    except wave.Error as e:
        if "unknown format: 3" in str(e):
            return _read_float32_wav(path)
        raise
    if sampwidth == 2:
        arr = np.frombuffer(frames, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        arr = np.frombuffer(frames, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 3:  # 24-bit packed
        b = np.frombuffer(frames, dtype=np.uint8).reshape(-1, 3)
        i32 = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        i32 = np.where(i32 >= 1 << 23, i32 - (1 << 24), i32)
        arr = i32.astype(np.float32) / float(1 << 23)
    elif sampwidth == 1:
        arr = (np.frombuffer(frames, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {sampwidth} in {path}")
    return arr.reshape(-1, n_channels).T, sample_rate


def write_wav(path: PathLike, wav: np.ndarray, sample_rate: int,
              subtype: str = "float32") -> None:
    """Write (channels, samples) or (samples,) audio as a WAV file.

    Default subtype is IEEE float32 (lossless for our float pipelines); pass
    subtype="pcm16" for maximal player compatibility.
    """
    wav = np.asarray(wav, dtype=np.float32)
    if wav.ndim == 1:
        wav = wav[None, :]
    wav = np.nan_to_num(wav)
    if subtype == "pcm16":
        pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2")
        with wave.open(str(path), "wb") as f:
            f.setnchannels(pcm.shape[0])
            f.setsampwidth(2)
            f.setframerate(int(sample_rate))
            f.writeframes(pcm.T.tobytes())
        return
    n_channels, sr = wav.shape[0], int(sample_rate)
    data = wav.T.astype("<f4").tobytes()
    block = 4 * n_channels
    fmt = struct.pack("<HHIIHH", _WAVE_FORMAT_IEEE_FLOAT, n_channels, sr,
                      sr * block, block, 32)
    fact = struct.pack("<I", wav.shape[1])
    body = (b"WAVE"
            + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"fact" + struct.pack("<I", len(fact)) + fact
            + b"data" + struct.pack("<I", len(data)) + data)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
