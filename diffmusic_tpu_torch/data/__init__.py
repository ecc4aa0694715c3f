"""Host-side audio data: WAV read/write, the MP3/Opus decoders, and the
dataset registry with its WAV/MP3/Opus datasets and batch-1 loader.

Copies of the JAX package's `data/io.py`, `data/codecs.py` and
`data/dataloader.py` (numpy, `wave`, ctypes and scipy). Arrays are
(channels, samples) float32.
"""

from .codecs import decode_mp3, decode_opus, read_audio
from .dataloader import (MP3Dataset, OpusDataset, WAVDataset, get_dataloader, get_dataset,
                         register_dataset)
from .io import read_wav, write_wav

__all__ = ["MP3Dataset", "OpusDataset", "WAVDataset", "decode_mp3", "decode_opus",
           "get_dataloader", "get_dataset", "read_audio", "read_wav", "register_dataset",
           "write_wav"]
