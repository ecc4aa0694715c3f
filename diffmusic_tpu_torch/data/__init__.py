"""Host-side audio I/O: WAV read/write and the MP3/Opus decoders.

Copies of the JAX package's `data/io.py` and `data/codecs.py` (numpy, `wave`
and ctypes). Arrays are (channels, samples) float32. The JAX package's
dataset classes (`data/dataloader.py`) are not ported yet (`ROADMAP.md`).
"""

from .codecs import decode_mp3, decode_opus, read_audio
from .io import read_wav, write_wav

__all__ = ["decode_mp3", "decode_opus", "read_audio", "read_wav", "write_wav"]
