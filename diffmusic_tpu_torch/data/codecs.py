"""Compressed-audio decode on the system codec libraries via ctypes.

A copy of `diffmusic_tpu/data/codecs.py` (numpy and ctypes, no JAX): the port
imports nothing of the JAX package.

The reference decodes MP3 through pydub/ffmpeg (diffmusic/data/dataloader.py:92-145)
and its fadtk test fixtures are Ogg/Opus files scored through an ffmpeg fallback
(fadtk/fad.py:160-183). Neither pydub nor ffmpeg is a dependency, but the
codec libraries themselves are common system libraries (libmpg123, libopus) — so MP3 decode binds
libmpg123 directly, and Opus couples a pure-python Ogg page demuxer with
libopus. No subprocesses, no temp files, no optional python deps.

Both return ((channels, samples) float32, sample_rate) — the package's
read_wav convention (data/io.py).
"""

import ctypes
import ctypes.util
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def _load(*names) -> Optional[ctypes.CDLL]:
    for n in names:
        try:
            return ctypes.CDLL(n)
        except OSError:
            continue
    found = ctypes.util.find_library(names[0].split(".")[0].removeprefix("lib"))
    if found:
        try:
            return ctypes.CDLL(found)
        except OSError:
            pass
    return None


# --------------------------------------------------------------------- MP3
_MPG123_OK, _MPG123_DONE, _MPG123_NEW_FORMAT = 0, -12, -11
_MPG123_ENC_FLOAT_32 = 0x200


class _Mpg123:
    _lib = None
    _inited = False

    @classmethod
    def lib(cls):
        if cls._lib is None:
            lib = _load("libmpg123.so.0", "libmpg123.so")
            if lib is None:
                raise RuntimeError(
                    "MP3 decoding needs libmpg123, which was not found on "
                    "this system (and pydub/ffmpeg are not installed).")
            lib.mpg123_new.restype = ctypes.c_void_p
            lib.mpg123_plain_strerror.restype = ctypes.c_char_p
            cls._lib = lib
        if not cls._inited:
            cls._lib.mpg123_init()
            cls._inited = True
        return cls._lib


def have_mp3() -> bool:
    try:
        _Mpg123.lib()
        return True
    except RuntimeError:
        return False


def decode_mp3(path) -> Tuple[np.ndarray, int]:
    """MP3 -> ((channels, samples) float32 in [-1, 1], sample_rate)."""
    lib = _Mpg123.lib()
    err = ctypes.c_int()
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError("mpg123_new failed")
    h = ctypes.c_void_p(h)
    try:
        if lib.mpg123_open(h, str(path).encode()) != _MPG123_OK:
            raise RuntimeError(f"mpg123 cannot open {path}")
        rate = ctypes.c_long()
        ch = ctypes.c_int()
        enc = ctypes.c_int()
        # the output format locks at open (a later mpg123_format call is
        # ignored for the running stream) — decode in whatever the library
        # negotiated (signed-16 on default builds) and convert below
        lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(ch),
                             ctypes.byref(enc))
        buf = (ctypes.c_char * 65536)()
        done = ctypes.c_size_t()
        chunks = []
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(bytes(buf[:done.value]))
            if rc == _MPG123_NEW_FORMAT:
                lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(ch),
                                     ctypes.byref(enc))
                continue
            if rc == _MPG123_DONE:
                break
            if rc != _MPG123_OK:
                msg = lib.mpg123_plain_strerror(rc)
                raise RuntimeError(f"mpg123 decode error: {msg!r}")
        data = b"".join(chunks)
        if enc.value & _MPG123_ENC_FLOAT_32:
            pcm = np.frombuffer(data, dtype="<f4").astype(np.float32)
        elif enc.value & 0x40:  # MPG123_ENC_16 family
            pcm = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif enc.value & 0x100:  # MPG123_ENC_32 family
            pcm = np.frombuffer(data, dtype="<i4").astype(np.float32) \
                / 2147483648.0
        else:
            raise RuntimeError(f"unsupported mpg123 encoding {enc.value:#x}")
        n_ch = max(1, ch.value)
        return pcm.reshape(-1, n_ch).T.astype(np.float32), int(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)


# -------------------------------------------------------------------- Opus
def _ogg_packets(raw: bytes):
    """Minimal Ogg demuxer: yields (packet_bytes, page_granule) for the first
    logical stream. Granule is the position of the LAST sample of the last
    packet completed on that page (RFC 3533 framing; lacing values of 255
    continue a packet, possibly across pages)."""
    pos, serial = 0, None
    pending = b""
    while pos + 27 <= len(raw):
        if raw[pos:pos + 4] != b"OggS":
            raise ValueError("bad Ogg page magic")
        (granule,) = struct.unpack_from("<q", raw, pos + 6)
        (page_serial,) = struct.unpack_from("<I", raw, pos + 14)
        nsegs = raw[pos + 26]
        lacing = raw[pos + 27:pos + 27 + nsegs]
        body = pos + 27 + nsegs
        if serial is None:
            serial = page_serial
        take = page_serial == serial
        off = 0
        for v in lacing:
            seg = raw[body + off:body + off + v]
            off += v
            if take:
                pending += seg
                if v < 255:
                    yield pending, granule
                    pending = b""
        pos = body + off


class _OpusLib:
    _lib = None

    @classmethod
    def lib(cls):
        if cls._lib is None:
            lib = _load("libopus.so.0", "libopus.so")
            if lib is None:
                raise RuntimeError(
                    "Opus decoding needs libopus, which was not found on "
                    "this system (and ffmpeg is not installed).")
            lib.opus_decoder_create.restype = ctypes.c_void_p
            cls._lib = lib
        return cls._lib


def have_opus() -> bool:
    try:
        _OpusLib.lib()
        return True
    except RuntimeError:
        return False


def decode_opus(path) -> Tuple[np.ndarray, int]:
    """Ogg/Opus -> ((channels, samples) float32, 48000).

    Opus always decodes at 48 kHz; OpusHead pre-skip and the final page
    granule position give the exact sample trim (RFC 7845 sections 4-5)."""
    lib = _OpusLib.lib()
    raw = Path(path).read_bytes()
    packets = _ogg_packets(raw)
    head, _ = next(packets)
    if head[:8] != b"OpusHead":
        raise ValueError(f"not an Ogg/Opus stream: {path}")
    channels = head[9]
    (pre_skip,) = struct.unpack_from("<H", head, 10)
    tags, _ = next(packets)  # OpusTags — ignored

    err = ctypes.c_int()
    dec = ctypes.c_void_p(
        lib.opus_decoder_create(48000, channels, ctypes.byref(err)))
    if err.value != 0:
        raise RuntimeError(f"opus_decoder_create failed: {err.value}")
    try:
        max_frame = 5760  # 120 ms at 48 kHz
        out = (ctypes.c_float * (max_frame * channels))()
        pcm = []
        last_granule = 0
        for pkt, granule in packets:
            if not pkt:
                continue
            n = lib.opus_decode_float(dec, pkt, len(pkt), out, max_frame, 0)
            if n < 0:
                raise RuntimeError(f"opus_decode_float error {n} in {path}")
            pcm.append(np.ctypeslib.as_array(out)[:n * channels].copy())
            if granule > 0:
                last_granule = granule
        audio = np.concatenate(pcm).reshape(-1, channels)
        end = last_granule if last_granule else audio.shape[0]
        audio = audio[pre_skip:end]
        return audio.T.astype(np.float32), 48000
    finally:
        lib.opus_decoder_destroy(dec)


def read_audio(path) -> Tuple[np.ndarray, int]:
    """Extension-dispatched decode: wav (data/io.py), mp3 (libmpg123),
    opus/ogg (libopus)."""
    suffix = Path(path).suffix.lower()
    if suffix == ".mp3":
        return decode_mp3(path)
    if suffix in (".opus", ".ogg"):
        return decode_opus(path)
    from .io import read_wav
    return read_wav(path)
