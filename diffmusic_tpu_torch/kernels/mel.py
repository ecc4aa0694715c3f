"""The fused mel spectrogram: reflect pad -> frames -> windowed DFT ->
|X|^power -> mel, in one kernel.

Replaces `diffmusic_tpu/pallas/mel_kernel.py::fused_mel_spectrogram` with
the CUDA kernel of `csrc/mel.cu`. Contract (`mel_kernel.py:152-186`): (..., L)
of any float dtype, cast to fp32, becomes (..., n_mels, 1 + L // hop) fp32;
a periodic Hann window of `win_length` centred in `n_fft`, reflect padding of
n_fft // 2 on each side, the htk mel filterbank without norm; power 2 gives
|X|^2, power 1 sqrt(|X|^2 + 1e-24), any other p (|X|^2 + 1e-24)^(p / 2).

The function's least work is an FFT's, about 2.5 n_fft log2(n_fft) fp32
operations per frame plus the filterbank's nonzeros, so at the eval's shapes
it is bound by its bytes (signal in, mels out). The kernel has two paths,
picked once per geometry by `mel_plan`, which also builds their operands:

- the factored path, wherever n_fft = n1 * n2 with both factors in 2..64
  (`fft_split`, nearest sqrt(n_fft): 400 = 20 x 20, 1024 = 32 x 32): a
  Cooley-Tukey DFT in two stages of small dense products, n_fft (n1 + 2 n2)
  FMAs a frame (about 24 k at n_fft 400 and 98 k at 1024, against 213 k and
  1.18 M for the dense product), only the n_fft // 2 + 1 bins computed, each
  a sum of n1 + n2 terms; tiles of `FFT_FRAMES` frames, so that a 10-s clip
  at batch 1 gives 126 blocks; the filterbank applied from its nonzeros (a
  CSR, `fft_tables`);
- the dense path, for an n_fft with no such split (a prime, for example):
  the DFT as a dense product with the window folded into the basis,
  n_fft x 2 n_freqs FMAs a frame, 64 frames a block (`_kernel_bases`).

Both keep every intermediate on the chip and run in fp32 FMAs, not on the
tensor cores: TF32 misses the JAX test's rtol 1e-4 on mel values in the
hundreds over a 400-1024-term sum, and the MFCC front end's log(mel + 1e-6)
amplifies relative error in quiet bands. Where no gradient is wanted the
wrapper skips the autograd function; per call it checks the input, looks
the plan up and makes one launch on the current stream's raw handle.

On a CPU tensor the wrapper runs `fused_mel_plain` beside it; on a CUDA
tensor it launches the kernel or raises. The gradient is the JAX kernel's
custom VJP (`_fused_mel_bwd`, `:206-248`) in plain PyTorch: it recomputes
the spectrum from the saved input and pushes the cotangent back through the
mel and DFT matmuls and an overlap-add, then through the reflect pad; for a
power other than 2 it is autograd through the plain version, as in JAX.
"""

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.mel import _filterbank_tensor, mel_filterbank
from ..ops.stft import _dft_basis, frame_signal, overlap_add, spectrogram
from ..tracing import count
from .device import use_plain

# launches of the kernel since the last reset (see kernels.launch_counts)
LAUNCHES = {"fused_mel_spectrogram": 0}

FFT_MAX_FACTOR = 64   # the factored path's largest factor (csrc/mel.cu: size class S)
FFT_FRAMES = 8        # frames a tile of the factored path
FRAME_TILE = 64   # frames per thread block of the dense path (csrc/mel.cu: FT)
FREQ_TILE = 64    # frequencies per basis tile (csrc/mel.cu: NT)
DEPTH_TILE = 32   # DFT depth per staged basis chunk (csrc/mel.cu: KT)


def _bases(n_fft: int, win_length: int, n_mels: int, sample_rate: int,
           f_min: float, f_max, use_hann: bool):
    """(windowed [cos | sin] basis (n_fft, 2 n_freqs), mel filterbank
    (n_freqs, n_mels)), float32 numpy (`mel_kernel._bases`)."""
    cos_b, sin_b = _dft_basis(n_fft)
    if use_hann:
        n = np.arange(win_length)
        w = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)
        if win_length < n_fft:
            lpad = (n_fft - win_length) // 2
            w = np.pad(w, (lpad, n_fft - win_length - lpad))
        basis = np.concatenate([cos_b * w[:, None], sin_b * w[:, None]], axis=1)
    else:
        basis = np.concatenate([cos_b, sin_b], axis=1)
    fb = mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate, f_min, f_max)
    return basis.astype(np.float32), fb.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _plain_bases(n_fft, win_length, n_mels, sample_rate, f_min, f_max, use_hann, device):
    basis, fb = _bases(n_fft, win_length, n_mels, sample_rate, f_min, f_max, use_hann)
    return torch.as_tensor(basis, device=device), torch.as_tensor(fb, device=device)


def mels_padded(n_mels: int) -> int:
    """The kernel's mel columns: 64 or 128 (8 warps x 8 or 16)."""
    for m in (64, 128):
        if n_mels <= m:
            return m
    raise ValueError(f"fused_mel_spectrogram: the kernel takes at most 128 mels, not {n_mels}")


@functools.lru_cache(maxsize=16)
def _kernel_bases(n_fft, win_length, n_mels, sample_rate, f_min, f_max, use_hann, device):
    """The kernel's operands on `device`: the windowed basis cut into tiles
    of FREQ_TILE frequencies, each tile's 64 cos and 64 sin columns stored
    column-major over a depth zero-padded to DEPTH_TILE, (tiles, 128,
    n_fft_pad); the filterbank zero-padded to (tiles * FREQ_TILE, mels_padded)."""
    basis, fb = _bases(n_fft, win_length, n_mels, sample_rate, f_min, f_max, use_hann)
    n_freqs = n_fft // 2 + 1
    tiles = -(-n_freqs // FREQ_TILE)
    f_pad = tiles * FREQ_TILE
    k_pad = -(-n_fft // DEPTH_TILE) * DEPTH_TILE
    cos_b = np.zeros((k_pad, f_pad), np.float32)
    sin_b = np.zeros((k_pad, f_pad), np.float32)
    cos_b[:n_fft, :n_freqs] = basis[:, :n_freqs]
    sin_b[:n_fft, :n_freqs] = basis[:, n_freqs:]
    cols = np.concatenate([cos_b.T.reshape(tiles, FREQ_TILE, k_pad),
                           sin_b.T.reshape(tiles, FREQ_TILE, k_pad)], axis=1)
    fb_pad = np.zeros((f_pad, mels_padded(n_mels)), np.float32)
    fb_pad[:n_freqs, :n_mels] = fb
    return (torch.as_tensor(np.ascontiguousarray(cols), device=device),
            torch.as_tensor(fb_pad, device=device), k_pad)


def fused_mel_plain(x, n_fft: int = 1024, hop_length: int = 160, win_length: int = 1024,
                    n_mels: int = 64, sample_rate: int = 16000, f_min: float = 0.0,
                    f_max: Optional[float] = None, power: float = 2.0,
                    use_hann: bool = True):
    """The plain version (`mel_kernel._reference_mel`): the port's
    spectrogram, then the filterbank. (..., L) -> (..., n_mels, T) fp32."""
    spec = spectrogram(x.float(), n_fft, hop_length, win_length, power=power, center=True,
                       use_hann=use_hann)
    fb = _filterbank_tensor(n_fft // 2 + 1, n_mels, sample_rate, f_min, f_max, spec.device,
                            spec.dtype)
    return torch.einsum("...ft,fm->...mt", spec, fb)


_MODES = {2.0: 2, 1.0: 1}   # power -> the kernel's epilogue (0: powf)


def fft_split(n_fft: int):
    """(n1, n2) of the factored path: n_fft = n1 * n2 with 2 <= n1, n2 <=
    FFT_MAX_FACTOR, the pair nearest sqrt(n_fft) (the larger n1 on a tie);
    None where there is none (a prime n_fft, for example): the dense path."""
    pairs = [(n1, n_fft // n1) for n1 in range(2, FFT_MAX_FACTOR + 1)
             if n_fft % n1 == 0 and 2 <= n_fft // n1 <= FFT_MAX_FACTOR]
    if not pairs:
        return None
    return min(pairs, key=lambda p: (abs(p[0] - p[1]), -p[0]))


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def fft_tables(n_fft: int, n1: int, n2: int, win_length: int, n_mels: int, sample_rate: int,
               f_min: float, f_max, use_hann: bool):
    """The factored path's operands (csrc/mel.cu, `fft_args` reads the same
    layout): `tabf` float32, the window (n_fft, zero outside win_length) at
    0; from round4(n_fft) the stage-1 matrix d1 (n1 rows of round4(n1):
    cos(2 pi m k1 / n1) for k1 = 0..n1 // 2, then -sin for k1 = 1..(n1 - 1)
    // 2); the twiddles exp(-2 pi i b k1 / n_fft) (n2 x n1, complex
    interleaved); the stage-2 matrix exp(-2 pi i b j / n2) (n2 x (n2 // 2 +
    1), complex); the filterbank's nonzeros mel by mel; zero-padded to a
    multiple of 4. `tabi` int32: the CSR row pointers (n_mels + 1), then the
    bin of each nonzero, zero-padded to a multiple of 4. The tables are
    computed in float64 and rounded once; the filterbank's values are the
    plain version's float32 ones."""
    if use_hann:
        n = np.arange(win_length)
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
        lpad = (n_fft - win_length) // 2
        w = np.pad(w, (lpad, n_fft - win_length - lpad))
    else:
        w = np.ones(n_fft)
    h = n1 // 2
    m = np.arange(n1)[:, None]
    d1 = np.zeros((n1, _round4(n1)))
    d1[:, :h + 1] = np.cos(2.0 * np.pi * m * np.arange(h + 1) / n1)
    d1[:, h + 1:n1] = -np.sin(2.0 * np.pi * m * np.arange(1, n1 - h) / n1)
    b = np.arange(n2)[:, None]
    tw = np.exp(-2j * np.pi * b * np.arange(n1) / n_fft)
    w2 = np.exp(-2j * np.pi * b * np.arange(n2 // 2 + 1) / n2)
    fb = mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate, f_min, f_max)
    mel_of, bin_of = np.nonzero(fb.T)        # mel by mel, bins ascending
    vals = fb.T[mel_of, bin_of]
    rows = np.searchsorted(mel_of, np.arange(n_mels + 1))
    parts = [np.pad(w, (0, _round4(n_fft) - n_fft)), d1.ravel(),
             np.stack([tw.real, tw.imag], -1).ravel(), np.stack([w2.real, w2.imag], -1).ravel()]
    tabf = np.concatenate([p.astype(np.float32) for p in parts] + [vals.astype(np.float32)])
    tabf = np.pad(tabf, (0, _round4(tabf.size) - tabf.size))
    tabi = np.concatenate([rows, bin_of]).astype(np.int32)
    tabi = np.pad(tabi, (0, _round4(tabi.size) - tabi.size))
    return tabf, tabi, int(vals.size)


@functools.lru_cache(maxsize=16)
def _fft_operands(n_fft, n1, n2, win_length, n_mels, sample_rate, f_min, f_max, use_hann,
                  device):
    """`fft_tables` on `device`: (tabf, tabi, nnz)."""
    tabf, tabi, nnz = fft_tables(n_fft, n1, n2, win_length, n_mels, sample_rate, f_min, f_max,
                                 use_hann)
    return torch.as_tensor(tabf, device=device), torch.as_tensor(tabi, device=device), nnz


@functools.lru_cache(maxsize=16)
def mel_plan(n_fft: int, hop: int, win_length: int, n_mels: int, sample_rate: int,
             f_min: float, f_max, power: float, use_hann: bool, device) -> tuple:
    """The launch of one geometry on `device`, made once: ("fft", tabf, tabi,
    n1, n2, nnz, frames, max_blocks, mode) on the factored path, where
    `fft_split` finds a split (operands from `_fft_operands`), else
    ("dense", basis, fb, k_pad, mode) on the dense path (`_kernel_bases`).
    Raises for what the kernel does not take: a device other than CUDA,
    hop < 1, win_length > n_fft, more than 128 mels, more shared memory
    than a block may use."""
    from . import build
    count("kernels.cache_miss", "mel.mel_plan")
    if device.type != "cuda":
        raise ValueError(f"fused_mel_spectrogram: x must be on a CUDA device, not {device}")
    if hop < 1 or win_length > n_fft:
        raise ValueError(f"fused_mel_spectrogram: hop {hop}, win_length {win_length}, "
                         f"n_fft {n_fft}")
    m_pad = mels_padded(n_mels)
    mode = _MODES.get(power, 0)
    lib = build.library()
    split = fft_split(n_fft)
    if split is None:
        basis, fb, k_pad = _kernel_bases(n_fft, win_length, n_mels, sample_rate, f_min, f_max,
                                         use_hann, device)
        build.check_smem("fused_mel_spectrogram", lib.dm_fused_mel_smem(hop, k_pad, m_pad))
        return "dense", basis, fb, k_pad, mode
    n1, n2 = split
    tabf, tabi, nnz = _fft_operands(n_fft, n1, n2, win_length, n_mels, sample_rate, f_min,
                                    f_max, use_hann, device)
    frames = FFT_FRAMES
    per_sm = lib.dm_fused_mel_fft_blocks(hop, n_fft, n1, n2, n_mels, nnz, frames)
    if per_sm < 1:
        raise ValueError(f"fused_mel_spectrogram: a block of the factored path needs more "
                         f"shared memory than an SM has at n_fft {n_fft}, hop {hop}")
    max_blocks = per_sm * torch.cuda.get_device_properties(device).multi_processor_count
    return "fft", tabf, tabi, n1, n2, nnz, frames, max_blocks, mode


def _run_kernel(xb, geom):
    """The CUDA kernel on (B, L) fp32 xb: (B, n_mels, T)."""
    from . import build
    n_fft, hop, win_length, n_mels, sample_rate, f_min, f_max, power, use_hann = geom
    if xb.dtype != torch.float32 or xb.ndim != 2 or not xb.is_contiguous():
        raise TypeError(f"fused_mel_spectrogram: the kernel takes contiguous (B, L) float32, "
                        f"not {tuple(xb.shape)} {xb.dtype}")
    plan = mel_plan(*geom, xb.device)
    bsz, length = xb.shape
    xp = xb.data_ptr()
    if length <= n_fft // 2 or xp % 16:
        raise ValueError(f"fused_mel_spectrogram: length {length}, n_fft {n_fft}: reflect "
                         f"padding needs length > n_fft // 2, and x must start 16-byte aligned")
    n_frames = 1 + length // hop
    out = torch.empty((bsz, n_mels, n_frames), dtype=torch.float32, device=xb.device)
    lib = build.library()
    if plan[0] == "fft":
        _, tabf, tabi, n1, n2, nnz, frames, max_blocks, mode = plan
        rc = lib.dm_fused_mel_fft(xp, tabf.data_ptr(), tabi.data_ptr(), out.data_ptr(), bsz,
                                  length, n_frames, hop, n_fft, n1, n2, n_mels, nnz, frames,
                                  mode, power, max_blocks, build.stream_ptr(xb.device))
    else:
        _, basis, fb, k_pad, mode = plan
        rc = lib.dm_fused_mel(xp, basis.data_ptr(), fb.data_ptr(), out.data_ptr(), bsz, length,
                              n_frames, k_pad, hop, n_fft // 2, basis.shape[0], n_mels,
                              fb.shape[1], mode, power, build.stream_ptr(xb.device))
    build.check(rc, "fused_mel_spectrogram")
    return out


def _launch(xb, geom):
    out = _run_kernel(xb, geom)
    LAUNCHES["fused_mel_spectrogram"] += 1
    return out


def _forward(x, geom):
    """The kernel on (..., L) x of any float dtype: (..., n_mels, T) fp32."""
    xb = x if x.ndim == 2 else x.reshape(-1, x.shape[-1])
    if xb.dtype != torch.float32:
        xb = xb.float()
    if not xb.is_contiguous():
        xb = xb.contiguous()
    if xb.data_ptr() % 16:          # the kernel's 16-byte span loads
        xb = xb.clone()
    out = _launch(xb, geom)
    return out if x.ndim == 2 else out.reshape(*x.shape[:-1], *out.shape[1:])


def _reflect_pad_adjoint(gp, pad: int, length: int):
    """Adjoint of a reflect pad of `pad` on each side of the last axis."""
    g = gp[..., pad:pad + length].clone()
    g[..., 1:pad + 1] += gp[..., :pad].flip(-1)
    g[..., length - pad - 1:length - 1] += gp[..., pad + length:].flip(-1)
    return g


def _mel_bwd_power2(x, g, geom):
    """`mel_kernel._fused_mel_bwd` at power 2: recompute the spectrum of the
    frames, then gmag = g fb^T, [2 re gmag, 2 im gmag] basis^T, overlap-add,
    trimmed or padded to L + n_fft, and the reflect pad's adjoint."""
    n_fft, hop, win_length, n_mels, sample_rate, f_min, f_max, _, use_hann = geom
    basis, fb = _plain_bases(n_fft, win_length, n_mels, sample_rate, f_min, f_max, use_hann,
                             x.device)
    n_freqs = n_fft // 2 + 1
    length = x.shape[-1]
    xb = x.reshape(-1, length).float()
    gb = g.reshape(-1, n_mels, g.shape[-1]).transpose(-1, -2).float()   # (B, T, M)
    spec2 = frame_signal(xb, n_fft, hop, center=True) @ basis            # (B, T, 2F)
    re, im = spec2[..., :n_freqs], spec2[..., n_freqs:]
    gmag = gb @ fb.T                                                      # (B, T, F)
    gframes = torch.cat([2.0 * re * gmag, 2.0 * im * gmag], dim=-1) @ basis.T
    gx_pad = overlap_add(gframes, hop)
    pad_len = length + n_fft
    if gx_pad.shape[-1] < pad_len:
        gx_pad = F.pad(gx_pad, (0, pad_len - gx_pad.shape[-1]))
    gx = _reflect_pad_adjoint(gx_pad[..., :pad_len], n_fft // 2, length)
    return gx.reshape(x.shape).to(x.dtype)


class _FusedMel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, geom):
        ctx.save_for_backward(x)
        ctx.geom = geom
        if use_plain(x, "fused_mel_spectrogram"):
            return fused_mel_plain(x, *geom)
        return _forward(x, geom)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        geom = ctx.geom
        if geom[7] == 2.0:
            return _mel_bwd_power2(x, g, geom), None
        xx = x.detach().requires_grad_(True)
        with torch.enable_grad():
            y = fused_mel_plain(xx, *geom)
        return torch.autograd.grad(y, xx, g)[0], None


def mel_geometry(n_fft: int = 1024, hop_length: int = 160, win_length: int = 1024,
                 n_mels: int = 64, sample_rate: int = 16000, f_min: float = 0.0,
                 f_max: Optional[float] = None, power: float = 2.0,
                 use_hann: bool = True) -> tuple:
    """The geometry tuple the wrapper keys its plan on (`mel_plan`'s
    arguments but the device)."""
    return (int(n_fft), int(hop_length), int(win_length), int(n_mels), int(sample_rate),
            float(f_min), None if f_max is None else float(f_max), float(power), bool(use_hann))


def fused_mel_spectrogram(x, n_fft: int = 1024, hop_length: int = 160, win_length: int = 1024,
                          n_mels: int = 64, sample_rate: int = 16000, f_min: float = 0.0,
                          f_max: Optional[float] = None, power: float = 2.0,
                          use_hann: bool = True):
    """(..., L) -> (..., n_mels, 1 + L // hop_length) fp32 mel spectrogram
    (`mel_kernel.fused_mel_spectrogram`, the same defaults)."""
    geom = mel_geometry(n_fft, hop_length, win_length, n_mels, sample_rate, f_min, f_max, power,
                        use_hann)
    if torch.is_grad_enabled() and x.requires_grad:
        return _FusedMel.apply(x, geom)
    if use_plain(x, "fused_mel_spectrogram"):
        return fused_mel_plain(x, *geom)
    return _forward(x, geom)
