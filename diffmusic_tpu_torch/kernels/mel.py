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
it is bound by its bytes (signal in, mels out). This kernel does the DFT as
a dense product instead, n_fft x 2 n_freqs FMAs per frame (10-20x the FFT's
count), and never writes the frames or the linear spectrogram to device
memory. It runs in fp32 FMAs, not on the tensor cores: TF32 misses the JAX
test's rtol 1e-4 on mel values in the hundreds over a 400-1024-term sum, and
the MFCC front end's log(mel + 1e-6) amplifies relative error in quiet bands.

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
from .device import use_plain

# launches of the kernel since the last reset (see kernels.launch_counts)
LAUNCHES = {"fused_mel_spectrogram": 0}

FRAME_TILE = 64   # frames per thread block (csrc/mel.cu: FT)
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


def _run_kernel(xb, geom):
    """The CUDA kernel on (B, L) fp32 xb: (B, n_mels, T)."""
    from . import build
    n_fft, hop, win_length, n_mels, sample_rate, f_min, f_max, power, use_hann = geom
    build.check_tensors("fused_mel_spectrogram", xb)
    if xb.dtype != torch.float32 or xb.ndim != 2:
        raise TypeError(f"fused_mel_spectrogram: the kernel takes (B, L) float32, not "
                        f"{tuple(xb.shape)} {xb.dtype}")
    bsz, length = xb.shape
    pad = n_fft // 2
    if length <= pad or hop < 1 or win_length > n_fft:
        raise ValueError(f"fused_mel_spectrogram: length {length}, n_fft {n_fft}, hop {hop}, "
                         f"win_length {win_length}: reflect padding needs length > n_fft // 2")
    basis, fb, k_pad = _kernel_bases(n_fft, win_length, n_mels, sample_rate, float(f_min),
                                     f_max, use_hann, xb.device)
    n_frames = 1 + length // hop
    lib = build.library()
    build.check_smem("fused_mel_spectrogram",
                     lib.dm_fused_mel_smem(hop, k_pad, fb.shape[1]))
    out = torch.empty((bsz, n_mels, n_frames), dtype=torch.float32, device=xb.device)
    rc = lib.dm_fused_mel(xb.data_ptr(), basis.data_ptr(), fb.data_ptr(), out.data_ptr(),
                          bsz, length, n_frames, k_pad, hop, pad, basis.shape[0], n_mels,
                          fb.shape[1], _MODES.get(float(power), 0), float(power),
                          build.stream_ptr(xb.device))
    build.check(rc, "fused_mel_spectrogram")
    return out


def _launch(xb, geom):
    out = _run_kernel(xb, geom)
    LAUNCHES["fused_mel_spectrogram"] += 1
    return out


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
        length = x.shape[-1]
        xb = x.reshape(-1, length).float().contiguous()
        if xb.data_ptr() % 16:          # the kernel's 16-byte span loads
            xb = xb.clone()
        out = _launch(xb, geom)
        return out.reshape(*x.shape[:-1], *out.shape[1:])

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


def fused_mel_spectrogram(x, n_fft: int = 1024, hop_length: int = 160, win_length: int = 1024,
                          n_mels: int = 64, sample_rate: int = 16000, f_min: float = 0.0,
                          f_max: Optional[float] = None, power: float = 2.0,
                          use_hann: bool = True):
    """(..., L) -> (..., n_mels, 1 + L // hop_length) fp32 mel spectrogram
    (`mel_kernel.fused_mel_spectrogram`, the same defaults)."""
    geom = (int(n_fft), int(hop_length), int(win_length), int(n_mels), int(sample_rate),
            float(f_min), None if f_max is None else float(f_max), float(power), bool(use_hann))
    return _FusedMel.apply(x, geom)
