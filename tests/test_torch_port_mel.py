"""CPU parity of the port's fused mel spectrogram (`kernels/mel.py`) with the
JAX package's Pallas kernel (`pallas/mel_kernel.py`) in interpret mode.

On the CPU the port's wrapper runs its plain version; its gradient is the
port of the JAX kernel's custom VJP. Both sides take the same numpy inputs in
fp32; the JAX side runs under `jax.default_matmul_precision("float32")` and
is finished before the port's side starts. Bounds: forward rtol 1e-4 / atol
1e-3 (the JAX kernel test's own, on mel values in the hundreds to tens of
thousands), gradients and the overlap-add 1e-4 of max |JAX|. A numpy
emulation of the CUDA kernel's tiling (span, reflect indices, basis tiles,
filterbank tiles) holds the kernel's operand layout on the CPU at 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffmusic_tpu.pallas.mel_kernel as mk
from diffmusic_tpu_torch import kernels
from diffmusic_tpu_torch.kernels import mel as tmel
from diffmusic_tpu_torch.ops import mel as topsmel
from diffmusic_tpu_torch.ops import stft as tstft
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

jstft = importlib.import_module("diffmusic_tpu.ops.stft")

MFCC = dict(n_fft=400, hop_length=160, win_length=400, n_mels=64, sample_rate=16000,
            f_min=125.0, f_max=7500.0)
CASES = {
    "default-16000": ((2, 16000), {}),
    "default-32123": ((2, 32123), {}),
    "mfcc": ((2, 16000), MFCC),
    "512-128-400-40": ((1, 8000), dict(n_fft=512, hop_length=128, win_length=400, n_mels=40)),
    "power1": ((2, 8000), dict(power=1.0)),
    "batch-3x2": ((3, 2, 4000), {}),
    "hop100": ((2, 16001), dict(hop_length=100)),
    "hop100-128-power1.5": ((2, 16001), dict(hop_length=100, n_mels=128, power=1.5)),
}


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setattr(mk, "_INTERPRET", True)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def signal(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def jax_mel(x, kw):
    """The JAX kernel on its own copy of x, with fp32 matmuls, finished."""
    with jax.default_matmul_precision("float32"):
        out = mk.fused_mel_spectrogram(jnp.array(x), **kw)
    return np.asarray(jax.block_until_ready(out))


def jax_grad(x, kw):
    with jax.default_matmul_precision("float32"):
        g = jax.grad(lambda s: jnp.sum(mk.fused_mel_spectrogram(s, **kw) ** 0.5))(jnp.array(x))
    return np.asarray(jax.block_until_ready(g))


def port_grad(x, kw):
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    (g,) = torch.autograd.grad((tmel.fused_mel_spectrogram(xt, **kw) ** 0.5).sum(), xt)
    return g.numpy()


@pytest.fixture(scope="module", autouse=True)
def warm_up():
    """Run both sides once before the tests: the first test of a file can be
    a worker's first JAX and first BLAS computation."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mk, "_INTERPRET", True)
        x = signal((1, 4000), 1)
        jax_mel(x, {})
        tmel.fused_mel_spectrogram(torch.from_numpy(x))


@pytest.mark.parametrize("case", list(CASES))
def test_fused_mel_matches_jax_kernel(case):
    shape, kw = CASES[case]
    x = signal(shape)
    ref = jax_mel(x, kw)
    kernels.reset_launch_counts()
    out = tmel.fused_mel_spectrogram(torch.from_numpy(x.copy()), **kw)
    assert kernels.launch_counts()["fused_mel_spectrogram"] == 0   # a CPU tensor: plain
    n_mels = kw.get("n_mels", 64)
    assert out.dtype == torch.float32
    assert tuple(out.shape) == ref.shape == shape[:-1] + (n_mels, 1 + shape[-1] //
                                                         kw.get("hop_length", 160))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-3,
                               err_msg=f"port vs JAX kernel: {rel(out, ref):.2e} of max")


@pytest.mark.parametrize("case", ["default", "mfcc", "power1"])
def test_fused_mel_gradient_matches_jax(case):
    """The input gradient of sum(mel ** 0.5): at power 2 the port of
    `_fused_mel_bwd` against JAX's custom VJP, at power 1 autograd through
    the plain versions on both sides."""
    kw = {"default": {}, "mfcc": MFCC, "power1": dict(power=1.0)}[case]
    x = signal((1, 8000), 2)
    ref = jax_grad(x, kw)
    out = port_grad(x, kw)
    assert out.shape == x.shape
    assert rel(out, ref) <= 1e-4, f"port vs JAX gradient: {rel(out, ref):.2e} of max"


def test_fused_mel_input_dtype_and_plain_version():
    """The wrapper casts to fp32 (`mel_kernel.py:169`); the plain version is
    the port's spectrogram and filterbank, so it equals MelSpectrogram."""
    x = signal((2, 5000), 3)
    out = tmel.fused_mel_spectrogram(torch.from_numpy(x).double())
    assert out.dtype == torch.float32
    assert rel(out, topsmel.MelSpectrogram()(torch.from_numpy(x))) <= 1e-6


@pytest.mark.parametrize("n_fft,hop", [(1024, 160), (400, 128), (512, 512), (400, 160)])
def test_overlap_add_matches_jax(n_fft, hop):
    fr = signal((2, 13, n_fft), 4)
    ref = np.asarray(jstft.overlap_add(jnp.asarray(fr), hop))
    out = tstft.overlap_add(torch.from_numpy(fr), hop)
    assert tuple(out.shape) == ref.shape == (2, 12 * hop + n_fft)
    assert rel(out, ref) <= 1e-4


def emulate_kernel(x, geom):
    """numpy replica of `csrc/mel.cu` on (B, L) x: the span of each 64-frame
    tile read through the reflect indices, the DFT over the tiled,
    column-major basis, |X|^power and the filterbank tile by tile."""
    n_fft, hop, win, n_mels, sr, f_min, f_max, power, use_hann = geom
    basis, fb, k_pad = tmel._kernel_bases(n_fft, win, n_mels, sr, f_min, f_max, use_hann,
                                          torch.device("cpu"))
    basis, fb = basis.double().numpy(), fb.double().numpy()
    bsz, length = x.shape
    pad, n_frames = n_fft // 2, 1 + length // hop
    out = np.zeros((bsz, n_mels, n_frames))
    for t0 in range(0, n_frames, tmel.FRAME_TILE):
        s = t0 * hop - pad + np.arange((tmel.FRAME_TILE - 1) * hop + k_pad)
        s = np.where(s < 0, -s, np.where(s >= length, 2 * (length - 1) - s, s))
        valid = t0 * hop - pad + np.arange(s.size) < length + pad
        span = np.where(valid, x[:, np.clip(s, 0, length - 1)], 0.0)     # (B, S)
        frames = span[:, np.arange(tmel.FRAME_TILE)[:, None] * hop + np.arange(k_pad)]
        acc = np.zeros((bsz, tmel.FRAME_TILE, fb.shape[1]))
        for tile in range(basis.shape[0]):
            spec = frames @ basis[tile].T                                  # (B, 64, 128)
            m2 = spec[..., :64] ** 2 + spec[..., 64:] ** 2
            p = m2 if power == 2.0 else (m2 + 1e-24) ** (power / 2)
            acc += p @ fb[tile * 64:(tile + 1) * 64]
        n = min(tmel.FRAME_TILE, n_frames - t0)
        out[:, :, t0:t0 + n] = acc[:, :n, :n_mels].transpose(0, 2, 1)
    return out


@pytest.mark.parametrize("case", ["default-32123", "mfcc", "512-128-400-40", "power1", "hop100",
                                  "hop100-128-power1.5"])
def test_kernel_operand_layout_reproduces_plain(case):
    shape, kw = CASES[case]
    x = signal(shape, 5).reshape(-1, shape[-1])
    full = dict(n_fft=1024, hop_length=160, win_length=1024, n_mels=64, sample_rate=16000,
                f_min=0.0, f_max=None, power=2.0, use_hann=True)
    full.update(kw)
    ref = tmel.fused_mel_plain(torch.from_numpy(x), **full).numpy()
    out = emulate_kernel(x.astype(np.float64), tuple(full.values()))
    assert rel(out, ref) <= 1e-5, f"emulated kernel vs plain: {rel(out, ref):.2e} of max"
