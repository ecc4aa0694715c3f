"""The fused mel kernel's factored path (`csrc/mel.cu`, `mel_fft_kernel`;
`kernels/mel.py::mel_plan`, `fft_tables`), on the CPU, against the plain
version, the JAX package and a float64 oracle.

The kernel cannot run here, so `emulate_fft` computes what it computes, in
fp32, from the plan's own tables: the reflect-padded frames, windowed;
stage 1, n2 real DFTs of length n1 over the stride-n2 samples (the n1 real
columns of `d1`); the other half of each by conjugation; the twiddles; stage
2, the DFTs of length n2 of the bins k1 + n1 k2 <= n_fft / 2; |X|^power; the
filterbank from its CSR. It must equal `fused_mel_plain`, the JAX
`fused_mel_spectrogram` (the Pallas kernel in interpret mode, as
`tests/test_pallas_mel.py` runs it) and a float64 `np.fft.rfft` oracle within
1e-5 of max at each of `tests/test_torch_port_mel.py`'s cases. Then the
split of the plan, the CSR against the dense filterbank, and the launch path
through a stand-in library.
"""

import numpy as np
import pytest
import torch

import diffmusic_tpu.pallas.mel_kernel as mk
import test_torch_port_mel
from diffmusic_tpu_torch import kernels
from diffmusic_tpu_torch.kernels import build
from diffmusic_tpu_torch.kernels import mel as tmel
from diffmusic_tpu_torch.ops.mel import mel_filterbank
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

CUDA = torch.device("cuda", 0)
DEFAULTS = dict(n_fft=1024, hop_length=160, win_length=1024, n_mels=64, sample_rate=16000,
                f_min=0.0, f_max=None, power=2.0, use_hann=True)
CASES = test_torch_port_mel.CASES


def r4(n: int) -> int:
    return -(-n // 4) * 4


def unpack(geom):
    """The plan's tables as arrays: window, d1 (n1 x n1), twiddles (n2 x
    n1), w2 (n2 x n2 // 2 + 1), CSR (row pointers, bins, values)."""
    n_fft, hop, win, n_mels, sr, f_min, f_max, power, use_hann = geom
    n1, n2 = tmel.fft_split(n_fft)
    tabf, tabi, nnz = tmel.fft_tables(n_fft, n1, n2, win, n_mels, sr, f_min, f_max, use_hann)
    k2s = n2 // 2 + 1
    o_d1 = r4(n_fft)
    o_tw = o_d1 + n1 * r4(n1)
    o_w2 = o_tw + 2 * n2 * n1
    o_val = o_w2 + 2 * n2 * k2s
    cplx = lambda a, *shape: (a[0::2] + 1j * a[1::2]).astype(np.complex64).reshape(shape)
    return dict(n1=n1, n2=n2, window=tabf[:n_fft], d1=tabf[o_d1:o_tw].reshape(n1, r4(n1))[:, :n1],
                tw=cplx(tabf[o_tw:o_w2], n2, n1), w2=cplx(tabf[o_w2:o_val], n2, k2s),
                row=tabi[:n_mels + 1], col=tabi[n_mels + 1:n_mels + 1 + nnz],
                val=tabf[o_val:o_val + nnz])


def frames_of(x, n_fft, hop):
    """(B, T, n_fft) frames of the reflect-padded (B, L) x, zeros past L + pad."""
    length = x.shape[-1]
    pad, t = n_fft // 2, 1 + length // hop
    s = np.arange(t)[:, None] * hop - pad + np.arange(n_fft)
    valid = s < length + pad
    s = np.where(s < 0, -s, np.where(s >= length, 2 * (length - 1) - s, s))
    return np.where(valid, x[:, np.clip(s, 0, length - 1)], 0.0)


def epilogue(m2, power):
    if power == 2.0:
        return m2
    if power == 1.0:
        return np.sqrt(m2 + 1e-24)
    return (m2 + 1e-24) ** (power / 2)


def emulate_fft(x, geom):
    """(B, n_mels, T) float32 of the factored path on (B, L) float32 x."""
    n_fft, hop, _, n_mels, _, _, _, power, _ = geom
    t = unpack(geom)
    n1, n2 = t["n1"], t["n2"]
    fr = (frames_of(x, n_fft, hop).astype(np.float32) * t["window"]).astype(np.float32)
    a = fr.reshape(*fr.shape[:2], n1, n2).swapaxes(-1, -2)          # [b][m]: sample n2 m + b
    y = a @ t["d1"]                                                 # (B, T, n2, n1 columns)
    h = n1 // 2
    k1 = np.arange(n1)
    kk = np.where(k1 <= h, k1, n1 - k1)
    real = (kk == 0) | (2 * kk == n1)
    sign = np.where(real, 0, np.where(k1 <= h, 1, -1)).astype(np.float32)
    yc = (y[..., kk] + 1j * sign * y[..., np.where(real, 0, h + kk)]).astype(np.complex64)
    z = yc * t["tw"]
    xk = np.einsum("...bk,bj->...jk", z, t["w2"])                   # bin k1 + n1 j
    n_freqs = n_fft // 2 + 1
    spec = np.zeros(xk.shape[:2] + (n_freqs,), np.complex64)
    for j in range(xk.shape[2]):
        bins = k1 + n1 * j
        ok = bins < n_freqs
        spec[..., bins[ok]] = xk[:, :, j, ok]
    p = epilogue((spec.real ** 2 + spec.imag ** 2).astype(np.float32), power).astype(np.float32)
    out = np.zeros((x.shape[0], n_mels, p.shape[1]), np.float32)
    for m in range(n_mels):
        lo, hi = t["row"][m], t["row"][m + 1]
        out[:, m] = p[:, :, t["col"][lo:hi]] @ t["val"][lo:hi]
    return out


def oracle(x, geom):
    """float64: np.fft.rfft of the windowed frames, |X|^power, the filterbank."""
    n_fft, hop, win, n_mels, sr, f_min, f_max, power, use_hann = geom
    w = np.ones(n_fft)
    if use_hann:
        w = np.pad(0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win) / win),
                   ((n_fft - win) // 2, n_fft - win - (n_fft - win) // 2))
    spec = np.fft.rfft(frames_of(x.astype(np.float64), n_fft, hop) * w, axis=-1)
    p = epilogue(np.abs(spec) ** 2, power)
    fb = mel_filterbank(n_fft // 2 + 1, n_mels, sr, f_min, f_max).astype(np.float64)
    return (p @ fb).swapaxes(-1, -2)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("n_fft,split", [(400, (20, 20)), (1024, (32, 32)), (512, (32, 16)),
                                         (256, (16, 16)), (389, None), (4099, None),
                                         (126, (14, 9))])
def test_the_plans_split(n_fft, split):
    """Both factors in 2..64, nearest sqrt(n_fft), the larger first on a
    tie; None (the dense path) for a prime or a size no pair reaches."""
    assert tmel.fft_split(n_fft) == split


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_factored_path_matches_plain_jax_and_oracle(monkeypatch, case):
    shape, kw = CASES[case]
    geom = tuple(dict(DEFAULTS, **kw).values())
    x = test_torch_port_mel.signal(shape, 6)
    xb = x.reshape(-1, shape[-1])
    got = emulate_fft(xb, geom)
    got = got.reshape(*shape[:-1], *got.shape[1:])
    plain = tmel.fused_mel_plain(torch.from_numpy(x), *geom).numpy()
    monkeypatch.setattr(mk, "_INTERPRET", True)
    jk = test_torch_port_mel.jax_mel(x, kw)
    ref = oracle(xb, geom).reshape(got.shape)
    errs = {"plain": rel(got, plain), "jax kernel": rel(got, jk), "float64": rel(got, ref)}
    assert max(errs.values()) <= 1e-5, errs


@pytest.mark.parametrize("n_fft,n_mels,f_min,f_max", [(400, 64, 125.0, 7500.0),
                                                      (1024, 128, 0.0, None),
                                                      (512, 40, 0.0, None)])
def test_csr_reproduces_the_dense_filterbank(rng, n_fft, n_mels, f_min, f_max):
    geom = (n_fft, 160, n_fft, n_mels, 16000, f_min, f_max, 2.0, True)
    t = unpack(geom)
    fb = mel_filterbank(n_fft // 2 + 1, n_mels, 16000, f_min, f_max)
    p = rng.random((5, n_fft // 2 + 1))
    csr = np.stack([p[:, t["col"][t["row"][m]:t["row"][m + 1]]]
                    @ t["val"][t["row"][m]:t["row"][m + 1]] for m in range(n_mels)], -1)
    assert t["row"][0] == 0 and t["row"][-1] == np.count_nonzero(fb)
    assert rel(csr, p @ fb) <= 1e-12


# ----------------------------------------------------------- the launch path
class _Library:
    """Stands in for the kernel library: records the launches of each path."""

    def __init__(self):
        self.fft, self.dense = [], []

    def dm_fused_mel_fft(self, *args):
        self.fft.append(args)
        return 0

    def dm_fused_mel(self, *args):
        self.dense.append(args)
        return 0

    def dm_fused_mel_fft_blocks(self, *args):
        return 3

    def __getattr__(self, name):      # the shared-memory queries
        return lambda *a: 1024


@pytest.fixture
def stand_in(monkeypatch):
    """The launch path on CPU tensors seen as on one CUDA device of 132 SMs."""
    lib = _Library()
    real = tmel.mel_plan
    ops, bases = tmel._fft_operands, tmel._kernel_bases
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda device: 7)
    monkeypatch.setattr(tmel, "use_plain", lambda x, name: False)
    monkeypatch.setattr(tmel, "mel_plan", lambda *a: real(*a[:-1], CUDA))
    monkeypatch.setattr(tmel, "_fft_operands", lambda *a: ops(*a[:-1], torch.device("cpu")))
    monkeypatch.setattr(tmel, "_kernel_bases", lambda *a: bases(*a[:-1], torch.device("cpu")))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: type("Props", (), {"multi_processor_count": 132}))
    real.cache_clear()
    kernels.reset_launch_counts()
    return lib, real


def test_plan_is_made_once_and_each_call_is_one_launch(stand_in):
    lib, real = stand_in
    x = torch.zeros(1, 160000)
    for _ in range(3):
        out = tmel.fused_mel_spectrogram(x, 400, 160, 400, 64, 16000, 125.0, 7500.0)
        assert out.shape == (1, 64, 1001) and out.dtype == torch.float32
    tmel.fused_mel_spectrogram(torch.zeros(2, 16001), n_fft=389, win_length=389, power=1.5)
    info = real.cache_info()
    assert (info.misses, info.hits) == (2, 2)
    assert len(lib.fft) == 3 and len(lib.dense) == 1
    assert kernels.launch_counts()["fused_mel_spectrogram"] == 4
    xp, tabf, tabi, _, bsz, length, t, hop, n_fft, n1, n2, mels, nnz, frames, mode, power, \
        max_blocks, stream = lib.fft[0]
    assert (xp, bsz, length, t, hop, n_fft, n1, n2, mels, frames, mode, power, max_blocks,
            stream) == (x.data_ptr(), 1, 160000, 1001, 160, 400, 20, 20, 64, tmel.FFT_FRAMES,
                        2, 2.0, 3 * 132, 7)
    tables = tmel._fft_operands(400, 20, 20, 400, 64, 16000, 125.0, 7500.0, True, CUDA)
    assert (tabf, tabi, nnz) == (tables[0].data_ptr(), tables[1].data_ptr(), tables[2])
    assert lib.dense[0][13] == 0   # power 1.5: the powf epilogue


def test_no_autograd_function_without_a_gradient(stand_in, monkeypatch):
    """Under no_grad, or for an input that wants no gradient, the wrapper
    launches directly; with one it goes through the autograd function."""
    lib, _ = stand_in
    applied = []
    real_apply = tmel._FusedMel.apply
    monkeypatch.setattr(tmel._FusedMel, "apply", lambda *a: applied.append(1) or real_apply(*a))
    x = torch.zeros(2, 8000)
    tmel.fused_mel_spectrogram(x)
    with torch.no_grad():
        tmel.fused_mel_spectrogram(x.clone().requires_grad_(True))
    assert not applied and len(lib.fft) == 2
    tmel.fused_mel_spectrogram(x.clone().requires_grad_(True))
    assert applied == [1] and len(lib.fft) == 3


def test_plan_rejects_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(build, "library", lambda: _Library())
    geom = tuple(DEFAULTS.values())
    with pytest.raises(ValueError):        # not a CUDA device
        tmel.mel_plan(*geom, torch.device("cpu"))
    with pytest.raises(ValueError):        # more mels than the kernel's 128
        tmel.mel_plan(*geom[:3], 160, *geom[4:], CUDA)
    with pytest.raises(ValueError):        # a window longer than the frame
        tmel.mel_plan(400, 160, 401, *geom[3:], CUDA)
