"""The bf16 conv1d pair kernel's tiling (`csrc/conv1d.cu`, the TMA + wgmma
path of `conv1d_fused_pair` and `conv1d_pair_canvas`), on the CPU, against the
plain versions and the JAX package.

The kernel cannot run here, so `emulate_pair` computes what its blocks compute
from the same operands, in two passes (h, then y from h): per (`BLOCK_M`-row
tile, `BLOCK_N`-channel Cout tile), and per (`BLOCK_K`-channel slice, tap j),
the box of the pass's input starting at row t0 + j * dil - pad with zeros
wherever it leaves the tensor, the leaky ReLU on it in fp32 rounded to bf16
per element, times the box of the weights' tap-major copy, summed in fp32;
then the bias (pass 2 also the residual x) in fp32, one rounding to bf16, and
exact zeros on the rows outside the signal; a tile with no signal row writes
zeros only. Inputs are bf16 values made by numpy from a seed. Within 2e-2 of
max |ref| (TOL_CONV_BF16: the plain version rounds where the kernel keeps
fp32, and the JAX kernel rounds leaky(h) from fp32 where the kernel reads h
rounded, one bf16 ulp apart on negative h) it must equal `pair_plain` /
`pair_canvas_plain` in bf16 and the JAX `conv1d_fused_pair` /
`conv1d_pair_canvas` Pallas kernels in interpret mode, y and h, at C 128 and
256, every k of {3, 7, 11} and dilation of {1, 3, 5}, ragged T, T under one
row tile, on the canvas (whose margins hold row tiles with no signal row)
and off it.

The launch path's pure-Python part runs through a stand-in kernel library:
the plan made once per operand geometry, what it rejects, one tap-major copy
(with its tensor map) per weight tensor shared by the plain and the canvas
form, and, through the meta-device stand-in of `test_torch_port_canvas.py`,
the full-width vocoder's 24 pairs on the new path.
"""

import math
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_canvas as canvas_test
from diffmusic_tpu.pallas import conv1d_kernel as ck
from diffmusic_tpu_torch import kernels
from diffmusic_tpu_torch.kernels import build, repack
from diffmusic_tpu_torch.kernels import canvas as tcanvas
from diffmusic_tpu_torch.kernels import conv1d as tconv
from diffmusic_tpu_torch.models import configs as tcfg
from diffmusic_tpu_torch.models import hifigan as thifigan
from test_torch_port_conv2d_tiles import box   # a TMA tile load, zeros outside

SLOPE = 0.1
TOL = 2e-2   # chip_smoke.TOL_CONV_BF16
CUDA = torch.device("cuda", 0)
BF = torch.bfloat16


def f64(a):
    return (a.double().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(np.asarray(a, np.float32), np.float64))


def rel(a, b) -> float:
    a, b = f64(a), f64(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def bf16_arr(rng, *shape, scale=1.0):
    """A float32 array of bf16 values: the inputs both frameworks take."""
    a = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    return a.to(BF).float().numpy()


def leaky_bf16(a):
    """leaky(a) in fp32, rounded to bf16 (the kernel's pass over a staged
    tile), kept as fp32 values."""
    return torch.where(a >= 0, a, SLOPE * a).to(BF).float()


def emulate_pass(inp, taps, bias, res, dil, sig0, sig1):
    """One pass of the kernel's blocks on inp (B, T, C) and the tap-major
    taps (k, Cout, Cin), all bf16 values held in fp32: out (B, T, C)."""
    bsz, rows, c = inp.shape
    k = taps.shape[0]
    pad = (k - 1) * dil // 2
    bm, bn, bk = tconv.BLOCK_M, tconv.BLOCK_N, tconv.BLOCK_K
    out = torch.full((bsz, rows, c), float("nan"))
    for b in range(bsz):
        for t0 in range(0, rows, bm):
            for n0 in range(0, c, bn):
                r1, n1 = min(t0 + bm, rows), min(n0 + bn, c)
                if t0 + bm <= sig0 or t0 >= sig1:    # no signal row: zeros only
                    out[b, t0:r1, n0:n1] = 0.0
                    continue
                acc = torch.zeros(bm, bn)
                for kc in range(0, c, bk):
                    for j in range(k):
                        a = leaky_bf16(box(inp[b], (t0 + j * dil - pad, kc), (bm, bk)))
                        wt = box(taps, (j, n0, kc), (1, bn, bk))[0]      # K-major outputs
                        acc += a @ wt.T
                acc += box(bias, (n0,), (bn,))
                if res is not None:
                    acc += box(res[b], (t0, n0), (bm, bn))
                acc = acc.to(BF).float()
                t = torch.arange(t0, t0 + bm)[:, None]
                acc = torch.where((t >= sig0) & (t < sig1), acc, torch.zeros(()))
                out[b, t0:r1, n0:n1] = acc[:r1 - t0, :n1 - n0]
    return out


def emulate_pair(x, w1, b1, w2, b2, dil, sig=None):
    """(y, h) of the bf16 pair kernel's two passes on x (B, T, C), with the
    signal on rows `sig` = (sig0, sig1) (all rows if None)."""
    sig0, sig1 = sig or (0, x.shape[1])
    h = emulate_pass(x, tconv.tap_major(w1), b1, None, dil, sig0, sig1)
    y = emulate_pass(h, tconv.tap_major(w2), b2, x, 1, sig0, sig1)
    return y, h


def pair_operands(rng, c, k):
    w1, w2 = (bf16_arr(rng, k, c, c, scale=1 / math.sqrt(k * c)) for _ in range(2))
    b1, b2 = bf16_arr(rng, c, scale=0.1), bf16_arr(rng, c, scale=0.1)
    return w1, b1, w2, b2


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(ck, "_INTERPRET", True)


def check(got, plain, jax_ref):
    """(y, h) of the emulation against the plain version's and JAX's."""
    errs = {}
    for i, name in enumerate(("y", "h")):
        assert torch.isfinite(got[i]).all(), name
        errs[f"{name} vs plain"] = rel(got[i], plain[i])
        errs[f"{name} vs jax"] = rel(got[i], jax_ref[i])
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("bsz,t,c,k,dil", [(2, 300, 128, 3, 1), (1, 1031, 256, 11, 5),
                                           (1, 100, 128, 7, 3)], ids=str)
def test_emulated_pair_matches_plain_and_jax(interpret, rng, bsz, t, c, k, dil):
    x = bf16_arr(rng, bsz, t, c)
    ops = pair_operands(rng, c, k)
    tx, tw = torch.from_numpy(x), tuple(map(torch.from_numpy, ops))
    got = emulate_pair(tx, *tw, dil)
    plain = tconv.pair_plain(tx.to(BF), *(a.to(BF) for a in tw), dil, SLOPE)
    jy, jh = ck._conv1d_pair_pallas(jnp.asarray(x, jnp.bfloat16),
                                    *(jnp.asarray(a, jnp.bfloat16) for a in ops), dil, SLOPE)
    check(got, plain, (jy, jh))


@pytest.mark.parametrize("t,c,k,dil", [(700, 128, 11, 3), (300, 256, 7, 5), (100, 128, 3, 1)],
                         ids=str)
def test_emulated_pair_canvas_matches_plain_and_jax(interpret, rng, t, c, k, dil):
    """On the canvas: the margin tiles hold no signal row, the signal's first
    and last tiles hold both; everything outside the signal is exactly 0."""
    xs = bf16_arr(rng, 1, t, c)
    xc = tcanvas.to_canvas(torch.from_numpy(xs))
    ops = pair_operands(rng, c, k)
    tw = tuple(map(torch.from_numpy, ops))
    sig = (tcanvas.TIME_BLOCK, tcanvas.TIME_BLOCK + t)
    assert any(t0 + tconv.BLOCK_M <= sig[0] for t0 in range(0, xc.shape[1], tconv.BLOCK_M))
    got = emulate_pair(xc, *tw, dil, sig)
    for a in got:
        assert not a[:, :sig[0]].any() and not a[:, sig[1]:].any()
    plain = tconv.pair_canvas_plain(xc.to(BF), *(a.to(BF) for a in tw), t, dil, SLOPE)
    jy, jh = ck._pair_canvas_pallas(jnp.asarray(xc.numpy(), jnp.bfloat16),
                                    *(jnp.asarray(a, jnp.bfloat16) for a in ops), t, dil, SLOPE)
    check(got, plain, (jy, jh))


@pytest.mark.parametrize("t,c,blocks", [(5001, 512, 160), (20004, 256, 314), (40008, 128, 313)])
def test_block_counts_at_the_slice_stages(t, c, blocks):
    """The grid of each pass at the 10-s slice's vocoder stages 0-2: row tiles
    x Cout tiles."""
    assert -(-t // tconv.BLOCK_M) * -(-c // tconv.BLOCK_N) == blocks


# ----------------------------------------------------------- the launch path
class _Library:
    """Stands in for the kernel library: records the pair launches and the
    tensor maps encoded; every call succeeds."""

    def __init__(self):
        self.pairs, self.wmaps = [], []

    def dm_conv1d_pair(self, *args):
        self.pairs.append(args)
        return 0

    def dm_conv1d_pair_wmap(self, taps, k, c, out):
        self.wmaps.append((taps, k, c, out))
        return 0

    def __getattr__(self, name):
        return lambda *a: 0


@pytest.fixture
def stand_in(monkeypatch):
    """The launch path on CPU tensors seen as one CUDA device."""
    lib = _Library()
    real_plan = tconv.pair_plan
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda device: 7)
    monkeypatch.setattr(tconv, "pair_plan", lambda name, sh, st, dt, dev, d, t: real_plan(
        name, sh, st, dt, (CUDA,) * len(dev), d, t))
    real_plan.cache_clear()
    kernels.reset_launch_counts()
    for name in repack.REPACKS:
        repack.REPACKS[name] = 0
    return lib, real_plan


def test_pair_launch_path_shares_one_copy_per_weight(stand_in):
    """#4 and #7 on the same weights make one tap-major copy (and one tensor
    map) per weight tensor; later calls read the cached map; an in-place
    write remakes the copy; each call counts one launch of its form and
    passes its geometry and signal rows."""
    (lib, _), c, k, t = stand_in, 128, 3, 300
    x = torch.randn(1, t, c).to(BF)
    xc = tcanvas.to_canvas(torch.randn(1, t, c)).to(BF)
    w1, w2 = (torch.randn(k, c, c).to(BF) for _ in range(2))
    b = torch.randn(c).to(BF)
    for _ in range(2):
        tconv._launch_pair(x, w1, b, w2, b, 3, SLOPE)
        tconv._launch_pair(xc, w1, b, w2, b, 3, SLOPE, t)
    assert repack.REPACKS["conv1d_pair"] == 2 and len(lib.wmaps) == 2
    copies = [repack.cached(tconv.REPACK, w, None) for w in (w1, w2)]
    assert [m[:3] for m in lib.wmaps] == [(cp[0].data_ptr(), k, c) for cp in copies]
    assert all(torch.equal(cp[0], tconv.tap_major(w)) for cp, w in zip(copies, (w1, w2)))
    for args in lib.pairs:
        code, _, w1p, _, w2p = args[:5]
        assert code == 1 and (w1p, w2p) == tuple(cp[1].data_ptr() for cp in copies)
    sigs = [args[-3:-1] for args in lib.pairs]
    assert sigs == [(0, t), (512, 512 + t)] * 2
    assert [args[8:13] for args in lib.pairs[:2]] == [(1, t, c, k, 3),
                                                     (1, tcanvas.canvas_rows(t), c, k, 3)]
    counts = kernels.launch_counts()
    assert counts["conv1d_fused_pair"] == 2 and counts["conv1d_pair_canvas"] == 2
    with torch.no_grad():
        w1.mul_(-1.0)                                           # _version moves
    tconv._launch_pair(x, w1, b, w2, b, 3, SLOPE)
    assert repack.REPACKS["conv1d_pair"] == 3 and len(lib.wmaps) == 3


def test_pair_plan_is_made_once_per_geometry(stand_in):
    """The plan is read from its cache for a geometry seen before; fp32
    makes no copy and passes the weights' own addresses."""
    (lib, real_plan), c = stand_in, 128
    x, y = torch.randn(1, 200, c), torch.randn(1, 300, c)
    w, b = torch.randn(3, c, c), torch.randn(c)
    for a in (x, x, y, x):
        tconv._launch_pair(a, w, b, w, b, 1, SLOPE)
    info = real_plan.cache_info()
    assert (info.misses, info.hits) == (2, 2)
    assert [args[-3:-1] for args in lib.pairs] == [(0, 200), (0, 200), (0, 300), (0, 200)]
    assert repack.REPACKS["conv1d_pair"] == 0 and not lib.wmaps
    assert all(args[0] == 0 and (args[2], args[4]) == (w.data_ptr(),) * 2 for args in lib.pairs)


X, W, B = torch.Size((1, 200, 128)), torch.Size((3, 128, 128)), torch.Size((128,))
XS, WS, BS = (25600, 128, 1), (16384, 128, 1), (1,)


@pytest.mark.parametrize("shapes,strides,dtypes,devices,t,error", [
    ((X, W, B, W, B), (XS, WS, BS, WS, BS), (BF,) * 5, (CUDA,) * 4 + (torch.device("cpu"),),
     None, ValueError),                                                # not one CUDA device
    ((X, W, B, W, B), (XS, WS, BS, WS, BS), (BF,) * 4 + (torch.float32,), (CUDA,) * 5, None,
     TypeError),                                                       # mixed dtypes
    ((X, W, B, W, B), (XS, WS, BS, WS, BS), (torch.float16,) * 5, (CUDA,) * 5, None,
     TypeError),                                                       # fp16
    ((X, W, B, W, B), ((25600, 1, 200), WS, BS, WS, BS), (BF,) * 5, (CUDA,) * 5, None,
     ValueError),                                                      # x not contiguous
    ((X, torch.Size((3, 128, 256)), B, W, B), (XS, (32768, 256, 1), BS, WS, BS), (BF,) * 5,
     (CUDA,) * 5, None, ValueError),                                   # w1 not (k, C, C)
    ((X, torch.Size((4, 128, 128)), B, torch.Size((4, 128, 128)), B), (XS, WS, BS, WS, BS),
     (BF,) * 5, (CUDA,) * 5, None, ValueError),                        # even k
    ((torch.Size((1, 200, 96)), torch.Size((3, 96, 96)), torch.Size((96,)),
      torch.Size((3, 96, 96)), torch.Size((96,))), ((19200, 96, 1), (9216, 96, 1), BS,
                                                    (9216, 96, 1), BS), (BF,) * 5, (CUDA,) * 5,
     None, ValueError),                                                # C % 64 != 0
    ((X, W, B, W, B), (XS, WS, BS, WS, BS), (BF,) * 5, (CUDA,) * 5, 300, ValueError),
], ids=["device", "mixed", "fp16", "x-strides", "w-shape", "even-k", "c%64", "canvas-rows"])
def test_pair_plan_rejects_what_the_kernel_does_not_take(monkeypatch, shapes, strides, dtypes,
                                                         devices, t, error):
    monkeypatch.setattr(build, "library", _Library)
    with pytest.raises(error):
        tconv.pair_plan("conv1d_fused_pair", shapes, strides, dtypes, devices, 1, t)


@pytest.mark.parametrize("canvas,form", [("off", "conv1d_fused_pair"),
                                         ("xbwd", "conv1d_pair_canvas")])
def test_full_width_vocoder_pairs_take_the_new_path(monkeypatch, canvas, form):
    """A full-width bf16 vocoder forward on the meta device: its 24 pairs
    launch through the bf16 path (dtype code 1, the cached tensor maps, both
    passes in one call), at the 24 (C, k, dilation) of stages 0-2."""
    lib = _Library()
    with torch.device("meta"):
        model = thifigan.SpeechT5HifiGan(tcfg.HiFiGANConfig(), canvas=canvas).to(BF)
    mel = torch.empty(1, 1000, 64, device="meta", dtype=BF)
    with canvas_test.meta_launches(monkeypatch), monkeypatch.context() as mp:
        mp.setattr(build, "library", lambda: lib)
        kernels.reset_launch_counts()
        with torch.no_grad():
            model(mel)
        counts = kernels.launch_counts()
    assert counts[form] == 24 and len(lib.pairs) == 24
    assert all(args[0] == 1 for args in lib.pairs)
    seen = Counter((args[10], args[11], args[12]) for args in lib.pairs)
    want = Counter((c, k, d) for c, ks in ((512, (3, 7)), (256, (3, 7, 11)), (128, (3, 7, 11)))
                   for k in ks for d in (1, 3, 5))
    assert seen == want
    sig0 = {args[-3] for args in lib.pairs}
    assert sig0 == ({tcanvas.TIME_BLOCK} if canvas == "xbwd" else {0})
