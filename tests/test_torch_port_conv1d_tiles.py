"""The bf16 conv1d kernel's tiling (`csrc/conv1d.cu`, the TMA + wgmma path of
`conv1d_fused_pair` and `conv1d_pair_canvas`, and of `conv1d_fused` and
`conv1d_fused_canvas` with its adjoint), on the CPU, against the plain
versions and the JAX package.

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

`emulate_single` is one pass of the same blocks: the forward with or without
the slope, the bias and the residual, and the adjoint, which reads the
weight tensor as it lies, tap k-1-j's (Cin, Cout) matrix as its (N, K)
operand. Held within the same 2e-2 against `conv1d_plain` / `canvas_plain`
(the adjoint: `canvas_plain` of the flipped transposed kernel) and the JAX
`conv1d_fused` / `conv1d_fused_canvas` in interpret mode, the adjoint through
the canvas conv's backward (`_canvas_bwd`), on and off the canvas at C 128
and 256, every k and dilation, ragged T and T under one row tile.

The launch path's pure-Python part runs through a stand-in kernel library:
the plan made once per operand geometry, what it rejects, one tap-major copy
(with its tensor map) per weight tensor shared by the plain and the canvas
form, and, through the meta-device stand-in of `test_torch_port_canvas.py`,
the full-width vocoder's 24 pairs on the new path; for the single conv, its
plan, the forward reading the pair's cached copy, the adjoint a map over the
weight itself, and the full-width vocoder's single convs, forward and
adjoint, on the new path.
"""

import math
from collections import Counter

import jax
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
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

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


def leaky_bf16(a, slope=SLOPE):
    """leaky(a) in fp32, rounded to bf16 (the kernel's pass over a staged
    tile), kept as fp32 values."""
    return torch.where(a >= 0, a, slope * a).to(BF).float()


def emulate_pass(inp, taps, bias, res, dil, sig0, sig1, slope=SLOPE, flip=False, raw=False):
    """One pass of the kernel's blocks on inp (B, T, Cin) and k weight
    matrices taps (k, Cout, Cin), all bf16 values held in fp32: out (B, T,
    Cout). Tap j reads matrix j, or k-1-j with `flip` (the adjoint); with
    `slope` None there is no leaky; bias and res may be None. With `raw` the
    fp32 sums themselves, zero off the signal, for another epilogue (the
    stage backward's masks)."""
    bsz, rows, cin = inp.shape
    k, cout = taps.shape[:2]
    pad = (k - 1) * dil // 2
    bm, bn, bk = tconv.BLOCK_M, tconv.BLOCK_N, tconv.BLOCK_K
    out = torch.full((bsz, rows, cout), float("nan"))
    for b in range(bsz):
        for t0 in range(0, rows, bm):
            for n0 in range(0, cout, bn):
                r1, n1 = min(t0 + bm, rows), min(n0 + bn, cout)
                if t0 + bm <= sig0 or t0 >= sig1:    # no signal row: zeros only
                    out[b, t0:r1, n0:n1] = 0.0
                    continue
                acc = torch.zeros(bm, bn)
                for kc in range(0, cin, bk):
                    for j in range(k):
                        a = box(inp[b], (t0 + j * dil - pad, kc), (bm, bk))
                        if slope is not None:
                            a = leaky_bf16(a, slope)
                        tap = k - 1 - j if flip else j
                        wt = box(taps, (tap, n0, kc), (1, bn, bk))[0]    # K-major outputs
                        acc += a @ wt.T
                if bias is not None:
                    acc += box(bias, (n0,), (bn,))
                if res is not None:
                    acc += box(res[b], (t0, n0), (bm, bn))
                if not raw:
                    acc = acc.to(BF).float()
                t = torch.arange(t0, t0 + bm)[:, None]
                acc = torch.where((t >= sig0) & (t < sig1), acc, torch.zeros(()))
                out[b, t0:r1, n0:n1] = acc[:r1 - t0, :n1 - n0]
    return out


def emulate_single(x, w, b, res, dil, slope, sig=None, adjoint=False):
    """The bf16 single conv's one pass on x (B, T, Cin) and w (k, Cin, Cout),
    with the signal on rows `sig` (all rows if None): the forward reads the
    tap-major copy; the adjoint (x then holds the cotangent, Cout channels)
    reads w as it lies, tap k-1-j."""
    sig0, sig1 = sig or (0, x.shape[1])
    taps = w if adjoint else tconv.tap_major(w)
    return emulate_pass(x, taps, b, res, dil, sig0, sig1, slope, flip=adjoint)


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


# (B, T, C, k, dilation, slope, bias, residual) of the single conv off the
# canvas: ragged T, T under one row tile, each operand present and absent
SINGLE = [(2, 300, 128, 3, 1, SLOPE, True, True), (1, 1031, 256, 11, 5, SLOPE, True, False),
          (1, 100, 128, 7, 3, None, False, True), (1, 260, 256, 7, 3, None, True, False)]


def single_operands(rng, bsz, t, c, k, bias, res):
    x = bf16_arr(rng, bsz, t, c)
    w = bf16_arr(rng, k, c, c, scale=1 / math.sqrt(k * c))
    b = bf16_arr(rng, c, scale=0.1) if bias else None
    r = bf16_arr(rng, bsz, t, c) if res else None
    return x, w, b, r


def jax_single(fn, x, w, b, r, *args):
    """The JAX function on bf16 copies; a missing bias is zeros there."""
    j = lambda a: jnp.asarray(a, jnp.bfloat16)
    jb = j(b if b is not None else np.zeros(w.shape[2], np.float32))
    return fn(j(x), j(w), jb, j(r) if r is not None else None, *args, r is not None)


def torch_or_none(a):
    return torch.from_numpy(a) if a is not None else None


@pytest.mark.parametrize("bsz,t,c,k,dil,slope,bias,res", SINGLE, ids=str)
def test_emulated_single_matches_plain_and_jax(interpret, rng, bsz, t, c, k, dil, slope, bias,
                                               res):
    x, w, b, r = single_operands(rng, bsz, t, c, k, bias, res)
    tx, tw, tb, tr = map(torch_or_none, (x, w, b, r))
    got = emulate_single(tx, tw, tb, tr, dil, slope)
    assert torch.isfinite(got).all()
    bf = lambda a: a.to(BF) if a is not None else None
    plain = tconv.conv1d_plain(bf(tx), bf(tw), bf(tb), dil, slope, bf(tr))
    jy = jax_single(ck.conv1d_fused, x, w, b, r, dil, slope)
    errs = {"plain": rel(got, plain), "jax": rel(got, jy)}
    assert max(errs.values()) <= TOL, errs


# (T, C, k, dilation, slope, bias, residual) on the canvas; the adjoint runs
# at each (T, C, k, dilation)
SINGLE_CANVAS = [(700, 128, 11, 3, SLOPE, True, False), (300, 256, 7, 5, None, True, True),
                 (100, 128, 3, 1, SLOPE, False, True), (1100, 256, 3, 1, SLOPE, True, True)]


@pytest.mark.parametrize("t,c,k,dil,slope,bias,res", SINGLE_CANVAS, ids=str)
def test_emulated_single_canvas_matches_plain_and_jax(interpret, rng, t, c, k, dil, slope,
                                                      bias, res):
    """The canvas conv's forward and its adjoint pass (w read as it lies, tap
    k-1-j), the adjoint against `canvas_plain` of the flipped transposed
    kernel and against the JAX canvas conv's backward (slope None, so the
    backward is the adjoint alone); exact zeros outside the signal."""
    x, w, b, _ = single_operands(rng, 1, t, c, k, bias, False)
    xc = np.array(ck.to_canvas(jnp.asarray(x)))
    gc = np.array(ck.to_canvas(jnp.asarray(bf16_arr(rng, 1, t, c))))
    rc = np.array(ck.to_canvas(jnp.asarray(bf16_arr(rng, 1, t, c)))) if res else None
    sig = (tcanvas.TIME_BLOCK, tcanvas.TIME_BLOCK + t)
    txc, tgc, tw, tb, trc = map(torch_or_none, (xc, gc, w, b, rc))
    bf = lambda a: a.to(BF) if a is not None else None
    got = emulate_single(txc, tw, tb, trc, dil, slope, sig)
    dx = emulate_single(tgc, tw, None, None, dil, None, sig, adjoint=True)
    for a in (got, dx):
        assert torch.isfinite(a).all()
        assert not a[:, :sig[0]].any() and not a[:, sig[1]:].any()
    plain = tconv.canvas_plain(bf(txc), bf(tw), bf(tb), t, dil, slope, bf(trc))
    dx_plain = tconv.canvas_plain(bf(tgc), bf(tw).flip(0).transpose(1, 2), None, t, dil)
    jy = jax_single(ck.conv1d_fused_canvas, xc, w, b, rc, t, dil, slope)
    j = lambda a: jnp.asarray(a, jnp.bfloat16)
    _, vjp = jax.vjp(lambda x_: ck.conv1d_fused_canvas(x_, j(w), j(np.zeros(c, np.float32)),
                                                       None, t, dil, None, False), j(gc))
    (jdx,) = vjp(j(gc))
    errs = {"fwd vs plain": rel(got, plain), "fwd vs jax": rel(got, jy),
            "adjoint vs plain": rel(dx, dx_plain), "adjoint vs jax": rel(dx, jdx)}
    assert max(errs.values()) <= TOL, errs


def test_adjoint_reads_the_weight_as_it_lies(rng):
    """The adjoint's identity, exactly in float64: the conv of g with the
    flipped transposed kernel is, per tap j, g shifted by j dil - pad times
    w[k-1-j] (Cin, Cout) contracted over Cout."""
    k, dil, c, t = 7, 3, 16, 40
    w = torch.from_numpy(rng.standard_normal((k, c, 2 * c)))
    g2 = torch.from_numpy(rng.standard_normal((1, t, 2 * c)))
    ref = tconv.conv1d_plain(g2, w.flip(0).transpose(1, 2), None, dil)
    pad = (k - 1) * dil // 2
    got = torch.zeros(1, t, c, dtype=torch.float64)
    for j in range(k):
        got += box(g2[0], (j * dil - pad, 0), (t, 2 * c))[None] @ w[k - 1 - j].T
    assert torch.allclose(got, ref, atol=1e-12)


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
        self.pairs, self.wmaps, self.singles = [], [], []

    def dm_conv1d_pair(self, *args):
        self.pairs.append(args)
        return 0

    def dm_conv1d_fused(self, *args):
        self.singles.append(args)
        return 0

    def dm_conv1d_wmap(self, w, k, kdim, ndim, out):
        self.wmaps.append((w, k, kdim, ndim, out))
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
    real_fused_plan = lib.fused_plan = tconv.fused_plan
    monkeypatch.setattr(tconv, "fused_plan", lambda name, sh, st, dt, dev, *rest:
                        real_fused_plan(name, sh, st, dt, (CUDA,) * len(dev), *rest))
    real_plan.cache_clear()
    real_fused_plan.cache_clear()
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


def test_single_launch_path_shares_the_pair_copy_and_maps_the_adjoint(stand_in):
    """The bf16 single conv's forward reads the tap-major copy and map that
    the pair makes for the same weight (one per weight tensor); its adjoint
    reads a tensor map over the weight itself (K = Cout, N = Cin), made once
    per weight, with no copy; the plan is made once per operand geometry."""
    (lib, _), c, k, t = stand_in, 128, 7, 300
    x = torch.randn(1, t, c).to(BF)
    gc = tcanvas.to_canvas(torch.randn(1, t, c)).to(BF)
    w, w2 = (torch.randn(k, c, c).to(BF) for _ in range(2))
    b = torch.randn(c).to(BF)
    tconv._launch_pair(x, w, b, w2, b, 3, SLOPE)
    for _ in range(2):
        tconv._launch_fused(x, w, b, x, 3, SLOPE)
        tconv._launch_fused(x, w, None, None, 1, None)
        tconv._launch_fused(gc, w, None, None, 3, None, t, adjoint=True)
    assert repack.REPACKS["conv1d_pair"] == 2 and repack.REPACKS["conv1d_adjoint"] == 1
    taps, fmap = repack.cached(tconv.REPACK, w, None)
    amap = repack.cached(tconv.ADJOINT, w, None)
    assert lib.wmaps[-1][:4] == (w.data_ptr(), k, c, c)          # w itself, no copy
    assert [m[:4] for m in lib.wmaps[:2]] == [(taps.data_ptr(), k, c, c),
                                              (repack.cached(tconv.REPACK, w2, None)[0]
                                               .data_ptr(), k, c, c)]
    fwd = [a for a in lib.singles if not a[16]]
    adj = [a for a in lib.singles if a[16]]
    assert len(fwd) == 4 and len(adj) == 2
    assert all(a[0] == 1 and a[2] == fmap.data_ptr() for a in fwd)
    assert all(a[2] == amap.data_ptr() and a[3] is None and a[4] is None for a in adj)
    assert [(a[12], a[13]) for a in fwd[:2]] == [(SLOPE, 1), (0.0, 0)]     # slope, has_slope
    assert {(a[14], a[15]) for a in adj} == {(512, 512 + t)}
    assert fwd[0][4] == x.data_ptr() and fwd[1][3] is None
    counts = kernels.launch_counts()
    assert counts["conv1d_fused"] == 4 and counts["conv1d_fused_canvas"] == 2
    with torch.no_grad():
        w.mul_(-1.0)                                              # _version moves
    tconv._launch_fused(gc, w, None, None, 3, None, t, adjoint=True)
    assert repack.REPACKS["conv1d_adjoint"] == 2


def test_fused_plan_is_made_once_per_geometry(stand_in):
    """The single conv's plan is read from its cache for a geometry seen
    before; fp32 makes no copy or map and passes the weight's own address."""
    (lib, _), c = stand_in, 128
    x, y = torch.randn(1, 200, c), torch.randn(1, 300, c)
    w, b = torch.randn(3, c, c), torch.randn(c)
    for a in (x, x, y, x):
        tconv._launch_fused(a, w, b, None, 1, SLOPE)
    info = lib.fused_plan.cache_info()
    assert (info.misses, info.hits) == (2, 2)
    assert not lib.wmaps and repack.REPACKS["conv1d_pair"] == 0
    assert all(a[0] == 0 and a[2] == w.data_ptr() for a in lib.singles)


@pytest.mark.parametrize("shapes,dtypes,adjoint,error", [
    (((1, 200, 96), (3, 96, 128), (128,)), (BF,) * 3, False, ValueError),   # bf16 Cin 96
    (((1, 200, 96), (3, 96, 128), (128,)), (torch.float32,) * 3, False, None),  # fp32 takes it
    (((1, 200, 128), (3, 128, 256), (256,)), (BF,) * 3, False, None),       # Cin != Cout
    (((1, 200, 128), (3, 128, 256)), (BF,) * 2, True, ValueError),          # adjoint: Cin 256
    (((1, 200, 256), (3, 128, 256)), (BF,) * 2, True, None),
    (((1, 200, 128), (4, 128, 128), (128,)), (BF,) * 3, False, ValueError),  # even k
    (((1, 200, 128), (3, 128, 128), (64,)), (BF,) * 3, False, ValueError),   # bias shape
], ids=["bf16-cin96", "fp32-cin96", "cin-ne-cout", "adjoint-shape", "adjoint", "even-k",
        "bias"])
def test_fused_plan_rejects_what_the_kernel_does_not_take(monkeypatch, shapes, dtypes,
                                                          adjoint, error):
    monkeypatch.setattr(build, "library", _Library)
    strides = tuple(torch.empty(sh, device="meta").stride() for sh in shapes)
    args = ("conv1d_fused", tuple(map(torch.Size, shapes)), strides, dtypes,
            (CUDA,) * len(shapes), 1, None, adjoint, len(shapes) == 3, False)
    if error is None:
        code, k, cin, cout, sig0, sig1 = tconv.fused_plan(*args)
        assert (k, sig0, sig1) == (shapes[1][0], 0, 200) and cout % 64 == 0
    else:
        with pytest.raises(error):
            tconv.fused_plan(*args)


def test_full_width_vocoder_single_convs_take_the_new_path(monkeypatch):
    """A full-width bf16 vocoder on canvas "kernel", forward and backward on
    the meta device: its 54 canvas convs launch the bf16 pass (dtype code 1)
    forward, reading the tap-major maps, and 54 adjoint passes backward, each
    reading a map over its weight; the default route's 6 ch512 k11 convs
    take the same pass."""
    lib = _Library()
    with canvas_test.meta_launches(monkeypatch), monkeypatch.context() as mp:
        mp.setattr(build, "library", lambda: lib)
        for canvas, n_fwd in (("kernel", 54), ("off", 6)):
            with torch.device("meta"):
                model = thifigan.SpeechT5HifiGan(tcfg.HiFiGANConfig(), canvas=canvas).to(BF)
            mel = torch.empty(1, 1000, 64, device="meta", dtype=BF, requires_grad=True)
            lib.singles.clear()
            y = model(mel)
            assert len(lib.singles) == n_fwd
            torch.autograd.grad(y, mel, torch.empty_like(y))
            adj = [a for a in lib.singles[n_fwd:] if a[16]]
            assert len(adj) == (54 if canvas == "kernel" else 0)
            assert all(a[0] == 1 for a in lib.singles)
            seen = Counter((a[8], a[10], a[11]) for a in lib.singles[:n_fwd])
            if canvas == "off":
                assert seen == Counter({(512, 11, 1): 4, (512, 11, 3): 1, (512, 11, 5): 1})
