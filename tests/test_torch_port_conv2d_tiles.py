"""The bf16 conv2d kernel's tiling (`csrc/conv2d.cu`, the TMA + wgmma path),
replicated in torch on the CPU, against the plain conv2d and the JAX Pallas
kernel (`conv2d_kernel.conv2d_same_fused`) in interpret mode.

The kernel cannot run here, so `emulate_conv2d` computes what its blocks
compute from the same operands: the input's NHWC copy and the weights'
tap-major copy, per block of `BLOCK_M` output channels x `tile_rows(W)` image
rows x `tile_width(W)` columns, and per (64-channel slice, tap) the two TMA
boxes at the tap's offset with zeros wherever a box leaves the tensor,
accumulated as (BM x BK) @ (BK x BN) and written where the tile lies inside
the image. In fp32 it must equal both references within 1e-5 of max |ref|
(another summation order). It runs at one geometry of each tile width the
guided step uses (W 8, 16, 32, 64), with Cin != Cout and a ragged last row
tile; the tap-major layout and the wrapper's weight cache are tested too.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmusic_tpu.pallas import conv2d_kernel as ck
from diffmusic_tpu_torch.kernels import conv2d as tconv2d


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def box(t, starts, sizes):
    """A TMA tile load: the box of `sizes` at `starts` (which may lie partly
    or wholly outside t), elements outside t read as zero."""
    out = torch.zeros(sizes, dtype=t.dtype)
    src, dst = [], []
    for s0, n, dim in zip(starts, sizes, t.shape):
        lo, hi = max(s0, 0), min(s0 + n, dim)
        if hi <= lo:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - s0, hi - s0))
    out[tuple(dst)] = t[tuple(src)]
    return out


def emulate_conv2d(x, w, b):
    """torch replica of the bf16 kernel's blocks on NCHW x (B, Cin, H, W)
    and w (Cout, Cin, kh, kw), in x's dtype."""
    bsz, cin, h, wd = x.shape
    cout, _, kh, kw = w.shape
    xh = x.permute(0, 2, 3, 1).contiguous()              # the NHWC copy (B, H, W, C)
    taps = tconv2d.tap_major(w)                           # (T, Cout, Cin)
    wp, rows = tconv2d.tile_width(wd), tconv2d.tile_rows(wd)
    bm, bk = tconv2d.BLOCK_M, tconv2d.BLOCK_K
    y = torch.zeros(bsz, cout, h, wd, dtype=x.dtype)
    for bb in range(bsz):
        for h0 in range(0, h, rows):
            for w0 in range(0, wd, wp):
                for m0 in range(0, cout, bm):
                    acc = torch.zeros(bm, rows * wp, dtype=x.dtype)
                    for kc in range(0, cin, bk):
                        for t in range(kh * kw):
                            dh, dw = t // kw - kh // 2, t % kw - kw // 2
                            a = box(taps, (t, m0, kc), (1, bm, bk))[0]        # (BM, BK)
                            # [row][w][channel]: BN K-major pixel rows
                            win = box(xh[bb], (h0 + dh, w0 + dw, kc), (rows, wp, bk))
                            acc += a @ win.reshape(rows * wp, bk).T
                    acc += box(b, (m0,), (bm,))[:, None]
                    tile = acc.reshape(bm, rows, wp)
                    nm, nr, nc = min(bm, cout - m0), min(rows, h - h0), min(wp, wd - w0)
                    y[bb, m0:m0 + nm, h0:h0 + nr, w0:w0 + nc] = tile[:nm, :nr, :nc]
    return y


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(ck, "_INTERPRET", True)


# (H, W, Cin, Cout): one geometry per tile width of the guided step (8, 16, 32,
# 64 columns: 16, 8, 4, 2 rows a tile); each H leaves a ragged last row tile
# and meets the JAX kernel's rule (H * W >= 512)
GEOMS = [(70, 8, 256, 128), (37, 16, 128, 256), (17, 32, 256, 128), (9, 64, 128, 256)]


@pytest.mark.parametrize("h,w,cin,cout", GEOMS, ids=lambda v: str(v))
def test_emulated_tiling_matches_plain_and_jax(interpret, rng, h, w, cin, cout):
    x = rng.standard_normal((1, h, w, cin)).astype(np.float32)                 # NHWC
    wt = (rng.standard_normal((3, 3, cin, cout)) / math.sqrt(9 * cin)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    assert ck._eligible(x, wt)                                                # the Pallas kernel runs
    jy = np.asarray(ck.conv2d_same_fused(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias)))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    w_oihw = torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1)))
    y = emulate_conv2d(xt, w_oihw, torch.from_numpy(bias))
    assert tconv2d.tile_rows(w) * tconv2d.tile_width(w) == tconv2d.BLOCK_N
    assert tconv2d.tile_width(w) == w                  # whole image rows, no idle columns
    assert rel(y, tconv2d.conv2d_plain(xt, w_oihw, torch.from_numpy(bias))) <= 1e-5
    assert rel(y.permute(0, 2, 3, 1).numpy(), jy) <= 1e-5


@pytest.mark.parametrize("h,w,cin,cout,k", [(9, 20, 96, 192, (3, 3)), (10, 12, 64, 64, (1, 3)),
                                            (3, 130, 32, 64, (3, 5))], ids=str)
def test_emulated_tiling_at_ragged_widths_and_channels(rng, h, w, cin, cout, k):
    """What the wrapper's contract takes beyond the guided step: tiles wider
    than the image (W 20 and 12), two column tiles (W 130), a channel slice
    and a channel tile that TMA fills with zeros (Cin 96 and 32, Cout 192 and
    64), taps (1, 3) and (3, 5)."""
    x = torch.from_numpy(rng.standard_normal((2, cin, h, w)).astype(np.float32))
    wt = torch.from_numpy((rng.standard_normal((cout, cin) + k)
                           / math.sqrt(cin * k[0] * k[1])).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(cout)).astype(np.float32))
    assert rel(emulate_conv2d(x, wt, b), tconv2d.conv2d_plain(x, wt, b)) <= 1e-5


def test_tap_major_layout():
    """tap_major(w)[i * kw + j, o, c] = w[o, c, i, j], contiguous."""
    w = torch.arange(4 * 3 * 3 * 5, dtype=torch.float32).reshape(4, 3, 3, 5)
    t = tconv2d.tap_major(w)
    assert t.is_contiguous() and t.shape == (15, 4, 3)
    for i in range(3):
        for j in range(5):
            assert torch.equal(t[i * 5 + j], w[:, :, i, j])


@pytest.mark.parametrize("w,wp", [(1, 1), (8, 8), (12, 16), (16, 16), (20, 32), (32, 32),
                                  (64, 64), (100, 128), (200, 128)])
def test_tile_width_and_rows(w, wp):
    assert tconv2d.tile_width(w) == wp
    assert tconv2d.tile_rows(w) * wp == tconv2d.BLOCK_N


def test_tap_major_cache_repacks_once_per_weight():
    """One copy per weight tensor: a second call, a detached alias and a module
    rebuilt on the same weights (as `load_state_dict(..., assign=True)` does)
    hit it; an in-place write remakes it; a new tensor gets its own."""
    tconv2d.REPACKS["conv2d_same"] = 0
    conv = torch.nn.Conv2d(64, 128, 3)
    w = conv.weight
    t1 = tconv2d.cached_tap_major(w)
    assert torch.equal(t1, tconv2d.tap_major(w))
    assert tconv2d.cached_tap_major(w) is t1
    assert tconv2d.cached_tap_major(w.detach()) is t1
    rebuilt = torch.nn.Conv2d(64, 128, 3, device="meta")
    rebuilt.load_state_dict(conv.state_dict(), assign=True)
    assert tconv2d.cached_tap_major(rebuilt.weight) is t1
    assert tconv2d.REPACKS["conv2d_same"] == 1
    with torch.no_grad():
        w.mul_(-2.0)
    t2 = tconv2d.cached_tap_major(w)
    assert tconv2d.REPACKS["conv2d_same"] == 2 and torch.equal(t2, tconv2d.tap_major(w))
    other = torch.randn(128, 64, 3, 3)
    assert torch.equal(tconv2d.cached_tap_major(other), tconv2d.tap_major(other))
    assert tconv2d.REPACKS["conv2d_same"] == 3


def test_tap_major_cache_forgets_dead_weights():
    """Once a weight is gone, a new tensor at its address gets its own copy,
    whatever its values."""
    for seed in range(4):
        w = torch.randn(128, 64, 3, 3, generator=torch.Generator().manual_seed(seed))
        assert torch.equal(tconv2d.cached_tap_major(w), tconv2d.tap_major(w))
        del w
