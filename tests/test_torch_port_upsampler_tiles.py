"""The bf16 upsampler kernel's tiling (`csrc/upsampler.cu`, the TMA + wgmma
path) and the mask kernels' second g layout (`csrc/leaky_mask.cu`), on the
CPU, against the plain versions and the JAX package.

The upsampler kernel cannot run here, so `emulate_phase_ct` computes what its
blocks compute from the same operands: per (phase, `BLOCK_M` output rows,
`BLOCK_N` output channels), and per (`BLOCK_K`-channel slice, tap of the
phase), the box of x's rows at the tap's row offset d with zeros wherever it
leaves x, times the box of the cached tap-major weights, written where the
rows lie before t_out. In fp32 it must equal `convtranspose_plain` and the
JAX `phase_convtranspose` within 1e-5 of max |ref| (another summation order)
at the 10-s slice's three (k, stride) pairs, with a ragged input length, a
channel slice the box fills with zeros (Cin 96) and a ragged channel tile
(Cout 192).

The masks: g given as the transposed view of a (B, C, T) tensor (how the
adjoint conv leaves it) through the port's wrappers, against the JAX
`leaky_mask` / `leaky_mask_add` in interpret mode within 1e-6 (fp32, exact
selects); the mask route's backward through `_Conv1dPair` and `_Conv1dFused`,
which no longer copies the adjoint's output, against JAX's `_pair_bwd` and
`_conv1d_bwd` with the mask kernels in interpret mode within 1e-4; and the
lean launch path's pure-Python part (the cached plan and what it rejects)
through a stand-in kernel library.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmusic_tpu.pallas import conv1d_kernel as jconv
from diffmusic_tpu.pallas import mask_kernel as mk
from diffmusic_tpu.pallas import upsampler_kernel as jup
from diffmusic_tpu_torch import kernels
from diffmusic_tpu_torch.kernels import build
from diffmusic_tpu_torch.kernels import conv1d as tconv
from diffmusic_tpu_torch.kernels import conv2d as tconv2d
from diffmusic_tpu_torch.kernels import mask as tmask
from diffmusic_tpu_torch.kernels import repack
from diffmusic_tpu_torch.kernels import upsampler as tup
from test_torch_port_conv2d_tiles import box   # a TMA tile load, zeros outside

SLOPE = 0.1
CUDA = torch.device("cuda", 0)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def emulate_phase_ct(x, w, b, stride: int, k: int):
    """torch replica of the bf16 kernel's blocks on x (B, Tin, Cin), w (k,
    Cin, Cout), b (Cout,), in x's dtype: y (B, t_out, Cout)."""
    bsz, t_in, cin = x.shape
    cout = w.shape[2]
    t_out = tup.output_length(t_in, stride, k)
    rows = -(-t_out // stride)
    taps = repack.cached("phase_convtranspose", w, tup.tap_major)      # (k, Cout, Cin)
    bm, bn, bk = tup.BLOCK_M, tup.BLOCK_N, tup.BLOCK_K
    y = torch.full((bsz, t_out, cout), float("nan"), dtype=x.dtype)
    for bb in range(bsz):
        for rho in range(stride):
            for tp0 in range(0, rows, bm):
                for n0 in range(0, cout, bn):
                    acc = torch.zeros(bm, bn, dtype=x.dtype)
                    for kc in range(0, cin, bk):
                        for j, d in tup.phase_taps(k, stride, rho):
                            a = box(x[bb], (tp0 + d, kc), (bm, bk))          # K-major rows
                            wt = box(taps, (j, n0, kc), (1, bn, bk))[0]      # K-major outputs
                            acc += a @ wt.T
                    acc += box(b, (n0,), (bn,))
                    for r in range(bm):
                        t = stride * (tp0 + r) + rho
                        if t < t_out:
                            nn = min(bn, cout - n0)
                            y[bb, t, n0:n0 + nn] = acc[r, :nn]
    return y


@pytest.mark.parametrize("k,stride", [(16, 5), (16, 4), (8, 2)])
@pytest.mark.parametrize("t_in", [13, 21])
def test_emulated_tiling_matches_plain_and_jax(rng, k, stride, t_in):
    cin, cout = 96, 192
    x = arr(rng, 2, t_in, cin)
    w = arr(rng, k, cin, cout, scale=1.0 / math.sqrt(cout * k))
    b = arr(rng, cout, scale=0.1)
    t_out = tup.output_length(t_in, stride, k)
    jy = jup.phase_convtranspose(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride, k,
                                 t_out)
    y = emulate_phase_ct(*map(torch.from_numpy, (x, w, b)), stride, k)
    assert y.shape == (2, t_out, cout) and torch.isfinite(y).all()
    assert rel(y, tup.convtranspose_plain(*map(torch.from_numpy, (x, w, b)), stride, k)) <= 1e-5
    assert rel(y, jy) <= 1e-5


def test_emulated_tiling_over_several_row_tiles(rng):
    """Upsampler 0's (k, stride) at an input long enough for three row tiles
    of each phase, whose last is ragged."""
    k, stride, t_in = 16, 5, 300
    x = arr(rng, 1, t_in, 64)
    w = arr(rng, k, 64, 128, scale=1.0 / math.sqrt(128 * k))
    b = arr(rng, 128, scale=0.1)
    assert -(-tup.output_length(t_in, stride, k) // stride) > 2 * tup.BLOCK_M
    y = emulate_phase_ct(*map(torch.from_numpy, (x, w, b)), stride, k)
    assert rel(y, tup.convtranspose_plain(*map(torch.from_numpy, (x, w, b)), stride, k)) <= 1e-5


@pytest.mark.parametrize("k,stride", [(16, 5), (16, 4), (8, 2), (4, 2), (5, 5)])
def test_phase_taps_partition_the_kernel(k, stride):
    """Every tap j lies in exactly one phase, at the offset of the
    convolution's index identity, inside the range the fp32 path stages."""
    p_ct = (k - stride) // 2
    d_lo, d_hi = tup._tap_range(k, stride)
    seen = []
    for rho in range(stride):
        taps = tup.phase_taps(k, stride, rho)
        assert taps, rho                                       # k >= stride: no empty phase
        for j, d in taps:
            assert j == rho + p_ct - stride * d and d_lo <= d <= d_hi
            seen.append(j)
    assert sorted(seen) == list(range(k))


def test_upsampler_tap_major_layout():
    """tap_major(w)[j, o, c] = w[j, c, o], contiguous."""
    w = torch.arange(3 * 4 * 5, dtype=torch.float32).reshape(3, 4, 5)
    t = tup.tap_major(w)
    assert t.is_contiguous() and t.shape == (3, 5, 4)
    for j in range(3):
        assert torch.equal(t[j], w[j].T)


def test_repack_cache_keeps_one_copy_per_kernel_and_weight():
    """One copy per (kernel, weight tensor); a second call and a detached
    alias hit it; an in-place write remakes it; the same tensor under the
    conv2d and the upsampler kernels gets an entry of each."""
    for name in repack.REPACKS:
        repack.REPACKS[name] = 0
    w = torch.randn(16, 128, 64)
    t1 = repack.cached("phase_convtranspose", w, tup.tap_major)
    assert torch.equal(t1, tup.tap_major(w))
    assert repack.cached("phase_convtranspose", w, tup.tap_major) is t1
    assert repack.cached("phase_convtranspose", w.detach(), tup.tap_major) is t1
    assert repack.REPACKS == {"conv2d_same": 0, "phase_convtranspose": 1, "conv1d_pair": 0,
                              "conv1d_adjoint": 0, "conv2d_adjoint": 0}
    w4 = w.reshape(16, 128, 8, 8)
    c1 = tconv2d.cached_tap_major(w4)
    assert torch.equal(c1, tconv2d.tap_major(w4))
    assert repack.REPACKS == {"conv2d_same": 1, "phase_convtranspose": 1, "conv1d_pair": 0,
                              "conv1d_adjoint": 0, "conv2d_adjoint": 0}
    assert tconv2d.REPACKS is repack.REPACKS
    with torch.no_grad():
        w.mul_(-2.0)
    t2 = repack.cached("phase_convtranspose", w, tup.tap_major)
    assert repack.REPACKS["phase_convtranspose"] == 2 and torch.equal(t2, tup.tap_major(w))
    assert torch.equal(tconv2d.cached_tap_major(w4), tconv2d.tap_major(w4))   # shares _version
    assert repack.REPACKS == {"conv2d_same": 2, "phase_convtranspose": 2, "conv1d_pair": 0,
                              "conv1d_adjoint": 0, "conv2d_adjoint": 0}


# ---------------------------------------------------------------------- masks
@pytest.fixture
def interpret(monkeypatch):
    for module in (jconv, mk):
        monkeypatch.setattr(module, "_INTERPRET", True)
    monkeypatch.setenv("DIFFMUSIC_TPU_MASK", "pallas")


def transposed(a):
    """numpy (B, T, C) -> the torch (B, T, C) view of a contiguous (B, C, T)
    copy, as the adjoint conv leaves its output."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1))).transpose(1, 2)


@pytest.mark.parametrize("shape", [(1, 4096, 128), (2, 1031, 256)], ids=str)
def test_masks_take_a_transposed_g(interpret, rng, shape):
    h, g, r = arr(rng, *shape), arr(rng, *shape), arr(rng, *shape)
    th, tr = torch.from_numpy(h), torch.from_numpy(r)
    tg = transposed(g)
    assert not tg.is_contiguous() and torch.equal(tg, torch.from_numpy(g))
    assert tmask.launch_plan("leaky_mask", (th.shape, tg.shape), (th.stride(), tg.stride()),
                             (th.dtype, tg.dtype), (CUDA, CUDA)) == (0, tmask.G_TRANSPOSED)
    jh, jg, jr = map(jnp.asarray, (h, g, r))
    assert rel(tmask.leaky_mask(th, tg, SLOPE), mk.leaky_mask(jh, jg, SLOPE)) <= 1e-6
    assert rel(tmask.leaky_mask_add(th, tg, tr, SLOPE),
               mk.leaky_mask_add(jh, jg, jr, SLOPE)) <= 1e-6


def spy_masks(monkeypatch):
    """Record the g layout each mask wrapper receives from the backward."""
    layouts = []
    for name in ("leaky_mask", "leaky_mask_add"):
        fn = getattr(tconv, name)

        def spy(h, g, *rest, _fn=fn, _name=name):
            plan = tmask.launch_plan(_name, (h.shape, g.shape), (h.stride(), g.stride()),
                                     (h.dtype, g.dtype), (CUDA, CUDA))
            layouts.append((_name, plan[1]))
            return _fn(h, g, *rest)
        monkeypatch.setattr(tconv, name, spy)
    return layouts


def test_mask_route_pair_backward_matches_jax(interpret, rng, monkeypatch):
    """`_Conv1dPair`'s backward on the mask route hands the masks each
    adjoint's output as the conv leaves it (transposed, no copy) and equals
    JAX's `_pair_bwd` with its mask kernels in interpret mode."""
    c, k, dil = 128, 3, 3
    x = arr(rng, 1, 4096, c)
    w1, w2 = (arr(rng, k, c, c, scale=1.0 / math.sqrt(k * c)) for _ in range(2))
    b1, b2 = arr(rng, c, scale=0.1), arr(rng, c, scale=0.1)
    g = arr(rng, 1, 4096, c)
    layouts = spy_masks(monkeypatch)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tconv.conv1d_fused_pair(xt, *map(torch.from_numpy, (w1, b1, w2, b2)), dil, SLOPE,
                                mask_kernel=True)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    assert layouts == [("leaky_mask", tmask.G_TRANSPOSED), ("leaky_mask_add", tmask.G_TRANSPOSED)]
    jx, jw1, jb1, jw2, jb2 = map(jnp.asarray, (x, w1, b1, w2, b2))
    _, jh = jconv._pair_reference(jx, jw1, jb1, jw2, jb2, dil, SLOPE)
    jdx = jconv._pair_bwd(dil, SLOPE, (jx, jh, jw1, jw2), jnp.asarray(g))[0]
    assert rel(dx, jdx) <= 1e-4


def test_mask_route_single_backward_matches_jax(interpret, rng, monkeypatch):
    """The same for `_Conv1dFused` (residual path: its cotangent passes
    through) against JAX's `_conv1d_bwd`."""
    c, k, dil = 256, 11, 5
    x = arr(rng, 1, 2048, c)
    w = arr(rng, k, c, c, scale=1.0 / math.sqrt(k * c))
    b, r, g = arr(rng, c, scale=0.1), arr(rng, 1, 2048, c), arr(rng, 1, 2048, c)
    layouts = spy_masks(monkeypatch)
    xt = torch.from_numpy(x).requires_grad_(True)
    rt = torch.from_numpy(r).requires_grad_(True)
    y = tconv.conv1d_fused(xt, torch.from_numpy(w), torch.from_numpy(b), rt, dil, SLOPE,
                           mask_kernel=True)
    dx, dr = torch.autograd.grad(y, [xt, rt], torch.from_numpy(g))
    assert layouts == [("leaky_mask", tmask.G_TRANSPOSED)]
    jdx = jconv._conv1d_bwd(dil, SLOPE, True, (jnp.asarray(x), jnp.asarray(w), None),
                            jnp.asarray(g))[0]
    assert rel(dx, jdx) <= 1e-4
    assert torch.equal(dr, torch.from_numpy(g))


class _Library:
    """Stands in for the kernel library: records each mask launch."""

    def __init__(self):
        self.calls = []

    def dm_leaky_mask(self, *args):
        self.calls.append(args)
        return 0


def test_lean_launch_path(monkeypatch):
    """The launch path through a stand-in library, on meta tensors seen as
    one CUDA device: the plan is made once per operand geometry and read
    from the cache after; the arguments follow the g layout; the counts
    move once per launch."""
    lib = _Library()
    real_plan = tmask.launch_plan
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda device: 7)
    monkeypatch.setattr(tmask, "use_plain", lambda x, name: False)
    monkeypatch.setattr(tmask, "launch_plan", lambda name, sh, st, dt, dev: real_plan(
        name, sh, st, dt, (CUDA,) * len(dev)))
    h, r = (torch.empty(1, 640, 128, device="meta") for _ in range(2))
    gt = torch.empty(1, 128, 640, device="meta").transpose(1, 2)
    kernels.reset_launch_counts()
    real_plan.cache_clear()
    tmask.leaky_mask(h, gt, SLOPE)
    tmask.leaky_mask(h, gt, SLOPE)
    tmask.leaky_mask_add(h, h, r, SLOPE)
    info = real_plan.cache_info()
    assert (info.misses, info.hits) == (2, 1)
    (code, layout, *_, n, bsz, t, c, slope, stream) = lib.calls[0]
    assert (code, layout, n, bsz, t, c, stream) == (0, tmask.G_TRANSPOSED, 640 * 128, 1, 640,
                                                    128, 7)
    assert slope == pytest.approx(SLOPE)
    assert lib.calls[2][1] == tmask.G_AS_H and lib.calls[2][4] is not None
    assert lib.calls[0][4] is None                                   # no r
    counts = kernels.launch_counts()
    assert counts["leaky_mask"] == 2 and counts["leaky_mask_add"] == 1


SHAPE = torch.Size((1, 640, 128))
DENSE, TRANSPOSED = (81920, 128, 1), (81920, 1, 640)


@pytest.mark.parametrize("shapes,strides,dtypes,devices,error", [
    ((SHAPE, torch.Size((1, 641, 128))), (DENSE, DENSE), (torch.float32,) * 2, (CUDA,) * 2,
     ValueError),                                                      # shapes differ
    ((SHAPE, SHAPE), (DENSE, (81920, 2, 640)), (torch.float32,) * 2, (CUDA,) * 2,
     ValueError),                                                      # g in neither layout
    ((SHAPE, SHAPE), (TRANSPOSED, DENSE), (torch.float32,) * 2, (CUDA,) * 2,
     ValueError),                                                      # h not contiguous
    ((SHAPE,) * 3, (DENSE, DENSE, TRANSPOSED), (torch.float32,) * 3, (CUDA,) * 3,
     ValueError),                                                      # r not contiguous
    ((SHAPE, SHAPE), (DENSE, DENSE), (torch.float32, torch.bfloat16), (CUDA,) * 2,
     TypeError),                                                       # mixed dtypes
    ((SHAPE, SHAPE), (DENSE, DENSE), (torch.float16,) * 2, (CUDA,) * 2, TypeError),
    ((SHAPE, SHAPE), (DENSE, DENSE), (torch.float32,) * 2, (CUDA, torch.device("cpu")),
     ValueError),                                                      # not one CUDA device
    ((torch.Size((1, 640, 100)),) * 2, ((64000, 100, 1), (64000, 1, 640)),
     (torch.float32,) * 2, (CUDA,) * 2, ValueError),                   # transposed, C % 8 != 0
], ids=["shapes", "g-strides", "h-strides", "r-strides", "mixed", "fp16", "device", "c%8"])
def test_launch_plan_rejects_what_the_kernel_does_not_take(shapes, strides, dtypes, devices,
                                                           error):
    with pytest.raises(error):
        tmask.launch_plan("leaky_mask", shapes, strides, dtypes, devices)


def test_launch_plan_reads_both_layouts():
    f32, bf = (torch.float32,) * 2, (torch.bfloat16,) * 2
    assert tmask.launch_plan("leaky_mask", (SHAPE, SHAPE), (DENSE, DENSE), f32,
                             (CUDA,) * 2) == (0, tmask.G_AS_H)
    assert tmask.launch_plan("leaky_mask", (SHAPE, SHAPE), (DENSE, TRANSPOSED), bf,
                             (CUDA,) * 2) == (1, tmask.G_TRANSPOSED)
    # a size-1 dim's stride is free, as Tensor.is_contiguous reads it
    assert tmask.launch_plan("leaky_mask", (SHAPE, SHAPE), ((7, 128, 1), (3, 1, 640)), f32,
                             (CUDA,) * 2) == (0, tmask.G_TRANSPOSED)
