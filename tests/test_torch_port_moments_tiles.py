"""The bf16 channel moments kernel's plan (`csrc/group_norm.cu`,
`moments_bf16_kernel`; `kernels/group_norm.py::moments_plan`), on the CPU,
against the plain version and the JAX package.

The kernel cannot run here, so `emulate_moments` computes what it computes
from the same bf16 values, following the plan's partition and combine order:
per (batch, channel) row, a team of `team` threads; lane j reads the loads
of `vec` elements j, j + team, ... and sums them in fp32 in order (the sum
of squares by fmaf, emulated in float64 and rounded once); the team's
butterfly (xor shuffles within a warp); for teams of several warps a
butterfly over the warps' sums in the team's first warp. It must equal
`moments_plain` and the JAX `channel_moments` (the Pallas kernel in
interpret mode, as `tests/test_pallas_groupnorm.py` runs it, on the (B, N,
C) transpose) within 1e-5 of sum |x| and of sum x^2 per channel, at the
stats route's geometries shrunk to C 128 / 256, at N 64, 252, 1000 and 4000,
a ragged N (1001) and Ns not a multiple of 8. Then the launch path through a
stand-in library: the plan made once per geometry and what it rejects, the
plan's arguments at the launch, and no autograd function where no gradient
is wanted; and `stats_group_norm` on the emulated moments against the plain
GroupNorm.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import diffmusic_tpu.pallas.groupnorm_kernel as gk
import test_torch_port_cuda
from diffmusic_tpu_torch import kernels
from diffmusic_tpu_torch.kernels import build
from diffmusic_tpu_torch.kernels import group_norm as tgn

BF = torch.bfloat16
CUDA = torch.device("cuda", 0)
WARP = 32


def bf16_rows(rng, b, c, n, scale=2.0, shift=0.3):
    """(B, C, N) float32 numpy array of bf16 values."""
    a = rng.standard_normal((b, c, n)) * scale + shift
    return torch.from_numpy(a.astype(np.float32)).to(BF).float().numpy()


def butterfly(v, width: int):
    """The xor butterfly over the last axis in groups of `width` lanes (all
    lanes end with the same sum; lane 0's is returned per group)."""
    v = v.reshape(*v.shape[:-1], -1, width)
    lanes = np.arange(width)
    o = width // 2
    while o > 0:
        v = (v + v[..., lanes ^ o]).astype(np.float32)
        o //= 2
    return v[..., 0]


def emulate_moments(x3):
    """(B, 2, C) float32: the bf16 kernel's sums of x3 (B, C, N) under its
    plan for rows of N elements."""
    b, c, n = x3.shape
    vec, team, _ = tgn.moments_geometry(n)
    rows = x3.reshape(b * c, n // vec, vec).astype(np.float32)
    per = -(-rows.shape[1] // team)          # loads a thread, zeros past the row's end
    pad = np.zeros((rows.shape[0], per * team, vec), np.float32)
    pad[:, :rows.shape[1]] = rows
    pad = pad.reshape(rows.shape[0], per, team, vec)   # load m of lane j: m * team + j
    s = np.zeros((rows.shape[0], team), np.float32)
    ss = np.zeros_like(s)
    for m in range(per):
        for q in range(vec):
            f = pad[:, m, :, q]
            s = (s + f).astype(np.float32)
            ss = (f.astype(np.float64) * f + ss).astype(np.float32)   # fmaf
    out = []
    for v in (s, ss):
        if team <= WARP:
            v = butterfly(v, team)[:, 0]
        else:
            warps = butterfly(v, WARP)                  # (rows, team / 32)
            lanes = np.zeros((warps.shape[0], WARP), np.float32)
            lanes[:, :warps.shape[1]] = warps
            v = butterfly(lanes, WARP)[:, 0]
        out.append(v.reshape(b, c))
    return np.stack(out, axis=1)


def within(got, ref, x3):
    """max over channels of |got - ref| / (sum |x|, sum x^2)."""
    xf = np.asarray(x3, np.float64)
    scale = np.stack([np.abs(xf).sum(-1), (xf * xf).sum(-1)], axis=1)
    return float((np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
                  / scale).max())


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(gk, "_INTERPRET", True)


# (B, C, N): the stats route's N (62, 248, 1000, 4000, 16000, 64000) at C
# 128 / 256, N 64, 252, 1000 and 4000, a ragged N, Ns not a multiple of 8
CASES = [(1, 128, 62), (1, 256, 248), (2, 128, 1000), (1, 256, 4000), (1, 128, 16000),
         (1, 128, 64000), (2, 256, 64), (1, 128, 252), (1, 256, 1001), (2, 128, 63),
         (1, 128, 4002)]


@pytest.mark.parametrize("b,c,n", CASES, ids=str)
def test_emulated_moments_match_plain_and_jax(interpret, rng, b, c, n):
    x = bf16_rows(rng, b, c, n)
    got = emulate_moments(x)
    assert got.dtype == np.float32 and got.shape == (b, 2, c)
    plain = tgn.moments_plain(torch.from_numpy(x).to(BF))
    jm = gk.channel_moments(jnp.asarray(x.transpose(0, 2, 1), jnp.bfloat16))
    errs = {"plain": within(got, plain, x), "jax": within(got, jm, x)}
    assert max(errs.values()) <= 1e-5, errs


@pytest.mark.parametrize("n,plan", [(62, (2, 32, 256)), (248, (8, 32, 256)),
                                    (1000, (8, 128, 256)), (4000, (8, 512, 512)),
                                    (16000, (8, 512, 512)), (64000, (8, 512, 512)),
                                    (63, (1, 64, 256)), (252, (4, 64, 256))])
def test_plan_at_the_route_rows(n, plan):
    """The stats route's rows: a load a thread where the row allows, the
    widest aligned loads; several short rows a block, a block of 512
    threads a long row."""
    assert tgn.moments_geometry(n) == plan


@pytest.mark.parametrize("n", [62, 64, 248, 252, 1000, 1001, 4000, 16000, 64000, 10 ** 6])
def test_plan_is_within_what_the_kernel_takes(n):
    vec, team, threads = tgn.moments_geometry(n)
    assert n % vec == 0 and vec in (1, 2, 4, 8)
    assert team & (team - 1) == 0 and 1 <= team <= threads
    assert threads & (threads - 1) == 0 and 32 <= threads <= tgn.MOMENT_MAX_THREADS


def test_card_tests_cover_the_stats_geometries():
    """The card tests' geometries are those of the stats route at the
    slice, as chip_smoke.py derives them from the full-width models."""
    calls = chip_smoke.route_calls()["channel_moments"]
    assert sorted({shape for shape, _, _ in calls}) == sorted(
        test_torch_port_cuda.STATS_GEOMETRIES)


@pytest.mark.parametrize("shape", [(1, 128, 31, 2), (1, 256, 62, 4), (2, 128, 40, 25)],
                         ids=str)
def test_stats_group_norm_on_the_emulated_moments(monkeypatch, rng, shape):
    """The stats GroupNorm with its moments from the kernel's partition and
    order matches the plain GroupNorm within 1e-5 of max |plain|."""
    b, c, h, w = shape
    x = torch.from_numpy(bf16_rows(rng, b, c, h * w).reshape(shape))
    wt = torch.from_numpy((1 + 0.2 * rng.standard_normal(c)).astype(np.float32))
    bt = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
    monkeypatch.setattr(tgn, "channel_moments",
                        lambda x3: torch.from_numpy(emulate_moments(x3.numpy())))
    got = tgn.stats_group_norm(x, wt, bt, 32, 1e-5, True)
    ref = tgn.group_norm_plain(x, wt, bt, 32, 1e-5, True)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5


# ----------------------------------------------------------- the launch path
class _Library:
    """Stands in for the kernel library: records the moments launches."""

    def __init__(self):
        self.launches = []

    def dm_channel_moments(self, *args):
        self.launches.append(args)
        return 0

    def __getattr__(self, name):
        return lambda *a: 0


@pytest.fixture
def stand_in(monkeypatch):
    """The launch path on CPU tensors seen as on one CUDA device."""
    lib = _Library()
    real = tgn.moments_plan
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda device: 7)
    monkeypatch.setattr(tgn, "moments_plan",
                        lambda shape, stride, dtype, device: real(shape, stride, dtype, CUDA))
    real.cache_clear()
    kernels.reset_launch_counts()
    return lib, real


def test_plan_is_made_once_per_geometry(stand_in):
    lib, real = stand_in
    a, b = torch.zeros(1, 256, 4000, dtype=BF), torch.zeros(1, 128, 64000, dtype=BF)
    for x in (a, a, b, a, b):
        out = tgn._launch_moments(x)
        assert tuple(out.shape) == (1, 2, x.shape[1]) and out.dtype == torch.float32
    info = real.cache_info()
    assert (info.misses, info.hits) == (2, 3)
    assert kernels.launch_counts()["channel_moments"] == 5
    for args, x in zip(lib.launches, (a, a, b, a, b)):
        code, xp, _, bsz, c, n, vec, team, threads, stream = args
        assert (code, xp, bsz, c, n, stream) == (1, x.data_ptr(), 1, x.shape[1], x.shape[2], 7)
        assert (vec, team, threads) == tgn.moments_geometry(n)
    # fp32: the scalar kernel, no plan arguments
    tgn._launch_moments(torch.zeros(2, 128, 63))
    assert lib.launches[-1][6:9] == (1, 1, 1) and lib.launches[-1][0] == 0


def test_no_autograd_function_without_a_gradient(stand_in, monkeypatch):
    """Under no_grad, or for an input that wants no gradient, the wrapper
    launches directly; with one it goes through the autograd function."""
    lib, _ = stand_in
    applied = []
    real_apply = tgn._ChannelMoments.apply
    monkeypatch.setattr(tgn._ChannelMoments, "apply",
                        lambda x3: applied.append(1) or real_apply(x3))
    monkeypatch.setattr(tgn, "use_plain", lambda x, name: False)
    x = torch.zeros(1, 128, 1000, dtype=BF)
    tgn.channel_moments(x)
    with torch.no_grad():
        tgn.channel_moments(x.requires_grad_(True))
    assert not applied and len(lib.launches) == 2
    tgn.channel_moments(x)
    assert applied == [1] and len(lib.launches) == 3


@pytest.mark.parametrize("shape,stride,dtype,device,error", [
    ((1, 128, 64), (8192, 64, 1), BF, torch.device("cpu"), ValueError),      # not CUDA
    ((1, 128, 64), (8192, 64, 1), torch.float16, CUDA, TypeError),           # fp16
    ((1, 128, 64), (8192, 1, 128), BF, CUDA, ValueError),                    # not contiguous
    ((128, 64), (64, 1), BF, CUDA, ValueError),                              # not (B, C, N)
], ids=["device", "fp16", "strides", "rank"])
def test_plan_rejects_what_the_kernel_does_not_take(shape, stride, dtype, device, error):
    with pytest.raises(error):
        tgn.moments_plan(torch.Size(shape), stride, dtype, device)
