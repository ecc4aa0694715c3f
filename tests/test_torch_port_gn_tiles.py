"""The fused GroupNorm kernel's plan (`csrc/group_norm.cu`,
`gn_cluster_kernel`; `kernels/group_norm.py::fused_plan`), on the CPU,
against the plain version, the JAX package and a float64 oracle.

The kernel cannot run here, so `emulate_gn` computes what it computes from
the same values, following the plan's partition and combine order: per
(batch, group) run of n elements, k blocks of `threads` threads; thread j of
block r holds the loads r * loads * threads + i * threads + j (i < loads) of
`vec` elements each, sums them in fp32 in order (the sum of squares by
fmaf, emulated in float64 and rounded once), then the warp's xor butterfly,
the block's warp sums in warp 0 (a butterfly over 32 lanes, zeros past the
block's warps) and the cluster's block sums in rank order; then
(x - mu) * rsqrt(var + eps), times the weight plus the bias by fmaf, and the
optional SiLU, from the loaded values. Its fp32 output must equal the plain
GroupNorm and the JAX `_reference_gn` on the same fp32 values, and a float64
oracle, within 1e-5 of max |y|; rounded to bf16, the JAX `fused_group_norm`
(the Pallas kernel in interpret mode, on the NHWC transpose) within the
route's tolerance, 2e-2 of max. At small geometries (vec 8, 4 and 1, k 1)
and at two of the fused route's (k 1 and 8). Then the plan at the route's
20 geometries, and the launch path through a stand-in library.
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
GROUPS = 32


def butterfly(v):
    """The xor butterfly over the last axis of 32 lanes, in fp32; lane 0's sum."""
    lanes = np.arange(WARP)
    o = WARP // 2
    while o > 0:
        v = (v + v[..., lanes ^ o]).astype(np.float32)
        o //= 2
    return v[..., 0]


def emulate_gn(x, w, b, eps, silu, size):
    """(fp32 output, plan) of the kernel on NCHW x (float32 numpy of values
    of `size` bytes' dtype), weight and bias (C,), groups 32."""
    bsz, c, h, wd = x.shape
    n = c // GROUPS * h * wd
    vec, k, threads, loads = tgn.fused_geometry(n, size)
    runs = x.reshape(bsz * GROUPS, n // vec, vec).astype(np.float32)
    slots = np.zeros((runs.shape[0], k * loads * threads, vec), np.float32)
    slots[:, :runs.shape[1]] = runs
    # load i of thread j in block r: r * loads * threads + i * threads + j
    slots = slots.reshape(-1, k, loads, threads, vec)
    s = np.zeros((runs.shape[0], k, threads), np.float32)
    ss = np.zeros_like(s)
    for i in range(loads):
        for q in range(vec):
            f = slots[:, :, i, :, q]
            s = (s + f).astype(np.float32)
            ss = (f.astype(np.float64) * f + ss).astype(np.float32)   # fmaf
    tot = []
    for v in (s, ss):
        warps = butterfly(v.reshape(-1, k, threads // WARP, WARP))    # (runs, k, warps)
        lanes = np.zeros(warps.shape[:2] + (WARP,), np.float32)
        lanes[..., :warps.shape[2]] = warps
        blocks = butterfly(lanes)                                     # (runs, k)
        acc = blocks[:, 0]
        for r in range(1, k):
            acc = (acc + blocks[:, r]).astype(np.float32)
        tot.append(acc)
    count = np.float32(n)
    mu = (tot[0] / count).astype(np.float32)
    var = (tot[1] / count - mu * mu).astype(np.float32)
    inv = (1.0 / np.sqrt(var.astype(np.float64) + eps)).astype(np.float32)   # rsqrtf
    xg = x.reshape(bsz * GROUPS, -1).astype(np.float32)
    t = ((xg - mu[:, None]).astype(np.float32) * inv[:, None]).astype(np.float32)
    t = t.reshape(bsz, c, h * wd)
    y = (t.astype(np.float64) * w[None, :, None] + b[None, :, None]).astype(np.float32)
    if silu:
        y = (y / (1.0 + np.exp(-y.astype(np.float64)))).astype(np.float32)
    return y.reshape(x.shape), (vec, k, threads, loads)


def oracle(x, w, b, eps, silu):
    bsz, c = x.shape[:2]
    xg = x.astype(np.float64).reshape(bsz, GROUPS, -1)
    mu = xg.mean(-1, keepdims=True)
    var = (xg * xg).mean(-1, keepdims=True) - mu * mu
    y = ((xg - mu) / np.sqrt(var + eps)).reshape(x.shape)
    y = y * w.reshape(1, c, 1, 1) + b.reshape(1, c, 1, 1)
    return y / (1 + np.exp(-y)) if silu else y


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def operands(rng, shape, dtype):
    """x, weight, bias as float32 numpy arrays of `dtype`'s values."""
    c = shape[1]
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(dtype).float().numpy()
    return (to(rng.standard_normal(shape) * 2.0 + 0.3), to(1 + 0.2 * rng.standard_normal(c)),
            to(0.1 * rng.standard_normal(c)))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(gk, "_INTERPRET", True)


# (shape, dtype, eps, silu, expected (vec, k)): small runs of 8-element,
# 4-element and 1-element loads; two of the fused route's calls
CASES = [((2, 128, 16, 16), BF, 1e-5, True, (8, 1)), ((1, 128, 9, 7), BF, 1e-5, False, (4, 1)),
         ((2, 32, 5, 3), torch.float32, 1e-6, True, (1, 1)),
         ((2, 128, 9, 7), torch.float32, 1e-5, True, (4, 1)),
         ((1, 640, 31, 2), BF, 1e-5, True, (8, 1)), ((1, 256, 250, 16), BF, 1e-5, True, (8, 8))]


@pytest.mark.parametrize("shape,dtype,eps,silu,vk", CASES, ids=str)
def test_emulated_kernel_matches_plain_jax_and_oracle(interpret, rng, shape, dtype, eps, silu,
                                                     vk):
    x, w, b = operands(rng, shape, dtype)
    got, plan = emulate_gn(x, w, b, eps, silu, torch.empty((), dtype=dtype).element_size())
    assert plan[:2] == vk
    t = lambda a: torch.from_numpy(a)
    plain = tgn.group_norm_plain(t(x), t(w), t(b), GROUPS, eps, silu).numpy()
    nhwc = x.transpose(0, 2, 3, 1)
    ref_gn = np.asarray(gk._reference_gn(jnp.asarray(nhwc), jnp.asarray(w), jnp.asarray(b),
                                         GROUPS, eps, silu)).transpose(0, 3, 1, 2)
    errs = {"plain": rel(got, plain), "jax _reference_gn": rel(got, ref_gn),
            "float64": rel(got, oracle(x, w, b, eps, silu))}
    assert max(errs.values()) <= 1e-5, errs
    # rounded to the working dtype, against the JAX kernel in interpret mode
    jd = jnp.bfloat16 if dtype == BF else jnp.float32
    jk = gk.fused_group_norm(jnp.asarray(nhwc, jd), jnp.asarray(w, jd), jnp.asarray(b, jd),
                             GROUPS, eps, silu)
    jk = np.asarray(jk.astype(jnp.float32)).transpose(0, 3, 1, 2)
    rounded = torch.from_numpy(got).to(dtype).float().numpy()
    assert rel(rounded, jk) <= (2e-2 if dtype == BF else 1e-5)


@pytest.mark.parametrize("shape,eps,silu", test_torch_port_cuda.FUSED_GN_CALLS, ids=str)
def test_plan_is_within_what_the_kernel_takes(shape, eps, silu):
    """At each of the route's 20 calls: k in 1, 2, 4, 8; at most 8 loads a
    thread; threads a power of two, 32 to 512; the plan covers the group."""
    n = shape[1] // GROUPS * shape[2] * shape[3]
    vec, k, threads, loads = tgn.fused_geometry(n, 2)
    assert vec == 8 and n % vec == 0
    assert k in (1, 2, 4, 8) and 1 <= loads <= tgn.GN_MAX_LOADS
    assert threads & (threads - 1) == 0 and 32 <= threads <= tgn.GN_MAX_THREADS
    assert k * threads * loads * vec >= n


def test_card_tests_cover_the_fused_route():
    """The card tests' calls are those of the fused route at the slice, as
    chip_smoke.py derives them from the full-width models: 60 a step."""
    calls = chip_smoke.route_calls()["fused_group_norm"]
    assert sorted(calls) == sorted(test_torch_port_cuda.FUSED_GN_CALLS)
    assert sum(calls.values()) == 60


# ----------------------------------------------------------- the launch path
class _Library:
    """Stands in for the kernel library: records the fused launches."""

    def __init__(self):
        self.launches = []

    def dm_group_norm(self, *args):
        self.launches.append(args)
        return 0

    def dm_group_norm_smem(self, cpg):
        return 8 * cpg


@pytest.fixture
def stand_in(monkeypatch):
    """The launch path on CPU tensors seen as on one CUDA device."""
    lib = _Library()
    real = tgn.fused_plan
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda device: 7)
    monkeypatch.setattr(tgn, "use_plain", lambda x, name: False)
    monkeypatch.setattr(tgn, "fused_plan", lambda shape, stride, dtype, device, groups, p: real(
        shape, stride, dtype, CUDA, groups, p[:3] + (CUDA,) + p[4:7] + (CUDA,)))
    real.cache_clear()
    kernels.reset_launch_counts()
    return lib, real


def params(c, dtype=BF):
    return torch.ones(c, dtype=dtype), torch.zeros(c, dtype=dtype)


def test_plan_is_made_once_per_geometry(stand_in):
    lib, real = stand_in
    a, b = torch.zeros(1, 256, 250, 16, dtype=BF), torch.zeros(1, 640, 31, 2, dtype=BF)
    wa, ba = params(256)
    wb, bb = params(640)
    calls = [(a, wa, ba), (a, wa, ba), (b, wb, bb), (a, wa, ba), (b, wb, bb)]
    for x, w, bias in calls:
        y = tgn.fused_group_norm(x, w, bias, GROUPS, 1e-5, True)
        assert y.shape == x.shape and y.dtype == x.dtype
    info = real.cache_info()
    assert (info.misses, info.hits) == (2, 3)
    assert kernels.launch_counts()["fused_group_norm"] == 5
    for args, (x, w, bias) in zip(lib.launches, calls):
        code, xp, wp, bp, _, bsz, c, hw, g, eps, silu, *plan, stream = args
        assert (code, xp, wp, bp, bsz, c, hw, g, silu, stream) == (
            1, x.data_ptr(), w.data_ptr(), bias.data_ptr(), 1, x.shape[1],
            x.shape[2] * x.shape[3], GROUPS, 1, 7)
        assert tuple(plan) == tgn.fused_geometry(c // GROUPS * hw, 2)
    # fp32: 4 elements a load
    tgn.fused_group_norm(torch.zeros(2, 128, 9, 7), *params(128, torch.float32), GROUPS, 1e-5)
    assert lib.launches[-1][0] == 0 and lib.launches[-1][11] == 4


def test_no_autograd_function_without_a_gradient(stand_in, monkeypatch):
    """Under no_grad, or where neither x nor the weights want a gradient,
    the wrapper launches directly; otherwise it goes through the autograd
    function, whose backward is the plain recompute."""
    lib, _ = stand_in
    applied = []
    real_apply = tgn._FusedGroupNorm.apply
    monkeypatch.setattr(tgn._FusedGroupNorm, "apply",
                        lambda *a: applied.append(1) or real_apply(*a))
    x = torch.zeros(1, 128, 31, 2, dtype=BF)
    w, b = params(128)
    tgn.fused_group_norm(x, w, b, GROUPS, 1e-5)
    wg = w.clone().requires_grad_(True)
    with torch.no_grad():
        tgn.fused_group_norm(x.clone().requires_grad_(True), wg, b, GROUPS, 1e-5)
    assert not applied and len(lib.launches) == 2
    tgn.fused_group_norm(x, wg, b, GROUPS, 1e-5)
    assert applied == [1] and len(lib.launches) == 3


@pytest.mark.parametrize("shape,stride,dtype,device,groups,p,error", [
    ((1, 128, 4, 4), (2048, 16, 4, 1), BF, torch.device("cpu"), 32, None, ValueError),
    ((1, 128, 4, 4), (2048, 16, 4, 1), torch.float16, CUDA, 32, None, TypeError),
    ((1, 128, 4, 4), (2048, 1, 512, 128), BF, CUDA, 32, None, ValueError),
    ((128, 4, 4), (16, 4, 1), BF, CUDA, 32, None, ValueError),
    ((1, 128, 4, 4), (2048, 16, 4, 1), BF, CUDA, 48, None, ValueError),
    ((1, 128, 4, 4), (2048, 16, 4, 1), BF, CUDA, 32, ((128,), (1,), torch.float32, CUDA),
     TypeError),
    ((1, 128, 4, 4), (2048, 16, 4, 1), BF, CUDA, 32, ((64,), (1,), BF, CUDA), ValueError),
], ids=["device", "fp16", "strides", "rank", "groups", "weight-dtype", "weight-shape"])
def test_plan_rejects_what_the_kernel_does_not_take(monkeypatch, shape, stride, dtype, device,
                                                     groups, p, error):
    monkeypatch.setattr(build, "library", lambda: _Library())
    good = ((shape[1] if len(shape) == 4 else shape[0],), (1,), dtype, device)
    weight = p if p is not None else good
    with pytest.raises(error):
        tgn.fused_plan(torch.Size(shape), stride, dtype, device, groups, weight + good)
