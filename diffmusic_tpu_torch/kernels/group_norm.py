"""GroupNorm over NCHW: `fused_group_norm`, and `channel_moments` under
`stats_group_norm`.

Replace `diffmusic_tpu/pallas/groupnorm_kernel.py::fused_group_norm` and
`::channel_moments` / `::stats_group_norm` with the CUDA kernels of
`csrc/group_norm.cu`.

Bound on the H100: device memory. A GroupNorm does about ten operations per
element it reads once and writes once, far below the card's ~295 bf16
operations per byte. In NCHW a group (C/G channels x H*W) is contiguous, so
the fused kernel gives each (batch, group) one block, or a cluster of blocks
for a long group, whose threads hold their share of it in registers: they
sum x and x^2 in fp32, combine the sums across the cluster, then
normalise, scale, shift and apply the optional SiLU, in one read and one
write. It follows a plan made once per geometry (`fused_plan`, which also
checks what the kernel takes). The moments kernel reads
each (batch, channel) row once and writes its fp32 (sum, sum of squares);
the group combine and the normalise stay in plain PyTorch, as in the JAX
package. Statistics are var = E[x^2] - mu^2 in fp32, as the port's plain
GroupNorm and the JAX package compute them (no Welford).

The bf16 moments kernel follows a plan made once per geometry
(`moments_plan`, which also checks what the kernel takes): per row of N
elements a team of as many threads as the row has loads of `vec` elements
(16 bytes where N allows), up to a block of `MOMENT_MAX_THREADS`, several
short rows a block of `MOMENT_ROW_BLOCK`. Per call the wrapper reads the
address, allocates the output and launches on the current stream's raw
handle; where no gradient is wanted it skips the autograd function, as the
fused GroupNorm's does. The fp32 moments are the exact scalar kernel, one
block a row.

On a CPU tensor the wrappers run the plain versions beside them; on a CUDA
tensor they launch the kernel or raise. Gradients: the fused GroupNorm's
backward is a plain recompute (`_fgn_bwd`); the moments' VJP is elementwise,
dx = ds + 2 x dss in fp32, cast to x's dtype (`_moments_bwd`).
"""

import functools

import torch
import torch.nn.functional as F

from ..tracing import count
from .device import use_plain
from .mask import _dense

# launches of each kernel since the last reset (see kernels.launch_counts)
LAUNCHES = {"fused_group_norm": 0, "channel_moments": 0}

ROW_LIMIT_ELEMS = 2 ** 20   # H*W*C per batch row (`groupnorm_kernel._ROW_LIMIT_ELEMS`)
GN_MODES = ("plain", "fused", "stats")

# the fused kernel's plan (csrc/group_norm.cu, gn_cluster_kernel)
GN_MAX_THREADS = 512        # a block (128 registers a thread)
GN_MAX_LOADS = 8            # loads a thread, all in registers at once
GN_MAX_CLUSTER = 8          # blocks a group (the portable cluster size)
GN_BLOCK_LOADS = 1024       # the most loads a group takes in one block
GN_CLUSTER_THREADS = 128    # a block of a cluster

# the bf16 moments kernel's plan (csrc/group_norm.cu)
MOMENT_MAX_THREADS = 512    # a block, the team of the longest rows
MOMENT_ROW_BLOCK = 256      # the block of several short rows


def group_norm_plain(x, weight, bias, groups: int, eps: float, use_silu: bool = False):
    """GroupNorm over (B, C, ...) with fp32 statistics (var = E[x^2] - mu^2)
    and an optional SiLU; output in x.dtype."""
    b, c = x.shape[:2]
    xg = x.float().reshape(b, groups, -1)
    mu = xg.mean(-1, keepdim=True)
    var = xg.square().mean(-1, keepdim=True) - mu * mu
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.ndim - 2)
    y = y * weight.float().reshape(shape) + bias.float().reshape(shape)
    if use_silu:
        y = F.silu(y)
    return y.to(x.dtype)


def fused_gn_ok(x) -> bool:
    """The JAX routing rule (`groupnorm_kernel._eligible`) on NCHW: 4-D,
    C % 128 == 0 and H*W*C <= 2**20."""
    return (x.ndim == 4 and x.shape[1] % 128 == 0
            and x.shape[1] * x.shape[2] * x.shape[3] <= ROW_LIMIT_ELEMS)


def moments_ok(x3) -> bool:
    """The JAX routing rule (`groupnorm_kernel._moments_eligible`) on
    (B, C, N): C % 128 == 0, C <= 1024 and N >= 8."""
    _, c, n = x3.shape
    return c % 128 == 0 and c <= 1024 and n >= 8


def moments_plain(x3):
    """Per-channel (sum, sum of squares) of (B, C, N) x in fp32: (B, 2, C)."""
    xf = x3.float()
    return torch.stack([xf.sum(-1), (xf * xf).sum(-1)], dim=1)


def fused_geometry(n: int, size: int) -> tuple:
    """(vec, k, threads, loads) of the fused kernel for groups of n elements
    of `size` bytes: `vec` elements a load (16 bytes, or the largest power
    of two below dividing n); k blocks a group, 1 up to GN_BLOCK_LOADS loads
    and GN_MAX_CLUSTER above; `threads` a block, in a lone block the least
    power of two from 32 that gives each thread one load, up to
    GN_MAX_THREADS, in a cluster GN_CLUSTER_THREADS, or more where a thread
    would need more than GN_MAX_LOADS; `loads` a thread. The rule is the
    H100's (PERF.md, row 10 of §6): up to 1024 loads a group, 512 threads
    of one or two loads beat any cluster; above, 8 blocks of 128 threads of
    two to four loads beat fewer or wider blocks."""
    vec = next(v for v in (8, 4, 2, 1) if v * size <= 16 and n % v == 0)
    n_loads = n // vec
    if n_loads <= GN_BLOCK_LOADS:
        k, threads = 1, 32
        while threads < min(n_loads, GN_MAX_THREADS):
            threads *= 2
    else:
        k, threads = GN_MAX_CLUSTER, GN_CLUSTER_THREADS
    per = -(-n_loads // k)
    while threads < GN_MAX_THREADS and threads * GN_MAX_LOADS < per:
        threads *= 2
    return vec, k, threads, -(-per // threads)


@functools.lru_cache(maxsize=256)
def fused_plan(shape: tuple, stride: tuple, dtype, device, groups: int, params: tuple) -> tuple:
    """(dtype code, B, C, HW, G, vec, k, threads, loads) of a fused launch on
    x of this shape, stride, dtype and device with `groups` groups; `params`
    is (shape, stride, dtype, device) of the weight and then of the bias.
    Raises for what the kernel does not take: a device other than CUDA, a
    dtype other than bf16 or fp32, x not a contiguous NCHW tensor, C not a
    multiple of the groups, a weight or bias other than a contiguous (C,)
    tensor of x's dtype on x's device, a group of more loads than a cluster
    holds, or more shared memory than a block may use."""
    from . import build
    count("kernels.cache_miss", "group_norm.fused_plan")
    if device.type != "cuda":
        raise ValueError(f"fused_group_norm: x must be on a CUDA device, not {device}")
    code = build.dtype_code(dtype)
    if len(shape) != 4:
        raise ValueError(f"fused_group_norm: x must be NCHW, not {tuple(shape)}")
    if not _dense(shape, stride):
        raise ValueError("fused_group_norm: x must be contiguous")
    bsz, c, h, w = shape
    if groups < 1 or c % groups:
        raise ValueError(f"fused_group_norm: {c} channels in {groups} groups")
    for name, (p_shape, p_stride, p_dtype, p_device) in zip(("weight", "bias"),
                                                            (params[:4], params[4:])):
        if p_dtype != dtype:
            raise TypeError(f"fused_group_norm: {name} is {p_dtype}, x {dtype}")
        if p_device != device:
            raise ValueError(f"fused_group_norm: {name} on {p_device}, x on {device}")
        if tuple(p_shape) != (c,) or tuple(p_stride) != (1,):
            raise ValueError(f"fused_group_norm: {name} must be a contiguous ({c},), not "
                             f"{tuple(p_shape)}")
    n = c // groups * h * w
    vec, k, threads, loads = fused_geometry(n, torch.empty((), dtype=dtype).element_size())
    if loads > GN_MAX_LOADS:
        raise ValueError(f"fused_group_norm: a group of {n} elements is more than a cluster "
                         f"of {GN_MAX_CLUSTER} blocks holds")
    build.check_smem("fused_group_norm", build.library().dm_group_norm_smem(c // groups))
    return code, bsz, c, h * w, groups, vec, k, threads, loads


def _launch_fused(x, weight, bias, groups, eps, use_silu):
    from . import build
    code, bsz, c, hw, g, vec, k, threads, loads = fused_plan(
        x.shape, x.stride(), x.dtype, x.device, groups,
        (weight.shape, weight.stride(), weight.dtype, weight.device,
         bias.shape, bias.stride(), bias.dtype, bias.device))
    xp, wp, bp = x.data_ptr(), weight.data_ptr(), bias.data_ptr()
    if xp % 16 or wp % 16 or bp % 16:
        raise ValueError("fused_group_norm: x, weight and bias must start 16-byte aligned")
    y = torch.empty_like(x)
    rc = build.library().dm_group_norm(code, xp, wp, bp, y.data_ptr(), bsz, c, hw, g,
                                       float(eps), int(use_silu), vec, k, threads, loads,
                                       build.stream_ptr(x.device))
    build.check(rc, "fused_group_norm")
    LAUNCHES["fused_group_norm"] += 1
    return y


def moments_geometry(n: int) -> tuple:
    """(vec, team, threads) of the bf16 moments kernel for rows of n
    elements: `vec` elements a load (8, 16 bytes, or the largest of 4, 2, 1
    dividing n), a team of `team` threads a row (the least power of two
    with a load each, at most MOMENT_MAX_THREADS), `threads` a block (the
    team, or MOMENT_ROW_BLOCK for several shorter rows)."""
    vec = next(v for v in (8, 4, 2, 1) if n % v == 0)
    team = 1
    while team < MOMENT_MAX_THREADS and team * vec < n:
        team *= 2
    return vec, team, max(team, MOMENT_ROW_BLOCK)


@functools.lru_cache(maxsize=256)
def moments_plan(shape: tuple, stride: tuple, dtype, device) -> tuple:
    """(dtype code, B, C, N, vec, team, threads) of a moments launch on x of
    this shape, stride, dtype and device; raises for what the kernel does
    not take: a device other than CUDA, a dtype other than bf16 or fp32, x
    not a contiguous (B, C, N) tensor. fp32 takes the scalar kernel (vec,
    team and threads 1)."""
    from . import build
    count("kernels.cache_miss", "group_norm.moments_plan")
    if device.type != "cuda":
        raise ValueError(f"channel_moments: x must be on a CUDA device, not {device}")
    code = build.dtype_code(dtype)
    if len(shape) != 3:
        raise ValueError(f"channel_moments: x must be (B, C, N), not {tuple(shape)}")
    if not _dense(shape, stride):
        raise ValueError("channel_moments: x must be contiguous")
    bsz, c, n = shape
    return (code, bsz, c, n) + (moments_geometry(n) if code == 1 else (1, 1, 1))


def _launch_moments(x3):
    from . import build
    code, bsz, c, n, vec, team, threads = moments_plan(x3.shape, x3.stride(), x3.dtype,
                                                       x3.device)
    xp = x3.data_ptr()
    if xp % 16:
        raise ValueError("channel_moments: x must start 16-byte aligned")
    out = torch.empty((bsz, 2, c), dtype=torch.float32, device=x3.device)
    rc = build.library().dm_channel_moments(code, xp, out.data_ptr(), bsz, c, n, vec, team,
                                            threads, build.stream_ptr(x3.device))
    build.check(rc, "channel_moments")
    LAUNCHES["channel_moments"] += 1
    return out


class _FusedGroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, use_silu):
        ctx.save_for_backward(x, weight, bias)
        ctx.groups, ctx.eps, ctx.use_silu = groups, eps, use_silu
        if use_plain(x, "fused_group_norm"):
            return group_norm_plain(x, weight, bias, groups, eps, use_silu)
        return _launch_fused(x, weight, bias, groups, eps, use_silu)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = group_norm_plain(*inputs, ctx.groups, ctx.eps, ctx.use_silu)
        grads = iter(torch.autograd.grad(y, [t for t in inputs if t.requires_grad], g))
        return tuple(next(grads) if t.requires_grad else None for t in inputs) + (None,) * 3


class _ChannelMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x3):
        ctx.save_for_backward(x3)
        if use_plain(x3, "channel_moments"):
            return moments_plain(x3)
        return _launch_moments(x3)

    @staticmethod
    def backward(ctx, g):
        (x3,) = ctx.saved_tensors
        dx = g[:, 0, :, None] + 2.0 * x3.float() * g[:, 1, :, None]
        return dx.to(x3.dtype)


def fused_group_norm(x, weight, bias, groups: int, eps: float, use_silu: bool = False):
    """GroupNorm(+SiLU) of NCHW x in one kernel; stats in fp32, output in x.dtype."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _FusedGroupNorm.apply(x, weight, bias, groups, eps, use_silu)
    if use_plain(x, "fused_group_norm"):
        return group_norm_plain(x, weight, bias, groups, eps, use_silu)
    return _launch_fused(x, weight, bias, groups, eps, use_silu)


def channel_moments(x3):
    """(sum, sum of squares) of each (batch, channel) row of (B, C, N) x in
    fp32: (B, 2, C)."""
    if x3.requires_grad and torch.is_grad_enabled():
        return _ChannelMoments.apply(x3)
    if use_plain(x3, "channel_moments"):
        return moments_plain(x3)
    return _launch_moments(x3)


def stats_group_norm(x, weight, bias, groups: int, eps: float, use_silu: bool = False):
    """GroupNorm(+SiLU) of NCHW x with the statistics from `channel_moments`
    and the group combine and normalise in plain PyTorch
    (`groupnorm_kernel.stats_group_norm`)."""
    b, c, h, w = x.shape
    n = h * w
    x3 = x.reshape(b, c, n)
    # the moments kernel where the JAX package's `_moments_impl` takes it
    m = channel_moments(x3) if moments_ok(x3) else moments_plain(x3)   # (B, 2, C) fp32
    gsz = c // groups
    s_g = m[:, 0].reshape(b, groups, gsz).sum(-1)
    ss_g = m[:, 1].reshape(b, groups, gsz).sum(-1)
    count = float(n * gsz)
    mu_g = s_g / count
    var_g = ss_g / count - mu_g * mu_g
    inv_g = torch.rsqrt(var_g + eps)
    mu_c = mu_g.repeat_interleave(gsz, dim=1)          # (B, C)
    inv_c = inv_g.repeat_interleave(gsz, dim=1)
    w_c = inv_c * weight.float()
    b_c = bias.float() - mu_c * w_c
    y = x.float() * w_c[:, :, None, None] + b_c[:, :, None, None]
    if use_silu:
        y = F.silu(y)
    return y.to(x.dtype)
