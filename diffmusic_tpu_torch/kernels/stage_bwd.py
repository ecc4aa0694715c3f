"""A whole HiFi-GAN resblock stage on the canvas: `stage_resblocks_canvas`.

Replaces `diffmusic_tpu/pallas/stage_bwd_kernel.py::stage_resblocks_canvas`.
The forward is the chain of canvas pairs of every branch
(`conv1d.conv1d_pair_canvas`'s kernel, one launch per pair), averaged over the
branches; it saves each pair's canvas input x_i and intermediate h_i. The
backward is ONE call of `csrc/stage_bwd.cu`, which computes the stage's input
cotangent: per branch, dcur = g / n_branches, then for the pairs in reverse
dh = leaky'(h_i) * conv(dcur, flip(w2)^T, 1) and
dcur = leaky'(x_i) * conv(dh, flip(w1)^T, d) + dcur, zeroed outside the
signal; the branches summed.

Bound on the H100: tensor-core work, 4 T C^2 sum(k) operations per stage
(165 GFLOP at the 10-s slice's ch128 stage, T = 40008), against about 20
canvas tensors read once. In bf16 the call runs every adjoint conv as a pass
over the whole canvas of the conv1d kernel's TMA + wgmma core, one launch per
conv of pair step for all branches at once, with the masks and the skip sum
in its epilogues (the source says why: the old one-launch kernel recomputed
every conv over a 3x halo). Each pass reads its weight as it lies through
the tensor map that `conv1d.adjoint_weights` makes once per weight tensor
(cached under `repack.REPACKS["conv1d_adjoint"]`, shared with the canvas
conv's adjoint). The intermediates (per branch an fp32 dcur, a bf16 operand
and a bf16 dh canvas, and one bf16 first operand) are allocated per call
from PyTorch's caching allocator (`stage_scratch`). fp32 is the exact scalar
one-launch kernel.

Parameters come flattened branch-major, pair-minor: (w1, b1, w2, b2) per
pair. Weights are frozen: the backward returns the input cotangent only. On a
CPU tensor the forward runs the plain pair versions and the backward
`stage_bwd_plain`; on a CUDA tensor they launch the kernels or raise. A
backward counts one launch, however many CUDA kernels its call runs.
"""

import ctypes
import functools

import torch

from . import repack
from .canvas import TIME_BLOCK, canvas_row_mask, canvas_rows
from .conv1d import ADJOINT, adjoint_weights, conv1d_plain, pair_canvas_forward, pair_plain
from .device import use_plain

# launches of the kernel since the last reset (see kernels.launch_counts)
LAUNCHES = {"stage_resblocks_canvas": 0}

HALO = 64   # >= the longest branch's chain of pads (k = 11, d = (1, 3, 5): 60)
MAX_PAIRS, MAX_BRANCHES, MAX_PAD = 16, 4, 32


def stage_ok(channels: int, kernel_sizes, dilation_sizes, dtype) -> bool:
    """The JAX routing rule (`stage_bwd_kernel.stage_ok`): 128 channels, the
    longest chain of pads within HALO, the stage's weights within 6 MB."""
    if channels != 128:
        return False
    total_pad = max(sum((k - 1) * d // 2 + (k - 1) // 2 for d in dils)
                    for k, dils in zip(kernel_sizes, dilation_sizes))
    if total_pad > HALO:
        return False
    itemsize = torch.empty((), dtype=dtype).element_size()
    wbytes = sum(2 * k * channels * channels * itemsize * len(dils)
                 for k, dils in zip(kernel_sizes, dilation_sizes))
    return wbytes <= 6 * 2 ** 20


def _pairs(kernel_sizes, dilation_sizes):
    """(k, d) per pair, branch-major."""
    return [(k, d) for k, dils in zip(kernel_sizes, dilation_sizes) for d in dils]


def _branches(params, dilation_sizes):
    """Per branch, the (dilation, (w1, b1, w2, b2)) of its pairs in order."""
    it = iter(params)
    return [[(d, next(it)) for d in dils] for dils in dilation_sizes]


def stage_forward(xc, params, t: int, kernel_sizes, dilation_sizes, slope):
    """(mean over the branches of the pair chains, saved x_i, saved h_i),
    the JAX `_stage_fwd_collect`."""
    saved_x, saved_h, total = [], [], None
    for branch in _branches(params, dilation_sizes):
        xb = xc
        for d, (w1, b1, w2, b2) in branch:
            saved_x.append(xb)
            xb, h = pair_canvas_forward(xb, w1, b1, w2, b2, t, d, slope)
            saved_h.append(h)
        total = xb if total is None else total + xb
    return total / len(kernel_sizes), saved_x, saved_h


def stage_plain(x, params, kernel_sizes, dilation_sizes, slope):
    """The stage off the canvas (the JAX `_stage_ref`): mean over the
    branches of the plain pair chains."""
    total = None
    for branch in _branches(params, dilation_sizes):
        xb = x
        for d, (w1, b1, w2, b2) in branch:
            xb, _h = pair_plain(xb, w1, b1, w2, b2, d, slope)
        total = xb if total is None else total + xb
    return total / len(kernel_sizes)


def stage_bwd_plain(g, xs, hs, w1s, w2s, t: int, kernel_sizes, dilation_sizes, slope):
    """The stage's input cotangent in plain PyTorch: the JAX package's XLA
    composition (`_stage_vjp_bwd`), in fp32, with the kernel's roundings
    (g in the saved dtype on entry, each conv's operand in the weight dtype),
    which are no-ops in fp32."""
    rv = canvas_row_mask(g.shape[1], t, device=g.device)
    gm = g.to(xs[0].dtype).float() * rv

    def adjoint(a, w, d):   # the operand rounded to the weight dtype, fp32 conv
        return conv1d_plain(a.to(w.dtype).float(), w.float().flip(0).transpose(1, 2), None, d)

    dx, first = None, 0
    for dils in dilation_sizes:
        dcur = gm / len(kernel_sizes)
        for i in reversed(range(first, first + len(dils))):
            dhs = adjoint(dcur, w2s[i], 1)
            dh = torch.where(hs[i] >= 0, dhs, slope * dhs) * rv
            dxs = adjoint(dh, w1s[i], dils[i - first])
            dcur = torch.where(xs[i] >= 0, dxs, slope * dxs) * rv + dcur
        first += len(dils)
        dx = dcur if dx is None else dx + dcur
    return (dx * rv).to(g.dtype)


# the bf16 call's pass epilogues and slot flags (csrc/stage_pass.cuh, stage_bwd.cu)
MASK, MASK_ACC = 1, 2
FIRST, WRITE_OP = 1, 2


@functools.lru_cache(maxsize=16)
def stage_schedule(kernel_sizes, dilation_sizes) -> tuple:
    """The bf16 call's passes in launch order: (epilogue, slots) with slots
    ((branch, pair, flags), ...), one slot per branch in one launch. Step j
    runs pair P_b - 1 - j of every branch b that has one (P_b its pairs,
    branch-major pair indices): a MASK pass (dh from the branch's operand,
    op0 at its first pair: flag FIRST), then a MASK_ACC pass (dcur from dh,
    g / n_branches as the old dcur at the first pair: FIRST; rounded into
    the operand where a pair follows: WRITE_OP). Within a launch the branch
    of the largest k comes first, so its longest blocks start first."""
    counts = [len(d) for d in dilation_sizes]
    first = [sum(counts[:b]) for b in range(len(counts))]
    order = sorted(range(len(counts)), key=lambda b: -kernel_sizes[b])
    passes = []
    for j in range(max(counts)):
        live = [(b, first[b] + counts[b] - 1 - j) for b in order if counts[b] > j]
        start = FIRST if j == 0 else 0
        passes.append((MASK, tuple((b, i, start) for b, i in live)))
        passes.append((MASK_ACC, tuple((b, i, start | (WRITE_OP if i > first[b] else 0))
                                       for b, i in live)))
    return tuple(passes)


def stage_scratch(g, n_branches: int) -> tuple:
    """The bf16 call's intermediates for the canvas cotangent g (B, T, C):
    the first operand (B, T, C) bf16, and per branch side by side the fp32
    dcur and the bf16 operand and dh, (n_branches, B, T, C) each."""
    side = (n_branches,) + tuple(g.shape)
    return (torch.empty_like(g), torch.empty(side, dtype=torch.float32, device=g.device),
            torch.empty(side, dtype=g.dtype, device=g.device),
            torch.empty(side, dtype=g.dtype, device=g.device))


def _launch(g, xs, hs, w1s, w2s, t: int, kernel_sizes, dilation_sizes, slope):
    from . import build
    pairs = _pairs(kernel_sizes, dilation_sizes)
    n = len(pairs)
    build.check_tensors("stage_resblocks_canvas", g, *xs, *hs, *w1s, *w2s)
    bsz, rows, c = g.shape
    if c != 128 or rows != canvas_rows(t):
        raise ValueError(f"stage_resblocks_canvas: the kernel takes the canvas of a "
                         f"128-channel signal of {t} rows, not {tuple(g.shape)}")
    if (n > MAX_PAIRS or len(kernel_sizes) > MAX_BRANCHES
            or any(tuple(a.shape) != tuple(g.shape) for a in (*xs, *hs))
            or any(tuple(w.shape) != (k, c, c) for (k, _), w1, w2 in zip(pairs, w1s, w2s)
                   for w in (w1, w2))
            or any((k - 1) * d // 2 > MAX_PAD or k % 2 == 0 for k, d in pairs)):
        raise ValueError("stage_resblocks_canvas: bad shapes of the saved tensors or "
                         "weights, or more pairs, branches or padding than the kernel takes")
    lib = build.library()
    code = build.dtype_code(g.dtype)
    build.check_smem("stage_resblocks_canvas", lib.dm_stage_bwd_smem(code))
    if code == 1:   # the adjoint's tensor maps over the weights, and the scratch
        ws = [repack.cached(ADJOINT, w, adjoint_weights) for w in (*w1s, *w2s)]
        ws += stage_scratch(g, len(kernel_sizes))
    else:
        ws = [*w1s, *w2s]
    ptrs = [a.data_ptr() for a in (*xs, *hs, *ws)]
    ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    meta = [n, len(kernel_sizes), *(len(d) for d in dilation_sizes),
            *(k for k, _ in pairs), *(d for _, d in pairs)]
    if code == 1:
        schedule = stage_schedule(kernel_sizes, dilation_sizes)
        meta += [len(schedule)]
        for epi, slots in schedule:
            meta += [epi, len(slots), *(v for slot in slots for v in slot)]
    meta = (ctypes.c_int * len(meta))(*meta)
    out = torch.empty_like(g)
    rc = lib.dm_stage_bwd(code, g.data_ptr(), ctypes.cast(ptrs, ctypes.c_void_p),
                          ctypes.cast(meta, ctypes.c_void_p), out.data_ptr(), bsz, rows,
                          TIME_BLOCK, TIME_BLOCK + t, float(slope),
                          float(1.0 / len(kernel_sizes)), build.stream_ptr(g.device))
    build.check(rc, "stage_resblocks_canvas")
    LAUNCHES["stage_resblocks_canvas"] += 1
    return out


class _Stage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xc, t, kernel_sizes, dilation_sizes, slope, *flat):
        params = [flat[i:i + 4] for i in range(0, len(flat), 4)]
        out, xs, hs = stage_forward(xc, params, t, kernel_sizes, dilation_sizes, slope)
        ctx.save_for_backward(*xs, *hs, *flat[0::4], *flat[2::4])
        ctx.args = t, kernel_sizes, dilation_sizes, slope
        ctx.n_flat = len(flat)
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        n = len(saved) // 4
        xs, hs, w1s, w2s = (saved[i * n:(i + 1) * n] for i in range(4))
        g = g.to(xs[0].dtype).contiguous()   # the saved dtype on entry (`_stage_vjp_bwd`)
        if use_plain(g, "stage_resblocks_canvas"):
            dx = stage_bwd_plain(g, xs, hs, w1s, w2s, *ctx.args)
        else:
            dx = _launch(g, xs, hs, w1s, w2s, *ctx.args)
        return (dx, None, None, None, None) + (None,) * ctx.n_flat


def stage_resblocks_canvas(xc, params, t: int, kernel_sizes, dilation_sizes, slope):
    """The mean over the branches of each branch's chain of resblock pairs,
    on the canvas of a t-row signal; params: (w1, b1, w2, b2) per pair,
    branch-major, pair-minor. The backward is one call of the kernel
    library."""
    kernel_sizes = tuple(kernel_sizes)
    dilation_sizes = tuple(tuple(d) for d in dilation_sizes)
    if len(params) != len(_pairs(kernel_sizes, dilation_sizes)):
        raise ValueError("stage_resblocks_canvas: one (w1, b1, w2, b2) per pair")
    return _Stage.apply(xc, t, kernel_sizes, dilation_sizes, slope,
                        *(a for p in params for a in p))
