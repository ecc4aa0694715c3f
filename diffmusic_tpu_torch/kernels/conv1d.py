"""HiFi-GAN resblock convolutions: `conv1d_fused` and `conv1d_fused_pair`, and
their canvas forms `conv1d_fused_canvas` and `conv1d_pair_canvas`.

Replace `diffmusic_tpu/pallas/conv1d_kernel.py::conv1d_fused`,
`::conv1d_fused_pair`, `::conv1d_fused_canvas` / `::conv1d_canvas_xbwd` and
`::conv1d_pair_canvas` with the CUDA kernels of `csrc/conv1d.cu` (the canvas
forms are the same kernels told where the signal lies, plus an adjoint mode
of the single conv).

Bound on the H100: tensor-core work (the vocoder forward is about 1 TFLOP at
10 s), while each conv reads x and w once.

In bf16 both are passes of one implicit GEMM on wgmma fed by TMA: the single
conv one pass, the pair two in one C call (pass 1 writes h, pass 2 reads h
back and writes y). Each block owns `BLOCK_M` rows x `BLOCK_N` output
channels (160 / 314 / 313 blocks at the 10-s slice's stages 0-2, where
keeping the pair's h on chip, as the fp32 path does, leaves 79 at stage 0)
and walks (`BLOCK_K`-channel slice, tap): per step one TMA box of the pass's
input, (B, T, C) rows starting at the tap's shift, the rows outside the
tensor filled with zeros, which is the 'same' padding, and one box of the
tap's (Cout, Cin) weight matrix. Where the pass has a slope, each consumer
warpgroup applies the leaky ReLU to its rows of the staged input in place
before its products. The forward reads the weights' tap-major copy (k, Cout,
Cin); the copy and the TMA tensor map that reads it are made once per weight
tensor (`repack.cached(REPACK, ...)`, shared by the single conv and the pair,
the plain and the canvas form and every route over the same weights). The
canvas backward's adjoint pass reads tap k-1-j of the weight tensor itself,
(k, Cin, Cout) being the (N, K) layout that the adjoint's B operand needs,
through one tensor map per weight tensor (`repack.cached(ADJOINT, ...)`, no
copy). The epilogue adds the bias and the residual in fp32 and rounds once.
The pair's pass 2 reads h rounded, leaky(round(h)), as `pair_plain` does;
the JAX Pallas kernel rounds leaky(h) from fp32, one bf16 ulp apart on
negative h. The fp32 kernels are the exact scalar paths: the single conv
stages a haloed time window per block, the pair keeps h, for its rows plus
conv2's halo over all channels, in shared memory. The launch paths check
once per operand geometry (`fused_plan`, `pair_plan`); per call they read
the addresses, allocate the outputs and launch on the current stream's raw
handle.

Layout as in the JAX package: activations (B, T, C), weights (k, Cin, Cout),
'same' padding, odd k. On a CPU tensor the wrappers run the plain PyTorch
versions beside them; on a CUDA tensor they launch the kernel or raise.
Weights are frozen: the backward returns the activation cotangent only, as
plain adjoint convolutions in the weight dtype followed by the leaky-ReLU
masks (`_conv1d_bwd` and `_pair_bwd` of the JAX module). With
`adjoint_kernel` (the JAX package's vocoder variables carrying
`with_adjoint_weights`' kernels) `conv1d_fused`'s backward launches the
kernel's adjoint mode on the cotangent instead, where JAX's condition holds
(Cout and Cin multiples of 128), reading the weight through the adjoint's
cached tensor map; those launches count under "conv1d_fused_adjoint". The
pair's backward keeps its plain adjoints, as `_pair_bwd` does. With
`mask_kernel` (the JAX package's `DIFFMUSIC_TPU_MASK=pallas`) the masks of
tensors that `mask.mask_ok` admits take the mask kernels of
`kernels/mask.py`, which read each adjoint's output as the conv leaves it
(the transposed view of a contiguous (B, C, T) tensor), with no copy to (B,
T, C) first.

The canvas forms (`kernels/canvas.py`) take and return canvas tensors and
leave exact zeros outside the signal. Their backwards copy the JAX ones:
`conv1d_fused_canvas(bwd="kernel")` (`_canvas_bwd`, the JAX package's
`DIFFMUSIC_TPU_CANVAS=1`) launches the canvas kernel again on the cotangent
in its adjoint mode, then masks with a plain `where`; `bwd="plain"`
(`_canvas_xbwd_bwd`, `CANVAS=xbwd`) and `conv1d_pair_canvas`
(`_pair_canvas_bwd`) run plain adjoint convs over the whole canvas and
re-zero the margins with the row mask. None of them takes the mask kernels.
"""

import functools

import torch
import torch.nn.functional as F

from ..tracing import count
from . import build, repack
from .canvas import TIME_BLOCK, canvas_row_mask, canvas_rows, from_canvas, to_canvas
from .device import use_plain
from .mask import _dense, leaky_mask, leaky_mask_add, leaky_mask_plain, mask_ok
from .upsampler import tap_major

# launches of each kernel since the last reset (see kernels.launch_counts);
# the canvas forms count apart, the adjoint launches of the canvas backward
# with the forward ones, those of `conv1d_fused`'s backward apart again
LAUNCHES = {"conv1d_fused": 0, "conv1d_fused_pair": 0, "conv1d_fused_canvas": 0,
            "conv1d_pair_canvas": 0, "conv1d_fused_adjoint": 0}
CANVAS_BWD = ("kernel", "plain")

# the bf16 kernel's tile (csrc/conv1d.cu, namespace tc)
BLOCK_M = 128     # output rows per block
BLOCK_N = 128     # output channels per block
BLOCK_K = 64      # input channels per step
REPACK = "conv1d_pair"   # the forward's tap-major copies in repack.REPACKS
ADJOINT = "conv1d_adjoint"   # the adjoint's tensor maps over the weights themselves


def _conv_view(h, w, b, dilation: int):
    """F.conv1d(h, w, dilation) + b, 'same', of (B, T, Cin) h and (k, Cin,
    Cout) w: the (B, T, Cout) view of the conv's (B, Cout, T) output."""
    k = w.shape[0]
    out = F.conv1d(h.transpose(1, 2), w.permute(2, 1, 0), b,
                   padding=(k - 1) * dilation // 2, dilation=dilation)
    return out.transpose(1, 2)


def conv1d_plain(x, w, b=None, dilation: int = 1, slope=None, residual=None):
    """conv1d(leaky(x), w, dilation) + b [+ residual], 'same' padding.

    x: (B, T, Cin); w: (k, Cin, Cout) -> (B, T, Cout), contiguous."""
    h = F.leaky_relu(x, slope) if slope is not None else x
    out = _conv_view(h, w, b, dilation)
    if residual is not None:
        out = out + residual
    return out.contiguous()


def pair_plain(x, w1, b1, w2, b2, dilation: int, slope):
    """One ResidualBlock iteration: (y, h) with h = conv1(leaky(x)) + b1 and
    y = conv2(leaky(h)) + b2 + x."""
    h = conv1d_plain(x, w1, b1, dilation, slope)
    return conv1d_plain(h, w2, b2, 1, slope, residual=x), h


def canvas_plain(xc, w, b, t: int, dilation: int = 1, slope=None, residual=None):
    """`conv1d_plain` on the canvas (the JAX `_canvas_reference`): the
    signal out, the conv, back onto a canvas with zero margins."""
    r = from_canvas(residual, t) if residual is not None else None
    return to_canvas(conv1d_plain(from_canvas(xc, t), w, b, dilation, slope, r))


def pair_canvas_plain(xc, w1, b1, w2, b2, t: int, dilation: int, slope):
    """`pair_plain` on the canvas (`_pair_canvas_reference`): (y, h)."""
    y, h = pair_plain(from_canvas(xc, t), w1, b1, w2, b2, dilation, slope)
    return to_canvas(y), to_canvas(h)


def pair_ok(k: int, cin: int, cout: int, dtype) -> bool:
    """The JAX routing rule (`conv1d_kernel.py::pair_ok`): 128-aligned
    channels and at most 9 MB of pair weights in the activation dtype."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    weights_mb = 2 * k * cin * cout * itemsize / 2 ** 20
    return cin % 128 == 0 and cout % 128 == 0 and weights_mb <= 9.0


def _adjoint(g, w, dilation: int, copy: bool = True):
    """Input cotangent of a 'same' odd-k conv: the same conv with the
    flipped, transposed kernel, run in the weight dtype. `copy=False` returns
    the conv's (B, T, C) view of its (B, C, T) output as it is, which the
    mask kernels read without a copy."""
    out = _conv_view(g.to(w.dtype), w.flip(0).transpose(1, 2), None, dilation)
    return out.contiguous() if copy else out


def _leaky_mask(x, d, slope, use_kernel: bool, r=None):
    """where(x >= 0, d, slope * d) [+ r], through the mask kernels when
    `use_kernel` (the JAX backwards' `use_pallas_mask`)."""
    if not use_kernel:
        return leaky_mask_plain(x, d, slope, r)
    if r is None:
        return leaky_mask(x, d, slope)
    return leaky_mask_add(x, d, r.contiguous(), slope)


def _signal(name, rows: int, t):
    """Rows [first, end) of `rows` that hold the signal: all of them, or,
    given a canvas signal length t, [512, 512 + t) of a canvas of t."""
    if t is None:
        return 0, rows
    if rows != canvas_rows(t):
        raise ValueError(f"{name}: {rows} rows are not the canvas of a "
                         f"{t}-row signal ({canvas_rows(t)} rows)")
    return TIME_BLOCK, TIME_BLOCK + t


def _operand_code(name: str, shapes, strides, dtypes, devices) -> int:
    """The dtype code of a conv1d launch's operands, given by their shapes,
    strides, dtypes and devices; raises unless they are contiguous tensors
    of one kernel dtype on one CUDA device."""
    if any(d.type != "cuda" or d != devices[0] for d in devices):
        raise ValueError(f"{name}: all tensors must be on one CUDA device, not {devices}")
    if any(dt != dtypes[0] for dt in dtypes):
        raise TypeError(f"{name}: mixed dtypes {dtypes}")
    code = build.dtype_code(dtypes[0])
    if not all(_dense(sh, st) for sh, st in zip(shapes, strides)):
        raise ValueError(f"{name}: tensors must be contiguous")
    return code


def _wmap(w, k: int, kdim: int, ndim: int):
    """The 128-byte TMA tensor map (host memory) through which the bf16
    kernel reads k weight matrices (k, ndim, kdim) at w, kdim innermost."""
    wmap = torch.empty(128, dtype=torch.uint8)
    build.check(build.library().dm_conv1d_wmap(w.data_ptr(), k, kdim, ndim, wmap.data_ptr()),
                REPACK)
    return wmap


def pair_weights(w):
    """The bf16 kernel's copy of a forward weight (k, Cin, Cout): its tap-major
    layout (k, Cout, Cin) and the tensor map through which the kernel reads
    it."""
    taps = tap_major(w)
    k, cin, cout = w.shape
    return taps, _wmap(taps, k, cin, cout)


def adjoint_weights(w):
    """The tensor map through which the bf16 adjoint pass reads a weight (k,
    Cin, Cout) as it lies: tap k-1-j's (Cin, Cout) matrix is the adjoint's
    (N, K) operand, so no copy is made."""
    k, cin, cout = w.shape
    return _wmap(w, k, cout, cin)


@functools.lru_cache(maxsize=256)
def fused_plan(name: str, shapes: tuple, strides: tuple, dtypes: tuple, devices: tuple,
               dilation: int, t, adjoint: bool, has_bias: bool, has_res: bool) -> tuple:
    """(dtype code, k, Cin, Cout, sig0, sig1) of a single-conv launch on x, w
    and, where given, b and the residual, in that order by their shapes,
    strides, dtypes and devices, with `t` the canvas signal length or None;
    raises for what the kernel does not take: tensors not on one CUDA device,
    mixed or other dtypes, a tensor not contiguous, shapes other than x (B, T,
    Cin), w (k, Cin, Cout) with odd k (with `adjoint` (k, Cout, Cin)), b
    (Cout,), the residual the output's shape, channels the tiles do not
    divide (bf16: Cin and Cout multiples of 64; fp32: Cin of 32, Cout of 64),
    a canvas of another length."""
    count("kernels.cache_miss", "conv1d.fused_plan")
    code = _operand_code(name, shapes, strides, dtypes, devices)
    xs, ws = tuple(shapes[0]), tuple(shapes[1])
    bs = tuple(shapes[2]) if has_bias else None
    rs = tuple(shapes[2 + has_bias]) if has_res else None
    if len(xs) != 3 or len(ws) != 3:
        raise ValueError(f"{name}: bad shapes x {xs}, w {ws}")
    bsz, rows, cin = xs
    k, cin_w, cout = (ws[0], ws[2], ws[1]) if adjoint else ws
    if cin_w != cin or k % 2 == 0 or (bs is not None and bs != (cout,)):
        raise ValueError(f"{name}: bad shapes x {xs}, w {ws}, b {bs}")
    if rs is not None and rs != (bsz, rows, cout):
        raise ValueError(f"{name}: residual must have the output's shape")
    if code == 1 and (cin % 64 or cout % 64):
        raise ValueError(f"{name}: bf16 Cin and Cout must be multiples of 64")
    if cin % 32 or cout % 64:
        raise ValueError(f"{name}: Cin must be a multiple of 32, Cout of 64")
    sig0, sig1 = _signal(name, rows, t)
    build.check_smem(name, build.library().dm_conv1d_fused_smem(code, k, dilation))
    return code, k, cin, cout, sig0, sig1


def _launch_fused(x, w, b, residual, dilation, slope, t=None, adjoint=False):
    """The conv kernel; `t` puts it on the canvas of a t-row signal, and
    `adjoint` reads w (k, Cout, Cin) as the flipped transposed kernel."""
    name = ("conv1d_fused_canvas" if t is not None else
            "conv1d_fused_adjoint" if adjoint else "conv1d_fused")
    ops = [x, w] + [a for a in (b, residual) if a is not None]
    code, k, cin, cout, sig0, sig1 = fused_plan(
        name, tuple(a.shape for a in ops), tuple(a.stride() for a in ops),
        tuple(a.dtype for a in ops), tuple(a.device for a in ops), dilation, t, adjoint,
        b is not None, residual is not None)
    if functools.reduce(lambda acc, a: acc | a.data_ptr(), ops, 0) % 16:
        raise ValueError(f"{name}: tensors must start 16-byte aligned")
    wp = w.data_ptr()
    if code == 1:   # bf16 reads the weights through a cached tensor map
        wp = (repack.cached(ADJOINT, w, adjoint_weights) if adjoint else
              repack.cached(REPACK, w, pair_weights)[1]).data_ptr()
    bsz, rows = x.shape[:2]
    y = torch.empty((bsz, rows, cout), dtype=x.dtype, device=x.device)
    rc = build.library().dm_conv1d_fused(
        code, x.data_ptr(), wp, b.data_ptr() if b is not None else None,
        residual.data_ptr() if residual is not None else None, y.data_ptr(),
        bsz, rows, cin, cout, k, dilation, float(slope or 0.0), int(slope is not None),
        sig0, sig1, int(adjoint), build.stream_ptr(x.device))
    build.check(rc, name)
    LAUNCHES[name] += 1
    return y


@functools.lru_cache(maxsize=256)
def pair_plan(name: str, shapes: tuple, strides: tuple, dtypes: tuple, devices: tuple,
              dilation: int, t) -> tuple:
    """(dtype code, sig0, sig1) of a pair launch on x, w1, b1, w2, b2, given
    in that order by their shapes, strides, dtypes and devices, with `t` the
    canvas signal length or None; raises for what the kernel does not take:
    tensors not on one CUDA device, mixed or other dtypes, a tensor not
    contiguous, shapes other than x (B, T, C), w (k, C, C) with odd k <= 17,
    b (C,), C not a multiple of 64, a canvas of another length."""
    count("kernels.cache_miss", "conv1d.pair_plan")
    code = _operand_code(name, shapes, strides, dtypes, devices)
    xs, w1s, b1s, w2s, b2s = (tuple(sh) for sh in shapes)
    if len(xs) != 3 or len(w1s) != 3:
        raise ValueError(f"{name}: bad shapes x {xs}, w1 {w1s}, w2 {w2s}")
    bsz, rows, c = xs
    k = w1s[0]
    if w1s != (k, c, c) or w2s != (k, c, c) or b1s != (c,) or b2s != (c,) or k % 2 == 0:
        raise ValueError(f"{name}: bad shapes x {xs}, w1 {w1s}, w2 {w2s}")
    if c % 64 or (k - 1) // 2 > 8:
        raise ValueError(f"{name}: C must be a multiple of 64 and k <= 17")
    sig0, sig1 = _signal(name, rows, t)
    build.check_smem(name, build.library().dm_conv1d_pair_smem(code, c, k, dilation))
    return code, sig0, sig1


def _launch_pair(x, w1, b1, w2, b2, dilation, slope, t=None):
    """The pair kernel; `t` puts it on the canvas of a t-row signal."""
    name = "conv1d_fused_pair" if t is None else "conv1d_pair_canvas"
    ops = (x, w1, b1, w2, b2)
    code, sig0, sig1 = pair_plan(name, tuple(a.shape for a in ops),
                                 tuple(a.stride() for a in ops), tuple(a.dtype for a in ops),
                                 tuple(a.device for a in ops), dilation, t)
    xp, w1p, b1p, w2p, b2p = (a.data_ptr() for a in ops)
    if (xp | w1p | b1p | w2p | b2p) % 16:
        raise ValueError(f"{name}: tensors must start 16-byte aligned")
    if code == 1:   # bf16 reads the cached copies through their tensor maps
        w1p = repack.cached(REPACK, w1, pair_weights)[1].data_ptr()
        w2p = repack.cached(REPACK, w2, pair_weights)[1].data_ptr()
    y = torch.empty_like(x)
    h = torch.empty_like(x)
    bsz, rows, c = x.shape
    rc = build.library().dm_conv1d_pair(
        code, xp, w1p, b1p, w2p, b2p, y.data_ptr(), h.data_ptr(), bsz, rows, c, w1.shape[0],
        dilation, float(slope), sig0, sig1, build.stream_ptr(x.device))
    build.check(rc, name)
    LAUNCHES[name] += 1
    return y, h


def pair_canvas_forward(xc, w1, b1, w2, b2, t: int, dilation: int, slope):
    """(y, h) of one canvas pair, no autograd: the kernel on a CUDA tensor,
    the plain version on a CPU one (the stage route's forward chain)."""
    if use_plain(xc, "conv1d_pair_canvas"):
        return pair_canvas_plain(xc, w1, b1, w2, b2, t, dilation, slope)
    return _launch_pair(xc, w1, b1, w2, b2, dilation, slope, t)


class _Conv1dFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, residual, dilation, slope, mask_kernel, adjoint_kernel):
        ctx.save_for_backward(x, w)
        ctx.dilation, ctx.slope, ctx.mask_kernel = dilation, slope, mask_kernel
        ctx.adjoint_kernel = adjoint_kernel
        ctx.has_residual = residual is not None
        if use_plain(x, "conv1d_fused"):
            return conv1d_plain(x, w, b, dilation, slope, residual)
        return _launch_fused(x, w, b, residual, dilation, slope)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        use_kernel = ctx.slope is not None and ctx.mask_kernel and mask_ok(x)
        if (ctx.adjoint_kernel and g.shape[-1] % 128 == 0 and w.shape[1] % 128 == 0
                and not use_plain(g, "conv1d_fused")):
            # `_conv1d_bwd` with w_adj: the forward kernel on the cotangent
            dx = _launch_fused(g.to(w.dtype).contiguous(), w, None, None, ctx.dilation, None,
                               adjoint=True)
        else:
            # the mask kernel reads the adjoint's output as the conv leaves it
            dx = _adjoint(g, w, ctx.dilation, copy=not use_kernel)
        if ctx.slope is not None:
            dx = _leaky_mask(x, dx, ctx.slope, use_kernel)
        dres = g if ctx.has_residual else None
        return dx.to(x.dtype), None, None, dres, None, None, None, None


class _Conv1dPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, dilation, slope, mask_kernel):
        if use_plain(x, "conv1d_fused_pair"):
            y, h = pair_plain(x, w1, b1, w2, b2, dilation, slope)
        else:
            y, h = _launch_pair(x, w1, b1, w2, b2, dilation, slope)
        ctx.save_for_backward(x, h, w1, w2)
        ctx.dilation, ctx.slope, ctx.mask_kernel = dilation, slope, mask_kernel
        return y

    @staticmethod
    def backward(ctx, g):
        x, h, w1, w2 = ctx.saved_tensors
        # both masks follow x's eligibility, as `_pair_bwd` does
        use_kernel = ctx.mask_kernel and mask_ok(x)
        # the mask kernels read the adjoints' outputs as the convs leave them
        copy = not use_kernel
        dh = _leaky_mask(h, _adjoint(g, w2, 1, copy), ctx.slope, use_kernel)
        dx = _leaky_mask(x, _adjoint(dh, w1, ctx.dilation, copy), ctx.slope, use_kernel, r=g)
        return dx.to(x.dtype), None, None, None, None, None, None, None


class _Conv1dCanvas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xc, w, b, residual, t, dilation, slope, bwd):
        ctx.save_for_backward(xc, w)
        ctx.t, ctx.dilation, ctx.slope, ctx.bwd = t, dilation, slope, bwd
        ctx.has_residual = residual is not None
        if use_plain(xc, "conv1d_fused_canvas"):
            return canvas_plain(xc, w, b, t, dilation, slope, residual)
        return _launch_fused(xc, w, b, residual, dilation, slope, t)

    @staticmethod
    def backward(ctx, g):
        xc, w = ctx.saved_tensors
        t, slope = ctx.t, ctx.slope
        if ctx.bwd == "kernel":
            # `_canvas_bwd`: the canvas kernel's adjoint mode on the cotangent
            g16 = g.to(w.dtype).contiguous()
            if use_plain(g16, "conv1d_fused_canvas"):
                dx = canvas_plain(g16, w.flip(0).transpose(1, 2), None, t, ctx.dilation)
            else:
                dx = _launch_fused(g16, w, None, None, ctx.dilation, None, t, adjoint=True)
            if slope is not None:
                dx = torch.where(xc >= 0, dx, slope * dx)
        else:
            # `_canvas_xbwd_bwd`: a plain adjoint over the whole canvas
            rv = canvas_row_mask(xc.shape[1], t, device=xc.device)
            g = g * rv.to(g.dtype)
            dx = _adjoint(g, w, ctx.dilation)
            if slope is not None:
                dx = torch.where(xc >= 0, dx, slope * dx)
            dx = dx * rv.to(dx.dtype)
        dres = g if ctx.has_residual else None
        return dx.to(xc.dtype), None, None, dres, None, None, None, None


class _PairCanvas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xc, w1, b1, w2, b2, t, dilation, slope):
        y, h = pair_canvas_forward(xc, w1, b1, w2, b2, t, dilation, slope)
        ctx.save_for_backward(xc, h, w1, w2)
        ctx.t, ctx.dilation, ctx.slope = t, dilation, slope
        return y

    @staticmethod
    def backward(ctx, g):
        # `_pair_canvas_bwd`: plain adjoints over the whole canvas, the
        # margins re-zeroed by the row mask
        xc, h, w1, w2 = ctx.saved_tensors
        slope = ctx.slope
        rv = canvas_row_mask(xc.shape[1], ctx.t, device=xc.device)
        g = g * rv.to(g.dtype)
        dhs = _adjoint(g, w2, 1)
        dh = torch.where(h >= 0, dhs, slope * dhs) * rv.to(dhs.dtype)
        dxs = _adjoint(dh, w1, ctx.dilation)
        dx = (torch.where(xc >= 0, dxs, slope * dxs) + g) * rv.to(dxs.dtype)
        return dx.to(xc.dtype), None, None, None, None, None, None, None


def conv1d_fused(x, w, b, residual=None, dilation: int = 1, slope=None,
                 mask_kernel: bool = False, adjoint_kernel: bool = False):
    """y = conv1d(leaky(x), w, dilation) + b [+ residual]; 'same', odd k.
    `mask_kernel` routes the backward's leaky-ReLU mask to the mask kernel,
    `adjoint_kernel` its adjoint conv to the kernel's adjoint mode."""
    return _Conv1dFused.apply(x, w, b, residual, dilation, slope, mask_kernel, adjoint_kernel)


def conv1d_fused_pair(x, w1, b1, w2, b2, dilation: int, slope: float,
                      mask_kernel: bool = False):
    """y = conv2(leaky(conv1(leaky(x), dilation) + b1)) + b2 + x in one launch.
    `mask_kernel` routes the backward's leaky-ReLU masks to the mask kernels."""
    return _Conv1dPair.apply(x, w1, b1, w2, b2, dilation, slope, mask_kernel)


def conv1d_fused_canvas(xc, w, b, residual, t: int, dilation: int = 1, slope=None,
                        bwd: str = "kernel"):
    """`conv1d_fused` on the canvas of a t-row signal: xc, residual and the
    result are canvas tensors (`kernels/canvas.py`). `bwd` "kernel" runs the
    backward's adjoint conv as the kernel (the JAX `conv1d_fused_canvas`),
    "plain" as a plain conv (`conv1d_canvas_xbwd`)."""
    if bwd not in CANVAS_BWD:
        raise ValueError(f"bwd must be one of {CANVAS_BWD}, not {bwd!r}")
    return _Conv1dCanvas.apply(xc, w, b, residual, t, dilation, slope, bwd)


def conv1d_pair_canvas(xc, w1, b1, w2, b2, t: int, dilation: int, slope: float):
    """`conv1d_fused_pair` on the canvas of a t-row signal; the backward is
    plain (the JAX `conv1d_pair_canvas`)."""
    return _PairCanvas.apply(xc, w1, b1, w2, b2, t, dilation, slope)
