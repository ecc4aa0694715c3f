"""HiFi-GAN resblock convolutions: `conv1d_fused` and `conv1d_fused_pair`.

Replace `diffmusic_tpu/pallas/conv1d_kernel.py::conv1d_fused` and
`::conv1d_fused_pair` with the CUDA kernels of `csrc/conv1d.cu`.

Bound on the H100: tensor-core work (the vocoder forward is about 1 TFLOP at
10 s), while each conv reads x and w once. The kernels stage one haloed time
window of x per block (leaky applied on the way in) and accumulate all k
shifted tap products from it with WMMA (bf16 in, fp32 accumulate), so no
im2col patches reach device memory. The pair kernel keeps h, for its rows
plus conv2's halo over all channels, in shared memory, writes it once for
the backward's mask and runs conv2 from shared memory.

Layout as in the JAX package: activations (B, T, C), weights (k, Cin, Cout),
'same' padding, odd k. On a CPU tensor the wrappers run the plain PyTorch
versions beside them; on a CUDA tensor they launch the kernel or raise.
Weights are frozen: the backward returns the activation cotangent only, as
plain adjoint convolutions in the weight dtype followed by the leaky-ReLU
masks (`_conv1d_bwd` and `_pair_bwd` of the JAX module). With `mask_kernel`
(the JAX package's `DIFFMUSIC_TPU_MASK=pallas`) the masks of tensors that
`mask.mask_ok` admits take the mask kernels of `kernels/mask.py`.
"""

import torch
import torch.nn.functional as F

from .device import use_plain
from .mask import leaky_mask, leaky_mask_add, leaky_mask_plain, mask_ok

# launches of each kernel since the last reset (see kernels.launch_counts)
LAUNCHES = {"conv1d_fused": 0, "conv1d_fused_pair": 0}


def conv1d_plain(x, w, b=None, dilation: int = 1, slope=None, residual=None):
    """conv1d(leaky(x), w, dilation) + b [+ residual], 'same' padding.

    x: (B, T, Cin); w: (k, Cin, Cout) -> (B, T, Cout), contiguous."""
    k = w.shape[0]
    h = F.leaky_relu(x, slope) if slope is not None else x
    out = F.conv1d(h.transpose(1, 2), w.permute(2, 1, 0), b,
                   padding=(k - 1) * dilation // 2, dilation=dilation)
    out = out.transpose(1, 2)
    if residual is not None:
        out = out + residual
    return out.contiguous()


def pair_plain(x, w1, b1, w2, b2, dilation: int, slope):
    """One ResidualBlock iteration: (y, h) with h = conv1(leaky(x)) + b1 and
    y = conv2(leaky(h)) + b2 + x."""
    h = conv1d_plain(x, w1, b1, dilation, slope)
    return conv1d_plain(h, w2, b2, 1, slope, residual=x), h


def pair_ok(k: int, cin: int, cout: int, dtype) -> bool:
    """The JAX routing rule (`conv1d_kernel.py::pair_ok`): 128-aligned
    channels and at most 9 MB of pair weights in the activation dtype."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    weights_mb = 2 * k * cin * cout * itemsize / 2 ** 20
    return cin % 128 == 0 and cout % 128 == 0 and weights_mb <= 9.0


def _adjoint(g, w, dilation: int):
    """Input cotangent of a 'same' odd-k conv: the same conv with the
    flipped, transposed kernel, run in the weight dtype."""
    return conv1d_plain(g.to(w.dtype), w.flip(0).transpose(1, 2), None, dilation)


def _leaky_mask(x, d, slope, use_kernel: bool, r=None):
    """where(x >= 0, d, slope * d) [+ r], through the mask kernels when
    `use_kernel` (the JAX backwards' `use_pallas_mask`)."""
    if not use_kernel:
        return leaky_mask_plain(x, d, slope, r)
    if r is None:
        return leaky_mask(x, d, slope)
    return leaky_mask_add(x, d, r.contiguous(), slope)


def _launch_fused(x, w, b, residual, dilation, slope):
    from . import build
    ops = [x, w, b] + ([residual] if residual is not None else [])
    build.check_tensors("conv1d_fused", *ops)
    bsz, t, cin = x.shape
    k, cin_w, cout = w.shape
    if cin_w != cin or k % 2 == 0 or tuple(b.shape) != (cout,):
        raise ValueError(f"conv1d_fused: bad shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    if residual is not None and tuple(residual.shape) != (bsz, t, cout):
        raise ValueError("conv1d_fused: residual must have the output's shape")
    if cin % 32 or cout % 64:
        raise ValueError("conv1d_fused: Cin must be a multiple of 32, Cout of 64")
    lib = build.library()
    code = build.dtype_code(x.dtype)
    build.check_smem("conv1d_fused", lib.dm_conv1d_fused_smem(code, k, dilation))
    y = torch.empty((bsz, t, cout), dtype=x.dtype, device=x.device)
    rc = lib.dm_conv1d_fused(
        code, x.data_ptr(), w.data_ptr(), b.data_ptr(),
        residual.data_ptr() if residual is not None else None, y.data_ptr(),
        bsz, t, cin, cout, k, dilation, float(slope or 0.0), int(slope is not None),
        build.stream_ptr(x.device))
    build.check(rc, "conv1d_fused")
    LAUNCHES["conv1d_fused"] += 1
    return y


def _launch_pair(x, w1, b1, w2, b2, dilation, slope):
    from . import build
    build.check_tensors("conv1d_fused_pair", x, w1, b1, w2, b2)
    bsz, t, c = x.shape
    k = w1.shape[0]
    if (tuple(w1.shape) != (k, c, c) or tuple(w2.shape) != (k, c, c)
            or tuple(b1.shape) != (c,) or tuple(b2.shape) != (c,) or k % 2 == 0):
        raise ValueError(f"conv1d_fused_pair: bad shapes x {tuple(x.shape)}, "
                         f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    if c % 64 or (k - 1) // 2 > 8:
        raise ValueError("conv1d_fused_pair: C must be a multiple of 64 and k <= 17")
    lib = build.library()
    code = build.dtype_code(x.dtype)
    build.check_smem("conv1d_fused_pair", lib.dm_conv1d_pair_smem(code, c, k, dilation))
    y = torch.empty_like(x)
    h = torch.empty_like(x)
    rc = lib.dm_conv1d_pair(
        code, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        y.data_ptr(), h.data_ptr(), bsz, t, c, k, dilation, float(slope),
        build.stream_ptr(x.device))
    build.check(rc, "conv1d_fused_pair")
    LAUNCHES["conv1d_fused_pair"] += 1
    return y, h


class _Conv1dFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, residual, dilation, slope, mask_kernel):
        ctx.save_for_backward(x, w)
        ctx.dilation, ctx.slope, ctx.mask_kernel = dilation, slope, mask_kernel
        ctx.has_residual = residual is not None
        if use_plain(x, "conv1d_fused"):
            return conv1d_plain(x, w, b, dilation, slope, residual)
        return _launch_fused(x, w, b, residual, dilation, slope)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = _adjoint(g, w, ctx.dilation)
        if ctx.slope is not None:
            dx = _leaky_mask(x, dx, ctx.slope, ctx.mask_kernel and mask_ok(x))
        dres = g if ctx.has_residual else None
        return dx.to(x.dtype), None, None, dres, None, None, None


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
        dh = _leaky_mask(h, _adjoint(g, w2, 1), ctx.slope, use_kernel)
        dx = _leaky_mask(x, _adjoint(dh, w1, ctx.dilation), ctx.slope, use_kernel, r=g)
        return dx.to(x.dtype), None, None, None, None, None, None, None


def conv1d_fused(x, w, b, residual=None, dilation: int = 1, slope=None,
                 mask_kernel: bool = False):
    """y = conv1d(leaky(x), w, dilation) + b [+ residual]; 'same', odd k.
    `mask_kernel` routes the backward's leaky-ReLU mask to the mask kernel."""
    return _Conv1dFused.apply(x, w, b, residual, dilation, slope, mask_kernel)


def conv1d_fused_pair(x, w1, b1, w2, b2, dilation: int, slope: float,
                      mask_kernel: bool = False):
    """y = conv2(leaky(conv1(leaky(x), dilation) + b1)) + b2 + x in one launch.
    `mask_kernel` routes the backward's leaky-ReLU masks to the mask kernels."""
    return _Conv1dPair.apply(x, w1, b1, w2, b2, dilation, slope, mask_kernel)
