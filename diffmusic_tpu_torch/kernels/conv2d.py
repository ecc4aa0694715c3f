"""'same' 2-D convolution of the UNet and the VAE decoder: `conv2d_same`.

Replaces `diffmusic_tpu/pallas/conv2d_kernel.py::conv2d_same_fused` with the
CUDA kernel of `csrc/conv2d.cu`, forward only.

Bound on the H100: tensor-core work (a 3x3 conv at (250, 16) with 512
channels is 19 GFLOP, at (500, 32) 75). The kernel is an implicit GEMM over
the port's NCHW tensors as they are: no layout copy, and the zero padding at
the image edges comes from predicated loads, not a padded copy.

x (B, Cin, H, W), w (Cout, Cin, kh, kw) as `nn.Conv2d` keeps it, stride 1,
padding (kh // 2, kw // 2), odd kh and kw. On a CPU tensor the wrapper runs
the plain version; on a CUDA tensor it launches the kernel or raises. Weights
are frozen: the backward returns the input cotangent only, the plain adjoint
conv with the flipped, channel-swapped kernel run in the weight dtype
(`_conv2d_bwd`, the JAX default `DIFFMUSIC_TPU_CONV2D_BWD=xla`).
"""

import torch
import torch.nn.functional as F

from .device import use_plain

# launches of the kernel since the last reset (see kernels.launch_counts)
LAUNCHES = {"conv2d_same": 0}

ROW_BLOCK = 512   # `conv2d_kernel.ROW_BLOCK`, which the routing rule reads


def conv2d_ok(x, w) -> bool:
    """The JAX route (`layers.Conv2DSame`: k > 1 and W <= 64, then
    `conv2d_kernel._eligible`) on NCHW x and (Cout, Cin, kh, kw) w: odd
    taps, 128-aligned channels, 512 % W == 0 and H * W >= 512."""
    cout, cin, kh, kw = w.shape
    h, wd = x.shape[2:]
    return (kh * kw > 1 and wd <= 64 and kh % 2 == 1 and kw % 2 == 1
            and cin % 128 == 0 and cout % 128 == 0
            and ROW_BLOCK % wd == 0 and h * wd >= ROW_BLOCK)


def conv2d_plain(x, w, b):
    """conv2d(x, w, 'same', stride 1) + b."""
    return F.conv2d(x, w, b, padding=(w.shape[2] // 2, w.shape[3] // 2))


def _launch(x, w, b):
    from . import build
    build.check_tensors("conv2d_same", x, w, b)
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"conv2d_same: x and w must be 4-D, not {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    bsz, cin, h, wd = x.shape
    cout, cin_w, kh, kw = w.shape
    if cin_w != cin or tuple(b.shape) != (cout,) or kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"conv2d_same: bad shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}")
    if cin % 32 or cout % 64:
        raise ValueError("conv2d_same: Cin must be a multiple of 32, Cout of 64")
    lib = build.library()
    code = build.dtype_code(x.dtype)
    build.check_smem("conv2d_same", lib.dm_conv2d_same_smem(code))
    y = torch.empty((bsz, cout, h, wd), dtype=x.dtype, device=x.device)
    rc = lib.dm_conv2d_same(code, x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                            bsz, cin, cout, h, wd, kh, kw, build.stream_ptr(x.device))
    build.check(rc, "conv2d_same")
    LAUNCHES["conv2d_same"] += 1
    return y


class _Conv2dSame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(w)
        ctx.x_dtype = x.dtype
        if use_plain(x, "conv2d_same"):
            return conv2d_plain(x, w, b)
        return _launch(x, w, b)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        w_adj = w.flip(2, 3).transpose(0, 1)          # (Cin, Cout, kh, kw)
        dx = F.conv2d(g.to(w.dtype), w_adj, padding=(w.shape[2] // 2, w.shape[3] // 2))
        return dx.to(ctx.x_dtype), None, None


def conv2d_same(x, w, b):
    """y = conv2d(x, w, 'same', stride 1) + b on NCHW, odd kh and kw."""
    return _Conv2dSame.apply(x, w, b)
