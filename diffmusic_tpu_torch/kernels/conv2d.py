"""'same' 2-D convolution of the UNet and the VAE decoder: `conv2d_same`.

Replaces `diffmusic_tpu/pallas/conv2d_kernel.py::conv2d_same_fused` with the
CUDA kernel of `csrc/conv2d.cu`, in the forward and, with `bwd="kernel"`, in
the backward's adjoint conv.

Bound on the H100: tensor-core work (a 3x3 conv at (250, 16) with 512
channels is 19 GFLOP, at (500, 32) 75). In bf16 the kernel is an implicit
GEMM on wgmma whose operands arrive by TMA into a 3-stage shared-memory
ring: per (64-channel slice, tap), a box of the weights' tap-major copy and
a box of the input's NHWC copy at the tap's own offset, whose out-of-image
part TMA fills with zeros (the 'same' padding, with no padded copy). A block
owns `BLOCK_M` output channels x `BLOCK_N` pixels, `tile_rows(W)` whole
image rows of `tile_width(W)` columns. Channels are innermost because a TMA
box must start 16-byte aligned in the innermost dimension: the tap's +-1
column shift of an NCHW row is a 2-byte start, which the card refuses. fp32
takes the exact scalar path with predicated loads on NCHW x.

Per call, a transpose kernel that the same C call launches first writes the
NHWC copy (one read and one write of x) into scratch the wrapper allocates.
The tap-major copy (kh*kw, Cout, Cin) of a weight is made once per weight
tensor and kept until the tensor changes (`repack.cached`; `REPACKS` counts
the copies made); the module's parameters stay those of `nn.Conv2d`.

x (B, Cin, H, W), w (Cout, Cin, kh, kw) as `nn.Conv2d` keeps it, stride 1,
padding (kh // 2, kw // 2), odd kh and kw. On a CPU tensor the wrapper runs
the plain version; on a CUDA tensor it launches the kernel or raises. Weights
are frozen: the backward returns the input cotangent only, the adjoint conv
with the flipped, channel-swapped kernel run in the weight dtype
(`_conv2d_bwd`). `bwd="plain"` (the JAX default `DIFFMUSIC_TPU_CONV2D_BWD=xla`)
runs it as `F.conv2d`; `bwd="kernel"` (`CONV2D_BWD=pallas`) launches this
kernel on the cotangent where `conv2d_ok(g, w_adj)` holds, as JAX's
`_eligible(g16, w_adj)`, and the plain adjoint elsewhere. The adjoint weights
(and, in bf16, their tap-major copy) are made once per weight tensor
(`repack.cached`, `REPACKS["conv2d_adjoint"]`); its launches count apart,
under "conv2d_same_adjoint".
"""

import functools

import torch
import torch.nn.functional as F

from . import repack
from .device import use_plain
from .repack import REPACKS  # noqa: F401  (tap-major weight copies, "conv2d_same")

# launches of the kernel since the last reset (see kernels.launch_counts): the
# forward, and the adjoint conv of the `bwd="kernel"` backward
LAUNCHES = {"conv2d_same": 0, "conv2d_same_adjoint": 0}
CONV2D_BWD = ("plain", "kernel")
ADJOINT = "conv2d_adjoint"   # the adjoint weights in repack.REPACKS

ROW_BLOCK = 512   # `conv2d_kernel.ROW_BLOCK`, which the routing rule reads

# the tensor-core kernel's tile (csrc/conv2d.cu, namespace tc)
BLOCK_M = 128     # output channels per block
BLOCK_N = 128     # output pixels per block
BLOCK_K = 64      # input channels per step


def conv2d_ok(x, w) -> bool:
    """The JAX route (`layers.Conv2DSame`: k > 1 and W <= 64, then
    `conv2d_kernel._eligible`) on NCHW x and (Cout, Cin, kh, kw) w: odd
    taps, 128-aligned channels, 512 % W == 0 and H * W >= 512."""
    cout, cin, kh, kw = w.shape
    h, wd = x.shape[2:]
    return (kh * kw > 1 and wd <= 64 and kh % 2 == 1 and kw % 2 == 1
            and cin % 128 == 0 and cout % 128 == 0
            and ROW_BLOCK % wd == 0 and h * wd >= ROW_BLOCK)


def tile_width(w: int) -> int:
    """Columns of a pixel tile: W rounded up to a power of two, at most
    `BLOCK_N` (wider images take several column tiles)."""
    wp = 1
    while wp < w and wp < BLOCK_N:
        wp *= 2
    return wp


def tile_rows(w: int) -> int:
    """Image rows of a pixel tile."""
    return BLOCK_N // tile_width(w)


def tap_major(w):
    """(Cout, Cin, kh, kw) -> (kh*kw, Cout, Cin): each tap's (Cout, Cin)
    matrix contiguous, input channels innermost (K-major for wgmma)."""
    cout, cin, kh, kw = w.shape
    return w.detach().permute(2, 3, 0, 1).reshape(kh * kw, cout, cin).contiguous()


def cached_tap_major(w):
    """`tap_major(w)`, made once per weight tensor and remade when the tensor
    is written in place (its `_version` moves) or has died."""
    return repack.cached("conv2d_same", w, tap_major)


def conv2d_plain(x, w, b):
    """conv2d(x, w, 'same', stride 1) + b."""
    return F.conv2d(x, w, b, padding=(w.shape[2] // 2, w.shape[3] // 2))


def adjoint_weight(w):
    """The adjoint conv's kernel: w flipped in both taps, channels swapped,
    (Cin, Cout, kh, kw)."""
    return w.flip(2, 3).transpose(0, 1)


def adjoint_operands(w):
    """What the kernel's adjoint launch reads, made once per weight tensor:
    the contiguous adjoint weight, its tap-major copy (bf16; None in fp32)
    and a zero bias of Cin."""
    wa = adjoint_weight(w.detach()).contiguous()
    taps = tap_major(wa) if wa.dtype == torch.bfloat16 else None
    return wa, taps, torch.zeros(wa.shape[0], dtype=wa.dtype, device=wa.device)


@functools.lru_cache(maxsize=None)
def _check_smem(code: int) -> None:
    from . import build
    build.check_smem("conv2d_same", build.library().dm_conv2d_same_smem(code))


def _launch(x, w, b, taps=None, name="conv2d_same"):
    """The kernel on x; bf16 reads `taps`, or w's cached tap-major copy."""
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
    _check_smem(code)
    # bf16: scratch for the NHWC copy (the C entry point's transpose kernel
    # writes it) and the tap-major weights (given, or w's cached copy); fp32
    # reads x and w
    xh = None
    if code == 1:
        xh = torch.empty((bsz, h, wd, cin), dtype=x.dtype, device=x.device)
        taps = cached_tap_major(w) if taps is None else taps
    else:
        taps = None
    y = torch.empty((bsz, cout, h, wd), dtype=x.dtype, device=x.device)
    rc = lib.dm_conv2d_same(code, x.data_ptr(), w.data_ptr(),
                            None if xh is None else xh.data_ptr(),
                            None if taps is None else taps.data_ptr(), b.data_ptr(),
                            y.data_ptr(), bsz, cin, cout, h, wd, kh, kw,
                            build.stream_ptr(x.device))
    build.check(rc, name)
    LAUNCHES[name] += 1
    return y


class _Conv2dSame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, bwd):
        ctx.save_for_backward(w)
        ctx.x_dtype, ctx.bwd = x.dtype, bwd
        if use_plain(x, "conv2d_same"):
            return conv2d_plain(x, w, b)
        return _launch(x, w, b)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        g = g.to(w.dtype)
        w_adj = adjoint_weight(w)                      # (Cin, Cout, kh, kw)
        if ctx.bwd == "kernel" and conv2d_ok(g, w_adj) and not use_plain(g, "conv2d_same"):
            wa, taps, zero = repack.cached(ADJOINT, w, adjoint_operands)
            dx = _launch(g.contiguous(), wa, zero, taps, "conv2d_same_adjoint")
        else:
            dx = F.conv2d(g, w_adj, padding=(w.shape[2] // 2, w.shape[3] // 2))
        return dx.to(ctx.x_dtype), None, None, None


def conv2d_same(x, w, b, bwd: str = "plain"):
    """y = conv2d(x, w, 'same', stride 1) + b on NCHW, odd kh and kw; `bwd`
    ("plain" or "kernel") is the backward's adjoint conv."""
    if x.device.type == "cuda" and not (torch.is_grad_enabled() and x.requires_grad):
        return _launch(x, w, b)      # no graph to record: skip autograd's bookkeeping
    return _Conv2dSame.apply(x, w, b, bwd)
