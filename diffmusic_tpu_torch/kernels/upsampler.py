"""HiFi-GAN upsampler forward: `phase_convtranspose`.

Replaces `diffmusic_tpu/pallas/upsampler_kernel.py::phase_convtranspose` with
the CUDA kernels of `csrc/upsampler.cu`, a phase-decomposed ConvTranspose1d.

Bound on the H100: tensor-core work, about k / stride tap products per
output row (16.8, 21.0 and 10.5 GFLOP at the 10-s slice's upsamplers 0-2):
no multiplications by the interleaved zeros of the lhs-dilated form, and no
per-phase buffers. In bf16 each block owns `BLOCK_M` output rows of one
phase x `BLOCK_N` output channels, an implicit GEMM on wgmma whose operands
arrive by TMA into a 3-stage shared-memory ring: per (`BLOCK_K`-channel
slice, tap of the phase), a box of x's rows at the tap's row offset d, whose
part before row 0 or past the end TMA fills with zeros, and a box of the
weights' tap-major copy (k, Cout, Cin). That copy is made once per weight
tensor and kept until the tensor changes (`repack.cached`; `REPACKS` counts
the copies made). The epilogue adds the bias in fp32, rounds once and writes
each output row stride * tp + rho as 16-byte vectors of contiguous channels,
masking the ragged tail. fp32 takes the exact scalar path on w as it is.

`leaky(x)` -> ConvTranspose1d(stride, torch padding (k - stride) // 2) + b, with
x (B, T, Cin) and the math-layout kernel w (k, Cin, Cout). The leaky ReLU
stays outside the linear op, as in the JAX package, so its gradient mask is
autograd's. On a CPU tensor the wrapper runs the plain PyTorch version; on a
CUDA tensor it launches the kernel or raises. The backward is the plain
strided-conv adjoint in the weight dtype, with no weight gradients.
"""

import functools

import torch
import torch.nn.functional as F

from . import repack
from .device import use_plain

# launches of the kernel since the last reset (see kernels.launch_counts)
LAUNCHES = {"phase_convtranspose": 0}

# the tensor-core kernel's tile (csrc/upsampler.cu, namespace tc)
BLOCK_M = 128     # output rows of one phase per block
BLOCK_N = 128     # output channels per block
BLOCK_K = 64      # input channels per step


def phase_ct_ok(cin: int, cout: int) -> bool:
    """The JAX routing rule (`upsampler_kernel.py::phase_ct_ok`): cin % 128 == 0
    and cout = 128 * 2**n."""
    n = cout // 128
    return cin % 128 == 0 and cout % 128 == 0 and n > 0 and (n & (n - 1)) == 0


def output_length(t_in: int, stride: int, k: int) -> int:
    return (t_in - 1) * stride + k - 2 * ((k - stride) // 2)


def convtranspose_plain(x, w, b, stride: int, k: int):
    """ConvTranspose1d(stride, padding (k - stride) // 2) + b on (B, T, Cin)."""
    y = F.conv_transpose1d(x.transpose(1, 2), w.permute(1, 2, 0), b,
                           stride=stride, padding=(k - stride) // 2)
    return y.transpose(1, 2).contiguous()


def phase_taps(k: int, stride: int, rho: int) -> list:
    """[(j, d)]: the taps j of phase rho, in the kernel's order, each with the
    input-row offset d of y[stride * tp + rho] += x[tp + d] @ W[j]."""
    p_ct = (k - stride) // 2
    return [(j, (rho + p_ct - j) // stride) for j in range((rho + p_ct) % stride, k, stride)]


@functools.lru_cache(maxsize=None)
def _tap_range(k: int, stride: int):
    """(d_lo, d_hi): the input-row offsets d over every phase's taps."""
    ds = [d for rho in range(stride) for _, d in phase_taps(k, stride, rho)]
    return min(ds), max(ds)


def tap_major(w):
    """(k, Cin, Cout) -> (k, Cout, Cin): each tap's (Cout, Cin) matrix
    contiguous, input channels innermost (K-major for wgmma)."""
    return w.detach().transpose(1, 2).contiguous()


@functools.lru_cache(maxsize=None)
def _check_smem(code: int, d_lo: int, d_hi: int) -> None:
    from . import build
    build.check_smem("phase_convtranspose",
                     build.library().dm_phase_convtranspose_smem(code, d_lo, d_hi))


def _check_length(t_in: int, stride: int, k: int, t_out: int) -> None:
    if t_out != output_length(t_in, stride, k):
        raise ValueError(f"phase_convtranspose: t_out {t_out} is not the "
                         f"transposed conv's length {output_length(t_in, stride, k)}")


def _launch(x, w, b, stride, k, t_out):
    from . import build
    _check_length(x.shape[1], stride, k, t_out)
    build.check_tensors("phase_convtranspose", x, w, b)
    bsz, t_in, cin = x.shape
    if tuple(w.shape[:2]) != (k, cin) or tuple(b.shape) != (w.shape[2],):
        raise ValueError(f"phase_convtranspose: bad shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    cout = w.shape[2]
    if cin % 32 or cout % 64 or k < stride:
        raise ValueError("phase_convtranspose: Cin must be a multiple of 32, "
                         "Cout of 64, and k >= stride")
    d_lo, d_hi = _tap_range(k, stride)
    code = build.dtype_code(x.dtype)
    _check_smem(code, d_lo, d_hi)
    # bf16: the cached tap-major weights; fp32 reads w
    taps = repack.cached("phase_convtranspose", w, tap_major) if code == 1 else None
    y = torch.empty((bsz, t_out, cout), dtype=x.dtype, device=x.device)
    rc = build.library().dm_phase_convtranspose(
        code, x.data_ptr(), w.data_ptr(), None if taps is None else taps.data_ptr(),
        b.data_ptr(), y.data_ptr(), bsz, t_in, cin, cout, k, stride, d_lo, d_hi, t_out,
        build.stream_ptr(x.device))
    build.check(rc, "phase_convtranspose")
    LAUNCHES["phase_convtranspose"] += 1
    return y


class _PhaseCT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, stride, k, t_out):
        ctx.save_for_backward(w)
        ctx.stride, ctx.k, ctx.x_dtype = stride, k, x.dtype
        if use_plain(x, "phase_convtranspose"):
            _check_length(x.shape[1], stride, k, t_out)
            return convtranspose_plain(x, w, b, stride, k)
        return _launch(x, w, b, stride, k, t_out)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        dx = F.conv1d(g.to(w.dtype).transpose(1, 2), w.permute(1, 2, 0),
                      stride=ctx.stride, padding=(ctx.k - ctx.stride) // 2)
        return dx.transpose(1, 2).to(ctx.x_dtype), None, None, None, None, None


def phase_convtranspose(x, w, b, stride: int, k: int, t_out: int, slope=None):
    """leaky(x) -> ConvTranspose1d(stride, padding (k - stride) // 2) + b."""
    if slope is not None:
        x = F.leaky_relu(x, slope)
    if x.device.type == "cuda" and not (torch.is_grad_enabled() and x.requires_grad):
        return _launch(x, w, b, stride, k, t_out)   # no graph to record
    return _PhaseCT.apply(x, w, b, stride, k, t_out)
