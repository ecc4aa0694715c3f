"""HiFi-GAN upsampler forward: `phase_convtranspose`.

Replaces `diffmusic_tpu/pallas/upsampler_kernel.py::phase_convtranspose` with
the CUDA kernel of `csrc/upsampler.cu`, a phase-decomposed ConvTranspose1d.

Bound on the H100: tensor-core work, about k / stride tap products per
output row. One block per (row tile, Cout tile, batch x phase) stages the
input window its rows need, accumulates only its phase's taps with WMMA and
writes its rows straight into the interleaved output, masking the ragged
tail: no multiplications by the interleaved zeros of the lhs-dilated form,
and no per-phase buffers.

`leaky(x)` -> ConvTranspose1d(stride, torch padding (k - stride) // 2) + b, with
x (B, T, Cin) and the math-layout kernel w (k, Cin, Cout). The leaky ReLU
stays outside the linear op, as in the JAX package, so its gradient mask is
autograd's. On a CPU tensor the wrapper runs the plain PyTorch version; on a
CUDA tensor it launches the kernel or raises. The backward is the plain
strided-conv adjoint in the weight dtype, with no weight gradients.
"""

import torch
import torch.nn.functional as F

from .device import use_plain

# launches of the kernel since the last reset (see kernels.launch_counts)
LAUNCHES = {"phase_convtranspose": 0}


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


def _tap_range(k: int, stride: int):
    """(d_lo, d_hi): the input-row offsets d of y[s*tp + rho] += x[tp + d] @ W[j]."""
    p_ct = (k - stride) // 2
    ds = [((j - p_ct) % stride + p_ct - j) // stride for j in range(k)]
    return min(ds), max(ds)


def _launch(x, w, b, stride, k, t_out):
    from . import build
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
    lib = build.library()
    code = build.dtype_code(x.dtype)
    build.check_smem("phase_convtranspose",
                     lib.dm_phase_convtranspose_smem(code, d_lo, d_hi))
    y = torch.empty((bsz, t_out, cout), dtype=x.dtype, device=x.device)
    rc = lib.dm_phase_convtranspose(
        code, x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, t_in, cin,
        cout, k, stride, d_lo, d_hi, t_out, build.stream_ptr(x.device))
    build.check(rc, "phase_convtranspose")
    LAUNCHES["phase_convtranspose"] += 1
    return y


class _PhaseCT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, stride, k, t_out):
        if t_out != output_length(x.shape[1], stride, k):
            raise ValueError(f"phase_convtranspose: t_out {t_out} is not the "
                             f"transposed conv's length {output_length(x.shape[1], stride, k)}")
        ctx.save_for_backward(w)
        ctx.stride, ctx.k, ctx.x_dtype = stride, k, x.dtype
        if use_plain(x, "phase_convtranspose"):
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
    return _PhaseCT.apply(x, w, b, stride, k, t_out)
