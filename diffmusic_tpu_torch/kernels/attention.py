"""Flash self-attention at head_dim 8: `flash_attention`.

Replaces `diffmusic_tpu/pallas/attention_kernel.py::flash_attention` with the
CUDA kernel of `csrc/flash_attention.cu`: unmasked softmax(Q K^T / sqrt(D)) V
over (B, T, H, D) tensors, the layout of `jax.nn.dot_product_attention`.

Bound on the H100: the exponentials. At head_dim 8 the products are small
(4 * T^2 * H * 8 FLOPs) and the bytes smaller (4 * T * H * 8 elements of
input and output), but every logit needs one exp2: T^2 * H of them at 16 per
clock per SM. Depth 8 is within the tensor cores' reach (`mma.sync`
m16n8k8 takes bf16; only WMMA and wgmma need depth 16). In bf16 a warp owns
16 query rows of one head: QK^T on m16n8k8, an online softmax per chunk of
`KEY_CHUNK` keys, P rounded to bf16 in registers, PV on m16n8k16, with the
key and value chunks of a block's heads staged through a double-buffered
`cp.async` ring (the warp core of `csrc/mma_attention.cuh`, which the bf16
transformer block shares). fp32 runs the exact scalar core it shares with the fused
transformer block (`csrc/common.cuh`). Either way the (T, T) logits never
reach device memory. It takes head_dim 8 and raises otherwise.

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA tensor
it launches the kernel or raises. The backward is a plain fp32 recompute
through autograd, as the JAX package's default `_flash_bwd`; guided DPS
sampling never calls it, because the UNet runs under no-grad.
"""

import functools
import math

import torch

from .device import use_plain

# launches of the kernel since the last reset (see kernels.launch_counts)
LAUNCHES = {"flash_attention": 0}

_LOG2E = 1.4426950408889634
KEY_CHUNK = 64      # keys per online-softmax step of the bf16 kernel (csrc, tc::KC)


def attention_plain(q, k, v, bias=None):
    """The JAX `_reference_attention`: fp32 logits, softmax and product, the
    result in q's dtype. (B, Tq, H, D) queries over (B, Tk, H, D) keys and
    values; `bias`, if given, is added to the (B, H, Tq, Tk) logits."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    if bias is not None:
        s = s + bias.float()
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v.float()).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _check_smem(code: int, heads: int) -> None:
    from . import build
    build.check_smem("flash_attention", build.library().dm_flash_attention_smem(code, heads))


def _launch(q, k, v):
    from . import build
    bsz, t, heads, d = q.shape
    if d != 8 or heads > 256:
        raise ValueError(f"flash_attention: the kernel takes head_dim 8 and at most 256 "
                         f"heads (got q {tuple(q.shape)})")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k, v must have one shape "
                         f"(got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)})")
    build.check_tensors("flash_attention", q, k, v)
    lib = build.library()
    code = build.dtype_code(q.dtype)
    _check_smem(code, heads)
    out = torch.empty_like(q)
    rc = lib.dm_flash_attention(code, q.data_ptr(), k.data_ptr(),
                                v.data_ptr(), out.data_ptr(), bsz, t, heads,
                                _LOG2E / math.sqrt(d), build.stream_ptr(q.device))
    build.check(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        if use_plain(q, "flash_attention"):
            return attention_plain(q, k, v)
        return _launch(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [a.detach().requires_grad_(True) for a in (q, k, v)]
            out = attention_plain(*qkv)
            return torch.autograd.grad(out, qkv, g.to(out.dtype))


def flash_attention(q, k, v):
    """Unmasked self-attention over (B, T, H, D) tensors."""
    if q.device.type == "cuda" and not (torch.is_grad_enabled() and any(
            a.requires_grad for a in (q, k, v))):
        return _launch(q, k, v)      # no graph to record: skip autograd's bookkeeping
    return _Flash.apply(q, k, v)
