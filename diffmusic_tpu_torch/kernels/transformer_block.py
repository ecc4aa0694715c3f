"""Fused self-attention transformer block: `fused_transformer_block`.

Replaces `diffmusic_tpu/pallas/transformer_kernel.py::fused_transformer_block`
(self-attention mode) with the CUDA kernel of `csrc/transformer_block.cu`:
LN1 -> MHSA -> +res -> LN3 -> GEGLU FF -> +res per 32-row query tile.

Bound on the H100: at head_dim 8 the attention is scalar work (below the
bf16 MMA depth of 16), T^2 * heads * 18 operations per call; the projections
and the FF are tensor-core work. The kernel runs QK^T and PV as fp32 FMAs
with an online softmax over 32-key chunks, so the (T, T) logits never reach
device memory, and the projections and the FF as WMMA tiles, streaming the
FF weights through L2.

x: (B, T, C); p: the block's parameters in the JAX math layout (dense kernels
(in, out)): ln1_scale/ln1_bias, wq/wk/wv/wo/bo, ln3_scale/ln3_bias, wi/bi,
wo2/bo2. K and V are projected outside the kernel with `torch.matmul`, as the
JAX wrapper does. On a CPU tensor the wrapper runs the plain PyTorch version;
on a CUDA tensor it launches the kernel or raises. The backward recomputes
through the plain version (`_ftb_bwd`); guided DPS sampling never calls it,
because the UNet runs under no-grad.
"""

import ctypes
import math

import torch
import torch.nn.functional as F

from .device import use_plain

# launches of the kernel since the last reset (see kernels.launch_counts)
LAUNCHES = {"fused_transformer_block": 0}

PARAM_ORDER = ("ln1_scale", "ln1_bias", "wq", "wk", "wv", "wo", "bo",
               "ln3_scale", "ln3_bias", "wi", "bi", "wo2", "bo2")
_LOG2E = 1.4426950408889634


def layer_norm(x, scale, bias, eps: float = 1e-6):
    """LayerNorm in fp32 (flax default eps 1e-6); returns fp32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def transformer_block_plain(x, p, heads: int, head_dim: int):
    """The JAX `_reference_block` (self-attention mode) in plain PyTorch."""
    b, t, c = x.shape
    scale = 1.0 / math.sqrt(head_dim)
    h1 = layer_norm(x, p["ln1_scale"], p["ln1_bias"]).to(x.dtype)
    q, k, v = h1 @ p["wq"], h1 @ p["wk"], h1 @ p["wv"]
    qh, kh, vh = (a.reshape(b, t, heads, head_dim).float() for a in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    o = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vh)
    o = o.reshape(b, t, c).to(x.dtype)
    res1 = x + (o @ p["wo"] + p["bo"]).to(x.dtype)
    h2 = layer_norm(res1, p["ln3_scale"], p["ln3_bias"]).to(x.dtype)
    a, g = (h2 @ p["wi"] + p["bi"]).chunk(2, dim=-1)
    return res1 + ((a * F.gelu(g)) @ p["wo2"] + p["bo2"]).to(x.dtype)


def _launch(x, p, heads: int, head_dim: int):
    from . import build
    bsz, t, c = x.shape
    if head_dim != 8 or heads * head_dim != c or c % 64 or heads > 32:
        raise ValueError(f"fused_transformer_block: the kernel takes head_dim 8, "
                         f"C = heads * 8, C % 64 == 0 and heads <= 32 "
                         f"(got C {c}, heads {heads}, head_dim {head_dim})")
    expect = {"wq": (c, c), "wk": (c, c), "wv": (c, c), "wo": (c, c),
              "wi": (c, 8 * c), "bi": (8 * c,), "wo2": (4 * c, c)}
    for n in PARAM_ORDER:
        if tuple(p[n].shape) != expect.get(n, (c,)):
            raise ValueError(f"fused_transformer_block: {n} has shape {tuple(p[n].shape)}")
    build.check_tensors("fused_transformer_block", x, *(p[n] for n in PARAM_ORDER))
    h1 = layer_norm(x, p["ln1_scale"], p["ln1_bias"]).to(x.dtype)
    k = (h1 @ p["wk"]).contiguous()
    v = (h1 @ p["wv"]).contiguous()
    lib = build.library()
    code = build.dtype_code(x.dtype)
    build.check_smem("fused_transformer_block", lib.dm_transformer_block_smem(code, c))
    operands = [x, k, v, p["ln1_scale"], p["ln1_bias"], p["wq"], p["wo"], p["bo"],
                p["ln3_scale"], p["ln3_bias"], p["wi"], p["bi"], p["wo2"], p["bo2"]]
    ptrs = (ctypes.c_void_p * len(operands))(*[o.data_ptr() for o in operands])
    out = torch.empty_like(x)
    rc = lib.dm_transformer_block(code, ctypes.cast(ptrs, ctypes.c_void_p),
                                  out.data_ptr(), bsz, t, c,
                                  _LOG2E / math.sqrt(head_dim),
                                  build.stream_ptr(x.device))
    build.check(rc, "fused_transformer_block")
    LAUNCHES["fused_transformer_block"] += 1
    return out


class _FusedBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, heads, head_dim, *params):
        ctx.save_for_backward(x, *params)
        ctx.heads, ctx.head_dim = heads, head_dim
        p = dict(zip(PARAM_ORDER, params))
        if use_plain(x, "fused_transformer_block"):
            return transformer_block_plain(x, p, heads, head_dim)
        return _launch(x, p, heads, head_dim)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_(True)
            out = transformer_block_plain(xd, dict(zip(PARAM_ORDER, params)),
                                          ctx.heads, ctx.head_dim)
            (dx,) = torch.autograd.grad(out, xd, g.to(out.dtype))
        return (dx, None, None) + (None,) * len(params)


def fused_transformer_block(x, p, heads: int, head_dim: int):
    """One self-attention BasicTransformerBlock over x (B, T, C)."""
    return _FusedBlock.apply(x, heads, head_dim, *(p[n] for n in PARAM_ORDER))
