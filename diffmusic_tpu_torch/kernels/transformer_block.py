"""Fused transformer block: `fused_transformer_block`.

Replaces `diffmusic_tpu/pallas/transformer_kernel.py::fused_transformer_block`
(self-attention mode, the dual-cross mode of AudioLDM2, and the bounded
softmax of either) with the CUDA kernel of `csrc/transformer_block.cu`, per
32-row query tile: LN1 -> MHSA -> +res -> [per cross stream i: LN2_i -> q_i
-> attention over the stream's keys -> out-projection -> +res] -> LN3 ->
GEGLU FF -> +res.

Bound on the H100: the self-attention's exponentials, one exp2 per logit,
T^2 * heads at 16 per clock per SM, above the tensor-core work of the
projections, the FF and the attention's products. In bf16 the attention runs
on the tensor cores with the flash kernel's warp core (`csrc/mma_attention.cuh`:
QK^T on mma.sync m16n8k8, an online softmax per 64-key chunk, P rounded to
bf16 for PV on m16n8k16), so the (T, T) logits never reach device memory.
One block of 16 warps owns 8 heads and 64 channels of a 32-row tile, and
the `COLS_PER_BLOCK`-channel blocks of a tile form a cluster (250 blocks at
T 4000, 16 heads; 128 at T 1000, 32 heads): each computes q and the
attention for its heads, the out-projection and residual for its channels
after gathering the cluster's attention output through distributed shared
memory, and a quarter-share of the FF's hidden units, whose partial
products the cluster sums per output channel. The projections stream their
weight tiles through a cp.async ring into mma.sync m16n8k16 products. fp32
runs the exact scalar path: one block of 8 warps per tile, the attention as
fp32 FMAs (one thread per (row, head)), the products as scalar tiles.

The cross streams add a few keys each (AudioLDM2: 8 GPT-2 states, the T5
sequence's tokens): one 64-key chunk each, with the mask's additive bias;
the win is keeping LN2_i, q_i, the stream's output and the residual on chip.

x: (B, T, C); p: the block's parameters in the JAX math layout (dense kernels
(in, out)): ln1_scale/ln1_bias, wq/wk/wv/wo/bo, ln3_scale/ln3_bias, wi/bi,
wo2/bo2, and per cross stream i: ln2{i}_scale/ln2{i}_bias, cwq{i}/cwk{i}/
cwv{i}/cwo{i}/cbo{i}. contexts: per stream (B, Tk_i, ctx_dim_i);
cross_biases: per stream (B, 1, Tk_i) fp32 additive logit bias (0 / -1e9 from
the attention mask; zeros when unmasked). The self K/V and the cross K/V are
projected outside the kernel with `torch.matmul`, as the JAX wrapper does; the
kernel masks the keys past each stream's Tk itself, so they are not padded.

`bsoft` (the JAX package's `DIFFMUSIC_TPU_BSOFT`) runs the self-attention's
softmax with the bounded shift: the row max is replaced by the Cauchy-Schwarz
bound ||q_r|| * max_k ||k_k|| (times the logit scale, in log2 units), fixed
before the first key, so there is no running max and no rescale; the
denominator is guarded with max(den, 1e-37). The wrapper computes max_k
||k_k|| per (batch, head) over the rounded keys the kernel dots against, as
the JAX wrapper does outside its kernel. The cross streams keep the exact
softmax. The bounded mode counts its launches apart.

The kernel takes head_dim 8, C = heads * 8 up to 32 heads, and works in
whole 64-channel slices: a block narrower than that (the tiny configs' 16
and 32 channels, which the JAX rule fuses as it fuses every block with T >=
512) runs zero-padded to one slice (`widen`), with its LayerNorms'
statistics over its own C channels; the padded channels stay exactly zero
and are cut from the output.

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA tensor
it launches the kernel or raises. The backward recomputes through the plain
version and returns the gradients of x and of the contexts (`_ftb_bwd`);
guided DPS sampling never calls it, because the UNet runs under no-grad.
"""

import ctypes
import math

import torch
import torch.nn.functional as F

from .attention import attention_plain
from .device import use_plain

# launches of the kernel since the last reset (see kernels.launch_counts)
# (the dual-cross mode counts apart from the self-attention mode, and the
# bounded-softmax mode, self-attention or dual-cross, apart from both)
LAUNCHES = {"fused_transformer_block": 0, "fused_transformer_block_cross": 0,
            "fused_transformer_block_bsoft": 0}

PARAM_ORDER = ("ln1_scale", "ln1_bias", "wq", "wk", "wv", "wo", "bo",
               "ln3_scale", "ln3_bias", "wi", "bi", "wo2", "bo2")
CROSS_ORDER = ("ln2{}_scale", "ln2{}_bias", "cwq{}", "cwk{}", "cwv{}", "cwo{}", "cbo{}")
MAX_CROSS = 2
COLS_PER_BLOCK = 64   # bf16: channels (8 heads) per block of a tile's cluster (csrc, tc::COLS)
_LOG2E = 1.4426950408889634


def param_names(n_cross: int) -> tuple:
    """The block's parameter names with `n_cross` cross streams."""
    return PARAM_ORDER + tuple(n.format(i) for i in range(n_cross) for n in CROSS_ORDER)


def layer_norm(x, scale, bias, eps: float = 1e-6):
    """LayerNorm in fp32 (flax default eps 1e-6); returns fp32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def key_norm_max(k, heads: int):
    """max over the keys of ||k|| per (batch, head): (B, T, heads * D) -> (B,
    heads) fp32, of k as it is (the rounded keys the kernel dots against).
    Two ops: on the host-bound guided step each op costs host time."""
    b, t, c = k.shape
    return torch.linalg.vector_norm(k.reshape(b, t, heads, c // heads), dim=-1,
                                    dtype=torch.float32).amax(1)


def bounded_attention_plain(q, k, v):
    """Softmax attention over (B, T, H, D) with the bounded shift of the
    JAX kernel's bsoft mode: logits and shift in log2 units, fp32, the
    denominator guarded with max(den, 1e-37)."""
    scale = _LOG2E / math.sqrt(q.shape[-1])
    qf = q.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float()) * scale
    kmax = key_norm_max(k.flatten(2), k.shape[2])                    # (B, H)
    bound = qf.norm(dim=-1).transpose(1, 2)[..., None] * kmax[..., None, None] * scale
    p = torch.exp2(s - bound)
    den = p.sum(-1, keepdim=True).clamp_min(1e-37)
    o = torch.einsum("bhqk,bkhd->bhqd", p, v.float()) / den
    return o.transpose(1, 2).to(q.dtype)


def transformer_block_plain(x, p, heads: int, head_dim: int, contexts=(), cross_biases=(),
                            bsoft: bool = False):
    """The JAX `_reference_block` in plain PyTorch; with `bsoft`, its
    self-attention takes the bounded softmax of the kernel's bsoft mode."""
    b, t, c = x.shape

    def attend(q, k, v, bias=None, fn=attention_plain):   # (B, T, C) rows split into heads
        split = lambda a: a.reshape(b, a.shape[1], heads, head_dim)
        args = (split(q), split(k), split(v)) + ((bias,) if bias is not None else ())
        return fn(*args).reshape(b, t, c)

    h1 = layer_norm(x, p["ln1_scale"], p["ln1_bias"]).to(x.dtype)
    o = attend(h1 @ p["wq"], h1 @ p["wk"], h1 @ p["wv"],
               fn=bounded_attention_plain if bsoft else attention_plain)
    res1 = x + (o @ p["wo"] + p["bo"]).to(x.dtype)
    for i, ctx in enumerate(contexts):
        hc = layer_norm(res1, p[f"ln2{i}_scale"], p[f"ln2{i}_bias"]).to(x.dtype)
        ckv = ctx.to(x.dtype)
        oc = attend(hc @ p[f"cwq{i}"], ckv @ p[f"cwk{i}"], ckv @ p[f"cwv{i}"],
                    cross_biases[i][:, None])
        res1 = res1 + (oc @ p[f"cwo{i}"] + p[f"cbo{i}"]).to(x.dtype)
    h2 = layer_norm(res1, p["ln3_scale"], p["ln3_bias"]).to(x.dtype)
    a, g = (h2 @ p["wi"] + p["bi"]).chunk(2, dim=-1)
    return res1 + ((a * F.gelu(g)) @ p["wo2"] + p["bo2"]).to(x.dtype)


def widen(a, name: str, c: int, cp: int):
    """A block operand of width C zero-padded to cp channels, the kernel's
    whole 64-channel slices: `name` is the parameter's, or "rows" for (B, T,
    C) activations. Every channel axis grows; a and gate of `wi` / `bi` grow
    each to 4 cp. The padded channels and hidden units stay exactly zero
    through the block, as their LayerNorm scale and bias, weights and keys
    are zero and the kernel takes the LayerNorm's statistics over the first
    C channels only."""
    g = cp - c
    if g == 0:
        return a
    if name in ("wi", "bi"):
        rows = (0, g) if name == "wi" else ()
        return torch.cat([F.pad(h, (0, 4 * g) + rows) for h in a.chunk(2, dim=-1)], dim=-1)
    if name == "wo2":
        return F.pad(a, (0, g, 0, 4 * g))
    if name.rstrip("0123456789") in ("wq", "wo", "cwq", "cwo"):
        return F.pad(a, (0, g, 0, g))
    return F.pad(a, (0, g))   # a vector of C, or rows


def _launch(x, p, heads: int, head_dim: int, contexts, cross_biases, bsoft: bool):
    from . import build
    bsz, t, c = x.shape
    n = len(contexts)
    name = ("fused_transformer_block_bsoft" if bsoft else
            "fused_transformer_block_cross" if n else "fused_transformer_block")
    if head_dim != 8 or heads * head_dim != c or heads > 32 or n > MAX_CROSS:
        raise ValueError(f"fused_transformer_block: the kernel takes head_dim 8, "
                         f"C = heads * 8, heads <= 32 and at most {MAX_CROSS} cross "
                         f"streams (got C {c}, heads {heads}, head_dim {head_dim}, "
                         f"{n} streams)")
    expect = {"wq": (c, c), "wk": (c, c), "wv": (c, c), "wo": (c, c),
              "wi": (c, 8 * c), "bi": (8 * c,), "wo2": (4 * c, c)}
    for i, ctx in enumerate(contexts):
        cd = ctx.shape[-1]
        expect.update({f"cwq{i}": (c, c), f"cwk{i}": (cd, c), f"cwv{i}": (cd, c),
                       f"cwo{i}": (c, c)})
        if ctx.shape[0] != bsz or tuple(cross_biases[i].shape) != (bsz, 1, ctx.shape[1]):
            raise ValueError(f"fused_transformer_block: stream {i} has context "
                             f"{tuple(ctx.shape)} and bias {tuple(cross_biases[i].shape)}")
    names = param_names(n)
    for k in names:
        if tuple(p[k].shape) != expect.get(k, (c,)):
            raise ValueError(f"fused_transformer_block: {k} has shape {tuple(p[k].shape)}")
    build.check_tensors(name, x, *contexts, *(p[k] for k in names))
    # a block narrower than a whole 64-channel slice (the tiny configs' 16
    # and 32) runs padded to one, with the LayerNorms over its C channels
    cp = -(-c // COLS_PER_BLOCK) * COLS_PER_BLOCK
    wide = lambda a, k="rows": widen(a, k, c, cp).contiguous()
    h1 = layer_norm(x, p["ln1_scale"], p["ln1_bias"]).to(x.dtype)
    keys = h1 @ p["wk"]
    kmax = F.pad(key_norm_max(keys, heads), (0, (cp - c) // 8)).contiguous() if bsoft else None
    operands = [wide(x), wide(keys), wide(h1 @ p["wv"])] + [
        wide(p[k], k) for k in ("ln1_scale", "ln1_bias", "wq", "wo", "bo", "ln3_scale",
                                "ln3_bias", "wi", "bi", "wo2", "bo2")]
    tks = [0] * MAX_CROSS
    for i, ctx in enumerate(contexts):
        bias = cross_biases[i].float().contiguous()
        build.check_tensors(name, bias)
        operands += [wide(ctx @ p[f"cwk{i}"]), wide(ctx @ p[f"cwv{i}"]), bias] + [
            wide(p[k], k) for k in (f"ln2{i}_scale", f"ln2{i}_bias", f"cwq{i}", f"cwo{i}",
                                    f"cbo{i}")]
        tks[i] = ctx.shape[1]
    lib = build.library()
    code = build.dtype_code(x.dtype)
    build.check_smem(name, lib.dm_transformer_block_smem(code, cp))
    ptrs = (ctypes.c_void_p * len(operands))(*[o.data_ptr() for o in operands])
    out = x.new_empty(bsz, t, cp)
    rc = lib.dm_transformer_block(code, ctypes.cast(ptrs, ctypes.c_void_p),
                                  out.data_ptr(), bsz, t, cp, c, n, *tks,
                                  _LOG2E / math.sqrt(head_dim),
                                  kmax.data_ptr() if bsoft else None,
                                  build.stream_ptr(x.device))
    build.check(rc, name)
    LAUNCHES[name] += 1
    return out if cp == c else out[..., :c].contiguous()


class _FusedBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, heads, head_dim, n_cross, bsoft, *tensors):
        ctx.save_for_backward(x, *tensors)
        ctx.heads, ctx.head_dim, ctx.n_cross = heads, head_dim, n_cross
        contexts, biases = tensors[:n_cross], tensors[n_cross:2 * n_cross]
        p = dict(zip(param_names(n_cross), tensors[2 * n_cross:]))
        if use_plain(x, "fused_transformer_block"):
            return transformer_block_plain(x, p, heads, head_dim, contexts, biases, bsoft)
        return _launch(x, p, heads, head_dim, contexts, biases, bsoft)

    @staticmethod
    def backward(ctx, g):
        x, *tensors = ctx.saved_tensors
        n = ctx.n_cross
        with torch.enable_grad():
            xd = x.detach().requires_grad_(True)
            contexts = [c.detach().requires_grad_(True) for c in tensors[:n]]
            out = transformer_block_plain(
                xd, dict(zip(param_names(n), tensors[2 * n:])), ctx.heads, ctx.head_dim,
                contexts, tensors[n:2 * n])
            grads = torch.autograd.grad(out, [xd, *contexts], g.to(out.dtype))
        # the biases encode the (non-differentiable) attention mask; the
        # weights are frozen. The recompute takes the exact softmax in either
        # mode, as the JAX `_ftb_bwd` does.
        return (grads[0], None, None, None, None, *grads[1:]) + (None,) * (len(tensors) - n)


def fused_transformer_block(x, p, heads: int, head_dim: int, contexts=(), cross_biases=(),
                            bsoft: bool = False):
    """One BasicTransformerBlock over x (B, T, C): self-attention, then the
    given cross-attention streams, then the GEGLU FF. `bsoft` bounds the
    self-attention's softmax (module docstring)."""
    n = len(contexts)
    if len(cross_biases) != n:
        raise ValueError("fused_transformer_block: one bias per context")
    return _FusedBlock.apply(x, heads, head_dim, n, bsoft, *contexts, *cross_biases,
                             *(p[k] for k in param_names(n)))
