"""Flash self-attention at head_dim 8 and at head_dim 32-512: `flash_attention`.

Replaces `diffmusic_tpu/pallas/attention_kernel.py::flash_attention` with the
CUDA kernels of `csrc/flash_attention.cu`: unmasked softmax(Q K^T / sqrt(D)) V
over (B, T, H, D) tensors, the layout of `jax.nn.dot_product_attention`. The
JAX kernel takes any head_dim; the port takes the two its callers give it:
head_dim 8 (the UNets' attention) and 32 <= D <= 512 with D % 32 == 0 (the
VAE's mid-block under `vae_mid_attn="flash"`: one head of D = 512 channels at
published widths, 32 in the tiny configs). It raises for any other D.

Head_dim 8, bound on the H100: the exponentials. The products are small (4 *
T^2 * H * 8 FLOPs) and the bytes smaller (4 * T * H * 8 elements of input and
output), but every logit needs one exp2: T^2 * H of them at 16 per clock per
SM. Depth 8 is within the tensor cores' reach (`mma.sync` m16n8k8 takes bf16;
only WMMA and wgmma need depth 16). In bf16 a warp owns 16 query rows of one
head: QK^T on m16n8k8, an online softmax per chunk of `KEY_CHUNK` keys, P
rounded to bf16 in registers, PV on m16n8k16, with the key and value chunks of
a block's heads staged through a double-buffered `cp.async` ring (the warp
core of `csrc/mma_attention.cuh`, which the bf16 transformer block shares).
fp32 runs the exact scalar core it shares with the fused transformer block
(`csrc/common.cuh`).

Head_dim 32-512, bound on the H100: the tensor cores (4 * T^2 * D FLOPs, 0.033
ms at (1, 4000, 1, 512)). In bf16 (`flash_hopper_kernel`) a block owns
`WIDE_ROWS` query rows of one (batch, head), all D output columns and one of
`wide_splits` key splits; the splits of a query tile are one thread-block
cluster. A producer warpgroup brings Q once and K, V in chunks of
`WIDE_KEY_CHUNK` keys, each into a slot of its own, by TMA; two consumer
warpgroups each own half of the channels (D rounded up to 128), contract QK^T
over them on wgmma, sum the two partial S tiles through shared memory, run the
same online softmax on the whole S (keys past T at -inf), round P to bf16 and
multiply it by their half of V on wgmma with P in registers. S is computed
once. The splits' fp32 partial outputs meet in distributed shared memory and
are combined by log-sum-exp in the same launch. fp32 runs exact scalar FMAs.
Either way the (T, T) logits never reach device memory. Every D the wrapper
admits runs these two kernels.

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA tensor
it launches the kernel or raises. The backward is plain PyTorch, as the JAX
package's `_flash_bwd`: `bwd="f32"` (its default) recomputes the fp32
attention through autograd, `bwd="bf16"` (`DIFFMUSIC_TPU_FLASH_BWD=bf16`) is
the manual VJP with input-dtype operands, `attention_bwd_bf16`. The UNet runs
under no-grad in guided sampling, but on the `vae_mid_attn="flash"` route the
VAE decode is differentiated every guided step, and this backward with it.
"""

import functools
import math

import torch

from .device import use_plain

# launches of the kernel since the last reset (see kernels.launch_counts)
LAUNCHES = {"flash_attention": 0}
FLASH_BWD = ("f32", "bf16")

_LOG2E = 1.4426950408889634
KEY_CHUNK = 64      # keys per online-softmax step of the bf16 kernel (csrc, tc::KC)
# the bf16 head_dim 32-512 kernel's tile (csrc, namespace wide)
WIDE_ROWS = 64          # query rows per block
WIDE_KEY_CHUNK = 64     # keys per online-softmax step
WIDE_MIN_CHUNKS = 2     # chunks a key split keeps at least
WIDE_MAX_SPLITS = 8     # key splits of a query tile: the portable cluster size


def wide_ok(d: int) -> bool:
    """The head widths the head_dim 32-512 kernels take."""
    return 32 <= d <= 512 and d % 32 == 0


def wide_splits(batch: int, t: int, heads: int, sms: int) -> int:
    """The key splits of the bf16 head_dim 32-512 kernel on a card of `sms`
    SMs (csrc, `wide::splits_for`): doubled while the grid of query tiles
    times splits stays within the SMs and each split keeps `WIDE_MIN_CHUNKS`
    chunks."""
    blocks = -(-t // WIDE_ROWS) * batch * heads
    chunks = -(-t // WIDE_KEY_CHUNK)
    n = 1
    while n < WIDE_MAX_SPLITS and blocks * n * 2 <= sms and chunks >= WIDE_MIN_CHUNKS * n * 2:
        n *= 2
    return n


def wide_launch_plan(batch: int, t: int, heads: int, d: int) -> dict:
    """The bf16 head_dim 32-512 kernel's launch at (batch, t, heads, d) on the
    current CUDA device, as the library makes it (csrc,
    `dm_flash_attention_wide_plan`, the function the launch itself calls):
    `grid` (query tiles, batch x heads, key splits), `rows` of a tile, `keys`
    of a chunk and the `channels` d is rounded up to."""
    import ctypes

    from . import build
    plan = (ctypes.c_int * 6)()
    build.check(build.library().dm_flash_attention_wide_plan(batch, t, heads, d,
                                                             ctypes.addressof(plan)),
                "flash_attention")
    return {"grid": tuple(plan[:3]), "rows": plan[3], "keys": plan[4], "channels": plan[5]}


def attention_plain(q, k, v, bias=None):
    """The JAX `_reference_attention`: fp32 logits, softmax and product, the
    result in q's dtype. (B, Tq, H, D) queries over (B, Tk, H, D) keys and
    values; `bias`, if given, is added to the (B, H, Tq, Tk) logits."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    if bias is not None:
        s = s + bias.float()
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v.float()).to(q.dtype)


def attention_bwd_bf16(q, k, v, g):
    """The JAX `_bwd_attention_bf16`: the attention's VJP with operands in
    the input dtype and fp32 products and softmax, P and dS rounded to the
    input dtype; (dq, dk, dv) in the inputs' dtypes."""
    f = lambda a: a.float()
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", f(q), f(k)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(q.dtype)                   # (B, H, Tq, Tk)
    dv = torch.einsum("bhqk,bqhd->bkhd", f(p), f(g))
    dp = torch.einsum("bqhd,bkhd->bhqk", f(g), f(v))
    o_dot_g = (torch.einsum("bhqk,bkhd->bqhd", f(p), f(v)) * f(g)).sum(-1)   # (B, Tq, H)
    ds = (f(p) * (dp - o_dot_g.transpose(1, 2)[..., None]) * scale).to(q.dtype)
    dq = torch.einsum("bhqk,bkhd->bqhd", f(ds), f(k))
    dk = torch.einsum("bhqk,bqhd->bkhd", f(ds), f(q))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.lru_cache(maxsize=None)
def _check_smem(code: int, heads: int, d: int) -> None:
    from . import build
    lib = build.library()
    build.check_smem("flash_attention", lib.dm_flash_attention_smem(code, heads) if d == 8
                     else lib.dm_flash_attention_wide_smem(code, d))


def _launch(q, k, v):
    from . import build
    bsz, t, heads, d = q.shape
    if not ((d == 8 and heads <= 256) or wide_ok(d)):
        raise ValueError(f"flash_attention: the kernel takes head_dim 8 (at most 256 heads) "
                         f"or 32 to 512 in steps of 32 (got q {tuple(q.shape)})")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k, v must have one shape "
                         f"(got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)})")
    build.check_tensors("flash_attention", q, k, v)
    lib = build.library()
    code = build.dtype_code(q.dtype)
    _check_smem(code, heads, d)
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    scale_log2e = _LOG2E / math.sqrt(d)
    stream = build.stream_ptr(q.device)
    if d == 8:
        rc = lib.dm_flash_attention(code, *ptrs, bsz, t, heads, scale_log2e, stream)
    else:
        rc = lib.dm_flash_attention_wide(code, *ptrs, bsz, t, heads, d, scale_log2e, stream)
    build.check(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bwd):
        ctx.save_for_backward(q, k, v)
        ctx.bwd = bwd
        if use_plain(q, "flash_attention"):
            return attention_plain(q, k, v)
        return _launch(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        if ctx.bwd == "bf16":
            return (*attention_bwd_bf16(q, k, v, g.to(q.dtype)), None)
        with torch.enable_grad():
            qkv = [a.detach().requires_grad_(True) for a in (q, k, v)]
            out = attention_plain(*qkv)
            return (*torch.autograd.grad(out, qkv, g.to(out.dtype)), None)


def flash_attention(q, k, v, bwd: str = "f32"):
    """Unmasked self-attention over (B, T, H, D) tensors; `bwd` ("f32" or
    "bf16") picks the backward's form."""
    if bwd not in FLASH_BWD:
        raise ValueError(f"bwd must be one of {FLASH_BWD}, not {bwd!r}")
    if q.device.type == "cuda" and not (torch.is_grad_enabled() and any(
            a.requires_grad for a in (q, k, v))):
        return _launch(q, k, v)      # no graph to record: skip autograd's bookkeeping
    return _Flash.apply(q, k, v, bwd)
