"""The bf16 fused transformer block's tiling (`csrc/transformer_block.cu`, the
mma.sync path of `fused_transformer_block` in its three modes), on the CPU,
against the plain version and the JAX package.

The kernel cannot run here, so `emulate_block` computes what its blocks
compute, in fp32 with the kernel's bf16 roundings: per cluster of n = C / 64
blocks, each owning 8 heads and 64 channels, LN1 rounded; q for its heads
rounded; the attention per 64-key chunk as the warp core does it (S = q K^T,
an online max and rescale, or in the bounded mode the shift fixed at ||q_r||
* kmax_h with the denominator guarded by max(l, 1e-37), every p carrying
2^23 that cancels in o / l; P in fp32 for the running sum and rounded to
bf16 for PV; keys past Tk masked; a cross stream's mask bias added to S
first), the output normalised and rounded; the
output projection and residual in fp32; each cross stream likewise; LN3
rounded, a and gate of each block's 256 hidden units, g rounded, and the
block's partial product g @ wo2[its rows] summed over the cluster before
the one rounding. Inputs are bf16 values made by numpy from a seed, at C 64
(one block a tile) and 128 (a cluster of two), T up to 333 (ragged against
the 32-row tiles and the 64-key chunks).

Tolerance: 3e-2 of max |reference| (chip_smoke.TOL_BLOCK_BF16), against
`transformer_block_plain` in bf16 and the JAX `fused_transformer_block` in
interpret mode (under `DIFFMUSIC_TPU_BSOFT=1` for the bounded mode): the
references round q, the attention output, the LayerNorm outputs and g to
bf16 as the kernel does, but the plain version keeps P in fp32 and rounds the
residual stream after each add, where the kernel keeps it in fp32; one bf16
rounding moves a product by ~2^-8 of its size, and the FF sums 4C of them.
Modes: self-attention, dual-cross (8 keys of width 96, then 12 of width 64
whose last 5 are masked), bounded at amplitude 1 and 5 (the bound's slack
grows with the logits).

The launch path, through a stand-in library that computes the fp32
kernel's contract from the operands it is handed: a block of 16 or 32
channels goes zero-padded to one 64-channel slice with the LayerNorms over
its own channels, the padding stays exactly zero, and the result equals the
plain version within 1e-5; what the kernel does not take raises.
"""

import ctypes
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import diffmusic_tpu.pallas.transformer_kernel as jtk
from diffmusic_tpu_torch import kernels
from diffmusic_tpu_torch.kernels import transformer_block as ttb
from diffmusic_tpu_torch.kernels.attention import attention_plain

TOL = 3e-2          # chip_smoke.TOL_BLOCK_BF16
KC = 64             # keys per chunk (csrc/mma_attention.cuh)
COLS = ttb.COLS_PER_BLOCK   # channels (8 heads) per block of a cluster
HID = 4 * COLS              # hidden units per block
LOG2E = 1.4426950408889634
HEADROOM = 23.0     # bounded: log2 of the scale every p carries (csrc/mma_attention.cuh)
BF = torch.bfloat16
CROSS = ((8, 96), (12, 64))   # (keys, width) of the two streams


def rnd(a):
    """Round to bf16, kept as fp32 values."""
    return a.to(BF).float()


def rel(a, b) -> float:
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float64)
    b = np.asarray(b.float() if isinstance(b, torch.Tensor) else b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def bf16_arr(rng, *shape, scale=1.0, shift=0.0):
    a = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
    return torch.from_numpy(a).to(BF).float().numpy()


def block_params(rng, c, n_cross, amp=1.0) -> dict:
    s = 1.0 / math.sqrt(c)
    p = dict(ln1_scale=bf16_arr(rng, c, scale=0.1 * amp, shift=amp),
             ln1_bias=bf16_arr(rng, c, scale=0.1),
             wq=bf16_arr(rng, c, c, scale=s), wk=bf16_arr(rng, c, c, scale=s),
             wv=bf16_arr(rng, c, c, scale=s), wo=bf16_arr(rng, c, c, scale=s),
             bo=bf16_arr(rng, c, scale=0.1),
             ln3_scale=bf16_arr(rng, c, scale=0.1, shift=1.0),
             ln3_bias=bf16_arr(rng, c, scale=0.1),
             wi=bf16_arr(rng, c, 8 * c, scale=s), bi=bf16_arr(rng, 8 * c, scale=0.1),
             wo2=bf16_arr(rng, 4 * c, c, scale=0.5 * s), bo2=bf16_arr(rng, c, scale=0.1))
    for i, (_, cd) in enumerate(CROSS[:n_cross]):
        p.update({f"ln2{i}_scale": bf16_arr(rng, c, scale=0.1, shift=1.0),
                  f"ln2{i}_bias": bf16_arr(rng, c, scale=0.1),
                  f"cwq{i}": bf16_arr(rng, c, c, scale=s),
                  f"cwk{i}": bf16_arr(rng, cd, c, scale=1 / math.sqrt(cd)),
                  f"cwv{i}": bf16_arr(rng, cd, c, scale=1 / math.sqrt(cd)),
                  f"cwo{i}": bf16_arr(rng, c, c, scale=s), f"cbo{i}": bf16_arr(rng, c, scale=0.1)})
    return p


def emulate_attention(q, k, v, bias=None, kmax=None):
    """The warp core over one head: q (Tq, 8), k and v (Tk, 8) bf16 values in
    fp32; bias (Tk,) in natural-log units or None; kmax the head's key-norm
    bound (the bounded mode) or None. Returns the output rounded to bf16."""
    c = LOG2E / math.sqrt(8)
    tq, tk = q.shape[0], k.shape[0]
    o = torch.zeros(tq, 8)
    l = torch.zeros(tq)
    if kmax is not None:
        m = q.norm(dim=1) * kmax                     # fixed for good (raw units)
    else:
        m = torch.full((tq,), -math.inf)
    for c0 in range(0, tk, KC):
        s = q @ k[c0:c0 + KC].T                      # (tq, <= KC), fp32
        if bias is not None:
            s = s + bias[c0:c0 + KC] * (LOG2E / c)   # raw logit units
        if kmax is None:
            mx = torch.maximum(m, s.max(dim=1).values)
            corr = torch.exp2((m - mx) * c)
            l, o, m = l * corr, o * corr[:, None], mx
        lift = HEADROOM if kmax is not None else 0.0
        p = torch.exp2(s * c - (m * c)[:, None] + lift)
        l = l + p.sum(dim=1)
        o = o + rnd(p) @ v[c0:c0 + KC]
    den = l.clamp_min(1e-37 * 2 ** HEADROOM) if kmax is not None else l
    return rnd(o / den[:, None])


def emulate_block(x, p, contexts=(), biases=(), bsoft=False):
    """The bf16 block kernel on x (B, T, C) and the parameters p (bf16 values
    in fp32); contexts (B, Tk_i, ctx_dim_i), biases (B, 1, Tk_i)."""
    bsz, t, c = x.shape
    heads, n = c // 8, c // COLS
    out = torch.empty(bsz, t, c)
    for b in range(bsz):
        res = x[b].clone()
        h1 = rnd(ttb.layer_norm(res, p["ln1_scale"], p["ln1_bias"]))
        keys, vals = rnd(h1 @ p["wk"]), rnd(h1 @ p["wv"])     # projected outside
        kmax = ttb.key_norm_max(keys[None], heads)[0] if bsoft else None
        streams = [(h1, p["wq"], p["wo"], p["bo"], keys, vals, None, kmax)]
        for i, ctx in enumerate(contexts):
            streams.append((None, p[f"cwq{i}"], p[f"cwo{i}"], p[f"cbo{i}"],
                            rnd(ctx[b] @ p[f"cwk{i}"]), rnd(ctx[b] @ p[f"cwv{i}"]),
                            biases[i][b, 0], None))
        for i, (hn, wq, wo, bo, kk, vv, bias, km) in enumerate(streams):
            if hn is None:
                hn = rnd(ttb.layer_norm(res, p[f"ln2{i - 1}_scale"], p[f"ln2{i - 1}_bias"]))
            o = torch.empty(t, c)
            for r in range(n):                        # block r of the cluster: its 8 heads
                q = rnd(hn @ wq[:, r * COLS:(r + 1) * COLS])
                for hl in range(COLS // 8):
                    h = r * (COLS // 8) + hl
                    sl = slice(8 * h, 8 * h + 8)
                    o[:, sl] = emulate_attention(q[:, 8 * hl:8 * hl + 8], kk[:, sl], vv[:, sl],
                                                 bias, None if km is None else km[h])
            for r in range(n):                        # each block's own channels
                cs = slice(r * COLS, (r + 1) * COLS)
                res[:, cs] += o @ wo[:, cs] + bo[cs]
        h2 = rnd(ttb.layer_norm(res, p["ln3_scale"], p["ln3_bias"]))
        acc = res.clone()
        for r in range(n):                            # block r's 256 hidden units
            hs = slice(r * HID, (r + 1) * HID)
            a = h2 @ p["wi"][:, hs] + p["bi"][hs]
            gate = h2 @ p["wi"][:, 4 * c:][:, hs] + p["bi"][4 * c:][hs]
            g = rnd(a * F.gelu(gate))
            acc = acc + g @ p["wo2"][hs]
        out[b] = rnd(acc + p["bo2"])
    return out


def operands(rng, c, t, n_cross, amp=1.0):
    x = torch.from_numpy(bf16_arr(rng, 1, t, c, scale=amp))
    p = {k: torch.from_numpy(v) for k, v in block_params(rng, c, n_cross, amp).items()}
    ctx = tuple(torch.from_numpy(bf16_arr(rng, 1, tk, cd, scale=0.5))
                for tk, cd in CROSS[:n_cross])
    mask = np.arange(12) < 7
    biases = (torch.zeros(1, 1, 8),
              torch.from_numpy(np.where(mask, 0.0, -1e9).astype(np.float32))[None, None])
    return x, p, ctx, biases[:n_cross]


def jax_block(x, p, ctx, biases, heads):
    j = lambda a: jnp.asarray(a.numpy(), jnp.bfloat16)
    out = jtk.fused_transformer_block(j(x), {k: j(v) for k, v in p.items()}, heads, 8,
                                      tuple(map(j, ctx)),
                                      tuple(jnp.asarray(b.numpy()) for b in biases))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("c,t,n_cross,bsoft,amp", [
    (64, 333, 0, False, 1.0), (128, 200, 0, False, 1.0), (64, 333, 2, False, 1.0),
    (128, 100, 2, False, 1.0), (64, 333, 0, True, 1.0), (64, 260, 0, True, 5.0),
    (128, 150, 2, True, 5.0)], ids=str)
def test_emulated_block_matches_plain_and_jax(rng, monkeypatch, c, t, n_cross, bsoft, amp):
    monkeypatch.setattr(jtk, "_INTERPRET", True)
    monkeypatch.setenv("DIFFMUSIC_TPU_BSOFT", "1" if bsoft else "0")
    x, p, ctx, biases = operands(rng, c, t, n_cross, amp)
    got = emulate_block(x, p, ctx, biases, bsoft)
    assert torch.isfinite(got).all()
    kernels.reset_launch_counts()
    plain = ttb.fused_transformer_block(x.to(BF), {k: v.to(BF) for k, v in p.items()}, c // 8,
                                        8, tuple(a.to(BF) for a in ctx), biases, bsoft=bsoft)
    assert not any(kernels.launch_counts().values())   # CPU: the plain version
    ref = jax_block(x, p, ctx, biases, c // 8)
    errs = {"plain": rel(got, plain), "jax": rel(got, ref)}
    assert max(errs.values()) <= TOL, errs


def test_emulated_attention_is_the_softmax(rng):
    """The chunked warp core in fp32 (P not rounded: the rounding is the only
    difference the test allows) equals softmax attention over 150 keys, three
    chunks, the last one ragged; the bounded mode equals it too while the
    bound's slack stays far from underflow."""
    q, k, v = (torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
               for n in (40, 150, 150))
    bias = torch.from_numpy(np.where(np.arange(150) < 120, 0.0, -1e9).astype(np.float32))
    want = torch.softmax(q @ k.T / math.sqrt(8) + bias, dim=1) @ v
    got = emulate_attention(q, k, v, bias)
    assert rel(got, want) <= 1e-2              # the output rounded to bf16, P to bf16
    kmax = k.norm(dim=1).max()
    want = torch.softmax(q @ k.T / math.sqrt(8), dim=1) @ v
    assert rel(emulate_attention(q, k, v, kmax=kmax), want) <= 1e-2



# ----------------------------------------------------------- the launch path
class ContractLibrary:
    """Stands in for the kernel library on CPU fp32 tensors: computes, from
    the operands the wrapper hands `dm_transformer_block`, what the fp32
    kernel computes under its contract (C whole 64-channel slices, the
    LayerNorms' statistics over the first Cn), and keeps the padded
    channels of its output."""

    def __init__(self):
        self.launches, self.padding = [], None

    def dm_transformer_block_smem(self, code, c):
        return 0

    def dm_transformer_block(self, code, args, out, b, t, c, cn, n, tk0, tk1, scale, kmax,
                             stream):
        self.launches.append((code, b, t, c, cn, n, tk0, tk1))
        addr = ctypes.cast(args, ctypes.POINTER(ctypes.c_void_p))

        def view(address, *shape):
            return np.ctypeslib.as_array(ctypes.cast(address, ctypes.POINTER(ctypes.c_float)),
                                         shape=shape)

        arr = lambda i, *shape: torch.from_numpy(view(addr[i], *shape).copy())
        heads = c // 8

        def norm(r, s, bias):
            mu = r[..., :cn].mean(-1, keepdim=True)
            var = (r[..., :cn] - mu).square().mean(-1, keepdim=True)
            return (r - mu) * torch.rsqrt(var + 1e-6) * s + bias

        def attend(q, k, v, bias=None, bounded=False):
            split = lambda a: a.reshape(b, a.shape[1], heads, 8)
            o = (ttb.bounded_attention_plain(split(q), split(k), split(v)) if bounded else
                 attention_plain(split(q), split(k), split(v), bias))
            return o.reshape(b, t, c)

        x, kx, vx = (arr(i, b, t, c) for i in range(3))
        if kmax is not None:
            assert torch.equal(torch.from_numpy(view(kmax, b, heads).copy()),
                               ttb.key_norm_max(kx, heads))
        h1 = norm(x, arr(3, c), arr(4, c))
        res = x + attend(h1 @ arr(5, c, c), kx, vx, bounded=kmax is not None) @ arr(6, c, c) \
            + arr(7, c)
        for i, tk in enumerate((tk0, tk1)[:n]):
            o = 14 + 8 * i
            hc = norm(res, arr(o + 3, c), arr(o + 4, c))
            bias = arr(o + 2, b, tk)[:, None, None, :]
            res = res + attend(hc @ arr(o + 5, c, c), arr(o, b, tk, c), arr(o + 1, b, tk, c),
                               bias) @ arr(o + 6, c, c) + arr(o + 7, c)
        a, g = (norm(res, arr(8, c), arr(9, c)) @ arr(10, c, 8 * c) + arr(11, 8 * c)).chunk(2, -1)
        y = res + (a * F.gelu(g)) @ arr(12, 4 * c, c) + arr(13, c)
        self.padding = y[..., cn:]
        view(out, b, t, c)[...] = y.numpy()
        return 0


def stand_in(monkeypatch) -> ContractLibrary:
    """The block's launch path on CPU tensors seen as on one CUDA device."""
    from diffmusic_tpu_torch.kernels import build
    lib = ContractLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda device: 7)
    monkeypatch.setattr(build, "check_tensors", lambda name, *tensors: None)
    monkeypatch.setattr(ttb, "use_plain", lambda x, name: False)
    kernels.reset_launch_counts()
    return lib


@pytest.mark.parametrize("c,n_cross,bsoft", [
    (16, 0, False), (32, 0, False), (16, 2, False), (32, 2, False), (16, 0, True),
    (32, 2, True), (64, 2, False)], ids=str)
def test_narrow_block_runs_padded_to_one_slice(rng, monkeypatch, c, n_cross, bsoft):
    """A block narrower than a 64-channel slice (the tiny configs' 16 and 32
    channels, which JAX fuses) reaches the kernel zero-padded to one slice,
    with Cn = C: under the kernel's contract the padded channels stay exactly
    zero and the block equals its plain version; a whole slice goes as it
    is."""
    lib = stand_in(monkeypatch)
    x, p, ctx, biases = operands(rng, c, 100, n_cross)
    got = ttb.fused_transformer_block(x, p, c // 8, 8, ctx, biases, bsoft)
    name = ("fused_transformer_block_bsoft" if bsoft else
            "fused_transformer_block_cross" if n_cross else "fused_transformer_block")
    assert kernels.launch_counts()[name] == 1
    tks = [a.shape[1] for a in ctx] + [0] * (2 - n_cross)
    assert lib.launches == [(0, 1, 100, max(c, 64), c, n_cross, *tks)]
    assert got.shape == x.shape and not bool(lib.padding.any())
    want = ttb.transformer_block_plain(x, p, c // 8, 8, ctx, biases, bsoft)
    assert rel(got, want) <= 1e-5


@pytest.mark.parametrize("c,heads,head_dim", [(128, 8, 16), (384, 48, 8), (24, 4, 8)], ids=str)
def test_block_kernel_refuses_what_it_does_not_take(rng, monkeypatch, c, heads, head_dim):
    """head_dim 8 and C = heads * 8 up to 32 heads, or a ValueError."""
    lib = stand_in(monkeypatch)
    x, p, _, _ = operands(rng, c, 40, 0)
    with pytest.raises(ValueError, match="the kernel takes head_dim 8"):
        ttb.fused_transformer_block(x, p, heads, head_dim)
    assert not lib.launches
