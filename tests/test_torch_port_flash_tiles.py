"""The bf16 flash attention kernel's chunked online softmax
(`csrc/flash_attention.cu`, `flash_mma_kernel`), replicated in torch on the
CPU, against the JAX Pallas kernel (`attention_kernel.flash_attention`) in
interpret mode and the plain attention.

`emulate_flash` computes what the kernel's warps compute for their rows: the
logits of q and k in fp32 (the m16n8k8 products of bf16 operands are exact
in fp32), then per chunk of `KEY_CHUNK` keys the running row max, the rescale
of the output and the sum by exp2((m_old - m_new) c), p = exp2(s c - m c),
the sum of p in fp32, and P rounded to bf16 before PV (the JAX kernel rounds
P the same way) or kept in fp32. T is not a multiple of the chunk (333, 1001),
so the last chunk is ragged, and H is 4, 16 or 32 (a block stages 8 heads; 4
leave half of it idle).

Tolerances, of max |ref|: with fp32 P, 1e-5 against the plain attention and
JAX's kernel on fp32 inputs (another order of the same fp32 sums); with bf16
P on bf16-rounded inputs, 2e-2 against JAX's kernel in bf16, which rounds P
relative to the full row's max instead of the running one, and its output to
bf16.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffmusic_tpu.pallas.attention_kernel as jak
from diffmusic_tpu_torch.kernels import attention as tattn

CASES = [(t, h) for t in (333, 1001) for h in (4, 16, 32)]


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def emulate_flash(q, k, v, p_bf16: bool):
    """torch replica of the kernel on (B, T, H, 8) q, k, v; fp32 result."""
    d = q.shape[-1]
    c = 1.4426950408889634 / math.sqrt(d)
    s_all = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    vh = v.float().permute(0, 2, 1, 3)                                  # (B, H, T, D)
    m = torch.full(s_all.shape[:-1] + (1,), -math.inf)
    l = torch.zeros_like(m)
    o = torch.zeros(s_all.shape[:-1] + (d,))
    for k0 in range(0, s_all.shape[-1], tattn.KEY_CHUNK):
        s = s_all[..., k0:k0 + tattn.KEY_CHUNK]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * c)                              # 0 on the first chunk
        p = torch.exp2(s * c - m_new * c)
        l = l * corr + p.sum(-1, keepdim=True)
        if p_bf16:
            p = p.bfloat16().float()
        o = o * corr + p @ vh[:, :, k0:k0 + tattn.KEY_CHUNK]
        m = m_new
    return (o / l).permute(0, 2, 1, 3)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jak, "_INTERPRET", True)


def qkv(rng, t, h):
    return [rng.standard_normal((1, t, h, 8)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("t,h", CASES, ids=str)
def test_emulated_flash_fp32_matches_plain_and_jax(interpret, rng, t, h):
    q, k, v = qkv(rng, t, h)
    ref = np.asarray(jak.flash_attention(*map(jnp.asarray, (q, k, v))))
    out = emulate_flash(*map(torch.from_numpy, (q, k, v)), p_bf16=False)
    assert rel(out, tattn.attention_plain(*map(torch.from_numpy, (q, k, v)))) <= 1e-5
    assert rel(out, ref) <= 1e-5


@pytest.mark.parametrize("t,h", CASES, ids=str)
def test_emulated_flash_bf16_p_matches_jax_bf16(interpret, rng, t, h):
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in qkv(rng, t, h))
    ref = jak.flash_attention(q, k, v)
    assert ref.dtype == jnp.bfloat16
    qt, kt, vt = (torch.from_numpy(np.array(a.astype(jnp.float32))) for a in (q, k, v))
    out = emulate_flash(qt, kt, vt, p_bf16=True).bfloat16().float()
    assert rel(out, np.asarray(ref.astype(jnp.float32))) <= 2e-2
    assert rel(out, tattn.attention_plain(qt, kt, vt)) <= 2e-2
