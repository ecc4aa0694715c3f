"""A torch replica of the bf16 head_dim 32-512 flash kernel's arithmetic
(`csrc/flash_attention.cu::wide::flash_hopper_kernel`), shared by the CPU
tests (`test_torch_port_vae_mid_attn.py`) and the card tests
(`test_torch_port_cuda.py`); it imports no jax, so that it runs on a card's
machine that has none."""

import math

import torch

from diffmusic_tpu_torch.kernels import attention as tattn

H100_SMS = 132
LOG2E = 1.4426950408889634


def emulate_wide(q, k, v, p_bf16: bool, splits=None):
    """The kernel on (B, T, H, D) q, k, v: the keys cut into `splits` key
    splits of whole `WIDE_KEY_CHUNK`-key chunks (by default `wide_splits` on
    an H100's 132 SMs), split s taking chunks [C s / n, C (s + 1) / n); per
    split and chunk the fp32 logits (the wgmma products of bf16 operands are
    exact in fp32), the running max, the rescale by exp2((m_old - m_new) c),
    p = exp2(s c - m c), the fp32 sum of p, and P rounded to bf16 before PV
    (or kept in fp32); then the splits' log-sum-exp combine, w_s = exp2((m_s
    - max m) c) and out = sum_s (w_s / sum_s w_s l_s) O_s, where a split with
    no chunk carries m = -inf, l = 0, O = 0. fp32 result."""
    b, t, h, d = q.shape
    c = LOG2E / math.sqrt(d)
    n = splits or tattn.wide_splits(b, t, h, H100_SMS)
    kc = tattn.WIDE_KEY_CHUNK
    chunks = -(-t // kc)
    s_all = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    vh = v.float().permute(0, 2, 1, 3)                                  # (B, H, T, D)
    parts = []
    for sp in range(n):
        m = torch.full(s_all.shape[:-1] + (1,), -math.inf)
        l = torch.zeros_like(m)
        o = torch.zeros(s_all.shape[:-1] + (d,))
        for ch in range(chunks * sp // n, chunks * (sp + 1) // n):
            s = s_all[..., ch * kc:(ch + 1) * kc]     # keys past T: absent, as at -inf
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp2((m - m_new) * c)                          # 0 on the first chunk
            p = torch.exp2(s * c - m_new * c)
            l = l * corr + p.sum(-1, keepdim=True)
            if p_bf16:
                p = p.bfloat16().float()
            o = o * corr + p @ vh[:, :, ch * kc:(ch + 1) * kc]
            m = m_new
        parts.append((m, l, o))
    mmax = torch.stack([m for m, _, _ in parts]).amax(0)
    weights = [torch.exp2((m - mmax) * c) for m, _, _ in parts]
    lsum = sum(w * l for w, (_, l, _) in zip(weights, parts))
    out = sum((w / lsum) * o for w, (_, _, o) in zip(weights, parts))
    return out.permute(0, 2, 1, 3)
