"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR [--profile]]

Phases, in order; any failure raises and the script exits non-zero:
  1. device: a CUDA device must be present; prints its nvidia-smi name and
     power limit;
  2. build: compiles the kernels from `diffmusic_tpu_torch/kernels/csrc` with
     nvcc (sm_90a), one process per source, and prints the seconds taken;
  3. kernels: each kernel's wrapper against its plain PyTorch version, on the
     card, at every shape the 10-s MusicLDM and AudioLDM2 slices give it
     (bf16; the guided step's route kernels at the geometries of its UNet,
     VAE decoder and vocoder; the vocoder's canvas conv, forward and adjoint,
     at every resblock conv of stages 0-2, the canvas pair at every pair,
     the stage backward at stage 2, the bounded-softmax block in both
     modes), plus small fp32 cases with TF32 off; the fused mel spectrogram
     in fp32 at the eval's MFCC geometry, the default geometry, an odd
     length, a batch shape and power 1; forward and, where the
     kernel has a backward, the input gradient; canvas outputs exactly zero
     outside the signal; median times of the kernel, its plain version and
     the one PyTorch call that computes the same function where there is
     one, from CUDA events, beside the bound the shapes give (bytes over
     device memory rate, operations over peak rate);
  4. reference: small fp32 MusicLDM and AudioLDM2 models (the latter from a
     text prompt, under classifier-free guidance, on both UNet routes), a
     small fp32 MusicLDM with the guided step's routes on (`gn_mode`
     "stats", then "fused"; conv2d and mask kernels) and under each newer
     route (the vocoder's canvas "xbwd" and "kernel", its stage route, the
     bounded softmax), through the whole DPS pipeline on the card (kernels)
     and on the CPU (plain versions), which must agree;
  5. slice: full-width MusicLDM with seeded random bf16 weights, 20 DPS
     steps inpainting a 10-s clip (box mask at 4-6 s) through
     `MusicLDMPipeline.__call__`, with the launch counts of every kernel, on
     the default route and on each route setting (TURN_ROUTES), each once
     in each direction of TURNS (one card, one host: the turns keep the
     host's drift out of the comparison);
  6. breakdown: each stage of one guided step timed alone at the slice's
     shapes, for the default route and each route setting (the vocoder
     alone for its routes, the UNet alone for bsoft); with --profile also a
     torch.profiler table of two guided steps and the device busy share,
     written to --out;
  7. audioldm2: full-width AudioLDM2 (cvssp/audioldm2-music widths) with
     seeded random bf16 weights, the empty prompt through the whole text
     stack (CLAP, T5, projection, GPT-2), the same 20 DPS steps through
     `AudioLDM2Pipeline.__call__`, once on each UNet route: `fuse_cross` off
     (flash attention, the JAX default), on (the dual-cross block), and on
     with the bounded softmax; then its per-stage breakdown;
  8. eval: in a temporary directory, EVAL_PAIRS pairs of 10-s clips (pair 0
     the slice's ground truth and the audio its default turn restored; two
     pairs as 44.1-kHz stereo) and a seeded random torchvggish-layout
     `vggish.pth`, scored by `diffmusic_tpu_torch.eval.main` on the card with
     --embedding mfcc-stack vggish --fad_inf --individual from cold caches:
     finite scores, one CSV row per pair, the mel kernel's launches, the
     wall seconds and their split, peak memory; then 4 of the pairs on the
     card and on the CPU, whose scores and cached embeddings must agree.
Then the card's nvidia-smi name and power limit, a JSON line with one entry
per kernel, and last {"ok": true, "device": {...}}. No JAX is imported.
"""

import argparse
import contextlib
import csv
import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# bf16 tolerances, as a fraction of max |plain|: one bf16 rounding of an
# intermediate (h, q, attention output) moves a product by ~2^-8 relative
TOL_CONV_BF16 = 2e-2
TOL_FLASH_BF16 = 2e-2
TOL_BLOCK_BF16 = 3e-2
# the route kernels round their output once where the plain versions may
# round twice (the SiLU's input, the mask before the residual add)
TOL_ROUTE_BF16 = 2e-2
# fp32: the kernels accumulate in another order than cuDNN/cuBLAS
TOL_FP32 = 1e-4

# The H100 SXM's published peaks (NVIDIA data sheet, dense, at 700 W), from
# which each kernel's bound is computed.
BF16_FLOPS = 989e12   # tensor cores, bf16
FP32_FLOPS = 67e12    # fp32 outside the tensor cores
HBM_BYTES = 3.35e12   # device memory, bytes per second

SLOPE = 0.1
STEPS = 20   # DPS steps of the slice
REPLACES = {
    "fused_transformer_block": "diffmusic_tpu/pallas/transformer_kernel.py:291",
    "conv1d_fused_pair": "diffmusic_tpu/pallas/conv1d_kernel.py:661",
    "conv1d_fused": "diffmusic_tpu/pallas/conv1d_kernel.py:183",
    "phase_convtranspose": "diffmusic_tpu/pallas/upsampler_kernel.py:231",
    "flash_attention": "diffmusic_tpu/pallas/attention_kernel.py:74",
    # the dual-cross mode of the same function
    "fused_transformer_block_cross": "diffmusic_tpu/pallas/transformer_kernel.py:291",
    "fused_group_norm": "diffmusic_tpu/pallas/groupnorm_kernel.py:123",
    "channel_moments": "diffmusic_tpu/pallas/groupnorm_kernel.py:258",
    "conv2d_same": "diffmusic_tpu/pallas/conv2d_kernel.py:168",
    "leaky_mask": "diffmusic_tpu/pallas/mask_kernel.py:80",
    "leaky_mask_add": "diffmusic_tpu/pallas/mask_kernel.py:89",
    # the bounded-softmax mode of the block (DIFFMUSIC_TPU_BSOFT, :319-323)
    "fused_transformer_block_bsoft": "diffmusic_tpu/pallas/transformer_kernel.py:291",
    "conv1d_fused_canvas": "diffmusic_tpu/pallas/conv1d_kernel.py:469",
    "conv1d_pair_canvas": "diffmusic_tpu/pallas/conv1d_kernel.py:870",
    "stage_resblocks_canvas": "diffmusic_tpu/pallas/stage_bwd_kernel.py:261",
    "fused_mel_spectrogram": "diffmusic_tpu/pallas/mel_kernel.py:152",
}
SOURCES = {
    "fused_transformer_block": "diffmusic_tpu_torch/kernels/csrc/transformer_block.cu",
    "conv1d_fused_pair": "diffmusic_tpu_torch/kernels/csrc/conv1d.cu",
    "conv1d_fused": "diffmusic_tpu_torch/kernels/csrc/conv1d.cu",
    "phase_convtranspose": "diffmusic_tpu_torch/kernels/csrc/upsampler.cu",
    "flash_attention": "diffmusic_tpu_torch/kernels/csrc/flash_attention.cu",
    "fused_transformer_block_cross": "diffmusic_tpu_torch/kernels/csrc/transformer_block.cu",
    "fused_group_norm": "diffmusic_tpu_torch/kernels/csrc/group_norm.cu",
    "channel_moments": "diffmusic_tpu_torch/kernels/csrc/group_norm.cu",
    "conv2d_same": "diffmusic_tpu_torch/kernels/csrc/conv2d.cu",
    "leaky_mask": "diffmusic_tpu_torch/kernels/csrc/leaky_mask.cu",
    "leaky_mask_add": "diffmusic_tpu_torch/kernels/csrc/leaky_mask.cu",
    "fused_transformer_block_bsoft": "diffmusic_tpu_torch/kernels/csrc/transformer_block.cu",
    "conv1d_fused_canvas": "diffmusic_tpu_torch/kernels/csrc/conv1d.cu",
    "conv1d_pair_canvas": "diffmusic_tpu_torch/kernels/csrc/conv1d.cu",
    "stage_resblocks_canvas": "diffmusic_tpu_torch/kernels/csrc/stage_bwd.cu",
    "fused_mel_spectrogram": "diffmusic_tpu_torch/kernels/csrc/mel.cu",
}
# launches per guided step of the 10-s slices (UNet levels 0/1: 2 down + 3 up
# blocks each; vocoder: 24 pairs, the 6 ch512 k=11 convs, upsamplers 0-2).
# MusicLDM's blocks are self-attention only; AudioLDM2's are dual-cross, and
# take flash attention or, with fuse_cross, the dual-cross block.
# The vocoder's routes, by the names of the slice's turns, and their launches
# per vocoder forward and per backward (stages 0-2 on the canvas: "xbwd" runs
# the 24 pairs and the 6 ch512 k=11 convs there with plain backwards,
# "kernel" all 54 convs both ways, "stage" stage 2's 9 pairs inside the stage
# route and its backward as one launch).
# (tests/test_torch_port_canvas.py derives these from the models on the CPU.)
VOCODER_ROUTES = {"default": {}, "xbwd": {"canvas": "xbwd"}, "kernel": {"canvas": "kernel"},
                  "stage": {"canvas": "xbwd", "stage_bwd": True}}
VOCODER_LAUNCHES = {
    "default": ({"conv1d_fused_pair": 24, "conv1d_fused": 6, "phase_convtranspose": 3}, {}),
    "xbwd": ({"conv1d_pair_canvas": 24, "conv1d_fused_canvas": 6, "phase_convtranspose": 3}, {}),
    "kernel": ({"conv1d_fused_canvas": 54, "phase_convtranspose": 3},
               {"conv1d_fused_canvas": 54}),
    "stage": ({"conv1d_pair_canvas": 24, "conv1d_fused_canvas": 6, "phase_convtranspose": 3},
              {"stage_resblocks_canvas": 1}),
}
VOCODER_PER_STEP = VOCODER_LAUNCHES["default"][0]
# The guided step's routes (`gn_mode`, `conv2d_kernel`, `mask_kernel`):
# launches per forward of the full-width UNet and VAE decoder at latents
# (1, 8, 250, 16), for each `gn_mode`. Of the UNet's 61 GroupNorms, the two
# of 1280 channels (up_0) miss the moments rule (C <= 1024) and the one of
# 384 channels at (250, 16) misses the fused rule (H*W*C <= 2**20); of its 3x3
# convs, the 22 at levels 0-1 meet the conv2d rule. All 24 VAE GroupNorms
# meet the moments rule and none the fused one; 24 of its 26 3x3 convs
# (not conv_in, conv_out) meet the conv2d rule.
# (tests/test_torch_port_routes.py derives these from the models on the CPU.)
ROUTE_LAUNCHES = {
    "unet": {"stats": {"channel_moments": 59, "conv2d_same": 22},
             "fused": {"fused_group_norm": 60, "conv2d_same": 22}},
    "vae": {"stats": {"channel_moments": 24, "conv2d_same": 24},
            "fused": {"fused_group_norm": 0, "conv2d_same": 24}},
}
# mask launches per guided step (the vocoder backward): stages 0-2 meet
# mask_ok; each of the 24 pairs masks dh and dx, each of the 6 single convs x
MASKS_PER_STEP = {"leaky_mask": 30, "leaky_mask_add": 24}
ROUTE_KERNELS = ("fused_group_norm", "channel_moments", "conv2d_same", "leaky_mask",
                 "leaky_mask_add")
LATENTS = (1, 8, 250, 16)   # the 10-s slice's latents
# The eval phase: EVAL_PAIRS pairs of 10-s clips through the port's eval
# with --embedding mfcc-stack vggish --fad_inf --individual.
EVAL_PAIRS = 64


def eval_mel_launches(n_pairs: int) -> int:
    """fused_mel_spectrogram launches of one such eval from cold caches, with
    mfcc-stack first: the mfcc-stack FAD caches embed each gt and recon clip
    once (2 n), KL re-embeds each with the first model (2 n); --fad_inf and
    --individual read the caches, and VGGish computes its own numpy log-mel.
    (tests/test_torch_port_eval.py counts them on the CPU.)"""
    return 4 * n_pairs


LOG_FILE = None   # with --out, every line also goes to OUT_DIR/chip_smoke.log


def log(msg: str) -> None:
    print(msg, flush=True)
    if LOG_FILE is not None:
        with open(LOG_FILE, "a") as f:
            f.write(msg + "\n")


def time_ms(fn, reps: int = 5, inner: int = 10, warmup: int = 2) -> float:
    """Median milliseconds per call of fn() on the current stream: CUDA events
    around `inner` back-to-back calls, so that the card's queue stays fed and
    the host's dispatch hides behind the kernels wherever it is the shorter."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def randn(shape, gen, device, dtype, scale=1.0, shift=0.0):
    return (torch.randn(shape, generator=gen) * scale + shift).to(device=device, dtype=dtype)


def rel_err(out, ref) -> tuple:
    err = (out.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def grad_err(out, ref) -> tuple:
    """(max abs, max abs / max |ref|, ||out - ref|| / ||ref||). Gradients are
    held by the norm: a leaky-ReLU mask flips where an activation rounds
    across zero differently in the two versions, which moves single elements
    by up to (1 - slope) of their cotangent."""
    a, r = rel_err(out, ref)
    d = (out.float() - ref.float()).norm() / max(ref.float().norm().item(), 1e-30)
    return a, r, d.item()


def compare_with_grad(kern, plain, x, g):
    """Forward and input-gradient errors of kern against plain on x."""
    res = {}
    for label, fn in (("kernel", kern), ("plain", plain)):
        xx = x.clone().requires_grad_(True)
        y = fn(xx)
        (dx,) = torch.autograd.grad(y, xx, g)
        res[label] = (y.detach(), dx)
    torch.cuda.synchronize()
    return (rel_err(res["kernel"][0], res["plain"][0]),
            grad_err(res["kernel"][1], res["plain"][1]))


def timings(kern, plain, x, dtype, library=None):
    """Forward ms of the kernel, its plain version and, if given, the one
    library call (bf16 slice shapes only)."""
    if dtype != torch.bfloat16:
        return float("nan"), float("nan"), None
    with torch.no_grad():
        return (time_ms(lambda: kern(x)), time_ms(lambda: plain(x)),
                None if library is None else time_ms(lambda: library(x)))


def bound(nbytes: float, ops: float, peak: float = BF16_FLOPS) -> tuple:
    """(bytes ms, operations ms): the least times the card needs to move
    `nbytes` through device memory and to do `ops` operations at `peak`; the
    kernel's bound is the larger."""
    return 1e3 * nbytes / HBM_BYTES, 1e3 * ops / peak


def result(err, times, bnd) -> dict:
    ms, plain_ms, library_ms = times
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound": bnd}


def describe(fwd, bwd, tol) -> str:
    return (f"fwd max|err| {fwd[0]:.3e} rel {fwd[1]:.2e}; grad max|err| {bwd[0]:.3e} "
            f"rel {bwd[1]:.2e} norm-rel {bwd[2]:.2e} (tol {tol:.0e})")


def describe_times(r) -> str:
    lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.3f}"
    by = "operations" if r["bound"][1] > r["bound"][0] else "bytes"
    return (f"{r['ms']:.3f} ms vs plain {r['plain_ms']:.3f}{lib}; bound "
            f"{max(r['bound']):.4g} ms ({by})")


# ----------------------------------------------------------------- kernels
def conv_cases(dtype):
    """(name, x shape, k, dilation, residual) for every resblock conv call of
    the 10-s slice."""
    from diffmusic_tpu_torch.kernels.conv1d import pair_ok
    cases = []
    stages = [(5001, 512), (20004, 256), (40008, 128)]
    for t, c in stages:
        for k in (3, 7, 11):
            for d in (1, 3, 5):
                if pair_ok(k, c, c, dtype):
                    cases.append(("conv1d_fused_pair", (1, t, c), k, d, False))
                else:
                    cases.append(("conv1d_fused", (1, t, c), k, d, False))
                    cases.append(("conv1d_fused", (1, t, c), k, 1, True))
    return cases


def check_conv(name, shape, k, d, residual, dtype, gen, tol):
    from diffmusic_tpu_torch.kernels import conv1d as K
    dev = "cuda"
    c = shape[-1]
    x = randn(shape, gen, dev, dtype)
    w1 = randn((k, c, c), gen, dev, dtype, 1.0 / math.sqrt(k * c))
    b1 = randn((c,), gen, dev, dtype, 0.1)
    w2 = randn((k, c, c), gen, dev, dtype, 1.0 / math.sqrt(k * c))
    b2 = randn((c,), gen, dev, dtype, 0.1)
    r = randn(shape, gen, dev, dtype) if residual else None
    g = randn(shape, gen, dev, dtype)
    size, rows = x.element_size(), shape[0] * shape[1]
    if name == "conv1d_fused_pair":
        kern = lambda xx: K.conv1d_fused_pair(xx, w1, b1, w2, b2, d, SLOPE)
        plain = lambda xx: K.pair_plain(xx, w1, b1, w2, b2, d, SLOPE)[0]
        # x in; y and the saved h out; both kernels
        bnd = bound(size * (3 * rows * c + 2 * k * c * c + 2 * c), 4 * rows * k * c * c)
    else:
        kern = lambda xx: K.conv1d_fused(xx, w1, b1, r, d, SLOPE)
        plain = lambda xx: K.conv1d_plain(xx, w1, b1, d, SLOPE, r)
        bnd = bound(size * ((3 if residual else 2) * rows * c + k * c * c + c),
                    2 * rows * k * c * c)
    fwd, bwd = compare_with_grad(kern, plain, x, g)
    if name == "conv1d_fused_pair":   # the h the kernel saves for the backward
        with torch.no_grad():
            h_err = rel_err(K._launch_pair(x, w1, b1, w2, b2, d, SLOPE)[1],
                            K.pair_plain(x, w1, b1, w2, b2, d, SLOPE)[1])
        fwd = max(fwd, h_err, key=lambda e: e[1])
    res = result(fwd[0], timings(kern, plain, x, dtype), bnd)
    log(f"  {name:24s} x{shape} k{k} d{d}{' +res' if residual else ''} {str(dtype)[6:]}: "
        f"{describe(fwd, bwd, tol)}; {describe_times(res)}")
    if fwd[1] > tol or bwd[2] > tol:
        raise AssertionError(f"{name} disagrees with its plain version")
    return res


def check_upsampler(cin, cout, k, s, t_in, dtype, gen, tol):
    """The upsampler with its leaky ReLU against the plain version (forward,
    gradient); times of the kernel alone (the wrapper applies the leaky ReLU
    outside it), on the leaky input, beside F.conv_transpose1d."""
    from diffmusic_tpu_torch.kernels import upsampler as U
    dev = "cuda"
    x = randn((1, t_in, cin), gen, dev, dtype)
    w = randn((k, cin, cout), gen, dev, dtype, 1.0 / math.sqrt(k * cout))
    b = randn((cout,), gen, dev, dtype, 0.1)
    t_out = U.output_length(t_in, s, k)
    g = randn((1, t_out, cout), gen, dev, dtype)
    kern = lambda xx: U.phase_convtranspose(xx, w, b, s, k, t_out, SLOPE)
    plain = lambda xx: U.convtranspose_plain(F.leaky_relu(xx, SLOPE), w, b, s, k)
    fwd, bwd = compare_with_grad(kern, plain, x, g)
    library = lambda xx: F.conv_transpose1d(xx.transpose(1, 2), w.permute(1, 2, 0), b,
                                            stride=s, padding=(k - s) // 2)
    times = timings(lambda xx: U.phase_convtranspose(xx, w, b, s, k, t_out),
                    lambda xx: U.convtranspose_plain(xx, w, b, s, k),
                    F.leaky_relu(x, SLOPE), dtype, library)
    size = x.element_size()
    res = result(fwd[0], times, bound(size * (t_in * cin + t_out * cout + k * cin * cout + cout),
                                      2 * t_in * k * cin * cout))
    log(f"  phase_convtranspose      {t_in}->{t_out} {cin}->{cout} k{k} s{s} "
        f"{str(dtype)[6:]}: {describe(fwd, bwd, tol)}; {describe_times(res)}")
    if fwd[1] > tol or bwd[2] > tol:
        raise AssertionError("phase_convtranspose disagrees with its plain version")
    return res


def check_block(t, c, dtype, gen, tol, cross=False, bsoft=False, amp=1.0):
    """The fused block at (1, t, c), 8-dim heads; with `cross`, in the
    dual-cross mode with AudioLDM2's two streams: 8 GPT-2 states of 768,
    unmasked, and 12 T5 tokens of 1024 whose last 7 are masked; with `bsoft`,
    in the bounded-softmax mode, against the plain version in that mode.
    `amp` scales x and the LayerNorm scale (so the logits grow by amp^2 and
    the bound grows slack)."""
    from diffmusic_tpu_torch.kernels import transformer_block as TB
    dev = "cuda"
    heads = c // 8
    x = randn((1, t, c), gen, dev, dtype, amp)
    sc = 1.0 / math.sqrt(c)
    p = dict(ln1_scale=amp * (1 + randn((c,), gen, dev, dtype, 0.1)),
             ln1_bias=randn((c,), gen, dev, dtype, 0.1),
             wq=randn((c, c), gen, dev, dtype, sc), wk=randn((c, c), gen, dev, dtype, sc),
             wv=randn((c, c), gen, dev, dtype, sc), wo=randn((c, c), gen, dev, dtype, sc),
             bo=randn((c,), gen, dev, dtype, 0.1),
             ln3_scale=1 + randn((c,), gen, dev, dtype, 0.1),
             ln3_bias=randn((c,), gen, dev, dtype, 0.1),
             wi=randn((c, 8 * c), gen, dev, dtype, sc), bi=randn((8 * c,), gen, dev, dtype, 0.1),
             wo2=randn((4 * c, c), gen, dev, dtype, 1.0 / math.sqrt(4 * c)),
             bo2=randn((c,), gen, dev, dtype, 0.1))
    # projections and GEGLU FF (32 T C^2) and attention (4 T^2 C); x in, out,
    # the 16 C^2 weights
    ops, nbytes = 32 * t * c * c + 4 * t * t * c, 2 * (2 * t * c + 16 * c * c)
    contexts, biases = (), ()
    if cross:
        for i, cd in enumerate((768, 1024)):
            p.update({f"ln2{i}_scale": 1 + randn((c,), gen, dev, dtype, 0.1),
                      f"ln2{i}_bias": randn((c,), gen, dev, dtype, 0.1),
                      f"cwq{i}": randn((c, c), gen, dev, dtype, sc),
                      f"cwk{i}": randn((cd, c), gen, dev, dtype, 1.0 / math.sqrt(cd)),
                      f"cwv{i}": randn((cd, c), gen, dev, dtype, 1.0 / math.sqrt(cd)),
                      f"cwo{i}": randn((c, c), gen, dev, dtype, sc),
                      f"cbo{i}": randn((c,), gen, dev, dtype, 0.1)})
        contexts = (randn((1, 8, 768), gen, dev, dtype), randn((1, 12, 1024), gen, dev, dtype))
        mask = torch.arange(12, device=dev) < 5
        biases = (torch.zeros(1, 1, 8, device=dev),
                  torch.where(mask, 0.0, -1e9)[None, None])
        for tk, cd in ((8, 768), (12, 1024)):   # q, o; k, v of the context; attention
            ops += 4 * t * c * c + 4 * tk * cd * c + 4 * t * tk * c
            nbytes += 2 * (2 * c * c + 2 * cd * c + tk * cd) + 4 * tk
    kern = lambda: TB.fused_transformer_block(x, p, heads, 8, contexts, biases, bsoft)
    plain = lambda: TB.transformer_block_plain(x, p, heads, 8, contexts, biases, bsoft)
    with torch.no_grad():
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        err = rel_err(out, ref)
    if not torch.isfinite(out).all():
        raise AssertionError("the fused block gave non-finite values")
    res = result(err[0], timings(lambda _: kern(), lambda _: plain(), None, dtype),
                 bound(nbytes, ops))
    name = ("fused_transformer_block_bsoft" if bsoft else
            "fused_transformer_block_cross" if cross else "fused_transformer_block")
    mode = " +cross" if bsoft and cross else ""
    log(f"  {name:24s} (1, {t}, {c}) heads {heads}{mode} amp {amp:g} {str(dtype)[6:]}: "
        f"max|err| {err[0]:.3e} rel {err[1]:.2e} (tol {tol:.0e}); {describe_times(res)}")
    if err[1] > tol:
        raise AssertionError(f"{name} disagrees with its plain version")
    return res


def check_flash(t, heads, dtype, gen, tol):
    """Flash attention over (1, t, heads, 8) q, k, v of unit variance, beside
    F.scaled_dot_product_attention on the same tensors (as (B, H, T, 8) views)."""
    from diffmusic_tpu_torch.kernels import attention as A
    q, k, v = (randn((1, t, heads, 8), gen, "cuda", dtype) for _ in range(3))
    with torch.no_grad():
        out, ref = A.flash_attention(q, k, v), A.attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = rel_err(out, ref)
    sdpa = lambda _: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                    v.transpose(1, 2))
    times = timings(lambda _: A.flash_attention(q, k, v), lambda _: A.attention_plain(q, k, v),
                    None, dtype, sdpa)
    res = result(err[0], times, bound(2 * 4 * t * heads * 8, 4 * t * t * heads * 8))
    log(f"  flash_attention          (1, {t}, {heads}, 8) {str(dtype)[6:]}: "
        f"max|err| {err[0]:.3e} rel {err[1]:.2e} (tol {tol:.0e}); {describe_times(res)}")
    if err[1] > tol:
        raise AssertionError("flash_attention disagrees with its plain version")
    return res


# ------------------------------------------------------ the guided step's routes
@contextlib.contextmanager
def blocks_pass_through():
    """The long transformer blocks return x unchanged (their kernel runs on
    the card only), for shape-only forwards on the meta device."""
    from diffmusic_tpu_torch.models import layers
    fn = layers.fused_transformer_block
    layers.fused_transformer_block = lambda x, *a, **k: x
    try:
        yield
    finally:
        layers.fused_transformer_block = fn


def slice_geometries() -> dict:
    """Per model ("unet", "vae"): the (shape, eps, use_silu) of every
    GroupNorm input and the (x shape, weight shape) of every 3x3 'same' conv
    of one full-width forward at the slice's latents, from a forward on the
    meta device (shapes only: nothing is allocated or computed)."""
    from diffmusic_tpu_torch.models import layers
    from diffmusic_tpu_torch.models.configs import UNetConfig, VAEConfig
    from diffmusic_tpu_torch.models.unet import UNet2DConditionModel
    from diffmusic_tpu_torch.models.vae import AutoencoderKL
    with torch.device("meta"):
        models = {"unet": UNet2DConditionModel(UNetConfig()), "vae": AutoencoderKL(VAEConfig())}
    seen = {name: {"gn": [], "conv": []} for name in models}
    for name, model in models.items():
        for m in model.modules():
            if isinstance(m, layers.GroupNorm):
                m.register_forward_pre_hook(lambda mod, a, _s=seen[name]: _s["gn"].append(
                    (tuple(a[0].shape), mod.eps, mod.use_silu)))
            elif isinstance(m, layers.Conv2dSame):
                m.register_forward_pre_hook(lambda mod, a, _s=seen[name]: _s["conv"].append(
                    (tuple(a[0].shape), tuple(mod.weight.shape))))
    lat = torch.empty(LATENTS, device="meta")
    with torch.no_grad(), blocks_pass_through():
        models["unet"](lat, torch.empty(1, device="meta"),
                       class_labels=torch.empty(1, 512, device="meta"))
        models["vae"].decode(lat)
    return seen


def mask_geometries() -> list:
    """((1, T, C), leaky_mask launches, leaky_mask_add launches) per guided
    step for each vocoder stage of the 10-s slice: where `mask_ok` holds,
    each pair masks dh and dx and each single conv its input; elsewhere 0."""
    from diffmusic_tpu_torch.kernels.conv1d import pair_ok
    from diffmusic_tpu_torch.kernels.mask import mask_ok
    from diffmusic_tpu_torch.kernels.upsampler import output_length
    from diffmusic_tpu_torch.models.configs import HiFiGANConfig
    cfg = HiFiGANConfig()
    t, out = LATENTS[2] * 4, []    # mel frames
    for i, (rate, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        t, ch = output_length(t, rate, k), cfg.upsample_initial_channel // 2 ** (i + 1)
        n_mask = n_add = 0
        if mask_ok(torch.empty(1, t, ch, device="meta")):
            for rk, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                pair = pair_ok(rk, ch, ch, torch.bfloat16)
                n_mask += len(dils) * (1 if pair else 2)
                n_add += len(dils) * pair
        out.append(((1, t, ch), n_mask, n_add))
    return out


def route_calls() -> dict:
    """Per route kernel: Counter of its calls per guided step at the slice
    (UNet forward + VAE decode + vocoder backward), keyed by geometry."""
    from diffmusic_tpu_torch.kernels.conv2d import conv2d_ok
    from diffmusic_tpu_torch.kernels.group_norm import fused_gn_ok, moments_ok
    calls = {n: Counter() for n in ROUTE_KERNELS}
    for name, seen in slice_geometries().items():
        for shape, eps, silu in seen["gn"]:
            x = torch.empty(shape, device="meta")
            if fused_gn_ok(x):
                calls["fused_group_norm"][(shape, eps, silu)] += 1
            if moments_ok(x.reshape(shape[0], shape[1], -1)):
                calls["channel_moments"][(shape, eps, silu)] += 1
        for xs, ws in seen["conv"]:
            if conv2d_ok(torch.empty(xs, device="meta"), torch.empty(ws, device="meta")):
                calls["conv2d_same"][(xs, ws)] += 1
    for shape, n_mask, n_add in mask_geometries():
        if n_mask:
            calls["leaky_mask"][shape] += n_mask
        if n_add:
            calls["leaky_mask_add"][shape] += n_add
    return calls


def check_group_norm(name, shape, eps, silu, dtype, gen, tol):
    """fused_group_norm (with its recompute backward) or channel_moments
    (with its VJP; and the whole stats GroupNorm around it) on an NCHW x of
    `shape`, groups 32, against the plain versions; times beside
    F.group_norm (which has no SiLU) for the fused kernel, none for the
    moments."""
    from diffmusic_tpu_torch.kernels import group_norm as GN
    dev = "cuda"
    b, c, h, w = shape
    n, size = b * c * h * w, torch.empty((), dtype=dtype).element_size()
    x = randn(shape, gen, dev, dtype, 2.0, 0.3)
    wt = randn((c,), gen, dev, dtype, 0.2, 1.0)
    bt = randn((c,), gen, dev, dtype, 0.1)
    if name == "fused_group_norm":
        kern = lambda xx: GN.fused_group_norm(xx, wt, bt, 32, eps, silu)
        plain = lambda xx: GN.group_norm_plain(xx, wt, bt, 32, eps, silu)
        library = lambda xx: F.group_norm(xx, 32, wt, bt, eps)
        g = randn(shape, gen, dev, dtype)
        bnd = bound(size * (2 * n + 2 * c), (10 + 4 * silu) * n, FP32_FLOPS)
    else:
        kern = lambda xx: GN.channel_moments(xx.reshape(b, c, h * w))
        plain = lambda xx: GN.moments_plain(xx.reshape(b, c, h * w))
        library = None
        g = randn((b, 2, c), gen, dev, torch.float32)
        bnd = bound(size * n + 4 * 2 * b * c, 3 * n, FP32_FLOPS)
    fwd, bwd = compare_with_grad(kern, plain, x, g)
    if name == "channel_moments":
        with torch.no_grad():
            whole = rel_err(GN.stats_group_norm(x, wt, bt, 32, eps, silu),
                            GN.group_norm_plain(x, wt, bt, 32, eps, silu))
        fwd = max(fwd, whole, key=lambda e: e[1])
    res = result(fwd[0], timings(kern, plain, x, dtype, library), bnd)
    log(f"  {name:24s} {shape} eps {eps:g}{' +silu' if silu else ''} {str(dtype)[6:]}: "
        f"{describe(fwd, bwd, tol)}; {describe_times(res)}")
    if fwd[1] > tol or bwd[2] > tol:
        raise AssertionError(f"{name} disagrees with its plain version")
    return res


def check_conv2d(xshape, wshape, dtype, gen, tol):
    """conv2d_same (forward kernel, plain adjoint backward) against the plain
    version, beside F.conv2d (the plain version is that one call)."""
    from diffmusic_tpu_torch.kernels import conv2d as C2
    dev = "cuda"
    b, cin, h, w = xshape
    cout, _, kh, kw = wshape
    x = randn(xshape, gen, dev, dtype)
    wt = randn(wshape, gen, dev, dtype, 1.0 / math.sqrt(kh * kw * cin))
    bias = randn((cout,), gen, dev, dtype, 0.1)
    g = randn((b, cout, h, w), gen, dev, dtype)
    kern = lambda xx: C2.conv2d_same(xx, wt, bias)
    plain = lambda xx: C2.conv2d_plain(xx, wt, bias)
    library = lambda xx: F.conv2d(xx, wt, bias, padding=(kh // 2, kw // 2))
    fwd, bwd = compare_with_grad(kern, plain, x, g)
    size, m = x.element_size(), b * h * w
    res = result(fwd[0], timings(kern, plain, x, dtype, library),
                 bound(size * (m * cin + m * cout + cout * cin * kh * kw + cout),
                       2 * m * cout * cin * kh * kw))
    log(f"  conv2d_same              x{xshape} w{wshape} {str(dtype)[6:]}: "
        f"{describe(fwd, bwd, tol)}; {describe_times(res)}")
    if fwd[1] > tol or bwd[2] > tol:
        raise AssertionError("conv2d_same disagrees with its plain version")
    return res


def check_mask(name, shape, dtype, gen, tol):
    """leaky_mask or leaky_mask_add against the plain version; times beside
    aten.leaky_relu_backward for leaky_mask (it differs only where h == 0);
    leaky_mask_add has no one-call counterpart."""
    from diffmusic_tpu_torch.kernels import mask as M
    dev = "cuda"
    h, g, r = (randn(shape, gen, dev, dtype) for _ in range(3))
    add = name == "leaky_mask_add"
    if add:
        kern = lambda hh: M.leaky_mask_add(hh, g, r, SLOPE)
        plain = lambda hh: M.leaky_mask_plain(hh, g, SLOPE, r)
        library = None
    else:
        kern = lambda hh: M.leaky_mask(hh, g, SLOPE)
        plain = lambda hh: M.leaky_mask_plain(hh, g, SLOPE)
        library = lambda hh: torch.ops.aten.leaky_relu_backward(g, hh, SLOPE, False)
    with torch.no_grad():
        out, ref = kern(h), plain(h)
        torch.cuda.synchronize()
        err = rel_err(out, ref)
    n = h.numel()
    res = result(err[0], timings(kern, plain, h, dtype, library),
                 bound(h.element_size() * (3 + add) * n, (2 + add) * n, FP32_FLOPS))
    log(f"  {name:24s} {shape} {str(dtype)[6:]}: max|err| {err[0]:.3e} rel {err[1]:.2e} "
        f"(tol {tol:.0e}); {describe_times(res)}")
    if err[1] > tol:
        raise AssertionError(f"{name} disagrees with its plain version")
    return res


# -------------------------------------------------- the vocoder's canvas routes
VOCODER_STAGES = ((5001, 512), (20004, 256), (40008, 128))   # (T, C) of stages 0-2
RESBLOCKS = ((3, 7, 11), ((1, 3, 5),) * 3)                    # kernel sizes, dilations


def assert_margins_zero(label, t, *tensors) -> None:
    """Canvas tensors must be exactly zero outside the signal [512, 512 + t)."""
    for a in tensors:
        if a[:, :512].any() or a[:, 512 + t:].any():
            raise AssertionError(f"{label}: a canvas output is not zero outside the signal")


def canvas_conv_calls() -> list:
    """(T, C, k, d, residual, launches per forward) of every resblock conv
    of stages 0-2 with `canvas="kernel"`: per branch k, conv1 at each
    dilation once, conv2 (d 1, with the residual) three times. Each
    forward launch has one adjoint launch in the backward."""
    return [(t, c, k, d, res, n) for t, c in VOCODER_STAGES for k in RESBLOCKS[0]
            for d, res, n in ((1, False, 1), (3, False, 1), (5, False, 1), (1, True, 3))]


def check_canvas_conv(t, c, k, d, residual, dtype, gen, tol) -> tuple:
    """conv1d_fused_canvas's forward and its backward's adjoint launch
    against the plain versions (`canvas_plain` of the conv and of the
    flipped transposed conv) on the canvas of a (1, t, c) signal. Returns
    the forward's and the adjoint's results."""
    from diffmusic_tpu_torch.kernels import conv1d as K
    from diffmusic_tpu_torch.kernels.canvas import canvas_rows, to_canvas
    dev, rows = "cuda", canvas_rows(t)
    xc, gc = (to_canvas(randn((1, t, c), gen, dev, dtype)) for _ in range(2))
    rc = to_canvas(randn((1, t, c), gen, dev, dtype)) if residual else None
    w = randn((k, c, c), gen, dev, dtype, 1.0 / math.sqrt(k * c))
    b = randn((c,), gen, dev, dtype, 0.1)
    w_adj = w.flip(0).transpose(1, 2)
    cases = {
        "fwd": (lambda xx: K._launch_fused(xx, w, b, rc, d, SLOPE, t),
                lambda xx: K.canvas_plain(xx, w, b, t, d, SLOPE, rc), xc),
        "adjoint": (lambda gg: K._launch_fused(gg, w, None, None, d, None, t, adjoint=True),
                    lambda gg: K.canvas_plain(gg, w_adj, None, t, d), gc)}
    size = xc.element_size()
    bnd = bound(size * ((3 if residual else 2) * rows * c + k * c * c + c), 2 * t * k * c * c)
    out = {}
    for label, (kern, plain, inp) in cases.items():
        with torch.no_grad():
            y, ref = kern(inp), plain(inp)
            torch.cuda.synchronize()
            err = rel_err(y, ref)
        assert_margins_zero(f"conv1d_fused_canvas {label}", t, y)
        out[label] = result(err[0], timings(kern, plain, inp, dtype), bnd)
        log(f"  conv1d_fused_canvas {label:7s} (1, {t}, {c}) k{k} d{d}"
            f"{' +res' if residual and label == 'fwd' else ''} {str(dtype)[6:]}: max|err| "
            f"{err[0]:.3e} rel {err[1]:.2e} (tol {tol:.0e}), margins 0; "
            f"{describe_times(out[label])}")
        if err[1] > tol:
            raise AssertionError("conv1d_fused_canvas disagrees with its plain version")
    return out["fwd"], out["adjoint"]


def check_pair_canvas(t, c, k, d, dtype, gen, tol):
    """conv1d_pair_canvas (y, the saved h, the input gradient through its
    plain backward) against the plain version on the canvas."""
    from diffmusic_tpu_torch.kernels import conv1d as K
    from diffmusic_tpu_torch.kernels.canvas import canvas_rows, to_canvas
    dev, rows = "cuda", canvas_rows(t)
    xc, gc = (to_canvas(randn((1, t, c), gen, dev, dtype)) for _ in range(2))
    w1, w2 = (randn((k, c, c), gen, dev, dtype, 1.0 / math.sqrt(k * c)) for _ in range(2))
    b1, b2 = (randn((c,), gen, dev, dtype, 0.1) for _ in range(2))
    kern = lambda xx: K.conv1d_pair_canvas(xx, w1, b1, w2, b2, t, d, SLOPE)
    plain = lambda xx: K.pair_canvas_plain(xx, w1, b1, w2, b2, t, d, SLOPE)[0]
    fwd, bwd = compare_with_grad(kern, plain, xc, gc)
    with torch.no_grad():
        y, h = K.pair_canvas_forward(xc, w1, b1, w2, b2, t, d, SLOPE)
        h_err = rel_err(h, K.pair_canvas_plain(xc, w1, b1, w2, b2, t, d, SLOPE)[1])
    xx = xc.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(kern(xx), xx, gc)
    assert_margins_zero("conv1d_pair_canvas", t, y, h, dx)
    fwd = max(fwd, h_err, key=lambda e: e[1])
    size = xc.element_size()
    res = result(fwd[0], timings(kern, plain, xc, dtype),
                 bound(size * (3 * rows * c + 2 * k * c * c + 2 * c), 4 * t * k * c * c))
    log(f"  conv1d_pair_canvas       (1, {t}, {c}) k{k} d{d} {str(dtype)[6:]}: "
        f"{describe(fwd, bwd, tol)}, margins 0; {describe_times(res)}")
    if fwd[1] > tol or bwd[2] > tol:
        raise AssertionError("conv1d_pair_canvas disagrees with its plain version")
    return res


def check_stage(t, dtype, gen, tol):
    """The stage route on the canvas of a (1, t, 128) signal, KS (3, 7, 11),
    dilations (1, 3, 5) x 3: its forward (9 pair launches) against the plain
    stage, its one-launch backward against `stage_bwd_plain` on the same
    saved tensors (held by norm); times of the backward."""
    from diffmusic_tpu_torch.kernels import stage_bwd as S
    from diffmusic_tpu_torch.kernels.canvas import canvas_rows, from_canvas, to_canvas
    dev, c, rows = "cuda", 128, canvas_rows(t)
    ks, dils = RESBLOCKS
    params = [(randn((k, c, c), gen, dev, dtype, 0.05), randn((c,), gen, dev, dtype, 0.1),
               randn((k, c, c), gen, dev, dtype, 0.05), randn((c,), gen, dev, dtype, 0.1))
              for k, ds in zip(ks, dils) for _ in ds]
    xc, gc = (to_canvas(randn((1, t, c), gen, dev, dtype)) for _ in range(2))
    w1s, w2s = [p[0] for p in params], [p[2] for p in params]
    with torch.no_grad():
        y, xs, hs = S.stage_forward(xc, params, t, ks, dils, SLOPE)
        fwd = rel_err(from_canvas(y, t), S.stage_plain(from_canvas(xc, t), params, ks, dils,
                                                       SLOPE))
        kern = lambda gg: S._launch(gg, xs, hs, w1s, w2s, t, ks, dils, SLOPE)
        plain = lambda gg: S.stage_bwd_plain(gg, xs, hs, w1s, w2s, t, ks, dils, SLOPE)
        dx, dx0 = kern(gc), plain(gc)
        torch.cuda.synchronize()
        bwd = grad_err(dx, dx0)
    assert_margins_zero("stage_resblocks_canvas", t, y, dx)
    n_taps = sum(k * len(ds) for k, ds in zip(ks, dils))
    # g, the 18 saved canvases and dx once; the 18 weights
    nbytes = gc.element_size() * ((2 + 2 * len(params)) * rows * c + 2 * n_taps * c * c)
    res = result(bwd[0], timings(kern, plain, gc, dtype), bound(nbytes, 4 * t * c * c * n_taps))
    log(f"  stage_resblocks_canvas   (1, {t}, {c}) {str(dtype)[6:]}: forward max|err| "
        f"{fwd[0]:.3e} rel {fwd[1]:.2e}; backward max|err| {bwd[0]:.3e} rel {bwd[1]:.2e} "
        f"norm-rel {bwd[2]:.2e} (tol {tol:.0e}), margins 0; backward {describe_times(res)}")
    if fwd[1] > tol or bwd[2] > tol:
        raise AssertionError("stage_resblocks_canvas disagrees with its plain version")
    return res


# ------------------------------------------------------ the eval's mel kernel
MEL_MFCC = dict(n_fft=400, hop_length=160, win_length=400, n_mels=64, sample_rate=16000,
                f_min=125.0, f_max=7500.0)    # the MFCC-stack embedder's geometry
MEL_DEFAULT = dict(n_fft=1024, hop_length=160, win_length=1024, n_mels=64,
                   sample_rate=16000, f_min=0.0, f_max=None)   # the kernel's defaults


def mel_composition(x, kw):
    """The cuFFT composition of the same function, a yardstick: torch.stft
    (centre, reflect pad, periodic Hann), |.|^2, the filterbank."""
    from diffmusic_tpu_torch.ops.mel import mel_filterbank
    n_fft, hop, win = kw["n_fft"], kw["hop_length"], kw["win_length"]
    fb = torch.as_tensor(mel_filterbank(n_fft // 2 + 1, kw["n_mels"], kw["sample_rate"],
                                        kw["f_min"], kw["f_max"]), device=x.device)
    window = torch.hann_window(win, periodic=True, device=x.device)
    xb = x.reshape(-1, x.shape[-1])
    spec = torch.stft(xb, n_fft, hop, win, window, center=True, pad_mode="reflect",
                      return_complex=True).abs().square()
    return torch.einsum("bft,fm->bmt", spec, fb).reshape(*x.shape[:-1], kw["n_mels"], -1)


def mel_bound(shape, kw) -> tuple:
    """The least work of the mel spectrogram, not this kernel's dense DFT:
    the bytes of the signal in and the mels out, and per frame the window
    (win_length products), a real FFT (the usual 2.5 n log2 n operations),
    |X|^2 (3 per frequency) and the filterbank's nonzeros (2 each), fp32."""
    from diffmusic_tpu_torch.ops.mel import mel_filterbank
    n_fft, n_mels = kw["n_fft"], kw["n_mels"]
    rows, length = math.prod(shape[:-1]), shape[-1]
    frames, freqs = rows * (1 + length // kw["hop_length"]), n_fft // 2 + 1
    fb_nonzeros = int(np.count_nonzero(mel_filterbank(freqs, n_mels, kw["sample_rate"],
                                                      kw["f_min"], kw["f_max"])))
    per_frame = kw["win_length"] + 2.5 * n_fft * math.log2(n_fft) + 3 * freqs + 2 * fb_nonzeros
    return bound(4 * (rows * length + n_mels * frames), frames * per_frame, FP32_FLOPS)


def check_mel(shape, kw, gen, power=2.0, timed=False, grad=False):
    """fused_mel_spectrogram against fused_mel_plain on the card, fp32 (TF32
    off), at tolerance TOL_FP32 of max |plain|; with `grad`, the input
    gradient of sum(mel ** 0.5) against autograd through the plain version;
    with `timed`, the kernel, the plain version and the cuFFT composition;
    the bound is `mel_bound`."""
    from diffmusic_tpu_torch.kernels import mel as M
    kw = dict(kw, power=power)
    x = randn(shape, gen, "cuda", torch.float32, 0.3)
    kern = lambda xx: M.fused_mel_spectrogram(xx, **kw)
    plain = lambda xx: M.fused_mel_plain(xx, **kw)
    with torch.no_grad():
        out, ref = kern(x), plain(x)
        torch.cuda.synchronize()
        err = rel_err(out, ref)
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"fused_mel_spectrogram: shape {tuple(out.shape)} or non-finite values")
    desc = f"max|err| {err[0]:.3e} rel {err[1]:.2e}"
    bad = err[1] > TOL_FP32
    if grad:
        dx = {}
        for label, fn in (("kernel", kern), ("plain", plain)):
            xx = x.clone().requires_grad_(True)
            (dx[label],) = torch.autograd.grad(fn(xx).pow(0.5).sum(), xx)
        torch.cuda.synchronize()
        g = grad_err(dx["kernel"], dx["plain"])
        desc += f"; grad of sum(mel ** 0.5) max|err| {g[0]:.3e} rel {g[1]:.2e}"
        bad = bad or g[1] > TOL_FP32
    n_fft, n_mels = kw["n_fft"], kw["n_mels"]
    bnd = mel_bound(shape, kw)
    times = (float("nan"), float("nan"), None)
    comp = ""
    if timed:
        with torch.no_grad():
            times = (time_ms(lambda: kern(x)), time_ms(lambda: plain(x)), None)
            comp_ms = time_ms(lambda: mel_composition(x, kw))
            comp_err = rel_err(mel_composition(x, kw), ref)
        comp = f"; cuFFT composition {comp_ms:.3f} ms (rel {comp_err[1]:.1e})"
    res = result(err[0], times, bnd)
    geometry = "mfcc" if n_fft == 400 else f"n_fft {n_fft}"
    log(f"  fused_mel_spectrogram    {shape} {geometry} hop {kw['hop_length']} mels {n_mels} "
        f"power {power:g} fp32: {desc} (tol {TOL_FP32:.0e})"
        + (f"; {describe_times(res)}{comp}" if timed else
           f"; bound {max(bnd):.4g} ms"))
    if bad:
        raise AssertionError("fused_mel_spectrogram disagrees with its plain version")
    return res


def phase_kernels(gen) -> dict:
    """Every kernel at the slice's shapes (bf16) and small fp32 cases.
    Returns per kernel: max abs error, and kernel / plain / library / bound
    ms summed over one guided step's calls."""
    from diffmusic_tpu_torch.kernels.conv1d import pair_ok
    stats = {n: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None,
                 "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0} for n in REPLACES}

    def add(name, res, per_step=1):
        s = stats[name]
        s["max_abs_err"] = max(s["max_abs_err"], res["err"])
        if math.isnan(res["ms"]):
            return
        s["ms"] += per_step * res["ms"]
        s["plain_ms"] += per_step * res["plain_ms"]
        if res["library_ms"] is not None:
            s["library_ms"] = (s["library_ms"] or 0.0) + per_step * res["library_ms"]
        bytes_ms, ops_ms = res["bound"]
        s["bound_ms"] += per_step * max(bytes_ms, ops_ms)
        s["bytes_ms"] += per_step * bytes_ms
        s["ops_ms"] += per_step * ops_ms

    bf = torch.bfloat16
    log("kernels vs plain versions, slice shapes, bf16:")
    for t, c in ((4000, 128), (1000, 256)):
        add("fused_transformer_block", check_block(t, c, bf, gen, TOL_BLOCK_BF16), 5)
        add("fused_transformer_block_cross",
            check_block(t, c, bf, gen, TOL_BLOCK_BF16, cross=True), 5)
        add("flash_attention", check_flash(t, c // 8, bf, gen, TOL_FLASH_BF16), 5)
    for name, shape, k, d, res in conv_cases(bf):
        add(name, check_conv(name, shape, k, d, res, bf, gen, TOL_CONV_BF16))
    for cin, cout, k, s, t_in in ((1024, 512, 16, 5, 1000), (512, 256, 16, 4, 5001),
                                  (256, 128, 8, 2, 20004)):
        add("phase_convtranspose", check_upsampler(cin, cout, k, s, t_in, bf, gen,
                                                   TOL_CONV_BF16))
    calls = route_calls()
    log("route kernels at the slice's geometries, bf16 (times per call; the line "
        "sums them over one guided step):")
    for name in ("fused_group_norm", "channel_moments"):
        for (shape, eps, silu), n in sorted(calls[name].items()):
            add(name, check_group_norm(name, shape, eps, silu, bf, gen, TOL_ROUTE_BF16), n)
    for (xs, ws), n in sorted(calls["conv2d_same"].items()):
        add("conv2d_same", check_conv2d(xs, ws, bf, gen, TOL_ROUTE_BF16), n)
    for name in ("leaky_mask", "leaky_mask_add"):
        for shape, n in sorted(calls[name].items()):
            add(name, check_mask(name, shape, bf, gen, TOL_ROUTE_BF16), n)

    log("the vocoder's canvas routes and the bounded softmax, bf16 (the line sums each "
        "kernel over one guided step of its route: canvas=\"kernel\", \"xbwd\", stage_bwd, "
        "bsoft):")
    for t, c, k, d, residual, n in canvas_conv_calls():
        for res in check_canvas_conv(t, c, k, d, residual, bf, gen, TOL_CONV_BF16):
            add("conv1d_fused_canvas", res, n)
    for t, c in VOCODER_STAGES:
        for k in RESBLOCKS[0]:
            if pair_ok(k, c, c, bf):
                for d in RESBLOCKS[1][0]:
                    add("conv1d_pair_canvas", check_pair_canvas(t, c, k, d, bf, gen,
                                                                TOL_CONV_BF16))
    add("stage_resblocks_canvas", check_stage(VOCODER_STAGES[2][0], bf, gen, TOL_CONV_BF16))
    for t, c in ((4000, 128), (1000, 256)):
        add("fused_transformer_block_bsoft",
            check_block(t, c, bf, gen, TOL_BLOCK_BF16, bsoft=True), 5)
        # the dual-cross bsoft mode (AudioLDM2 with fuse_cross): checked, not summed
        add("fused_transformer_block_bsoft",
            check_block(t, c, bf, gen, TOL_BLOCK_BF16, cross=True, bsoft=True), 0)
    add("fused_transformer_block_bsoft",
        check_block(4000, 128, bf, gen, TOL_BLOCK_BF16, bsoft=True, amp=5.0), 0)

    log("kernels vs plain versions, small fp32 cases (TF32 off):")
    f32 = torch.float32
    add("fused_transformer_block", check_block(600, 128, f32, gen, TOL_FP32))
    add("fused_transformer_block_cross", check_block(600, 128, f32, gen, TOL_FP32, cross=True))
    add("flash_attention", check_flash(600, 16, f32, gen, TOL_FP32))
    add("conv1d_fused_pair", check_conv("conv1d_fused_pair", (2, 300, 128), 7, 3, False,
                                        f32, gen, TOL_FP32))
    add("conv1d_fused", check_conv("conv1d_fused", (2, 300, 128), 11, 5, True, f32, gen,
                                   TOL_FP32))
    add("phase_convtranspose", check_upsampler(256, 128, 16, 5, 100, f32, gen, TOL_FP32))
    # the groups' and rows' runs of 252 and 63 elements take the scalar paths
    for name, shape, silu in (("fused_group_norm", (2, 128, 16, 16), True),
                              ("fused_group_norm", (1, 128, 9, 7), False),
                              ("channel_moments", (2, 256, 9, 7), True)):
        add(name, check_group_norm(name, shape, 1e-5, silu, f32, gen, TOL_FP32))
    for xs, ws in (((2, 128, 9, 20), (128, 128, 3, 3)), ((1, 64, 10, 12), (64, 64, 1, 3))):
        add("conv2d_same", check_conv2d(xs, ws, f32, gen, TOL_FP32))
    for name, shape in (("leaky_mask", (1, 1001, 100)), ("leaky_mask_add", (2, 999, 128))):
        add(name, check_mask(name, shape, f32, gen, TOL_FP32))
    for k, d, residual in ((11, 5, False), (3, 1, True)):
        for res in check_canvas_conv(1100, 128, k, d, residual, f32, gen, TOL_FP32):
            add("conv1d_fused_canvas", res)
    add("conv1d_pair_canvas", check_pair_canvas(1100, 128, 7, 3, f32, gen, TOL_FP32))
    add("stage_resblocks_canvas", check_stage(700, f32, gen, TOL_FP32))
    for cross, amp in ((False, 1.0), (True, 1.0), (False, 5.0)):
        add("fused_transformer_block_bsoft",
            check_block(600, 128, f32, gen, TOL_FP32, cross=cross, bsoft=True, amp=amp))

    log(f"the eval's fused mel spectrogram, fp32 (the line sums the {EVAL_PAIRS}-pair eval's "
        f"{eval_mel_launches(EVAL_PAIRS)} launches at the per-clip shape (1, 160000)):")
    add("fused_mel_spectrogram", check_mel((1, 160000), MEL_MFCC, gen, timed=True),
        eval_mel_launches(EVAL_PAIRS))
    add("fused_mel_spectrogram", check_mel((64, 160000), MEL_MFCC, gen, timed=True), 0)
    add("fused_mel_spectrogram", check_mel((1, 160000), MEL_DEFAULT, gen, timed=True,
                                           grad=True), 0)
    # every variant the wrapper takes: 64 or 128 mel columns, float4 or scalar
    # frame reads (hop a multiple of 4 or not), the power 2, 1 and powf epilogues
    for shape, kw, power in (((2, 32123), MEL_DEFAULT, 2.0), ((3, 2, 4000), MEL_DEFAULT, 2.0),
                             ((2, 32123), MEL_MFCC, 1.0),
                             ((2, 32123), dict(MEL_MFCC, hop_length=100), 2.0),
                             ((1, 16000), dict(MEL_DEFAULT, n_mels=128), 2.0),
                             ((2, 16001), dict(MEL_DEFAULT, hop_length=100, n_mels=128), 1.5)):
        add("fused_mel_spectrogram", check_mel(shape, kw, gen, power), 0)
    return stats


# -------------------------------------------------------------- pipelines
def harmonic_stack(owl: int, sr: int) -> np.ndarray:
    """bench.py's ground truth: four harmonics of 220 Hz with 2-Hz AM."""
    tt = np.arange(owl) / sr
    gt = sum(0.25 / (i + 1) * np.sin(2 * np.pi * 220 * (i + 1) * tt) for i in range(4))
    return (gt * (0.6 + 0.4 * np.sin(2 * np.pi * 2.0 * tt)))[None].astype(np.float32)


def inpainting(audio_s: float, device):
    """The slices' operator (box mask over 40-60 % of the clip) and its
    measurement of the harmonic stack."""
    from diffmusic_tpu_torch.inverse_problem import MusicInpaintingOperator
    op = MusicInpaintingOperator(audio_length_in_s=audio_s, sample_rate=16000,
                                 mask_type="box", start_inpainting_s=audio_s * 0.4,
                                 end_inpainting_s=audio_s * 0.6)
    owl = int(audio_s * 16000)
    return op, op.forward(torch.as_tensor(harmonic_stack(owl, 16000), device=device))


def build_pipe(unet_cfg, vae_cfg, voc_cfg, audio_s, device, weight_dtype, **routes):
    from diffmusic_tpu_torch.pipelines import MusicLDMPipeline
    op, measurement = inpainting(audio_s, device)
    pipe = MusicLDMPipeline.random(unet_cfg, vae_cfg, voc_cfg, seed=0, device=device,
                                   weight_dtype=weight_dtype, scheduler_name="dps",
                                   operator=op, **routes)
    return pipe, measurement


def build_audioldm2(unet_cfg, vae_cfg, voc_cfg, audio_s, device, weight_dtype, fuse_cross,
                    **text_cfgs):
    from diffmusic_tpu_torch.pipelines import AudioLDM2Pipeline
    op, measurement = inpainting(audio_s, device)
    pipe = AudioLDM2Pipeline.random(unet_cfg, vae_cfg, voc_cfg, seed=0, device=device,
                                    weight_dtype=weight_dtype, fuse_cross=fuse_cross,
                                    scheduler_name="dps", operator=op, **text_cfgs)
    return pipe, measurement


# each turn's route flags: the guided step's GroupNorm routes ("stats",
# "fused", with the conv2d and mask kernels), the vocoder's routes and the
# bounded softmax
TURN_ROUTES = {"default": {},
               "stats": dict(gn_mode="stats", conv2d_kernel=True, mask_kernel=True),
               "fused": dict(gn_mode="fused", conv2d_kernel=True, mask_kernel=True),
               **{name: r for name, r in VOCODER_ROUTES.items() if name != "default"},
               "bsoft": dict(bsoft=True)}


def with_routes(pipe, gn_mode="plain", conv2d_kernel=False, mask_kernel=False, bsoft=False,
                canvas="off", stage_bwd=False, fuse_cross=False):
    """The pipeline with its UNet, VAE and vocoder rebuilt with the given
    route flags, sharing the pipeline's weight tensors (no copy)."""
    from diffmusic_tpu_torch.models.hifigan import SpeechT5HifiGan
    from diffmusic_tpu_torch.models.unet import UNet2DConditionModel
    from diffmusic_tpu_torch.models.vae import AutoencoderKL
    routes = dict(gn_mode=gn_mode, conv2d_kernel=conv2d_kernel)
    with torch.device("meta"):
        models = dict(unet=UNet2DConditionModel(pipe.unet_cfg, fuse_cross=fuse_cross,
                                                bsoft=bsoft, **routes),
                      vae=AutoencoderKL(pipe.vae_cfg, **routes),
                      vocoder=SpeechT5HifiGan(pipe.vocoder_cfg, mask_kernel=mask_kernel,
                                              canvas=canvas, stage_bwd=stage_bwd))
    for name, model in models.items():
        model.load_state_dict(getattr(pipe, name).state_dict(), assign=True)
    return dataclasses.replace(pipe, **models)


def audioldm2_unet_config(**widths):
    """cvssp/audioldm2-music's UNet as the repo configures it
    (tools/check_audioldm2_step.py): two cross streams, no class embedding."""
    from diffmusic_tpu_torch.models.configs import UNetConfig
    kw = dict(cross_attention_dims=(768, 1024), class_embed_type=None,
              projection_class_embeddings_input_dim=None, class_embeddings_concat=False)
    kw.update(widths)
    return UNetConfig(**kw)


def expected_launches(blocks: str, gn_mode: str = "plain", vocoder: str = "default") -> dict:
    """Launches of every kernel over a slice's STEPS guided steps and its
    final decode, where `blocks` is the kernel its 10 transformer blocks per
    step take, `gn_mode` "stats" or "fused" means the guided step's routes
    are on (conv2d and mask kernels too) and `vocoder` names the vocoder's
    route. Every other kernel must not launch."""
    want = dict.fromkeys(REPLACES, 0)
    want[blocks] = 10 * STEPS
    # the vocoder's forward runs once more in the final decode, its backward not
    fwd, bwd = VOCODER_LAUNCHES[vocoder]
    for n, k in fwd.items():
        want[n] += k * (STEPS + 1)
    for n, k in bwd.items():
        want[n] += k * STEPS
    if gn_mode != "plain":
        # the UNet once a step; the VAE once a step and in the final decode;
        # the masks in the vocoder backward, once a step
        for model, runs in (("unet", STEPS), ("vae", STEPS + 1)):
            for name, n in ROUTE_LAUNCHES[model][gn_mode].items():
                want[name] += n * runs
        want.update({n: k * STEPS for n, k in MASKS_PER_STEP.items()})
    return want


def check_launches(label: str, counts: dict, want: dict) -> None:
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{label}: {name} launched {counts[name]} times, "
                                 f"expected {n}")


# Final-latent tolerances of the reference phase, as ||card - cpu|| / ||cpu||.
# The dB-mel loss is ill-conditioned: measured on the CPU at this
# configuration, a 1e-6 relative perturbation of the initial latents moves
# the final latents by 1.0e-3 (norm) after 2 steps, through log10 of
# near-silent mel bins; with the waveform-space loss the same perturbation
# moves them by 1.3e-6. So the waveform run carries the tight check of the
# gradient path (VAE decoder, vocoder kernels and their backwards).
REF_LATENT_TOL = {"mel_spectrogram": 2e-2, "wav_form": 1e-4}
REF_LOSS_TOL = 1e-4
REF_AUDIO_S = 0.64   # latent (1, 8, 32, 32): level-0 T = 1024 -> the block kernels
# latent (1, 8, 64, 32): the UNet's levels 0-1 and the VAE's 128-channel
# levels meet the conv2d and GroupNorm rules, and the vocoder's ch256 and
# ch128 stages (T 2564, 5130) meet mask_ok
ROUTES_REF_AUDIO_S = 1.28


def reference_configs():
    """The small fp32 reference models: UNet (128, 128), VAE (32, 64), and
    HiFi-GAN at full width with resblock kernels (3, 7), whose ch512 k=7
    pairs (14.7 MB in fp32) exceed pair_ok's 9 MB and take conv1d_fused, as
    the bf16 k=11 ones do in the slice."""
    from diffmusic_tpu_torch.models.configs import HiFiGANConfig, VAEConfig
    unet = dict(block_out_channels=(128, 128), layers_per_block=1, norm_num_groups=32,
                has_attention=(True, False))
    vae_cfg = VAEConfig(block_out_channels=(32, 64), layers_per_block=1, norm_num_groups=16)
    voc_cfg = HiFiGANConfig(resblock_kernel_sizes=(3, 7),
                            resblock_dilation_sizes=((1, 3), (1, 3)))
    return unet, vae_cfg, voc_cfg


def compare_reference(label, out, lat_tol, card_kernels) -> None:
    """Card run against CPU run: losses, final latents, and launches (every
    kernel of `card_kernels` on the card, none on the CPU)."""
    (lat_g, loss_g, counts_g), (lat_c, loss_c, counts_c) = out["cuda"], out["cpu"]
    lat_err = float(np.linalg.norm(lat_g - lat_c) / np.linalg.norm(lat_c))
    loss_err = float(np.abs(loss_g - loss_c).max() / np.abs(loss_c).max())
    log(f"reference ({label}): losses card {loss_g.tolist()} vs cpu {loss_c.tolist()} "
        f"(rel {loss_err:.2e}, tol {REF_LOSS_TOL:.0e}); final latents norm-rel "
        f"{lat_err:.2e} (tol {lat_tol:.0e}); card launches {counts_g}")
    if not all(counts_g[n] > 0 for n in card_kernels) or any(counts_c.values()):
        raise AssertionError(f"reference ({label}): the card run must launch "
                             f"{card_kernels}, the CPU run none")
    if loss_err > REF_LOSS_TOL or lat_err > lat_tol:
        raise AssertionError("the card's pipeline disagrees with the CPU reference")


def phase_reference():
    """A small fp32 MusicLDM through the whole DPS pipeline on the card (every
    MusicLDM kernel routed) and on the CPU (plain versions), with the slice's
    dB-mel loss and with the waveform loss: losses and final latents must
    agree."""
    from diffmusic_tpu_torch import kernels
    from diffmusic_tpu_torch.models.configs import UNetConfig
    unet, vae_cfg, voc_cfg = reference_configs()
    pipes = {dev: build_pipe(UNetConfig(**unet), vae_cfg, voc_cfg, REF_AUDIO_S, dev,
                             torch.float32) for dev in ("cuda", "cpu")}
    lat = torch.randn((1, 8, 32, 32), generator=torch.Generator().manual_seed(5))
    for space, lat_tol in REF_LATENT_TOL.items():
        out = {}
        for dev, (pipe, meas) in pipes.items():
            kernels.reset_launch_counts()
            res, losses = pipe(audio_length_in_s=REF_AUDIO_S, num_inference_steps=2, eta=0.0,
                               prompt_embeds=torch.zeros(2, 512), measurement=meas,
                               ip_guidance_rate=2.0, latents=lat, output_type="latent",
                               return_losses=True, supervised_space=space)
            out[dev] = (res.audios, losses, kernels.launch_counts())
        compare_reference(f"MusicLDM, fp32, small model, 2 DPS steps, {space} loss", out,
                          lat_tol, ("fused_transformer_block",) + tuple(VOCODER_PER_STEP))


def reference_runs(cfgs, audio_s, lat, **routes) -> dict:
    """2 DPS steps with the waveform loss of a small fp32 MusicLDM of the
    (UNet, VAE, HiFi-GAN) configs `cfgs` with the route flags, on the card
    and on the CPU: per device (final latents, losses, launch counts)."""
    from diffmusic_tpu_torch import kernels
    out = {}
    for dev in ("cuda", "cpu"):
        pipe, meas = build_pipe(*cfgs, audio_s, dev, torch.float32, **routes)
        kernels.reset_launch_counts()
        res, losses = pipe(audio_length_in_s=audio_s, num_inference_steps=2, eta=0.0,
                           prompt_embeds=torch.zeros(2, 512), measurement=meas,
                           ip_guidance_rate=2.0, latents=lat, output_type="latent",
                           return_losses=True, supervised_space="wav_form")
        out[dev] = (res.audios, losses, kernels.launch_counts())
    return out


def phase_reference_routes():
    """A small fp32 MusicLDM with the guided step's routes on (`gn_mode`
    "stats", then "fused"; the conv2d and mask kernels), 2 DPS steps with the
    waveform loss, on the card and on the CPU: every route kernel of the
    setting launches on the card, inside the differentiated chain too (the
    VAE's 128-channel levels, the vocoder backward), and none on the CPU."""
    from diffmusic_tpu_torch.models.configs import UNetConfig, VAEConfig
    unet, _, voc_cfg = reference_configs()
    vae_cfg = VAEConfig(block_out_channels=(32, 128), layers_per_block=1, norm_num_groups=32)
    lat = torch.randn((1, 8, 64, 32), generator=torch.Generator().manual_seed(7))
    gn_kernels = {"stats": "channel_moments", "fused": "fused_group_norm"}
    for gn_mode, gn_kernel in gn_kernels.items():
        out = reference_runs((UNetConfig(**unet), vae_cfg, voc_cfg), ROUTES_REF_AUDIO_S, lat,
                             **TURN_ROUTES[gn_mode])
        compare_reference(f"MusicLDM with the routes, gn_mode {gn_mode}, fp32, small model, "
                          f"2 DPS steps, wav_form loss", out, REF_LATENT_TOL["wav_form"],
                          (gn_kernel, "conv2d_same", "leaky_mask", "leaky_mask_add",
                           "fused_transformer_block") + tuple(VOCODER_PER_STEP))
        other = gn_kernels["fused" if gn_mode == "stats" else "stats"]
        if out["cuda"][2][other]:
            raise AssertionError(f"gn_mode {gn_mode} launched {other}")


# each new route's kernels, which must launch on the card in its reference run
NEW_ROUTE_KERNELS = {"xbwd": ("conv1d_pair_canvas", "conv1d_fused_canvas"),
                     "kernel": ("conv1d_fused_canvas",),
                     "stage": ("stage_resblocks_canvas", "conv1d_pair_canvas"),
                     "bsoft": ("fused_transformer_block_bsoft",)}


def phase_reference_new_routes():
    """The small fp32 MusicLDM of `phase_reference` (HiFi-GAN at full width
    with resblocks (3, 7): stage 2 is ch128 at T 2560 on a canvas of 7
    blocks, and meets the stage rule in fp32), 2 DPS steps with the waveform
    loss, card against CPU, under each new route: the vocoder's canvas
    "xbwd", "kernel", the stage route, and the bounded softmax."""
    from diffmusic_tpu_torch.models.configs import UNetConfig
    unet, vae_cfg, voc_cfg = reference_configs()
    lat = torch.randn((1, 8, 32, 32), generator=torch.Generator().manual_seed(8))
    for name, card_kernels in NEW_ROUTE_KERNELS.items():
        out = reference_runs((UNetConfig(**unet), vae_cfg, voc_cfg), REF_AUDIO_S, lat,
                             **TURN_ROUTES[name])
        compare_reference(f"MusicLDM, route {name} {TURN_ROUTES[name]}, fp32, small model, 2 "
                          f"DPS steps, wav_form loss", out, REF_LATENT_TOL["wav_form"],
                          card_kernels)


def phase_reference_audioldm2():
    """A small fp32 AudioLDM2 (tiny text stack, the reference's UNet with two
    32-wide cross streams) from a text prompt under classifier-free guidance
    (the UNet batch doubles), 2 DPS steps with the waveform loss, on the card
    and on the CPU, once per UNet route."""
    from diffmusic_tpu_torch import kernels
    from diffmusic_tpu_torch.models.configs import (ProjectionConfig, tiny_clap_text_config,
                                                    tiny_gpt2_config, tiny_t5_config)
    unet, vae_cfg, voc_cfg = reference_configs()
    txt, t5, gpt2 = tiny_clap_text_config(), tiny_t5_config(), tiny_gpt2_config()
    text = dict(text_cfg=txt, t5_cfg=t5, gpt2_cfg=gpt2,
                proj_cfg=ProjectionConfig(txt.projection_dim, t5.d_model, gpt2.n_embd))
    unet_cfg = audioldm2_unet_config(cross_attention_dims=(gpt2.n_embd, t5.d_model), **unet)
    lat = torch.randn((1, 8, 32, 32), generator=torch.Generator().manual_seed(6))
    for fuse_cross, route in ((False, "flash_attention"), (True, "fused_transformer_block_cross")):
        out = {}
        for dev in ("cuda", "cpu"):
            pipe, meas = build_audioldm2(unet_cfg, vae_cfg, voc_cfg, REF_AUDIO_S, dev,
                                         torch.float32, fuse_cross, **text)
            kernels.reset_launch_counts()
            res, losses = pipe(prompt="solo piano", audio_length_in_s=REF_AUDIO_S,
                               num_inference_steps=2, guidance_scale=3.5, eta=0.0,
                               measurement=meas, ip_guidance_rate=2.0, latents=lat,
                               output_type="latent", return_losses=True,
                               supervised_space="wav_form")
            out[dev] = (res.audios, losses, kernels.launch_counts())
        compare_reference(f"AudioLDM2, fp32, small model, prompt 'solo piano', CFG 3.5, "
                          f"fuse_cross {fuse_cross}, 2 DPS steps, wav_form loss", out,
                          REF_LATENT_TOL["wav_form"], (route,) + tuple(VOCODER_PER_STEP))
        if out["cuda"][2][{"flash_attention": "fused_transformer_block_cross",
                           "fused_transformer_block_cross": "flash_attention"}[route]]:
            raise AssertionError(f"fuse_cross {fuse_cross} launched the other route")


def drive(label: str, pipe, meas, want: dict, **call_kw) -> tuple:
    """One 10-s slice run through the pipeline's __call__: STEPS DPS steps,
    eta 0, rate 2.0, seeded latents (1, 8, 250, 16); the launch counts are set
    to 0 just before and read just after, and must equal `want`. Returns
    (launch counts, the restored audio (1, 160000))."""
    from diffmusic_tpu_torch import kernels
    lat = torch.randn(LATENTS, generator=torch.Generator().manual_seed(0))
    stamps = []

    def on_step(i, t, x):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    start = time.perf_counter()
    out, losses = pipe(audio_length_in_s=10.0, num_inference_steps=STEPS, eta=0.0,
                       measurement=meas, ip_guidance_rate=2.0, latents=lat,
                       return_losses=True, callback=on_step, **call_kw)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    step_ms = [1e3 * (b - a) for a, b in zip([start] + stamps[:-1], stamps)]
    peak = torch.cuda.max_memory_allocated()
    audio = out.audios
    q1, med, q3 = statistics.quantiles(step_ms[1:], n=4)
    log(f"{label}: DPS {STEPS} steps, eta 0, rate 2.0, latents {LATENTS}; "
        f"loss first {losses[0]:.4f} last {losses[-1]:.4f}; "
        f"ms/guided step after the first: median {med:.2f}, quartiles {q1:.2f}/{q3:.2f} "
        f"(first {step_ms[0]:.1f}); peak memory {peak / 2**30:.2f} GiB; "
        f"audio {audio.shape}")
    log(f"{label}: launches over the {STEPS} steps and the final decode {counts}")
    if not np.isfinite(losses).all() or not np.isfinite(audio).all():
        raise AssertionError(f"{label} produced non-finite losses or audio")
    if audio.shape != (1, 160000):
        raise AssertionError(f"audio shape {audio.shape}, expected (1, 160000)")
    check_launches(label, counts, want)
    return counts, audio


# the slice's turns: each route once each way, so that the host's drift over
# the call falls on every route alike
TURNS = ("default", "stats", "fused", "xbwd", "kernel", "stage", "bsoft",
         "bsoft", "stage", "kernel", "xbwd", "fused", "stats", "default")


def turn_launches(name: str) -> dict:
    """The launches a turn of the slice must give."""
    flags = TURN_ROUTES[name]
    return expected_launches("fused_transformer_block_bsoft" if flags.get("bsoft")
                             else "fused_transformer_block",
                             flags.get("gn_mode", "plain"),
                             name if name in VOCODER_ROUTES else "default")


def phase_slice(profile_dir=None) -> tuple:
    """Full-width MusicLDM on the default route and on each route of
    TURN_ROUTES, in the TURNS, then each setting's breakdown (the whole step
    for the default and the GroupNorm routes, the vocoder for its routes, the UNet
    for bsoft). Returns the launch counts of the first run of each setting
    and the audio of the first default turn."""
    from diffmusic_tpu_torch.models.configs import HiFiGANConfig, UNetConfig, VAEConfig
    t0 = time.time()
    pipe, meas = build_pipe(UNetConfig(), VAEConfig(), HiFiGANConfig(), 10.0, "cuda",
                            torch.bfloat16)
    log(f"slice: full-width MusicLDM, seeded random bf16 weights, built in "
        f"{time.time() - t0:.1f} s")
    pipes = {name: with_routes(pipe, **flags) if flags else pipe
             for name, flags in TURN_ROUTES.items()}
    counts, audio = {}, {}
    for turn, name in enumerate(TURNS):
        label = "slice" if name == "default" else f"slice route {name}"
        c, a = drive(f"{label} (turn {turn + 1})", pipes[name], meas, turn_launches(name),
                     prompt_embeds=torch.zeros(2, 512))
        counts.setdefault(name, c)
        audio.setdefault(name, a)
    for name, p in pipes.items():
        parts = (None if name in ("default", "stats", "fused") else
                 ("unet fwd (no grad)",) if name == "bsoft" else ("vocoder fwd+bwd",))
        phase_breakdown(p, meas, LATENTS, torch.zeros(2, 512),
                        "slice" if name == "default" else f"slice_route_{name}",
                        profile_dir if name in ("default", "stats") else None, parts)
    return counts, audio["default"]


def phase_audioldm2(profile_dir=None) -> dict:
    """Full-width AudioLDM2 from the empty prompt, both UNet routes; returns
    the launch counts of each route's run."""
    from diffmusic_tpu_torch.models.configs import HiFiGANConfig, VAEConfig
    from diffmusic_tpu_torch.models.unet import UNet2DConditionModel
    t0 = time.time()
    unet_cfg = audioldm2_unet_config()
    pipe, meas = build_audioldm2(unet_cfg, VAEConfig(), HiFiGANConfig(), 10.0, "cuda",
                                 torch.bfloat16, False)
    log(f"audioldm2: full-width AudioLDM2 (UNet cross dims (768, 1024), CLAP text, "
        f"flan-t5-large encoder, GPT-2, projection), seeded random bf16 weights, built in "
        f"{time.time() - t0:.1f} s")
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        embeds = pipe.encode_prompt("", None, True)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    log(f"audioldm2: text stack (CLAP, T5, projection, 8 GPT-2 steps; prompt and negative "
        f"prompt '') {secs[0]:.3f} s first, {secs[1]:.3f} s again; streams "
        f"{[tuple(a.shape) for a in embeds]}")
    counts = {False: drive("audioldm2 fuse_cross=False", pipe, meas,
                           expected_launches("flash_attention"), prompt="")[0]}
    with pipe.device:
        fused = UNet2DConditionModel(unet_cfg, fuse_cross=True)
    fused.to(torch.bfloat16).load_state_dict(pipe.unet.state_dict())
    fused_pipe = dataclasses.replace(pipe, unet=fused)
    counts[True] = drive("audioldm2 fuse_cross=True", fused_pipe, meas,
                         expected_launches("fused_transformer_block_cross"), prompt="")[0]
    del fused_pipe, fused
    counts["bsoft"] = drive("audioldm2 fuse_cross=True bsoft=True",
                            with_routes(pipe, fuse_cross=True, bsoft=True), meas,
                            expected_launches("fused_transformer_block_bsoft"), prompt="")[0]
    phase_breakdown(pipe, meas, LATENTS, embeds, "audioldm2", profile_dir)
    return counts


def phase_breakdown(pipe, meas, lat_shape, embeds, label, profile_dir=None,
                    only=None) -> None:
    """Where one guided step's time goes at the slice's shapes: each stage of
    the step alone (median ms from CUDA events; `only` names the stages to
    time, all by default), then optionally a torch.profiler table of two
    guided steps, written to `profile_dir`. `embeds` is the CFG-stacked
    conditioning of the empty prompt."""
    from diffmusic_tpu_torch.pipelines.musicldm import per_clip_loss
    dev = pipe.device
    gen = torch.Generator().manual_seed(1)
    x = randn(lat_shape, gen, dev, torch.float32)
    cond = pipe._map_embeds(lambda a: pipe._on_device(a)[a.shape[0] // 2:], embeds)
    owl = meas.shape[-1]
    target = pipe.operator.transform(meas)
    with torch.no_grad():
        mel = pipe.decode_mel(x)
        audio = pipe.mel_to_waveform(mel)
    g_mel = torch.randn(mel.shape, generator=gen).to(dev, mel.dtype)
    g_audio = torch.randn(audio.shape, generator=gen).to(dev, audio.dtype)

    def unet():
        with torch.no_grad():
            pipe._eps(cond, x, 501, 1.0)

    def vae():
        xx = x.clone().requires_grad_(True)
        torch.autograd.grad(pipe.decode_mel(xx), xx, g_mel)

    def vocoder():
        mm = mel.detach().requires_grad_(True)
        torch.autograd.grad(pipe.mel_to_waveform(mm), mm, g_audio)

    def loss_head():
        aa = audio.detach().float().requires_grad_(True)
        loss = per_clip_loss(target, pipe.operator, aa[:, :owl], "mel_spectrogram")
        torch.autograd.grad(loss, aa)

    parts = {"unet fwd (no grad)": unet, "vae decode fwd+bwd": vae,
             "vocoder fwd+bwd": vocoder, "mel loss head fwd+bwd": loss_head}
    parts = {name: fn for name, fn in parts.items() if only is None or name in only}
    # one call per timing: a stage's latency inside the step, host dispatch included
    times = {name: time_ms(fn, reps=5, inner=1, warmup=1) for name, fn in parts.items()}
    log(f"{label} breakdown of one guided step (median ms, CUDA events): " +
        "; ".join(f"{k} {v:.2f}" for k, v in times.items()) +
        f"; sum {sum(times.values()):.2f}")
    if profile_dir is None:
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    profile_dir.mkdir(parents=True, exist_ok=True)
    lat = randn(lat_shape, gen, dev, torch.float32)
    kw = dict(audio_length_in_s=owl / 16000, num_inference_steps=2, eta=0.0,
              prompt_embeds=embeds, measurement=meas, ip_guidance_rate=2.0,
              latents=lat, output_type="latent")
    pipe(**kw)
    torch.cuda.synchronize()
    wall = time.perf_counter()
    pipe(**kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = time.perf_counter()
        pipe(**kw)
        torch.cuda.synchronize()
        traced = time.perf_counter() - traced
    events = prof.key_averages()
    # kernel rows only, as the table's own "Self CUDA time total" counts them
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    table = events.table(sort_by="self_cuda_time_total", row_limit=40)
    path = profile_dir / f"profile_{label}.txt"
    path.write_text(table)
    log(f"{label} profile of 2 guided steps: kernel time {dev_us / 1e3:.1f} ms; wall "
        f"{1e3 * wall:.1f} ms untraced, {1e3 * traced:.1f} ms traced; device busy share "
        f"{dev_us / 1e6 / wall:.3f} of the untraced wall; table in {path}")
    for line in table.splitlines()[:18]:
        log(f"  {line}")


# ------------------------------------------------------------------- eval
EVAL_CARD_CPU_PAIRS = 4          # pairs scored on the card and on the CPU
EVAL_SCORE_TOL = 1e-3            # card vs CPU, relative, every score
EVAL_LEVEL_FLIPS = 0.01          # post-PCA VGGish: share of elements off by one level


def eval_pair(i: int, rng, sr: int, seconds: float = 10.0):
    """(gt, recon) of pair i >= 1 at `sr`: a harmonic stack of a seeded
    fundamental and AM rate, and the same clip with the 4-6 s box zeroed plus
    seeded Gaussian noise."""
    tt = np.arange(int(seconds * sr)) / sr
    f0, am = 110.0 * 2.0 ** rng.uniform(0.0, 3.0), rng.uniform(0.5, 4.0)
    gt = sum(0.25 / (h + 1) * np.sin(2 * np.pi * f0 * (h + 1) * tt + rng.uniform(0, 6))
             for h in range(4)) * (0.6 + 0.4 * np.sin(2 * np.pi * am * tt))
    rec = gt.copy()
    rec[int(0.4 * rec.size):int(0.6 * rec.size)] = 0.0
    rec = rec + rng.uniform(0.01, 0.1) * rng.standard_normal(rec.size)
    return gt.astype(np.float32), rec.astype(np.float32)


def write_eval_dirs(root: Path, restored: np.ndarray) -> None:
    """root/gt and root/recon, EVAL_PAIRS files each: pair 0 the slice's
    ground truth and the audio its default turn restored, pairs 1 and 2 as
    44.1-kHz stereo float32 (the loaders resample them), the rest 16 kHz
    mono."""
    from diffmusic_tpu_torch.data import write_wav
    rng = np.random.default_rng(0)
    for d in ("gt", "recon"):
        (root / d).mkdir(parents=True)
    write_wav(root / "gt" / "000.wav", harmonic_stack(160000, 16000), 16000)
    write_wav(root / "recon" / "000.wav", restored, 16000)
    for i in range(1, EVAL_PAIRS):
        sr = 44100 if i in (1, 2) else 16000
        gt, rec = eval_pair(i, rng, sr)
        if sr != 16000:
            gt, rec = np.stack([gt, 0.9 * gt]), np.stack([rec, rec])
        write_wav(root / "gt" / f"{i:03d}.wav", gt, sr)
        write_wav(root / "recon" / f"{i:03d}.wav", rec, sr)


@contextlib.contextmanager
def eval_split(split: Counter):
    """Seconds of the eval's parts into `split`, by wrapping the functions
    that do them: the directory loads, each embedder's cache pass (its file
    reads and embedding calls), KL (re-embedding every clip), LSD, MSE."""
    from diffmusic_tpu_torch import eval as E
    from diffmusic_tpu_torch.fadtk import engine

    def wrap(owner, attr, key):
        fn = getattr(owner, attr)

        def timed(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                split[key(*a)] += time.perf_counter() - t
        return owner, attr, fn, timed

    wraps = [wrap(E, "load_dir", lambda *a: "wav loading"),
             wrap(engine, "cache_embedding_files", lambda d, m: f"embedding {m.name}"),
             wrap(E.KullbackLeiblerDivergence, "score", lambda *a: "KL"),
             wrap(E.LogSpectralDistance, "score", lambda *a: "LSD"),
             wrap(E.MeanSquaredError, "score", lambda *a: "MSE")]
    for owner, attr, _, timed in wraps:
        setattr(owner, attr, timed)
    try:
        yield
    finally:
        for owner, attr, fn, _ in wraps:
            setattr(owner, attr, fn)


def run_eval(root: Path, ckpt: Path, device: str) -> dict:
    from diffmusic_tpu_torch import eval as E
    return E.main(["-gt", str(root / "gt"), "-r", str(root / "recon"),
                   "--embedding", "mfcc-stack", "vggish", "--fad_inf",
                   "--individual", str(root / "songs.csv"), "--device", device,
                   "--checkpoint_dir", str(ckpt)])


def compare_eval_card_cpu(root: Path, ckpt: Path) -> None:
    """The first EVAL_CARD_CPU_PAIRS pairs copied into fresh directories and
    scored on the card and on the CPU: every score within EVAL_SCORE_TOL
    relative; the cached mfcc-stack embeddings within TOL_FP32 of max; the
    cached (post-PCA) VGGish embeddings off by at most one level on at most
    EVAL_LEVEL_FLIPS of the elements; VGGish before PCA within TOL_FP32 of
    max on pair 0's examples."""
    from diffmusic_tpu_torch.metrics import vggish as V
    from diffmusic_tpu_torch.utils import load_audio_task
    scores, caches = {}, {}
    for dev in ("cuda", "cpu"):
        d = root / f"card_cpu_{dev}"
        for sub_dir in ("gt", "recon"):
            (d / sub_dir).mkdir(parents=True)
            for f in sorted((root / sub_dir).glob("*.wav"))[:EVAL_CARD_CPU_PAIRS]:
                shutil.copy(f, d / sub_dir / f.name)
        t = time.perf_counter()
        scores[dev] = run_eval(d, ckpt, dev)
        log(f"eval card vs cpu: {EVAL_CARD_CPU_PAIRS} pairs on {dev} in "
            f"{time.perf_counter() - t:.2f} s")
        caches[dev] = {m: np.stack([np.load(f) for f in sorted(
            (d / "gt" / "embeddings" / m).glob("*.npy"))]) for m in ("mfcc-stack", "vggish")}
    errs = {k: abs(scores["cuda"][k] - scores["cpu"][k]) / max(abs(scores["cpu"][k]), 1e-30)
            for k in scores["cpu"]}
    mfcc = rel_err(torch.from_numpy(caches["cuda"]["mfcc-stack"]),
                   torch.from_numpy(caches["cpu"]["mfcc-stack"]))
    levels = np.abs(caches["cuda"]["vggish"] - caches["cpu"]["vggish"])
    flips = float((levels > 0).mean())
    wav = load_audio_task(root / "gt" / "000.wav", 16000)
    pre = {dev: torch.from_numpy(V.vggish_embedding(
        V.load_vggish(ckpt / "vggish" / "vggish.pth", dev)[0], None, wav))
        for dev in ("cuda", "cpu")}
    pre_err = rel_err(pre["cuda"], pre["cpu"])
    log(f"eval card vs cpu: score rel errors {({k: f'{v:.1e}' for k, v in errs.items()})} "
        f"(tol {EVAL_SCORE_TOL:.0e}); mfcc-stack caches max|err| {mfcc[0]:.3e} rel "
        f"{mfcc[1]:.2e} (tol {TOL_FP32:.0e}); vggish caches max level difference "
        f"{levels.max():g} on {flips:.2%} of elements (tol 1 on {EVAL_LEVEL_FLIPS:.0%}); "
        f"vggish pre-PCA rel {pre_err[1]:.2e} (tol {TOL_FP32:.0e})")
    if (max(errs.values()) > EVAL_SCORE_TOL or mfcc[1] > TOL_FP32 or levels.max() > 1
            or flips > EVAL_LEVEL_FLIPS or pre_err[1] > TOL_FP32):
        raise AssertionError("the eval on the card disagrees with the eval on the CPU")


def phase_eval(restored: np.ndarray) -> dict:
    """The port's eval CLI on the card over EVAL_PAIRS pairs of 10-s clips
    from cold caches, then card against CPU; returns the launch counts of the
    card run."""
    from diffmusic_tpu_torch import kernels
    from diffmusic_tpu_torch.metrics import vggish as V
    with tempfile.TemporaryDirectory() as tmp:
        root, t0 = Path(tmp), time.perf_counter()
        write_eval_dirs(root, restored)
        ckpt = root / "ckpt"
        (ckpt / "vggish").mkdir(parents=True)
        torch.save({k: torch.from_numpy(v) for k, v in V.random_state_dict(0).items()},
                   ckpt / "vggish" / "vggish.pth")
        log(f"eval: {EVAL_PAIRS} pairs of 10-s clips and a seeded random torchvggish-layout "
            f"vggish.pth written in {time.perf_counter() - t0:.2f} s")
        split = Counter()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with eval_split(split):
            scores = run_eval(root, ckpt, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        rows = list(csv.reader(open(root / "songs.csv")))
        log(f"eval: {EVAL_PAIRS} pairs, --embedding mfcc-stack vggish --fad_inf --individual, "
            f"cold caches: {wall:.2f} s wall; " +
            "; ".join(f"{k} {v:.2f}" for k, v in split.items()) +
            f"; the rest (FAD, FAD-inf, per-song statistics) {wall - sum(split.values()):.2f} s; "
            f"peak memory {peak / 2**30:.2f} GiB; scores {scores}; CSV rows {len(rows)}; "
            f"launches {counts}")
        if not all(math.isfinite(v) for v in scores.values()) or len(scores) != 7:
            raise AssertionError(f"eval scores {scores}")
        if len(rows) != EVAL_PAIRS:
            raise AssertionError(f"the per-song CSV has {len(rows)} rows, expected {EVAL_PAIRS}")
        want = dict.fromkeys(REPLACES, 0)
        want["fused_mel_spectrogram"] = eval_mel_launches(EVAL_PAIRS)
        check_launches("eval", counts, want)
        compare_eval_card_cpu(root, ckpt)
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the whole log, the build log and the profile "
                         "(optional)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile two guided steps with torch.profiler (needs --out)")
    args = ap.parse_args()
    if args.profile and args.out is None:
        ap.error("--profile needs --out")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.out is not None:
        global LOG_FILE
        args.out.mkdir(parents=True, exist_ok=True)
        LOG_FILE = args.out / "chip_smoke.log"
        LOG_FILE.write_text("")
    # fp32 references in full fp32: state both TF32 switches
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from diffmusic_tpu_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    t0 = time.time()
    build.library()
    log(f"build: {time.time() - t0:.1f} s ({build.BUILD_ROOT / build.source_hash()})")
    build_log = (build.BUILD_ROOT / build.source_hash() / "build.log")
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
        if args.out is not None:
            args.out.mkdir(parents=True, exist_ok=True)
            shutil.copy(build_log, args.out / "build.log")

    profile_dir = args.out if args.profile else None
    gen = torch.Generator().manual_seed(0)
    stats = phase_kernels(gen)
    phase_reference()
    phase_reference_routes()
    phase_reference_new_routes()
    phase_reference_audioldm2()
    slice_counts, restored = phase_slice(profile_dir)
    a2 = phase_audioldm2(profile_dir)
    eval_counts = phase_eval(restored)
    # each kernel's launches from the path that runs it: MusicLDM's default
    # route for its four, its routes for the route kernels (the fused
    # GroupNorm from gn_mode "fused", the others from "stats"; the canvas
    # conv from canvas "kernel", the pair from "xbwd", the stage from its
    # route, the bounded softmax from bsoft), AudioLDM2 with fuse_cross off
    # for flash, on for the dual-cross block; the eval for the mel kernel
    counts = dict(slice_counts["stats"])
    counts.update({n: slice_counts["default"][n] for n in VOCODER_PER_STEP})
    counts["fused_transformer_block"] = slice_counts["default"]["fused_transformer_block"]
    counts["fused_group_norm"] = slice_counts["fused"]["fused_group_norm"]
    for name, route in (("conv1d_fused_canvas", "kernel"), ("conv1d_pair_canvas", "xbwd"),
                        ("stage_resblocks_canvas", "stage"),
                        ("fused_transformer_block_bsoft", "bsoft")):
        counts[name] = slice_counts[route][name]
    counts["flash_attention"] = a2[False]["flash_attention"]
    counts["fused_transformer_block_cross"] = a2[True]["fused_transformer_block_cross"]
    counts["fused_mel_spectrogram"] = eval_counts["fused_mel_spectrogram"]

    kernels_line = []
    for n in REPLACES:
        s = stats[n]
        kernels_line.append({
            "name": n, "route": "cuda", "source": SOURCES[n], "replaces": REPLACES[n],
            "launches": counts[n], "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "operations" if s["ops_ms"] > s["bytes_ms"] else "bytes",
            "library_ms": s["library_ms"]})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
