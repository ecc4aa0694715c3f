"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR [--profile]]

Phases, in order; any failure raises and the script exits non-zero:
  1. device: a CUDA device must be present; prints its nvidia-smi name and
     power limit;
  2. build: compiles the kernels from `diffmusic_tpu_torch/kernels/csrc` with
     nvcc (sm_90a) and prints the seconds taken;
  3. kernels: each kernel's wrapper against its plain PyTorch version, on the
     card, at every shape the 10-s MusicLDM slice gives it (bf16), plus a small
     fp32 case with TF32 off; forward and, for the vocoder kernels, the input
     gradient; median times of kernel and plain version from CUDA events;
  4. reference: a small fp32 model through the whole DPS pipeline on the card
     (kernels) and on the CPU (plain versions), which must agree;
  5. slice: full-width MusicLDM with seeded random bf16 weights, 20 DPS
     steps inpainting a 10-s clip (box mask at 4-6 s) through
     `MusicLDMPipeline.__call__`, with the launch counts of every kernel;
  6. breakdown: each stage of one guided step timed alone at the slice's
     shapes; with --profile also a torch.profiler table of two guided steps
     and the device busy share, written to --out.
Then the card's nvidia-smi name and power limit, a JSON line with one entry
per kernel, and last {"ok": true, "device": {...}}. No JAX is imported.
"""

import argparse
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# bf16 tolerances, as a fraction of max |plain|: one bf16 rounding of an
# intermediate (h, q, attention output) moves a product by ~2^-8 relative
TOL_CONV_BF16 = 2e-2
TOL_BLOCK_BF16 = 3e-2
# fp32: the kernels accumulate in another order than cuDNN/cuBLAS
TOL_FP32 = 1e-4

SLOPE = 0.1
STEPS = 20   # DPS steps of the slice
REPLACES = {
    "fused_transformer_block": "diffmusic_tpu/pallas/transformer_kernel.py:291",
    "conv1d_fused_pair": "diffmusic_tpu/pallas/conv1d_kernel.py:661",
    "conv1d_fused": "diffmusic_tpu/pallas/conv1d_kernel.py:183",
    "phase_convtranspose": "diffmusic_tpu/pallas/upsampler_kernel.py:231",
}
SOURCES = {
    "fused_transformer_block": "diffmusic_tpu_torch/kernels/csrc/transformer_block.cu",
    "conv1d_fused_pair": "diffmusic_tpu_torch/kernels/csrc/conv1d.cu",
    "conv1d_fused": "diffmusic_tpu_torch/kernels/csrc/conv1d.cu",
    "phase_convtranspose": "diffmusic_tpu_torch/kernels/csrc/upsampler.cu",
}
# launches per guided step of the 10-s slice (UNet levels 0/1: 2 down + 3 up
# blocks each; vocoder: 24 pairs, the 6 ch512 k=11 convs, upsamplers 0-2)
PER_STEP = {"fused_transformer_block": 10, "conv1d_fused_pair": 24,
            "conv1d_fused": 6, "phase_convtranspose": 3}


def log(msg: str) -> None:
    print(msg, flush=True)


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


def randn(shape, gen, device, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(device=device, dtype=dtype)


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


def timings(kern, plain, x, dtype):
    """Forward ms of kernel and plain version (bf16 slice shapes only)."""
    if dtype != torch.bfloat16:
        return float("nan"), float("nan")
    with torch.no_grad():
        return time_ms(lambda: kern(x)), time_ms(lambda: plain(x))


def describe(fwd, bwd, tol) -> str:
    return (f"fwd max|err| {fwd[0]:.3e} rel {fwd[1]:.2e}; grad max|err| {bwd[0]:.3e} "
            f"rel {bwd[1]:.2e} norm-rel {bwd[2]:.2e} (tol {tol:.0e})")


# ----------------------------------------------------------------- kernels
def conv_cases(dtype):
    """(name, x shape, k, dilation, residual) for every resblock conv call of
    the 10-s slice."""
    cases = []
    stages = [(5001, 512), (20004, 256), (40008, 128)]
    for t, c in stages:
        for k in (3, 7, 11):
            for d in (1, 3, 5):
                from diffmusic_tpu_torch.kernels.conv1d import pair_ok
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
    if name == "conv1d_fused_pair":
        kern = lambda xx: K.conv1d_fused_pair(xx, w1, b1, w2, b2, d, SLOPE)
        plain = lambda xx: K.pair_plain(xx, w1, b1, w2, b2, d, SLOPE)[0]
    else:
        kern = lambda xx: K.conv1d_fused(xx, w1, b1, r, d, SLOPE)
        plain = lambda xx: K.conv1d_plain(xx, w1, b1, d, SLOPE, r)
    fwd, bwd = compare_with_grad(kern, plain, x, g)
    if name == "conv1d_fused_pair":   # the h the kernel saves for the backward
        with torch.no_grad():
            h_err = rel_err(K._launch_pair(x, w1, b1, w2, b2, d, SLOPE)[1],
                            K.pair_plain(x, w1, b1, w2, b2, d, SLOPE)[1])
        fwd = max(fwd, h_err, key=lambda e: e[1])
    ms, plain_ms = timings(kern, plain, x, dtype)
    log(f"  {name:24s} x{shape} k{k} d{d}{' +res' if residual else ''} {str(dtype)[6:]}: "
        f"{describe(fwd, bwd, tol)}; {ms:.3f} ms vs plain {plain_ms:.3f} ms")
    if fwd[1] > tol or bwd[2] > tol:
        raise AssertionError(f"{name} disagrees with its plain version")
    return fwd[0], ms, plain_ms


def check_upsampler(cin, cout, k, s, t_in, dtype, gen, tol):
    from diffmusic_tpu_torch.kernels import upsampler as U
    dev = "cuda"
    x = randn((1, t_in, cin), gen, dev, dtype)
    w = randn((k, cin, cout), gen, dev, dtype, 1.0 / math.sqrt(k * cout))
    b = randn((cout,), gen, dev, dtype, 0.1)
    t_out = U.output_length(t_in, s, k)
    g = randn((1, t_out, cout), gen, dev, dtype)
    kern = lambda xx: U.phase_convtranspose(xx, w, b, s, k, t_out, SLOPE)
    plain = lambda xx: U.convtranspose_plain(torch.nn.functional.leaky_relu(xx, SLOPE),
                                             w, b, s, k)
    fwd, bwd = compare_with_grad(kern, plain, x, g)
    ms, plain_ms = timings(kern, plain, x, dtype)
    log(f"  phase_convtranspose      {t_in}->{t_out} {cin}->{cout} k{k} s{s} "
        f"{str(dtype)[6:]}: {describe(fwd, bwd, tol)}; {ms:.3f} ms vs plain {plain_ms:.3f} ms")
    if fwd[1] > tol or bwd[2] > tol:
        raise AssertionError("phase_convtranspose disagrees with its plain version")
    return fwd[0], ms, plain_ms


def check_block(t, c, dtype, gen, tol):
    from diffmusic_tpu_torch.kernels import transformer_block as TB
    dev = "cuda"
    heads = c // 8
    x = randn((1, t, c), gen, dev, dtype)
    sc = 1.0 / math.sqrt(c)
    p = dict(ln1_scale=1 + randn((c,), gen, dev, dtype, 0.1), ln1_bias=randn((c,), gen, dev, dtype, 0.1),
             wq=randn((c, c), gen, dev, dtype, sc), wk=randn((c, c), gen, dev, dtype, sc),
             wv=randn((c, c), gen, dev, dtype, sc), wo=randn((c, c), gen, dev, dtype, sc),
             bo=randn((c,), gen, dev, dtype, 0.1),
             ln3_scale=1 + randn((c,), gen, dev, dtype, 0.1), ln3_bias=randn((c,), gen, dev, dtype, 0.1),
             wi=randn((c, 8 * c), gen, dev, dtype, sc), bi=randn((8 * c,), gen, dev, dtype, 0.1),
             wo2=randn((4 * c, c), gen, dev, dtype, 1.0 / math.sqrt(4 * c)),
             bo2=randn((c,), gen, dev, dtype, 0.1))
    with torch.no_grad():
        out = TB.fused_transformer_block(x, p, heads, 8)
        ref = TB.transformer_block_plain(x, p, heads, 8)
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        ms = time_ms(lambda: TB.fused_transformer_block(x, p, heads, 8)) \
            if dtype == torch.bfloat16 else float("nan")
        plain_ms = time_ms(lambda: TB.transformer_block_plain(x, p, heads, 8)) \
            if dtype == torch.bfloat16 else float("nan")
    log(f"  fused_transformer_block  (1, {t}, {c}) heads {heads} {str(dtype)[6:]}: "
        f"max|err| {err[0]:.3e} rel {err[1]:.2e} (tol {tol:.0e}); "
        f"{ms:.3f} ms vs plain {plain_ms:.3f} ms")
    if err[1] > tol:
        raise AssertionError("fused_transformer_block disagrees with its plain version")
    return err[0], ms, plain_ms


def phase_kernels(gen) -> dict:
    """Every kernel at the slice's shapes (bf16) and a small fp32 case.
    Returns per kernel: max abs error, and kernel/plain ms summed over one
    guided step's calls."""
    stats = {n: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0} for n in REPLACES}

    def add(name, res, per_step=1):
        err, ms, plain_ms = res
        s = stats[name]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if not math.isnan(ms):
            s["ms"] += per_step * ms
            s["plain_ms"] += per_step * plain_ms

    bf = torch.bfloat16
    log("kernels vs plain versions, slice shapes, bf16:")
    for t, c in ((4000, 128), (1000, 256)):
        add("fused_transformer_block", check_block(t, c, bf, gen, TOL_BLOCK_BF16), 5)
    for name, shape, k, d, res in conv_cases(bf):
        add(name, check_conv(name, shape, k, d, res, bf, gen, TOL_CONV_BF16))
    for cin, cout, k, s, t_in in ((1024, 512, 16, 5, 1000), (512, 256, 16, 4, 5001),
                                  (256, 128, 8, 2, 20004)):
        add("phase_convtranspose", check_upsampler(cin, cout, k, s, t_in, bf, gen,
                                                   TOL_CONV_BF16))
    log("kernels vs plain versions, small fp32 cases (TF32 off):")
    f32 = torch.float32
    add("fused_transformer_block", check_block(600, 128, f32, gen, TOL_FP32))
    add("conv1d_fused_pair", check_conv("conv1d_fused_pair", (2, 300, 128), 7, 3, False,
                                        f32, gen, TOL_FP32))
    add("conv1d_fused", check_conv("conv1d_fused", (2, 300, 128), 11, 5, True, f32, gen,
                                   TOL_FP32))
    add("phase_convtranspose", check_upsampler(256, 128, 16, 5, 100, f32, gen, TOL_FP32))
    return stats


# -------------------------------------------------------------- pipelines
def harmonic_stack(owl: int, sr: int) -> np.ndarray:
    """bench.py's ground truth: four harmonics of 220 Hz with 2-Hz AM."""
    tt = np.arange(owl) / sr
    gt = sum(0.25 / (i + 1) * np.sin(2 * np.pi * 220 * (i + 1) * tt) for i in range(4))
    return (gt * (0.6 + 0.4 * np.sin(2 * np.pi * 2.0 * tt)))[None].astype(np.float32)


def build_pipe(unet_cfg, vae_cfg, voc_cfg, audio_s, device, weight_dtype):
    from diffmusic_tpu_torch.inverse_problem import MusicInpaintingOperator
    from diffmusic_tpu_torch.pipelines import MusicLDMPipeline
    op = MusicInpaintingOperator(audio_length_in_s=audio_s, sample_rate=16000,
                                 mask_type="box", start_inpainting_s=audio_s * 0.4,
                                 end_inpainting_s=audio_s * 0.6)
    pipe = MusicLDMPipeline.random(unet_cfg, vae_cfg, voc_cfg, seed=0, device=device,
                                   weight_dtype=weight_dtype, scheduler_name="dps",
                                   operator=op)
    owl = int(audio_s * 16000)
    measurement = op.forward(torch.as_tensor(harmonic_stack(owl, 16000), device=device))
    return pipe, measurement


# Final-latent tolerances of the reference phase, as ||card - cpu|| / ||cpu||.
# The dB-mel loss is ill-conditioned: measured on the CPU at this
# configuration, a 1e-6 relative perturbation of the initial latents moves
# the final latents by 1.0e-3 (norm) after 2 steps, through log10 of
# near-silent mel bins; with the waveform-space loss the same perturbation
# moves them by 1.3e-6. So the waveform run carries the tight check of the
# gradient path (VAE decoder, vocoder kernels and their backwards).
REF_LATENT_TOL = {"mel_spectrogram": 2e-2, "wav_form": 1e-4}
REF_LOSS_TOL = 1e-4


def phase_reference():
    """A small fp32 model through the whole DPS pipeline on the card (every
    kernel routed) and on the CPU (plain versions), with the slice's dB-mel
    loss and with the waveform loss: losses and final latents must agree."""
    from diffmusic_tpu_torch import kernels
    from diffmusic_tpu_torch.models.configs import HiFiGANConfig, UNetConfig, VAEConfig
    unet_cfg = UNetConfig(block_out_channels=(128, 128), layers_per_block=1,
                          norm_num_groups=32, has_attention=(True, False))
    vae_cfg = VAEConfig(block_out_channels=(32, 64), layers_per_block=1,
                        norm_num_groups=16)
    # in fp32 the ch512 k=7 pairs (14.7 MB) exceed pair_ok's 9 MB and take
    # conv1d_fused, as the bf16 k=11 ones do in the slice
    voc_cfg = HiFiGANConfig(resblock_kernel_sizes=(3, 7),
                            resblock_dilation_sizes=((1, 3), (1, 3)))
    audio_s = 0.64          # latent (1, 8, 32, 32): level-0 T = 1024 -> fused block
    pipes = {dev: build_pipe(unet_cfg, vae_cfg, voc_cfg, audio_s, dev, torch.float32)
             for dev in ("cuda", "cpu")}
    lat = torch.randn((1, 8, 32, 32), generator=torch.Generator().manual_seed(5))
    for space, lat_tol in REF_LATENT_TOL.items():
        out = {}
        for dev, (pipe, meas) in pipes.items():
            kernels.reset_launch_counts()
            res, losses = pipe(audio_length_in_s=audio_s, num_inference_steps=2, eta=0.0,
                               prompt_embeds=torch.zeros(2, 512), measurement=meas,
                               ip_guidance_rate=2.0, latents=lat, output_type="latent",
                               return_losses=True, supervised_space=space)
            out[dev] = (res.audios, losses, kernels.launch_counts())
        (lat_g, loss_g, counts_g), (lat_c, loss_c, counts_c) = out["cuda"], out["cpu"]
        lat_err = float(np.linalg.norm(lat_g - lat_c) / np.linalg.norm(lat_c))
        loss_err = float(np.abs(loss_g - loss_c).max() / np.abs(loss_c).max())
        log(f"reference (fp32, small model, 2 DPS steps, {space} loss): losses card "
            f"{loss_g.tolist()} vs cpu {loss_c.tolist()} (rel {loss_err:.2e}, tol "
            f"{REF_LOSS_TOL:.0e}); final latents norm-rel {lat_err:.2e} (tol {lat_tol:.0e}); "
            f"card launches {counts_g}")
        if not all(v > 0 for v in counts_g.values()) or any(counts_c.values()):
            raise AssertionError("the card run must launch every kernel, the CPU run none")
        if loss_err > REF_LOSS_TOL or lat_err > lat_tol:
            raise AssertionError("the card's pipeline disagrees with the CPU reference")


def phase_slice() -> dict:
    from diffmusic_tpu_torch import kernels
    from diffmusic_tpu_torch.models.configs import HiFiGANConfig, UNetConfig, VAEConfig
    t0 = time.time()
    pipe, meas = build_pipe(UNetConfig(), VAEConfig(), HiFiGANConfig(), 10.0, "cuda",
                            torch.bfloat16)
    log(f"slice: full-width MusicLDM, seeded random bf16 weights, built in "
        f"{time.time() - t0:.1f} s")
    lat = torch.randn((1, 8, 250, 16), generator=torch.Generator().manual_seed(0))
    stamps = []

    def on_step(i, t, x):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    start = time.perf_counter()
    out, losses = pipe(audio_length_in_s=10.0, num_inference_steps=STEPS, eta=0.0,
                       prompt_embeds=torch.zeros(2, 512), measurement=meas,
                       ip_guidance_rate=2.0, latents=lat, return_losses=True,
                       callback=on_step)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    step_ms = [1e3 * (b - a) for a, b in zip([start] + stamps[:-1], stamps)]
    peak = torch.cuda.max_memory_allocated()
    audio = out.audios
    q1, med, q3 = statistics.quantiles(step_ms[1:], n=4)
    log(f"slice: DPS {STEPS} steps, eta 0, rate 2.0, latents (1, 8, 250, 16); "
        f"loss first {losses[0]:.4f} last {losses[-1]:.4f}; "
        f"ms/guided step after the first: median {med:.2f}, quartiles {q1:.2f}/{q3:.2f} "
        f"(first {step_ms[0]:.1f}); peak memory {peak / 2**30:.2f} GiB; "
        f"audio {audio.shape}")
    log(f"slice: launches {counts}")
    if not np.isfinite(losses).all() or not np.isfinite(audio).all():
        raise AssertionError("the slice produced non-finite losses or audio")
    if audio.shape != (1, 160000):
        raise AssertionError(f"audio shape {audio.shape}, expected (1, 160000)")
    for name, per_step in PER_STEP.items():
        # the vocoder kernels run once more in the final decode
        want = per_step * (STEPS + (name != "fused_transformer_block"))
        if counts[name] != want:
            raise AssertionError(f"{name}: {counts[name]} launches, expected {want}")
    return counts, pipe, meas


def phase_breakdown(pipe, meas, lat_shape, profile_dir=None) -> None:
    """Where one guided step's time goes at the slice's shapes: each stage of
    the step alone (median ms from CUDA events), then optionally a
    torch.profiler table of two guided steps, written to `profile_dir`."""
    from diffmusic_tpu_torch.pipelines.musicldm import per_clip_loss
    dev = pipe.device
    gen = torch.Generator().manual_seed(1)
    x = randn(lat_shape, gen, dev, torch.float32)
    embeds = torch.zeros(1, 512, device=dev)
    owl = meas.shape[-1]
    target = pipe.operator.transform(meas)
    with torch.no_grad():
        mel = pipe.decode_mel(x)
        audio = pipe.mel_to_waveform(mel)
    g_mel = torch.randn(mel.shape, generator=gen).to(dev, mel.dtype)
    g_audio = torch.randn(audio.shape, generator=gen).to(dev, audio.dtype)

    def unet():
        with torch.no_grad():
            pipe._eps(embeds, x, 501, 1.0)

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
    # one call per timing: a stage's latency inside the step, host dispatch included
    times = {name: time_ms(fn, reps=5, inner=1, warmup=1) for name, fn in parts.items()}
    log("breakdown of one guided step (median ms, CUDA events): " +
        "; ".join(f"{k} {v:.2f}" for k, v in times.items()) +
        f"; sum {sum(times.values()):.2f}")
    if profile_dir is None:
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    profile_dir.mkdir(parents=True, exist_ok=True)
    lat = randn(lat_shape, gen, dev, torch.float32)
    kw = dict(audio_length_in_s=owl / 16000, num_inference_steps=2, eta=0.0,
              prompt_embeds=torch.zeros(2, 512), measurement=meas, ip_guidance_rate=2.0,
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
    (profile_dir / "profile.txt").write_text(table)
    log(f"profile of 2 guided steps: kernel time {dev_us / 1e3:.1f} ms; wall "
        f"{1e3 * wall:.1f} ms untraced, {1e3 * traced:.1f} ms traced; device busy share "
        f"{dev_us / 1e6 / wall:.3f} of the untraced wall; table in "
        f"{profile_dir / 'profile.txt'}")
    for line in table.splitlines()[:18]:
        log(f"  {line}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the build log and the profile (optional)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile two guided steps with torch.profiler (needs --out)")
    args = ap.parse_args()
    if args.profile and args.out is None:
        ap.error("--profile needs --out")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
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

    gen = torch.Generator().manual_seed(0)
    stats = phase_kernels(gen)
    phase_reference()
    counts, pipe, meas = phase_slice()
    phase_breakdown(pipe, meas, (1, 8, 250, 16), args.out if args.profile else None)

    kernels_line = [{"name": n, "route": "cuda", "source": SOURCES[n],
                     "replaces": REPLACES[n], "launches": counts[n],
                     "max_abs_err": stats[n]["max_abs_err"],
                     "ms": stats[n]["ms"], "plain_ms": stats[n]["plain_ms"]}
                    for n in REPLACES]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
