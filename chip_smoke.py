"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR [--profile]]

Phases, in order; any failure raises and the script exits non-zero:
  1. device: a CUDA device must be present; prints its nvidia-smi name and
     power limit;
  2. build: compiles the kernels from `diffmusic_tpu_torch/kernels/csrc` with
     nvcc (sm_90a), one process per source, and prints the seconds taken,
     each kernel's registers, spills and shared memory from ptxas and any
     warning that ptxas serialised a kernel's wgmma (C75xx); fails if the
     head_dim 32-512 flash kernel spills or draws such a warning;
  3. kernels: each kernel's wrapper against its plain PyTorch version, on the
     card, at every shape the 10-s MusicLDM and AudioLDM2 slices give it
     (bf16; the guided step's route kernels at the geometries of its UNet,
     VAE decoder and vocoder; the vocoder's canvas conv, forward and adjoint,
     at every resblock conv of stages 0-2, the canvas pair at every pair,
     the stage backward at stage 2, the bounded-softmax block in both
     modes; flash attention also at the VAE mid-block's (1, 4000, 1, 512)
     with its gradient, the times of its backward in both forms, the
     TFLOP/s the kernel issues and does useful work at, its key splits and
     grid as the library plans the launch (held against the Python rule the
     CPU emulation follows); the adjoint routes: the conv2d kernel on the
     cotangent at each routed VAE conv, the conv1d kernel's adjoint mode at
     the vocoder's 6 single convs), plus small fp32 cases with TF32 off (among
     them flash attention at (1, 1024, 1, 512) and (1, 512, 1, 32) and each
     adjoint route), and the block in each mode
     at the tiny configs' 16 and 32 channels (padded to one 64-channel
     slice) in fp32 and bf16; the fused mel spectrogram
     in fp32 at the eval's MFCC geometry, the default geometry, an odd
     length, a batch shape and power 1, and on its dense path (a prime
     n_fft) with each epilogue and mel width; forward and, where the
     kernel has a backward, the input gradient; canvas outputs exactly zero
     outside the signal; median times of the kernel, its plain version and
     the one PyTorch call that computes the same function where there is
     one, from CUDA events, beside the bound the shapes give (bytes over
     device memory rate, operations over peak rate; for the fused blocks
     also their exponentials, one exp2 per logit at EXP2_PER_CLOCK per SM
     at the SM clock nvidia-smi reads); for the upsampler, the masks, the
     fused GroupNorm (against F.group_norm, in turns), the channel moments
     at every geometry, the conv1d pair at one geometry of each vocoder
     stage, the single conv at ch512 k11, the canvas conv forward and
     adjoint at one geometry a stage, the stage backward and the fused block
     at both UNet levels (against their plain versions) also each call's
     device time (torch.profiler) and host time, the masks with g in
     both layouts, and the layout of the adjoint conv's output that the
     mask route hands them; the mel kernel's device and host time in turns
     with its plain version and the cuFFT composition; the plan of each
     fused GroupNorm call (cluster size, threads, loads) and of each mel
     geometry (its path, split and frames a tile);
  4. reference: small fp32 MusicLDM and AudioLDM2 models (the latter from a
     text prompt, under classifier-free guidance, on both UNet routes), a
     small fp32 MusicLDM with the guided step's routes on (`gn_mode`
     "stats", then "fused"; conv2d and mask kernels) and under each newer
     route (the vocoder's canvas "xbwd" and "kernel", its stage route, the
     bounded softmax, the VAE mid-block's flash attention, the vocoder's
     adjoint kernel, the conv2d kernel in the backward), through the whole
     DPS pipeline on the card (kernels) and on the CPU (plain versions),
     which must agree;
  5. slice: full-width MusicLDM with seeded random bf16 weights, 20 DPS
     steps inpainting a 10-s clip (box mask at 4-6 s) through
     `MusicLDMPipeline.__call__`, with the launch counts of every kernel, on
     the default route and on each route setting (TURN_ROUTES), each once
     in each direction of TURNS (one card, one host: the turns keep the
     host's drift out of the comparison), the VAE mid-block's flash route
     (`vae_mid_attn="flash"`) and the two adjoint routes (`conv2d_bwd=
     "kernel"`, the vocoder's `adjoint_kernel`) once;
  6. breakdown: each stage of one guided step timed alone at the slice's
     shapes, for the default route and each route setting (the vocoder
     alone for its routes, the UNet alone for bsoft, the VAE alone for its
     flash and conv2d adjoint routes); with --profile also a
     torch.profiler table of two guided steps and the device busy share,
     written to --out;
  7. audioldm2: full-width AudioLDM2 (cvssp/audioldm2-music widths) with
     seeded random bf16 weights, the empty prompt through the whole text
     stack (CLAP, T5, projection, GPT-2), the same 20 DPS steps through
     `AudioLDM2Pipeline.__call__`, once on each UNet route: `fuse_cross` off
     (flash attention, the JAX default), on (the dual-cross block), and on
     with the bounded softmax; then its per-stage breakdown;
  8. tasks reference: the small fp32 MusicLDM of phase 4, 2 steps at eta 1
     with the waveform loss, card against CPU from one CPU generator: MPGD
     and DSG on box inpainting, DiffMusic on each task (super-resolution,
     phase retrieval, dereverberation, random and periodic masks, the
     latter's measurement under Poisson noise);
  9. tasks: full-width MusicLDM with seeded random bf16 weights on the
     default route, 20 steps each through `MusicLDMPipeline.__call__`: MPGD,
     DSG and DiffMusic (configs/*.yaml's eta and rate) on the slice's box
     inpainting, then DiffMusic on each task with run.py's settings, phase
     retrieval with its phase-aware output (which must not move
     |STFT(output)| away from the measurement); each run's launches are the
     default DPS route's; ms per step, quartiles, peak memory; the
     dereverberation filter alone, forward and backward, with TF32 off and on;
  10. DITTO and optim_prompt reference: the small fp32 models of phase 4,
     card against CPU from one CPU generator, the waveform loss: DITTO, 2
     steps x 2 outer iterations at eta 1, on the default route and with
     gn_mode "fused", "stats" and the conv2d kernel alone (every step's UNet
     under a checkpoint, so the route kernels run in the forward and the
     recompute); DPS with optim_prompt, 4 steps, on MusicLDM and on AudioLDM2
     (text prompt, CFG 3.5) with fuse_cross off and on; and each bound
     against its planted fault, which it must fail: the DITTO gradient with
     eps detached inside the checkpointed body, optim_prompt's latents with
     the embedding step lost (lr 0);
  11. DITTO and optim_prompt at full width (seeded random bf16 weights, the
     default route, the slice's box inpainting): DITTO, 20 steps x 3 outer
     iterations at ditto.yaml's eta 1 and rate 0.5, through
     `MusicLDMPipeline.__call__` (seconds per outer iteration, peak memory,
     the losses, the launches: each step's UNet forward twice, the loss
     head once an iteration) and one iteration split into the chain
     forward, the loss head and the rest; then 20 DPS steps without and with
     optim_prompt (7 embedding steps) on MusicLDM and on AudioLDM2
     (fuse_cross on), ms per step and launches;
  12. clap: the CLAP audio tower (HTSAT), style guidance, CLAP prompts and
     re-ranking, AudioLDM2's VITS stream (no kernel of their own). First the
     small fp32 reference, card against CPU, each bound failing its planted
     fault: the tiny tower's pooled and frame embeddings (F.interpolate in
     place of JAX's bicubic resize), the style loss's gradient with respect
     to the waveform (the gram divided by D, not T'), 3 DiffMusic steps of
     the tiny MusicLDM under style guidance, the tiny AudioLDM2's
     encode_prompt with prompt_type "clap" and, in its TTS variant, with a
     transcription (VITS without its relative-position terms), and
     score_waveforms' order on 4 candidates (the top-dB clamp per clip).
     Then at full width with seeded random weights: MusicLDM (bf16, JAX's
     default routes) under style guidance with the tower at
     ClapAudioConfig's defaults (fp32), 20 DiffMusic steps at diffmusic.yaml's
     eta and rate (ms per step, peak memory, launches the default route's),
     the loss head's forward+backward split into the CLAP features, the
     tower and the rest; AudioLDM2 from the measurement's CLAP embedding,
     fuse_cross off and on; score_waveforms on 4 ten-second candidates on
     both; AudioLDM2-TTS (VITS at VitsConfig's defaults) from a fixed id
     sequence;
  13. stable_audio: StableAudio (the Oobleck VAE, the rotary-GQA DiT, EDM
     DPM-Solver++ 2M; no kernel of its own). First the tiny fp32 pipeline
     on the card and on the CPU with the same weights, each bound failing
     its planted faults: the DiT forward (KV heads tiled, rope on every
     channel), Oobleck's encode and decode (the snake's scales read as
     linear), 10 EDM steps at CFG 7 of 3 waveforms with the decoded audio
     (the CFG conditioning tiled, a second-order first step). Then
     stable-audio-open-1.0's widths with seeded random bf16 weights drawn on
     the card at stable_audio.yaml's settings (10 s, 3 waveforms, CFG 7, the
     empty prompt padded to 512 T5 tokens), 20 of its 200 EDM steps: ms per
     step, the text stack's seconds, Oobleck's decode of the 3 clips, peak
     memory, finite audio (3, 2, 441000); then `diffmusic_tpu_torch.run -m
     stable_audio -t music_generation --tiny` on the card; the launch counts
     must not move across the phase;
  14. checkpoint and CLI: a full-width MusicLDM snapshot (fp32, seeded, the
     diffusers layout of `tests/test_torch_port_snapshot.py`, its CLAP model
     with the audio tower) in a temporary directory, loaded by
     `MusicLDMPipeline.from_pretrained` on the card (seconds, MB/s), its
     weights, the tower's (fp32) and its embedding, and its output after 2
     DPS steps equal to the bit to those of the same weights handed over in
     memory; then `diffmusic_tpu_torch.run.main --tiny` on the card for -c
     dps, ditto and diffmusic x -m musicldm and audioldm2, 2 steps each, on a
     written WAV, and -t style_guidance, --prompt_type clap, -nw 2 (its
     re-ranking logged) and --transcription, each with its UNet launches
     checked (`cli_launches`: the tiny configs' 16- and 32-channel blocks
     take the block kernel padded to one slice); the snapshot carries a
     small RoBERTa tokenizer (vocab.json, merges.txt) written here, which the
     port's own reader encodes a prompt with (the line says whether
     transformers is importable; the reader does not use it), as it does a
     T5 tokenizer.json;
  15. eval: in a temporary directory, EVAL_PAIRS pairs of 10-s clips (pair 0
     the slice's ground truth and the audio its default turn restored; two
     pairs as 44.1-kHz stereo) and a seeded random torchvggish-layout
     `vggish.pth`, scored by `diffmusic_tpu_torch.eval.main` on the card with
     --embedding mfcc-stack vggish --fad_inf --individual from cold caches:
     finite scores, one CSV row per pair, the mel kernel's launches, the
     wall seconds and their split, peak memory; then 4 of the pairs on the
     card and on the CPU, whose scores and cached embeddings must agree; the
     fadtk command lines on fresh copies of those 4 pairs on the card
     (`fadtk`'s FAD and FAD-inf equal to the eval's, `fadtk.embeds` with 2
     spawn workers, `fadtk.package`'s bundle as a baseline, `fadtk.test`'s
     golden gate exiting 0); and the clap-laion embedder on them from a CLAP
     directory (the tower at ClapAudioConfig's defaults), card against CPU;
  16. eval_embedders: the eval's wav2vec2 / HuBERT / WavLM, Whisper and
     EnCodec embedders (no kernel of their own; TF32 off). First tiny fp32
     models of each family with seeded weights, card against CPU, each
     bound failing its planted fault (the pre-LN encoder's last state taken
     before its LayerNorm, WavLM's gated bias handed on, Whisper's frames
     shifted by one, EnCodec's causal padding split); then w2v2-base,
     WavLM-large, Whisper-large's encoder and EnCodec 24 kHz at their
     published widths with seeded random fp32 weights, through the loaders'
     `get_embedding` on one 10-s clip: parameters, ms per clip, peak memory,
     the embedding's shape, finite;
  17. mesh: the device mesh (`diffmusic_tpu_torch/parallel`). The slice's
     full-width MusicLDM with num_waveforms_per_prompt 2, STEPS DPS steps at
     MESH_RATE with the waveform loss, in bf16 through `make_mesh(1)` (the
     path of --mesh dp=1), and at batch 1: ms per step, peak memory, every run's
     launches those of a batch-1 slice turn; each kernel of the route at
     batch 2 against its rows alone; in fp32 (MESH_FP32_STEPS steps), each
     clip of the batch against its own batch-1 run within MESH_CLIP_TOL,
     which the planted joint norm must exceed (bf16's batch-dependent
     rounding in the plain ops would hide it); the eval of EVAL_PAIRS pairs
     with mfcc-stack per file and with --mesh dp=1 (each equal-length group
     in one batched call): seconds, mel launches (`eval_mel_launches`),
     caches within MESH_CACHE_TOL; the CLI's --tiny run with --mesh dp=1 on
     the card; where two cards are visible, dp=2 across them over NCCL
     (`parallel.launch`) against the one-card fp32 batch-2 run, else a line
     saying it was not run.
Then the command's total seconds, the card's nvidia-smi name and power limit,
a JSON line with one entry
per kernel (the masks' entries time g as h, and give the route's form, g
transposed, under "g_transposed"), and last {"ok": true, "device": {...}}.
No JAX is imported.
"""

import argparse
import contextlib
import copy
import csv
import dataclasses
import io
import json
import math
import os
import re
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
SMS = 132             # streaming multiprocessors
EXP2_PER_CLOCK = 16   # exp2 results per clock per SM (the MUFU)

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
    # the same flash function at the VAE mid-block's head width (D = 512)
    "flash_attention_d512": "diffmusic_tpu/pallas/attention_kernel.py:74",
    # the conv2d kernel on the cotangent (DIFFMUSIC_TPU_CONV2D_BWD=pallas)
    "conv2d_same_adjoint": "diffmusic_tpu/pallas/conv2d_kernel.py:190",
    # the single conv on the cotangent with with_adjoint_weights' w_adj
    "conv1d_fused_adjoint": "diffmusic_tpu/pallas/conv1d_kernel.py:224",
}
# the launch counters: every entry of the kernels line but the flash kernel's
# head_dim-512 form, whose launches count under "flash_attention"
COUNTERS = tuple(n for n in REPLACES if n != "flash_attention_d512")
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
    "flash_attention_d512": "diffmusic_tpu_torch/kernels/csrc/flash_attention.cu",
    "conv2d_same_adjoint": "diffmusic_tpu_torch/kernels/csrc/conv2d.cu",
    "conv1d_fused_adjoint": "diffmusic_tpu_torch/kernels/csrc/conv1d.cu",
}
# launches per guided step of the 10-s slices (UNet levels 0/1: 2 down + 3 up
# blocks each; vocoder: 24 pairs, the 6 ch512 k=11 convs, upsamplers 0-2).
# MusicLDM's blocks are self-attention only; AudioLDM2's are dual-cross, and
# take flash attention or, with fuse_cross, the dual-cross block.
# The vocoder's routes, by the names of the slice's turns, and their launches
# per vocoder forward and per backward (stages 0-2 on the canvas: "xbwd" runs
# the 24 pairs and the 6 ch512 k=11 convs there with plain backwards,
# "kernel" all 54 convs both ways, "stage" stage 2's 9 pairs inside the stage
# route and its backward as one launch; "adjoint", the default forward with
# the 6 ch512 k=11 convs' adjoints on the kernel's adjoint mode).
# (tests/test_torch_port_canvas.py derives these from the models on the CPU.)
VOCODER_ROUTES = {"default": {}, "xbwd": {"canvas": "xbwd"}, "kernel": {"canvas": "kernel"},
                  "stage": {"canvas": "xbwd", "stage_bwd": True},
                  "adjoint": {"adjoint_kernel": True}}
VOCODER_LAUNCHES = {
    "default": ({"conv1d_fused_pair": 24, "conv1d_fused": 6, "phase_convtranspose": 3}, {}),
    "xbwd": ({"conv1d_pair_canvas": 24, "conv1d_fused_canvas": 6, "phase_convtranspose": 3}, {}),
    "kernel": ({"conv1d_fused_canvas": 54, "phase_convtranspose": 3},
               {"conv1d_fused_canvas": 54}),
    "stage": ({"conv1d_pair_canvas": 24, "conv1d_fused_canvas": 6, "phase_convtranspose": 3},
              {"stage_resblocks_canvas": 1}),
    "adjoint": ({"conv1d_fused_pair": 24, "conv1d_fused": 6, "phase_convtranspose": 3},
                {"conv1d_fused_adjoint": 6}),
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
# With `conv2d_bwd="kernel"` the VAE's backward launches the conv2d kernel's
# adjoint once for each of its 24 routed convs, every guided step (the UNet
# runs under no-grad); with `vae_mid_attn="flash"` each VAE decode launches
# the flash kernel once, at (1, 4000, 1, 512).
# (tests/test_torch_port_vae_mid_attn.py derives both from the model on the CPU.)
VAE_ADJOINTS_PER_STEP = ROUTE_LAUNCHES["vae"]["stats"]["conv2d_same"]
# mask launches per guided step (the vocoder backward): stages 0-2 meet
# mask_ok; each of the 24 pairs masks dh and dx, each of the 6 single convs x
MASKS_PER_STEP = {"leaky_mask": 30, "leaky_mask_add": 24}
ROUTE_KERNELS = ("fused_group_norm", "channel_moments", "conv2d_same", "leaky_mask",
                 "leaky_mask_add")
LATENTS = (1, 8, 250, 16)   # the 10-s slice's latents
# (Cin, Cout, k, stride, t_in) of the 10-s slice's upsamplers 0-2
UPSAMPLERS = ((1024, 512, 16, 5, 1000), (512, 256, 16, 4, 5001), (256, 128, 8, 2, 20004))
# The eval phase: EVAL_PAIRS pairs of 10-s clips through the port's eval
# with --embedding mfcc-stack vggish --fad_inf --individual.
EVAL_PAIRS = 64


def eval_mel_launches(n_pairs: int, groups=None) -> int:
    """fused_mel_spectrogram launches of one such eval from cold caches, with
    mfcc-stack first: the mfcc-stack FAD caches embed each gt and recon clip
    once (2 n), KL re-embeds each with the first model (2 n); --fad_inf and
    --individual read the caches, and VGGish computes its own numpy log-mel.
    With --mesh, `groups` gives the number of equal-length groups of files
    in gt and in recon: the caches then embed each group in one call.
    (tests/test_torch_port_eval.py and test_torch_port_mesh.py count them on
    the CPU.)"""
    return (2 * n_pairs if groups is None else sum(groups)) + 2 * n_pairs


LOG_FILE = None   # with --out, every line also goes to OUT_DIR/chip_smoke.log
CARD = ""         # nvidia-smi's name and power limit, beside the phases' own numbers


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


def split_ms(fns: dict, n: int = 20, reps: int = 7) -> dict:
    """name -> (device ms, host ms) per call of each fn(): the device time is
    the self CUDA time of every kernel it launches, from torch.profiler over
    n calls; the host time the median over `reps` windows of n calls issued
    back to back after a synchronize (the card's queue does not fill, so the
    host never waits for it), the functions taking turns window by window so
    that the host's drift falls on each alike."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    host = {name: [] for name in fns}
    for fn in fns.values():
        for _ in range(3):
            fn()
    for _ in range(reps):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            host[name].append((time.perf_counter() - t0) / n)
    out = {}
    for name, fn in fns.items():
        dev_us = 0.0
        for _ in range(3):   # now and then a trace holds no device events: trace again
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
            if dev_us > 0:
                break
        # nan: not measured (no trace of the three held a device event)
        out[name] = (dev_us / 1e3 / n if dev_us > 0 else float("nan"),
                     1e3 * statistics.median(host[name]))
    return out


def describe_split(split: dict) -> str:
    return "; ".join(f"{name} device {d:.4f} host {h:.4f} ms/call"
                     for name, (d, h) in split.items())


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


# (T, C, k, dilation) of one pair per vocoder stage, and of the single conv,
# whose device and host time per call `check_conv` also reads (split_ms),
# beside the plain version's
PAIR_SPLITS = ((5001, 512, 3, 1), (20004, 256, 11, 1), (40008, 128, 3, 1))
SINGLE_SPLITS = ((5001, 512, 11, 1),)


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
    split = ""
    splits = PAIR_SPLITS if name == "conv1d_fused_pair" else SINGLE_SPLITS
    if dtype == torch.bfloat16 and (shape[1], c, k, d) in splits and not residual:
        with torch.no_grad():
            split = "; " + describe_split(split_ms({"kernel": lambda: kern(x),
                                                    "plain": lambda: plain(x)}))
    log(f"  {name:24s} x{shape} k{k} d{d}{' +res' if residual else ''} {str(dtype)[6:]}: "
        f"{describe(fwd, bwd, tol)}; {describe_times(res)}{split}")
    if fwd[1] > tol or bwd[2] > tol:
        raise AssertionError(f"{name} disagrees with its plain version")
    return res


def check_conv1d_adjoint(shape, k, d, dtype, gen, tol):
    """The vocoder's adjoint_kernel route: conv1d_fused's input gradient with
    the adjoint on the kernel's adjoint mode against the plain version's (by
    norm: the leaky mask), and the adjoint launch alone against the plain
    adjoint (`_adjoint`) on the same cotangent, whose error the result
    carries, timed beside it and F.conv_transpose1d, the one library call."""
    from diffmusic_tpu_torch.kernels import conv1d as K
    dev = "cuda"
    c = shape[-1]
    x = randn(shape, gen, dev, dtype)
    w = randn((k, c, c), gen, dev, dtype, 1.0 / math.sqrt(k * c))
    b = randn((c,), gen, dev, dtype, 0.1)
    g = randn(shape, gen, dev, dtype)
    fwd, bwd = compare_with_grad(
        lambda xx: K.conv1d_fused(xx, w, b, None, d, SLOPE, adjoint_kernel=True),
        lambda xx: K.conv1d_plain(xx, w, b, d, SLOPE), x, g)
    pad = (k - 1) * d // 2
    w_ct = w.permute(2, 1, 0).contiguous()                  # (Cout, Cin, k)
    kern = lambda gg: K._launch_fused(gg, w, None, None, d, None, adjoint=True)
    plain = lambda gg: K._adjoint(gg, w, d)
    library = lambda gg: F.conv_transpose1d(gg.transpose(1, 2), w_ct, padding=pad, dilation=d)
    with torch.no_grad():
        err = rel_err(kern(g), plain(g))
        torch.cuda.synchronize()
    size, rows = x.element_size(), shape[0] * shape[1]
    res = result(err[0], timings(kern, plain, g, dtype, library),
                 bound(size * (2 * rows * c + k * c * c), 2 * rows * k * c * c))
    log(f"  conv1d_fused_adjoint     g{shape} k{k} d{d} {str(dtype)[6:]}: adjoint max|err| "
        f"{err[0]:.3e} rel {err[1]:.2e}; {describe(fwd, bwd, tol)}; {describe_times(res)}")
    if err[1] > tol or bwd[2] > tol:
        raise AssertionError("conv1d_fused_adjoint disagrees with the plain adjoint")
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
    split = ""
    if dtype == torch.bfloat16:
        xl = F.leaky_relu(x, SLOPE)
        with torch.no_grad():
            split = "; " + describe_split(split_ms({
                "kernel": lambda: U.phase_convtranspose(xl, w, b, s, k, t_out),
                "library": lambda: library(xl)}))
    log(f"  phase_convtranspose      {t_in}->{t_out} {cin}->{cout} k{k} s{s} "
        f"{str(dtype)[6:]}: {describe(fwd, bwd, tol)}; {describe_times(res)}{split}")
    if fwd[1] > tol or bwd[2] > tol:
        raise AssertionError("phase_convtranspose disagrees with its plain version")
    return res


def check_block(t, c, dtype, gen, tol, cross=False, bsoft=False, amp=1.0):
    """The fused block at (1, t, c), 8-dim heads; with `cross`, in the
    dual-cross mode with AudioLDM2's two streams: 8 GPT-2 states of 768,
    unmasked, and 12 T5 tokens of 1024 whose last 7 are masked; with `bsoft`,
    in the bounded-softmax mode, against the plain version in that mode.
    `amp` scales x and the LayerNorm scale (so the logits grow by amp^2 and
    the bound grows slack). In bf16 the bound's operations are the larger of
    the tensor-core work and the exponentials, one exp2 per logit at
    EXP2_PER_CLOCK per clock per SM at the SM clock nvidia-smi reads right
    after the timing; at amp 1 also the device and host time per call
    (split_ms) beside the plain block's."""
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
    times = timings(lambda _: kern(), lambda _: plain(), None, dtype)
    bnd, floor, split = bound(nbytes, ops), "", ""
    if dtype == torch.bfloat16:
        # one exp2 per logit: t keys of the self-attention and the streams'
        # keys per query row and head, at the clock right after the timing
        exps = t * (t + sum(a.shape[1] for a in contexts)) * heads / (EXP2_PER_CLOCK * SMS)
        cur, top = sm_clock_mhz()
        exp2_ms = exps / (cur * 1e3)
        bnd = (bnd[0], max(bnd[1], exp2_ms))
        floor = (f"; exp2 floor {exp2_ms:.4f} ms at {cur:.0f} MHz "
                 f"({exps / (top * 1e3):.4f} at {top:.0f})")
        if amp == 1.0:
            with torch.no_grad():
                split = "; " + describe_split(split_ms({"kernel": kern, "plain": plain}))
    res = result(err[0], times, bnd)
    name = ("fused_transformer_block_bsoft" if bsoft else
            "fused_transformer_block_cross" if cross else "fused_transformer_block")
    mode = " +cross" if bsoft and cross else ""
    log(f"  {name:24s} (1, {t}, {c}) heads {heads}{mode} amp {amp:g} {str(dtype)[6:]}: "
        f"max|err| {err[0]:.3e} rel {err[1]:.2e} (tol {tol:.0e}); {describe_times(res)}"
        f"{floor}{split}")
    if err[1] > tol:
        raise AssertionError(f"{name} disagrees with its plain version")
    return res


def sm_clock_mhz() -> tuple:
    """(current, max) SM clock in MHz as nvidia-smi reads them now."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    cur, top = (float(v) for v in out.split(","))
    return cur, top


def wide_flash_work(b, t, heads, d) -> dict:
    """The bf16 head_dim 32-512 kernel's launch at (b, t, heads, d) on this
    card as the library plans it (`attention.wide_launch_plan`, the plan the
    launch takes): its key splits and grid, and the FLOPs that grid issues
    (QK^T and PV over its query tiles, whole key chunks and the channels D is
    rounded up to, S once) beside the 4 t^2 heads d the function needs. Fails
    if the plan differs from the Python rule the CPU emulation follows
    (`attention.wide_splits` and the WIDE_* constants)."""
    from diffmusic_tpu_torch.kernels import attention as A
    plan = A.wide_launch_plan(b, t, heads, d)
    tiles, bh, splits = plan["grid"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = {"grid": (-(-t // A.WIDE_ROWS), b * heads, A.wide_splits(b, t, heads, sms)),
            "rows": A.WIDE_ROWS, "keys": A.WIDE_KEY_CHUNK, "channels": -(-d // 128) * 128}
    if plan != want:
        raise AssertionError(f"flash_attention: the library plans {plan}, the Python rule {want}")
    return {"splits": splits, "grid": plan["grid"],
            "useful_flops": 4 * b * heads * t * t * d,
            "issued_flops": 4 * bh * tiles * plan["rows"] * -(-t // plan["keys"]) * plan["keys"]
            * plan["channels"]}


def check_flash(t, heads, dtype, gen, tol, d=8, grad=False):
    """Flash attention over (1, t, heads, d) q, k, v of unit variance, beside
    F.scaled_dot_product_attention on the same tensors (as (B, H, T, d)
    views). With `grad` also the gradient with respect to q through the
    kernel's backward (a plain recompute) against the plain attention's, and
    the times of the backward in both forms (`bwd="f32"` and `"bf16"`, the
    gradients of q, k and v as the VAE route takes them). bf16 also prints
    the exponentials' floor: t^2 * heads exp2 at EXP2_PER_CLOCK per clock per
    SM, at the SM clock nvidia-smi reads right after the timing (and at the
    card's maximum); the bound is unchanged. At d > 8 in bf16 also the TFLOP/s
    the kernel issues and does useful work at, its key splits and its grid."""
    from diffmusic_tpu_torch.kernels import attention as A
    q, k, v = (randn((1, t, heads, d), gen, "cuda", dtype) for _ in range(3))
    with torch.no_grad():
        out, ref = A.flash_attention(q, k, v), A.attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = rel_err(out, ref)
    gtxt = ""
    if grad:
        g = randn(q.shape, gen, "cuda", dtype)
        fwd, bwd = compare_with_grad(lambda qq: A.flash_attention(qq, k, v),
                                     lambda qq: A.attention_plain(qq, k, v), q, g)
        err = max(err, fwd, key=lambda e: e[1])
        gtxt = (f"; grad max|err| {bwd[0]:.3e} rel {bwd[1]:.2e} norm-rel {bwd[2]:.2e}")
    sdpa = lambda _: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                    v.transpose(1, 2))
    times = timings(lambda _: A.flash_attention(q, k, v), lambda _: A.attention_plain(q, k, v),
                    None, dtype, sdpa)
    res = result(err[0], times, bound(2 * 4 * t * heads * d, 4 * t * t * heads * d))
    floor = ""
    if dtype == torch.bfloat16:
        exps = t * t * heads / (EXP2_PER_CLOCK * SMS)
        cur, top = sm_clock_mhz()
        res["exp2_floor_ms"] = exps / (cur * 1e3)
        floor = (f"; exp2 floor {res['exp2_floor_ms']:.4f} ms at {cur:.0f} MHz "
                 f"({exps / (top * 1e3):.4f} at {top:.0f})")
        if d > 8:
            work = wide_flash_work(1, t, heads, d)
            res["useful_tflops"] = work["useful_flops"] / res["ms"] / 1e9
            res["issued_tflops"] = work["issued_flops"] / res["ms"] / 1e9
            res["splits"], res["grid"] = work["splits"], work["grid"]
            floor += (f"; {res['useful_tflops']:.1f} TFLOP/s useful, "
                      f"{res['issued_tflops']:.1f} issued ({work['issued_flops'] / 1e9:.2f} "
                      f"GFLOP for {work['useful_flops'] / 1e9:.2f}); {work['splits']} key "
                      f"splits, grid {work['grid']}")
    if grad and dtype == torch.bfloat16:
        qkv = [a.clone().requires_grad_(True) for a in (q, k, v)]
        res["backward_ms"] = {}
        for form in A.FLASH_BWD:
            y = A.flash_attention(*qkv, form)
            res["backward_ms"][form] = time_ms(
                lambda: torch.autograd.grad(y, qkv, g, retain_graph=True))
            del y
        floor += "; backward (q, k, v) " + ", ".join(
            f"bwd={form} {ms:.3f} ms" for form, ms in res["backward_ms"].items())
    log(f"  flash_attention          (1, {t}, {heads}, {d}) {str(dtype)[6:]}: "
        f"max|err| {err[0]:.3e} rel {err[1]:.2e} (tol {tol:.0e}){gtxt}; "
        f"{describe_times(res)}{floor}")
    if err[1] > tol or (grad and bwd[2] > tol):
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


def vae_conv2d_calls() -> Counter:
    """(x shape, weight shape) -> calls per VAE decode of the 3x3 convs that
    meet the conv2d rule: each one's adjoint runs once per guided step under
    conv2d_bwd="kernel"."""
    from diffmusic_tpu_torch.kernels.conv2d import conv2d_ok
    return Counter((xs, ws) for xs, ws in slice_geometries()["vae"]["conv"]
                   if conv2d_ok(torch.empty(xs, device="meta"), torch.empty(ws, device="meta")))


def single_conv_calls() -> Counter:
    """(T, C, k, dilation) -> calls per vocoder forward of `conv1d_fused` at
    the slice (the resblock convs of 128-aligned stages whose pair misses
    pair_ok in bf16: ch512 k=11), each one's adjoint once per guided step
    under adjoint_kernel."""
    from diffmusic_tpu_torch.kernels.conv1d import pair_ok
    calls = Counter()
    for (_, t, c), _, _ in mask_geometries():
        for k, dils in zip(*RESBLOCKS):
            if c % 128 == 0 and not pair_ok(k, c, c, torch.bfloat16):
                for d in dils:
                    calls[(t, c, k, d)] += 1     # convs1, dilated
                    calls[(t, c, k, 1)] += 1     # convs2
    return calls


def check_group_norm(name, shape, eps, silu, dtype, gen, tol):
    """fused_group_norm (with its recompute backward) or channel_moments
    (with its VJP; and the whole stats GroupNorm around it) on an NCHW x of
    `shape`, groups 32, against the plain versions; times beside
    F.group_norm (which has no SiLU) for the fused kernel, none for the
    moments; in bf16 the device and host time per call, in turns with
    F.group_norm or the plain moments."""
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
    plan = ""
    if name == "fused_group_norm":
        vec, k, threads, loads = GN.fused_plan(x.shape, x.stride(), x.dtype, x.device, 32, (
            wt.shape, wt.stride(), wt.dtype, wt.device, bt.shape, bt.stride(), bt.dtype,
            bt.device))[5:]
        plan = f"; plan k {k}, {threads} threads, {loads} loads of {vec}"
    split = ""
    if name == "fused_group_norm" and dtype == torch.bfloat16:
        # in turns with F.group_norm (and, for the +SiLU calls, F.group_norm
        # then F.silu, the same function in two calls)
        fns = {"kernel": lambda: kern(x), "F.group_norm": lambda: library(x)}
        if silu:
            fns["F.group_norm+F.silu"] = lambda: F.silu(library(x))
        with torch.no_grad():
            split = "; " + describe_split(split_ms(fns))
    elif dtype == torch.bfloat16:   # the moments, in turns with their plain version
        with torch.no_grad():
            split = "; " + describe_split(split_ms({"kernel": lambda: kern(x),
                                                    "plain": lambda: plain(x)}))
    log(f"  {name:24s} {shape} eps {eps:g}{' +silu' if silu else ''} {str(dtype)[6:]}: "
        f"{describe(fwd, bwd, tol)}; {describe_times(res)}{plan}{split}")
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


def check_conv2d_adjoint(xshape, wshape, dtype, gen, tol):
    """The conv2d_bwd="kernel" route: the input gradient through the kernel on
    the cotangent against the plain adjoint's, and the adjoint launch alone
    (the cached flipped, channel-swapped weight) against the plain adjoint on
    the same cotangent, whose error the result carries, timed beside it and
    F.conv2d of the cached weight, the one library call."""
    from diffmusic_tpu_torch.kernels import conv2d as C2
    from diffmusic_tpu_torch.kernels import repack
    dev = "cuda"
    b, cin, h, w = xshape
    cout, _, kh, kw = wshape
    x = randn(xshape, gen, dev, dtype)
    wt = randn(wshape, gen, dev, dtype, 1.0 / math.sqrt(kh * kw * cin))
    bias = randn((cout,), gen, dev, dtype, 0.1)
    g = randn((b, cout, h, w), gen, dev, dtype)
    fwd, bwd = compare_with_grad(lambda xx: C2.conv2d_same(xx, wt, bias, "kernel"),
                                 lambda xx: C2.conv2d_plain(xx, wt, bias), x, g)
    wa, taps, zero = repack.cached(C2.ADJOINT, wt, C2.adjoint_operands)
    kern = lambda gg: C2._launch(gg, wa, zero, taps, "conv2d_same_adjoint")
    plain = lambda gg: F.conv2d(gg, C2.adjoint_weight(wt), padding=(kh // 2, kw // 2))
    library = lambda gg: F.conv2d(gg, wa, padding=(kh // 2, kw // 2))
    with torch.no_grad():
        err = rel_err(kern(g), plain(g))
        torch.cuda.synchronize()
    size, m = x.element_size(), b * h * w
    res = result(err[0], timings(kern, plain, g, dtype, library),
                 bound(size * (m * cout + m * cin + cout * cin * kh * kw),
                       2 * m * cout * cin * kh * kw))
    log(f"  conv2d_same_adjoint      g({b}, {cout}, {h}, {w}) w{wshape} {str(dtype)[6:]}: "
        f"adjoint max|err| {err[0]:.3e} rel {err[1]:.2e}; {describe(fwd, bwd, tol)}; "
        f"{describe_times(res)}")
    if err[1] > tol or bwd[2] > tol:
        raise AssertionError("conv2d_same_adjoint disagrees with the plain adjoint")
    return res


def check_mask(name, shape, dtype, gen, tol):
    """leaky_mask or leaky_mask_add against the plain version, with g in each
    layout the kernel takes: as h, and (where C % 8 == 0) as the mask route
    passes it, the transposed view of a contiguous (B, C, T) tensor, which
    is how the adjoint conv leaves it. Times beside aten.leaky_relu_backward
    on the same g (it differs only where h == 0), and for the transposed g
    also beside the copy to (B, T, C) plus that call; leaky_mask_add has no
    one-call counterpart. Returns the result of each form, by form."""
    from diffmusic_tpu_torch.kernels import mask as M
    dev = "cuda"
    b, t, c = shape
    h, g, r = (randn(shape, gen, dev, dtype) for _ in range(3))
    forms = {"g as h": (g, M.G_AS_H)}
    if c % 8 == 0:
        forms["g transposed"] = (randn((b, c, t), gen, dev, dtype).transpose(1, 2),
                                 M.G_TRANSPOSED)
    add = name == "leaky_mask_add"
    n = h.numel()
    bnd = bound(h.element_size() * (3 + add) * n, (2 + add) * n, FP32_FLOPS)
    res = {}
    for form, (gg, want) in forms.items():
        layout = M.launch_plan(name, (h.shape, gg.shape), (h.stride(), gg.stride()),
                               (h.dtype, gg.dtype), (h.device, gg.device))[1]
        if layout != want:
            raise AssertionError(f"{name}: {form} took g layout {layout}, not {want}")
        if add:
            kern = lambda hh, gg=gg: M.leaky_mask_add(hh, gg, r, SLOPE)
            plain = lambda hh, gg=gg: M.leaky_mask_plain(hh, gg, SLOPE, r)
            library = None
        else:
            kern = lambda hh, gg=gg: M.leaky_mask(hh, gg, SLOPE)
            plain = lambda hh, gg=gg: M.leaky_mask_plain(hh, gg, SLOPE)
            library = lambda hh, gg=gg: torch.ops.aten.leaky_relu_backward(gg, hh, SLOPE, False)
        with torch.no_grad():
            out, ref = kern(h), plain(h)
            torch.cuda.synchronize()
            err = rel_err(out, ref)
        res[form] = result(err[0], timings(kern, plain, h, dtype, library), bnd)
        split = ""
        if dtype == torch.bfloat16:
            fns = {"kernel": lambda: kern(h)}
            if library is not None:
                fns["library"] = lambda: library(h)
                if form == "g transposed":
                    fns["copy + library"] = lambda: torch.ops.aten.leaky_relu_backward(
                        gg.contiguous(), h, SLOPE, False)
            with torch.no_grad():
                split = "; " + describe_split(split_ms(fns))
        log(f"  {name:24s} {shape} {form:12s} {str(dtype)[6:]}: max|err| {err[0]:.3e} rel "
            f"{err[1]:.2e} (tol {tol:.0e}); {describe_times(res[form])}{split}")
        if err[1] > tol:
            raise AssertionError(f"{name} with {form} disagrees with its plain version")
    return res


def adjoint_layout(shape, gen) -> None:
    """How the mask route's adjoint conv (bf16, k 3) leaves its output on the
    card: the strides of the (B, T, C) view the masks get and the g layout
    the mask kernel takes for it, and the device and host time of the copy
    to contiguous (B, T, C) that a mask reading g only as h would need first
    (none where the view is contiguous already)."""
    from diffmusic_tpu_torch.kernels import conv1d as K
    from diffmusic_tpu_torch.kernels import mask as M
    c = shape[-1]
    g = randn(shape, gen, "cuda", torch.bfloat16)
    w = randn((3, c, c), gen, "cuda", torch.bfloat16, 1.0 / math.sqrt(3 * c))
    with torch.no_grad():
        v = K._adjoint(g, w, 1, copy=False)
        copy = split_ms({"copy": lambda: v.contiguous()})["copy"]
    layout = M.launch_plan("leaky_mask", (g.shape, v.shape), (g.stride(), v.stride()),
                           (g.dtype, v.dtype), (g.device, v.device))[1]
    log(f"  adjoint conv output {shape}: strides {v.stride()}, contiguous "
        f"{v.is_contiguous()}, mask g layout {layout}; the copy it no longer needs: device "
        f"{copy[0]:.4f} host {copy[1]:.4f} ms/call")


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


# (T, C, k, dilation) of one canvas conv per vocoder stage whose device and
# host time per call, forward and adjoint, `check_canvas_conv` also reads
CANVAS_SPLITS = ((5001, 512, 11, 1), (20004, 256, 11, 1), (40008, 128, 3, 1))


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
        split = ""
        if dtype == torch.bfloat16 and (t, c, k, d) in CANVAS_SPLITS and not residual:
            with torch.no_grad():
                split = "; " + describe_split(split_ms({"kernel": lambda: kern(inp),
                                                        "plain": lambda: plain(inp)}))
        log(f"  conv1d_fused_canvas {label:7s} (1, {t}, {c}) k{k} d{d}"
            f"{' +res' if residual and label == 'fwd' else ''} {str(dtype)[6:]}: max|err| "
            f"{err[0]:.3e} rel {err[1]:.2e} (tol {tol:.0e}), margins 0; "
            f"{describe_times(out[label])}{split}")
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
    stage, its backward (one call: in bf16 the conv core's passes) against
    `stage_bwd_plain` on the same saved tensors (held by norm); times of the
    backward, in bf16 also its device and host time per call."""
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
    split = ""
    if dtype == torch.bfloat16:
        with torch.no_grad():
            split = "; " + describe_split(split_ms({"kernel": lambda: kern(gc),
                                                    "plain": lambda: plain(gc)}, n=5))
    log(f"  stage_resblocks_canvas   (1, {t}, {c}) {str(dtype)[6:]}: forward max|err| "
        f"{fwd[0]:.3e} rel {fwd[1]:.2e}; backward max|err| {bwd[0]:.3e} rel {bwd[1]:.2e} "
        f"norm-rel {bwd[2]:.2e} (tol {tol:.0e}), margins 0; backward {describe_times(res)}"
        f"{split}")
    if fwd[1] > tol or bwd[2] > tol:
        raise AssertionError("stage_resblocks_canvas disagrees with its plain version")
    return res


# ------------------------------------------------------ the eval's mel kernel
MEL_MFCC = dict(n_fft=400, hop_length=160, win_length=400, n_mels=64, sample_rate=16000,
                f_min=125.0, f_max=7500.0)    # the MFCC-stack embedder's geometry
MEL_DEFAULT = dict(n_fft=1024, hop_length=160, win_length=1024, n_mels=64,
                   sample_rate=16000, f_min=0.0, f_max=None)   # the kernel's defaults
MEL_DENSE = dict(MEL_DEFAULT, n_fft=389, win_length=389)   # a prime n_fft: the dense path


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
            # device and host time a call, in turns with the plain version and
            # the cuFFT composition
            split = split_ms({"kernel": lambda: kern(x), "plain": lambda: plain(x),
                              "cuFFT composition": lambda: mel_composition(x, kw)})
        comp = (f"; cuFFT composition {comp_ms:.3f} ms (rel {comp_err[1]:.1e}); "
                f"{describe_split(split)}")
    res = result(err[0], times, bnd)
    plan = M.mel_plan(*M.mel_geometry(**kw), x.device)
    plan = (f"factored {plan[3]} x {plan[4]}, {plan[6]} frames a tile, at most {plan[7]} blocks"
            if plan[0] == "fft" else f"dense, {M.FRAME_TILE} frames a block")
    geometry = "mfcc" if n_fft == 400 else f"n_fft {n_fft}"
    log(f"  fused_mel_spectrogram    {shape} {geometry} hop {kw['hop_length']} mels {n_mels} "
        f"power {power:g} fp32 ({plan}): {desc} (tol {TOL_FP32:.0e})"
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

    def add(name, res, per_step=1, form=None):
        """Sum res into the kernel's line; a second form of its operands
        (`form`) sums its times into an entry of its own."""
        s = stats[name]
        s["max_abs_err"] = max(s["max_abs_err"], res["err"])
        if math.isnan(res["ms"]):
            return
        if form is not None:
            s = s.setdefault(form, {"ms": 0.0, "plain_ms": 0.0, "library_ms": None,
                                    "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0})
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
    floor = 0.0
    for t, c in ((4000, 128), (1000, 256)):
        add("fused_transformer_block", check_block(t, c, bf, gen, TOL_BLOCK_BF16), 5)
        add("fused_transformer_block_cross",
            check_block(t, c, bf, gen, TOL_BLOCK_BF16, cross=True), 5)
        res = check_flash(t, c // 8, bf, gen, TOL_FLASH_BF16)
        add("flash_attention", res, 5)
        floor += 5 * res["exp2_floor_ms"]
    log(f"  flash_attention per guided step (10 calls): {stats['flash_attention']['ms']:.3f} ms "
        f"vs SDPA {stats['flash_attention']['library_ms']:.3f}; exp2 floor {floor:.4f} ms")
    # the VAE mid-block under vae_mid_attn="flash": one call per guided step
    res = check_flash(4000, 1, bf, gen, TOL_FLASH_BF16, d=512, grad=True)
    add("flash_attention_d512", res)
    stats["flash_attention_d512"]["wide"] = {
        key: res[key] for key in ("useful_tflops", "issued_tflops", "splits", "grid",
                                  "backward_ms")}
    for name, shape, k, d, res in conv_cases(bf):
        add(name, check_conv(name, shape, k, d, res, bf, gen, TOL_CONV_BF16))
    for cin, cout, k, s, t_in in UPSAMPLERS:
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
    # the masks' line times g as h, the operands it has always timed; the
    # route's form, g as the adjoint's transposed view, is summed under
    # "g_transposed"
    for name in ("leaky_mask", "leaky_mask_add"):
        for shape, n in sorted(calls[name].items()):
            forms = check_mask(name, shape, bf, gen, TOL_ROUTE_BF16)
            add(name, forms["g as h"], n)
            add(name, forms["g transposed"], n, form="g_transposed")
        parts = []
        for form, s in (("g as h", stats[name]),
                        ("g transposed (the route's)", stats[name]["g_transposed"])):
            lib = "" if s["library_ms"] is None else f" vs {s['library_ms']:.3f}"
            parts.append(f"{form} {s['ms']:.3f} ms{lib}")
        log(f"  {name} per guided step ({sum(calls[name].values())} calls; library "
            f"leaky_relu_backward on the same g): {'; '.join(parts)}")
    for shape in sorted(calls["leaky_mask"]):
        adjoint_layout(shape, gen)
    log("the adjoint routes, bf16 (the line sums each over one guided step of its route: "
        "conv2d_bwd=\"kernel\" at the VAE's routed convs, adjoint_kernel at the vocoder's "
        "single convs):")
    for (xs, ws), n in sorted(vae_conv2d_calls().items()):
        add("conv2d_same_adjoint", check_conv2d_adjoint(xs, ws, bf, gen, TOL_ROUTE_BF16), n)
    for (t, c, k, d), n in sorted(single_conv_calls().items()):
        add("conv1d_fused_adjoint", check_conv1d_adjoint((1, t, c), k, d, bf, gen,
                                                         TOL_CONV_BF16), n)

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
    for t, d in ((1024, 512), (512, 32)):
        add("flash_attention_d512", check_flash(t, 1, f32, gen, TOL_FP32, d=d))
    add("conv2d_same_adjoint", check_conv2d_adjoint((1, 128, 16, 32), (256, 128, 3, 3), f32,
                                                    gen, TOL_FP32))
    add("conv1d_fused_adjoint", check_conv1d_adjoint((2, 300, 128), 11, 5, f32, gen, TOL_FP32))
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
        for res in check_mask(name, shape, f32, gen, TOL_FP32).values():
            add(name, res)
    for k, d, residual in ((11, 5, False), (3, 1, True)):
        for res in check_canvas_conv(1100, 128, k, d, residual, f32, gen, TOL_FP32):
            add("conv1d_fused_canvas", res)
    add("conv1d_pair_canvas", check_pair_canvas(1100, 128, 7, 3, f32, gen, TOL_FP32))
    add("stage_resblocks_canvas", check_stage(700, f32, gen, TOL_FP32))
    for cross, amp in ((False, 1.0), (True, 1.0), (False, 5.0)):
        add("fused_transformer_block_bsoft",
            check_block(600, 128, f32, gen, TOL_FP32, cross=cross, bsoft=True, amp=amp))
    log("the narrow blocks the tiny configs fuse (C 16 and 32, run padded to one 64-channel "
        "slice; checked, not summed):")
    for dt, tol in ((f32, TOL_FP32), (bf, TOL_BLOCK_BF16)):
        for c in (16, 32):
            add("fused_transformer_block", check_block(600, c, dt, gen, tol), 0)
            add("fused_transformer_block_cross", check_block(600, c, dt, gen, tol, cross=True), 0)
            add("fused_transformer_block_bsoft", check_block(600, c, dt, gen, tol, bsoft=True), 0)

    log(f"the eval's fused mel spectrogram, fp32 (the line sums the {EVAL_PAIRS}-pair eval's "
        f"{eval_mel_launches(EVAL_PAIRS)} launches at the per-clip shape (1, 160000)):")
    add("fused_mel_spectrogram", check_mel((1, 160000), MEL_MFCC, gen, timed=True),
        eval_mel_launches(EVAL_PAIRS))
    add("fused_mel_spectrogram", check_mel((64, 160000), MEL_MFCC, gen, timed=True), 0)
    add("fused_mel_spectrogram", check_mel((1, 160000), MEL_DEFAULT, gen, timed=True,
                                           grad=True), 0)
    # every variant the wrapper takes: on the factored path 64 or 128 mels, the
    # power 2, 1 and powf epilogues, an odd length; on the dense path (n_fft
    # 389, prime) 64 or 128 mel columns, float4 or scalar frame reads (hop a
    # multiple of 4 or not) and each epilogue
    for shape, kw, power in (((2, 32123), MEL_DEFAULT, 2.0), ((3, 2, 4000), MEL_DEFAULT, 2.0),
                             ((2, 32123), MEL_MFCC, 1.0),
                             ((2, 32123), dict(MEL_MFCC, hop_length=100), 2.0),
                             ((1, 16000), dict(MEL_DEFAULT, n_mels=128), 2.0),
                             ((2, 16001), dict(MEL_DEFAULT, hop_length=100, n_mels=128), 1.5),
                             ((2, 32123), MEL_DENSE, 2.0), ((2, 16001), MEL_DENSE, 1.0),
                             ((2, 16001), dict(MEL_DENSE, hop_length=100, n_mels=128), 1.5)):
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
# "fused", with the conv2d and mask kernels; "conv2d_bwd", "stats" with the
# conv2d kernel in the backward too), the vocoder's routes, the bounded
# softmax and the VAE mid-block's flash attention
TURN_ROUTES = {"default": {},
               "stats": dict(gn_mode="stats", conv2d_kernel=True, mask_kernel=True),
               "fused": dict(gn_mode="fused", conv2d_kernel=True, mask_kernel=True),
               **{name: r for name, r in VOCODER_ROUTES.items() if name != "default"},
               "bsoft": dict(bsoft=True),
               "vae_flash": dict(vae_mid_attn="flash"),
               "conv2d_bwd": dict(gn_mode="stats", conv2d_kernel=True, mask_kernel=True,
                                  conv2d_bwd="kernel")}


def with_routes(pipe, gn_mode="plain", conv2d_kernel=False, mask_kernel=False, bsoft=False,
                canvas="off", stage_bwd=False, fuse_cross=False, conv2d_bwd="plain",
                vae_mid_attn="plain", adjoint_kernel=False):
    """The pipeline with its UNet, VAE and vocoder rebuilt with the given
    route flags, sharing the pipeline's weight tensors (no copy)."""
    from diffmusic_tpu_torch.models.hifigan import SpeechT5HifiGan
    from diffmusic_tpu_torch.models.unet import UNet2DConditionModel
    from diffmusic_tpu_torch.models.vae import AutoencoderKL
    routes = dict(gn_mode=gn_mode, conv2d_kernel=conv2d_kernel, conv2d_bwd=conv2d_bwd)
    with torch.device("meta"):
        models = dict(unet=UNet2DConditionModel(pipe.unet_cfg, fuse_cross=fuse_cross,
                                                bsoft=bsoft, **routes),
                      vae=AutoencoderKL(pipe.vae_cfg, vae_mid_attn=vae_mid_attn, **routes),
                      vocoder=SpeechT5HifiGan(pipe.vocoder_cfg, mask_kernel=mask_kernel,
                                              canvas=canvas, stage_bwd=stage_bwd,
                                              adjoint_kernel=adjoint_kernel))
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
    want = dict.fromkeys(COUNTERS, 0)
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
                     "bsoft": ("fused_transformer_block_bsoft",),
                     "vae_flash": ("flash_attention",),
                     "adjoint": ("conv1d_fused_adjoint",)}


def phase_reference_new_routes():
    """The small fp32 MusicLDM of `phase_reference` (HiFi-GAN at full width
    with resblocks (3, 7): stage 2 is ch128 at T 2560 on a canvas of 7
    blocks, and meets the stage rule in fp32; its ch512 k=7 convs take
    conv1d_fused in fp32), 2 DPS steps with the waveform loss, card against
    CPU, under each new route: the vocoder's canvas "xbwd", "kernel", the
    stage route, the bounded softmax, the VAE mid-block's flash attention
    (the VAE's 64 channels at T 1024: head_dim 64) and the vocoder's adjoint
    kernel; then the conv2d adjoint route on `phase_reference_routes`'
    models, whose VAE has 128-channel levels."""
    from diffmusic_tpu_torch.models.configs import UNetConfig, VAEConfig
    unet, vae_cfg, voc_cfg = reference_configs()
    lat = torch.randn((1, 8, 32, 32), generator=torch.Generator().manual_seed(8))
    for name, card_kernels in NEW_ROUTE_KERNELS.items():
        out = reference_runs((UNetConfig(**unet), vae_cfg, voc_cfg), REF_AUDIO_S, lat,
                             **TURN_ROUTES[name])
        compare_reference(f"MusicLDM, route {name} {TURN_ROUTES[name]}, fp32, small model, 2 "
                          f"DPS steps, wav_form loss", out, REF_LATENT_TOL["wav_form"],
                          card_kernels)
    vae_cfg = VAEConfig(block_out_channels=(32, 128), layers_per_block=1, norm_num_groups=32)
    lat = torch.randn((1, 8, 64, 32), generator=torch.Generator().manual_seed(7))
    out = reference_runs((UNetConfig(**unet), vae_cfg, voc_cfg), ROUTES_REF_AUDIO_S, lat,
                         **TURN_ROUTES["conv2d_bwd"])
    compare_reference(f"MusicLDM, route conv2d_bwd {TURN_ROUTES['conv2d_bwd']}, fp32, small "
                      f"model, 2 DPS steps, wav_form loss", out, REF_LATENT_TOL["wav_form"],
                      ("conv2d_same", "conv2d_same_adjoint", "channel_moments"))


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


def drive(label: str, pipe, meas, want: dict, repacks=None, eta: float = 0.0,
          rate: float = 2.0, **call_kw) -> tuple:
    """One 10-s slice run through the pipeline's __call__: STEPS steps of its
    sampler (DPS unless the pipeline names another), eta 0 and rate 2.0
    unless given, seeded latents (1, 8, 250, 16); the launch counts are set
    to 0 just before and read just after, and must equal `want`. The
    kernels' tap-major weight copies (conv2d, upsampler, conv1d pair) are
    counted per step: `repacks[kernel]` in the first (the route's weights
    not yet seen), none after. Returns (launch counts, the restored audio
    (1, 160000), the final latents)."""
    from diffmusic_tpu_torch import kernels
    from diffmusic_tpu_torch.kernels import repack
    lat = torch.randn(LATENTS, generator=torch.Generator().manual_seed(0))
    stamps, made, last = [], [], []
    repacks = {**dict.fromkeys(repack.REPACKS, 0), **(repacks or {})}

    def on_step(i, t, x):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        made.append(dict(repack.REPACKS))
        last[:] = [x]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for name in repack.REPACKS:
        repack.REPACKS[name] = 0
    start = time.perf_counter()
    out, losses = pipe(audio_length_in_s=10.0, num_inference_steps=STEPS, eta=eta,
                       measurement=meas, ip_guidance_rate=rate, latents=lat,
                       return_losses=True, callback=on_step, **call_kw)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    step_ms = [1e3 * (b - a) for a, b in zip([start] + stamps[:-1], stamps)]
    peak = torch.cuda.max_memory_allocated()
    audio = out.audios
    q1, med, q3 = statistics.quantiles(step_ms[1:], n=4)
    log(f"{label}: {pipe.scheduler_name} {STEPS} steps, eta {eta}, rate {rate}, latents "
        f"{LATENTS}; loss first {losses[0]:.4f} last {losses[-1]:.4f}; "
        f"ms/guided step after the first: median {med:.2f}, quartiles {q1:.2f}/{q3:.2f}, "
        f"mean {statistics.mean(step_ms[1:]):.2f} (first {step_ms[0]:.1f}); peak memory "
        f"{peak / 2**30:.2f} GiB; audio {audio.shape}")
    log(f"{label}: launches over the {STEPS} steps and the final decode {counts}")
    if not np.isfinite(losses).all() or not np.isfinite(audio).all():
        raise AssertionError(f"{label} produced non-finite losses or audio")
    if audio.shape != (1, 160000):
        raise AssertionError(f"audio shape {audio.shape}, expected (1, 160000)")
    check_launches(label, counts, want)
    later = {n: repack.REPACKS[n] - made[0][n] for n in repacks}
    log(f"{label}: tap-major weight copies in step 1: {made[0]}, after it: {later}")
    if made[0] != repacks or any(later.values()):
        raise AssertionError(f"{label}: tap-major weight copies {made[0]} in the first step "
                             f"and {later} after it, expected {repacks} and none")
    return counts, audio, last[0]


# the slice's turns: each route once each way, so that the host's drift over
# the call falls on every route alike; the VAE flash and the two adjoint
# routes once, in the middle
TURNS = ("default", "stats", "fused", "xbwd", "kernel", "stage", "bsoft",
         "vae_flash", "conv2d_bwd", "adjoint",
         "bsoft", "stage", "kernel", "xbwd", "fused", "stats", "default")


def turn_launches(name: str) -> dict:
    """The launches a turn of the slice must give."""
    flags = TURN_ROUTES[name]
    want = expected_launches("fused_transformer_block_bsoft" if flags.get("bsoft")
                             else "fused_transformer_block",
                             flags.get("gn_mode", "plain"),
                             name if name in VOCODER_ROUTES else "default")
    if flags.get("vae_mid_attn") == "flash":
        # the VAE mid-block: each guided step's decode and the final one
        want["flash_attention"] += STEPS + 1
    if flags.get("conv2d_bwd") == "kernel":
        want["conv2d_same_adjoint"] += VAE_ADJOINTS_PER_STEP * STEPS
    return want


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
    # the routes share the weight tensors, so only the first of the conv2d
    # routes' turns copies the 46 conv2d weights to the kernel's tap-major
    # layout, and only the first turn the 3 upsamplers' weights and the
    # conv1d kernel's 54 (the 24 pairs' 48 and the 6 single convs'; the canvas
    # and stage routes read the same copies); the first "kernel" turn maps
    # the 54 weights for its adjoint passes, with no copy
    upsampler_weights = VOCODER_PER_STEP["phase_convtranspose"]
    pair_weights = 2 * VOCODER_PER_STEP["conv1d_fused_pair"] + VOCODER_PER_STEP["conv1d_fused"]
    adjoint_maps = VOCODER_LAUNCHES["kernel"][1]["conv1d_fused_canvas"]
    first_kernel = TURNS.index("kernel")
    conv2d_weights = sum(ROUTE_LAUNCHES[m]["stats"]["conv2d_same"] for m in ROUTE_LAUNCHES)
    first_conv2d = next(i for i, n in enumerate(TURNS) if TURN_ROUTES[n].get("conv2d_kernel"))
    # the conv2d adjoint route copies the VAE's 24 routed weights, flipped and
    # channel-swapped, once; the vocoder's adjoint route reads maps of its 6
    # single convs' weights that the first "kernel" turn made
    first_conv2d_bwd = TURNS.index("conv2d_bwd")
    for turn, name in enumerate(TURNS):
        label = "slice" if name == "default" else f"slice route {name}"
        c, a, _ = drive(f"{label} (turn {turn + 1})", pipes[name], meas, turn_launches(name),
                     repacks={"conv2d_same": conv2d_weights if turn == first_conv2d else 0,
                              "phase_convtranspose": upsampler_weights if turn == 0 else 0,
                              "conv1d_pair": pair_weights if turn == 0 else 0,
                              "conv1d_adjoint": adjoint_maps if turn == first_kernel else 0,
                              "conv2d_adjoint": (VAE_ADJOINTS_PER_STEP
                                                 if turn == first_conv2d_bwd else 0)},
                     prompt_embeds=torch.zeros(2, 512))
        counts.setdefault(name, c)
        audio.setdefault(name, a)
    for name, p in pipes.items():
        parts = (None if name in ("default", "stats", "fused") else
                 ("unet fwd (no grad)",) if name == "bsoft" else
                 ("vae decode fwd+bwd",) if name in ("vae_flash", "conv2d_bwd") else
                 ("vocoder fwd+bwd",))
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
    # the first run copies its own vocoder's 3 upsampler weights and the
    # conv1d kernel's 54 (48 pair weights, 6 single); the other two share them
    counts = {False: drive("audioldm2 fuse_cross=False", pipe, meas,
                           expected_launches("flash_attention"),
                           {"phase_convtranspose": VOCODER_PER_STEP["phase_convtranspose"],
                            "conv1d_pair": 2 * VOCODER_PER_STEP["conv1d_fused_pair"]
                            + VOCODER_PER_STEP["conv1d_fused"]},
                           prompt="")[0]}
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


# ------------------------------------------------------------------ tasks
# The paper's samplers and tasks (configs/*.yaml, run.py's build_operator):
# (sampler, eta, rate) on the slices' box inpainting, then DiffMusic on each
# other task. The periodic mask's measurement carries Poisson noise.
SAMPLER_RUNS = (("mpgd", 0.0, 0.005), ("dsg", 1.0, 0.08), ("diffmusic", 1.0, 0.08))
DIFFMUSIC = SAMPLER_RUNS[2]
TASKS = ("super_resolution", "phase_retrieval", "dereverberation", "random_mask",
         "periodic_mask_poisson")
DEREVERB_IR = 5000
# The reference's rates. MPGD takes the DPS reference's 2.0 (its config's
# 0.005 barely moves the latents); DSG and DiffMusic their configs' 0.08.
# Those two rescale the gradient's unit direction to the noise's radius, so
# the card-vs-CPU difference of the gradient (fp32 kernels against cuDNN
# and the CPU, summing in other orders) reaches the latents weighted by the
# rate alone, not by the gradient's size: at 0.5, DSG's final latents
# differed by 1.8e-4 of their norm on an H100, against REF_LATENT_TOL's 1e-4.
REF_SAMPLER_RATES = {"mpgd": 2.0, "dsg": 0.08, "diffmusic": 0.08}


def task_operator(task: str, audio_s: float):
    """A task's operator with run.py's settings, its draws (random mask,
    reverb impulse response) from seed 0."""
    from diffmusic_tpu_torch import inverse_problem as ip
    if task == "super_resolution":
        return ip.SuperResolutionOperator(sample_rate=16000, scale=2)
    if task == "phase_retrieval":
        return ip.PhaseRetrievalOperator(n_fft=1024, hop_length=160, win_length=1024)
    if task == "dereverberation":
        return ip.MusicDereverberationOperator(ir_length=DEREVERB_IR, decay_factor=0.99,
                                               ir_generator=torch.Generator().manual_seed(0))
    if task == "random_mask":
        return ip.MusicInpaintingOperator(audio_length_in_s=audio_s, mask_type="random",
                                          mask_percentage=0.3, mask_duration_s=0.1,
                                          mask_generator=torch.Generator().manual_seed(0))
    if task == "periodic_mask_poisson":
        return ip.MusicInpaintingOperator(audio_length_in_s=audio_s, mask_type="periodic",
                                          interval_s=1.0, mask_duration_s=0.1,
                                          noiser=ip.PoissonNoise(rate=1.0))
    raise ValueError(task)


def task_measurement(op, audio_s: float, device) -> torch.Tensor:
    """The operator's measurement of the harmonic stack, made on the CPU (its
    noise from seed 1) and moved to `device`."""
    gt = torch.as_tensor(harmonic_stack(int(audio_s * 16000), 16000))
    return op.forward(gt, torch.Generator().manual_seed(1)).to(device)


def phase_reference_tasks():
    """The small fp32 MusicLDM of `phase_reference`, 2 steps with the waveform
    loss, card against CPU, from one CPU generator (eta 1: every draw
    enters): MPGD and DSG on box inpainting, DiffMusic on each task."""
    from diffmusic_tpu_torch import kernels
    from diffmusic_tpu_torch.models.configs import UNetConfig
    unet, vae_cfg, voc_cfg = reference_configs()
    pipes = {dev: build_pipe(UNetConfig(**unet), vae_cfg, voc_cfg, REF_AUDIO_S, dev,
                             torch.float32)[0] for dev in ("cuda", "cpu")}
    box = pipes["cpu"].operator
    lat = torch.randn((1, 8, 32, 32), generator=torch.Generator().manual_seed(9))
    # the guidance gradient itself, card against CPU, at the initial latents
    grads = {}
    for dev, pipe in pipes.items():
        x = lat.to(pipe.device).requires_grad_(True)
        loss_fn = pipe.make_loss_fn(task_measurement(box, REF_AUDIO_S, pipe.device),
                                    int(REF_AUDIO_S * 16000), "wav_form")
        grads[dev] = torch.autograd.grad(loss_fn(x), x)[0].cpu().double()
    g, c = grads["cuda"], grads["cpu"]
    log(f"reference guidance gradient (box inpainting, wav_form loss), card against CPU: "
        f"norm-rel {float((g - c).norm() / c.norm()):.3e}, 1 - cos "
        f"{1 - float((g * c).sum() / (g.norm() * c.norm())):.3e}")
    runs = [(name, "box_inpainting", box) for name in ("mpgd", "dsg")]
    runs += [("diffmusic", task, task_operator(task, REF_AUDIO_S)) for task in TASKS]
    for sampler, task, op in runs:
        meas = task_measurement(op, REF_AUDIO_S, "cpu")
        out = {}
        for dev, pipe in pipes.items():
            kernels.reset_launch_counts()
            res, losses = dataclasses.replace(pipe, scheduler_name=sampler, operator=op)(
                audio_length_in_s=REF_AUDIO_S, num_inference_steps=2, eta=1.0,
                prompt_embeds=torch.zeros(2, 512), measurement=meas,
                ip_guidance_rate=REF_SAMPLER_RATES[sampler], latents=lat,
                generator=torch.Generator().manual_seed(3), output_type="latent",
                return_losses=True, supervised_space="wav_form")
            out[dev] = (res.audios, losses, kernels.launch_counts())
        compare_reference(f"MusicLDM, fp32, small model, 2 {sampler} steps, eta 1, rate "
                          f"{REF_SAMPLER_RATES[sampler]}, {task}, wav_form loss", out,
                          REF_LATENT_TOL["wav_form"],
                          ("fused_transformer_block",) + tuple(VOCODER_PER_STEP))


def stft_error(audio, meas, op) -> float:
    """|| |STFT(audio)| - measurement || / || measurement ||, phase retrieval's
    consistency."""
    from diffmusic_tpu_torch.ops.stft import spectrogram
    mag = spectrogram(torch.as_tensor(audio, device=meas.device), op.n_fft, op.hop_length,
                      op.win_length, power=1.0, use_hann=False)
    return float(torch.linalg.vector_norm(mag - meas) / torch.linalg.vector_norm(meas))


def time_dereverb_conv(op) -> None:
    """The dereverberation filter alone at the slice's clip: one fp32
    `F.conv1d` of (1, 160000) with 5000 taps, forward and forward+backward
    (the input gradient), CUDA events; TF32 off as in the whole run, and on
    (PyTorch's default for cuDNN), beside its bound."""
    from diffmusic_tpu_torch.ops.filters import convolve1d
    x = randn((1, 160000), torch.Generator().manual_seed(2), "cuda", torch.float32)
    ir = torch.as_tensor(op.ir).to(x.device)
    g = randn((1, 160001), torch.Generator().manual_seed(3), "cuda", torch.float32)

    def fwd():
        convolve1d(x, ir)

    def fwd_bwd():
        xx = x.detach().requires_grad_(True)
        torch.autograd.grad(convolve1d(xx, ir), xx, g)

    macs = 160001 * DEREVERB_IR
    bound_fwd = max(2 * macs / FP32_FLOPS, 4 * (160000 + DEREVERB_IR + 160001) / HBM_BYTES)
    times = {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        times[tf32] = (time_ms(fwd), time_ms(fwd_bwd))
    torch.backends.cudnn.allow_tf32 = False
    log(f"dereverberation filter (1, 160000) x {DEREVERB_IR} taps, fp32 F.conv1d, median ms "
        f"(CUDA events): forward {times[False][0]:.3f}, forward+backward "
        f"{times[False][1]:.3f} (TF32 off, as run); with cuDNN's TF32 on "
        f"{times[True][0]:.3f} / {times[True][1]:.3f}; fp32 bound {1e3 * bound_fwd:.4f} "
        f"forward, {2e3 * bound_fwd:.4f} both ({macs / 1e9:.2f} G multiply-adds each)")


def phase_tasks() -> None:
    """Full-width MusicLDM with seeded random bf16 weights on the default
    route through `MusicLDMPipeline.__call__`, one pipeline whose sampler and
    operator are swapped: MPGD, DSG and DiffMusic on the slice's box
    inpainting, then DiffMusic on each task of TASKS (phase retrieval with
    the phase-aware output on). Each run's launches are the default DPS
    route's; phase retrieval's projection must not move |STFT(output)| away
    from the measurement."""
    from diffmusic_tpu_torch.models.configs import HiFiGANConfig, UNetConfig, VAEConfig
    t0 = time.time()
    pipe, box_meas = build_pipe(UNetConfig(), VAEConfig(), HiFiGANConfig(), 10.0, "cuda",
                                torch.bfloat16)
    log(f"tasks: full-width MusicLDM, seeded random bf16 weights, built in "
        f"{time.time() - t0:.1f} s")
    want = expected_launches("fused_transformer_block")
    runs = [(sampler, eta, rate, "box_inpainting", pipe.operator, box_meas)
            for sampler, eta, rate in SAMPLER_RUNS]
    for task in TASKS:
        op = task_operator(task, 10.0)
        runs.append(DIFFMUSIC + (task, op, task_measurement(op, 10.0, "cuda")))
    # the first run copies the new pipeline's 3 upsampler and 54 conv1d weights
    repacks = {"phase_convtranspose": VOCODER_PER_STEP["phase_convtranspose"],
               "conv1d_pair": 2 * VOCODER_PER_STEP["conv1d_fused_pair"]
               + VOCODER_PER_STEP["conv1d_fused"]}
    for i, (sampler, eta, rate, task, op, meas) in enumerate(runs):
        run = dataclasses.replace(pipe, scheduler_name=sampler, operator=op)
        extra = dict(phase_aware=True) if task == "phase_retrieval" else {}
        _, audio, final = drive(f"tasks {sampler} {task}", run, meas, want,
                                repacks if i == 0 else None, eta=eta, rate=rate,
                                prompt_embeds=torch.zeros(2, 512),
                                generator=torch.Generator().manual_seed(4), **extra)
        if task == "phase_retrieval":
            with torch.no_grad():
                plain = run.mel_to_waveform(run.decode_mel(final))[:, :160000].float()
            before, after = stft_error(plain, meas, op), stft_error(audio, meas, op)
            log(f"tasks phase_retrieval: || |STFT(output)| - measurement || / || measurement "
                f"||: vocoder output {before:.4f}, after the phase-aware projection "
                f"{after:.4f}")
            if not after <= before:
                raise AssertionError("the phase-aware projection moved |STFT| away from "
                                     "the measurement")
        if task == "dereverberation":
            time_dereverb_conv(op)


# ------------------------------------------------- DITTO and optim_prompt
# The two paths that differentiate through the UNet. DITTO: ditto.yaml's eta
# 1 and rate 0.5 at full width; the reference phase takes rate 0.05, where
# the outer loop stays well-conditioned (at 0.5 on the tiny CPU model even
# JAX's third gradient is 14 % from a float64 run: tests/test_torch_port_ditto.py).
DITTO_ETA, DITTO_RATE, DITTO_OUTER = 1.0, 0.5, 3
REF_DITTO_RATE = 0.05
# the DITTO gradient card against CPU, norm-relative (and 1 - cos below its
# square): the loss head's own gradient differs by 1.2e-3 of its norm on an
# H100, a rotation (phase 8's reading); a backward that lost the UNet's part
# would not
REF_DITTO_GRAD_TOL = 1e-2
# optim_prompt: the embedding step at every t with t % 30 == 1; 20 steps of
# the slice's schedule (951, 901, ..., 1) take it at 7 of them, 4 steps
# (751, 501, 251, 1) at 2
OPTIM_PROMPT_LR = 1e-4       # configs/*.yaml
REF_OPTIM_PROMPT_LR = 0.5    # large enough that the step moves the small models' run
REF_PROMPT_STEPS = 4
# optim_prompt's final latents card against CPU, norm-relative: the sound
# runs read 1.1e-6 to 4.6e-6 on an H100, MusicLDM with its embedding step
# lost (lr 0) 2.8e-4; between them, tighter than REF_LATENT_TOL
REF_PROMPT_LATENT_TOL = 3e-5


def prompt_fires(steps: int) -> int:
    from diffmusic_tpu_torch.samplers import DiffusionSchedule
    return sum(int(t) % 30 == 1 for t in DiffusionSchedule().timesteps(steps))


def ditto_launches(steps: int, outer: int, blocks: str = "fused_transformer_block") -> dict:
    """Launches of a DITTO run of `steps` x `outer` on the default route: each
    step's UNet forward runs twice under the checkpoint (the forward, then
    the recompute in the backward; the backwards of the block and flash
    kernels recompute with the plain versions and launch nothing), the loss
    head once per outer iteration (the vocoder's forward; its default
    backward launches nothing), and the final decode's vocoder once more."""
    want = dict.fromkeys(COUNTERS, 0)
    want[blocks] = 10 * 2 * steps * outer
    for n, k in VOCODER_PER_STEP.items():
        want[n] = k * (outer + 1)
    return want


def optim_prompt_launches(steps: int, blocks: str) -> dict:
    """Launches of a DPS run with optim_prompt on the default route: a UNet
    forward a step, one more (with autograd) and one more loss head at each
    embedding step, the final decode."""
    fires = prompt_fires(steps)
    want = dict.fromkeys(COUNTERS, 0)
    want[blocks] = 10 * (steps + fires)
    for n, k in VOCODER_PER_STEP.items():
        want[n] = k * (steps + fires + 1)
    return want


def ditto_gradient(pipe, meas, lat, audio_s: float) -> torch.Tensor:
    """d loss / d initial latents of a 2-step DITTO chain (eta 1, draws from
    a CPU generator) with the waveform loss, as a float64 CPU tensor."""
    from diffmusic_tpu_torch.samplers import SamplerConfig, ditto_draws
    cfg = SamplerConfig(name="ditto", eta=DITTO_ETA, ip_guidance_rate=REF_DITTO_RATE,
                        num_inference_steps=2)
    dev = pipe.device
    draws = ditto_draws(cfg, lat.shape, 2, torch.Generator().manual_seed(13), lat.dtype, dev)
    objective = pipe.ditto_objective(torch.zeros(1, 512, device=dev), 1.0,
                                     pipe.make_loss_fn(meas, int(audio_s * 16000), "wav_form"),
                                     cfg, pipe.schedule.timesteps(2), draws)
    with torch.enable_grad():
        x = lat.to(dev).requires_grad_(True)
        (grad,) = torch.autograd.grad(objective(x)[0], x)
    return grad.cpu().double()


def gradient_distance(g, ref) -> tuple:
    """(||g - ref|| / ||ref||, cos(g, ref))."""
    return (float((g - ref).norm() / ref.norm()),
            float((g * ref).sum() / (g.norm() * ref.norm())))


def phase_reference_ditto():
    """The small fp32 models of phase 4, card against CPU from one CPU
    generator, the waveform loss: DITTO (2 steps x 2 outer iterations, eta 1)
    on the default route and with gn_mode "fused", "stats" and the conv2d
    kernel alone; DPS with optim_prompt (4 steps, 2 embedding steps) on
    MusicLDM and on AudioLDM2 from a text prompt under CFG 3.5 with
    fuse_cross off and on. Each bound also meets the fault it is there to
    catch, planted on the card, and must fail it: the DITTO gradient with
    eps detached inside the checkpointed body (the default route), and each
    optim_prompt run with its embedding step lost (lr 0)."""
    from diffmusic_tpu_torch import kernels
    from diffmusic_tpu_torch.models.configs import (ProjectionConfig, UNetConfig, VAEConfig,
                                                    tiny_clap_text_config, tiny_gpt2_config,
                                                    tiny_t5_config)
    unet, vae_cfg, voc_cfg = reference_configs()
    route_vae = VAEConfig(block_out_channels=(32, 128), layers_per_block=1, norm_num_groups=32)
    routes = {"default": ({}, vae_cfg, REF_AUDIO_S, (1, 8, 32, 32),
                          ("fused_transformer_block",) + tuple(VOCODER_PER_STEP)),
              "fused": (TURN_ROUTES["fused"], route_vae, ROUTES_REF_AUDIO_S, (1, 8, 64, 32),
                        ("fused_group_norm", "conv2d_same", "leaky_mask", "leaky_mask_add")),
              "stats": (TURN_ROUTES["stats"], route_vae, ROUTES_REF_AUDIO_S, (1, 8, 64, 32),
                        ("channel_moments", "conv2d_same", "leaky_mask", "leaky_mask_add")),
              "conv2d": (dict(conv2d_kernel=True), route_vae, ROUTES_REF_AUDIO_S,
                         (1, 8, 64, 32), ("conv2d_same",))}
    sound = 0.0   # the largest norm-relative gradient difference of the routes
    for name, (flags, vae, audio_s, shape, card_kernels) in routes.items():
        lat = torch.randn(shape, generator=torch.Generator().manual_seed(12))
        out, grads = {}, {}
        for dev in ("cuda", "cpu"):
            pipe, meas = build_pipe(UNetConfig(**unet), vae, voc_cfg, audio_s, dev,
                                    torch.float32, **flags)
            grads[dev] = ditto_gradient(pipe, meas, lat, audio_s)
            if name == "default" and dev == "cuda":
                # the fault the bound must catch: a UNet whose eps leaves the
                # graph inside the checkpointed body (a kernel fast path that
                # skipped its autograd function)
                planted, eps_fn = copy.copy(pipe), pipe._eps
                planted._eps = lambda *a: eps_fn(*a).detach()
                grads["planted"] = ditto_gradient(planted, meas, lat, audio_s)
            kernels.reset_launch_counts()
            res, losses = dataclasses.replace(pipe, scheduler_name="ditto")(
                audio_length_in_s=audio_s, num_inference_steps=2, eta=DITTO_ETA,
                prompt_embeds=torch.zeros(2, 512), measurement=meas,
                ip_guidance_rate=REF_DITTO_RATE, optim_outer_loop=2, latents=lat,
                generator=torch.Generator().manual_seed(13), output_type="latent",
                return_losses=True, supervised_space="wav_form")
            out[dev] = (res.audios, losses, kernels.launch_counts())
        compare_reference(f"MusicLDM, fp32, small model, DITTO 2 steps x 2 outer, eta "
                          f"{DITTO_ETA}, rate {REF_DITTO_RATE}, route {name} {flags}, "
                          f"wav_form loss", out, REF_LATENT_TOL["wav_form"], card_kernels)
        c = grads["cpu"]
        rel, cos = gradient_distance(grads["cuda"], c)
        sound = max(sound, rel)
        log(f"reference DITTO gradient at the initial latents (2 checkpointed steps and the "
            f"loss head), route {name}, card against CPU: norm {float(c.norm()):.4e}, "
            f"norm-rel {rel:.3e}, 1 - cos {1 - cos:.3e}")
        if not (rel < REF_DITTO_GRAD_TOL and 1 - cos < REF_DITTO_GRAD_TOL ** 2):
            raise AssertionError(f"the card's DITTO gradient (route {name}) disagrees with "
                                 f"the CPU's")
        if "planted" in grads:
            prel, pcos = gradient_distance(grads["planted"], c)
            log(f"reference DITTO gradient, planted fault (eps detached inside the "
                f"checkpointed body), card against the sound CPU run: norm-rel {prel:.3e}, "
                f"1 - cos {1 - pcos:.3e} (bounds {REF_DITTO_GRAD_TOL:.0e} and "
                f"{REF_DITTO_GRAD_TOL ** 2:.0e})")
            if prel < REF_DITTO_GRAD_TOL and 1 - pcos < REF_DITTO_GRAD_TOL ** 2:
                raise AssertionError("the DITTO gradient bound lets a backward that loses "
                                     "the UNet's part pass")
    log(f"reference DITTO gradient bound {REF_DITTO_GRAD_TOL:.0e}: the routes' largest "
        f"norm-rel {sound:.3e} ({REF_DITTO_GRAD_TOL / max(sound, 1e-30):.1f}x below), the planted "
        f"fault's {prel:.3e} ({prel / REF_DITTO_GRAD_TOL:.1f}x above)")
    kw = dict(num_inference_steps=REF_PROMPT_STEPS, eta=0.0, ip_guidance_rate=2.0,
              optim_prompt=True, optim_prompt_learning_rate=REF_OPTIM_PROMPT_LR,
              output_type="latent", return_losses=True, supervised_space="wav_form")
    lat = torch.randn((1, 8, 32, 32), generator=torch.Generator().manual_seed(14))

    def prompt_runs(label, build, card_kernels, **call):
        """The optim_prompt run card against CPU, then the card's run with
        the embedding step lost (lr 0), the fault the bound must catch."""
        out, pipes = {}, {}
        for dev in ("cuda", "cpu"):
            pipe, meas = pipes[dev] = build(dev)
            kernels.reset_launch_counts()
            res, losses = pipe(audio_length_in_s=REF_AUDIO_S, measurement=meas, latents=lat,
                               **call, **kw)
            out[dev] = (res.audios, losses, kernels.launch_counts())
        label = f"{label}, DPS with optim_prompt (lr {REF_OPTIM_PROMPT_LR}), " \
                f"{REF_PROMPT_STEPS} steps, wav_form loss"
        compare_reference(label, out, REF_PROMPT_LATENT_TOL, card_kernels)
        pipe, meas = pipes["cuda"]
        res, _ = pipe(audio_length_in_s=REF_AUDIO_S, measurement=meas, latents=lat, **call,
                      **dict(kw, optim_prompt_learning_rate=0.0))
        ref = out["cpu"][0]
        lost = float(np.linalg.norm(res.audios - ref) / np.linalg.norm(ref))
        log(f"reference ({label}), planted fault (the embedding step lost: lr 0 on the "
            f"card) against the sound CPU run: final latents norm-rel {lost:.3e} (tol "
            f"{REF_PROMPT_LATENT_TOL:.0e})")
        if lost <= REF_PROMPT_LATENT_TOL:
            raise AssertionError("optim_prompt's latents bound lets a lost embedding step pass")

    prompt_runs("MusicLDM, fp32, small model",
                lambda dev: build_pipe(UNetConfig(**unet), vae_cfg, voc_cfg, REF_AUDIO_S, dev,
                                       torch.float32),
                ("fused_transformer_block",) + tuple(VOCODER_PER_STEP),
                prompt_embeds=torch.zeros(2, 512))
    txt, t5, gpt2 = tiny_clap_text_config(), tiny_t5_config(), tiny_gpt2_config()
    text = dict(text_cfg=txt, t5_cfg=t5, gpt2_cfg=gpt2,
                proj_cfg=ProjectionConfig(txt.projection_dim, t5.d_model, gpt2.n_embd))
    unet_cfg = audioldm2_unet_config(cross_attention_dims=(gpt2.n_embd, t5.d_model), **unet)
    for fuse_cross, route in ((False, "flash_attention"),
                              (True, "fused_transformer_block_cross")):
        prompt_runs(f"AudioLDM2, fp32, small model, prompt 'solo piano', CFG 3.5, "
                    f"fuse_cross {fuse_cross}",
                    lambda dev, fc=fuse_cross: build_audioldm2(
                        unet_cfg, vae_cfg, voc_cfg, REF_AUDIO_S, dev, torch.float32, fc, **text),
                    (route,) + tuple(VOCODER_PER_STEP), prompt="solo piano", guidance_scale=3.5)


def ditto_split(pipe, meas, lat, embeds) -> None:
    """One outer DITTO iteration of the slice split by CUDA events: the chain
    forward (STEPS checkpointed steps), the loss head forward and backward
    alone, and the rest of the whole iteration (the recompute of every step
    and the UNet backwards)."""
    from diffmusic_tpu_torch.pipelines.base import run_denoise_loop
    from diffmusic_tpu_torch.samplers import SamplerConfig, ditto_draws, make_step_fn
    cfg = SamplerConfig(name="ditto", eta=DITTO_ETA, ip_guidance_rate=DITTO_RATE,
                        num_inference_steps=STEPS)
    timesteps = pipe.schedule.timesteps(STEPS)
    draws = ditto_draws(cfg, lat.shape, STEPS, torch.Generator().manual_seed(15), lat.dtype,
                        lat.device)
    loss_fn = pipe.make_loss_fn(meas, 160000)
    step_fn = make_step_fn(pipe.schedule, cfg, None)
    objective = pipe.ditto_objective(embeds, 1.0, loss_fn, cfg, timesteps, draws)

    def chain():
        x = lat.detach().requires_grad_(True)
        return run_denoise_loop(step_fn, lambda y, t: pipe._eps(embeds, y, t, 1.0), x,
                                timesteps, grad=True, remat=True, draws=draws)[0]

    def head():
        with torch.enable_grad():
            f = final.detach().requires_grad_(True)
            torch.autograd.grad(loss_fn(f), f)

    def whole():
        with torch.enable_grad():
            x = lat.detach().requires_grad_(True)
            torch.autograd.grad(objective(x)[0], x)

    with torch.enable_grad():
        final = chain()
    times = {}
    for name, fn in (("whole iteration", whole), ("chain forward", chain),
                     ("loss head fwd+bwd", head)):
        with torch.enable_grad():
            times[name] = time_ms(fn, reps=3, inner=1, warmup=1)
    rest = times["whole iteration"] - times["chain forward"] - times["loss head fwd+bwd"]
    log(f"ditto split of one outer iteration ({STEPS} steps, CUDA events, median of 3 ms): "
        f"whole {times['whole iteration']:.1f}; chain forward {times['chain forward']:.1f}; "
        f"loss head fwd+bwd {times['loss head fwd+bwd']:.1f}; recompute + UNet backwards "
        f"(the rest) {rest:.1f}")


def run_ditto_full(pipe, meas) -> None:
    """DITTO through `MusicLDMPipeline.__call__` at the slice's shapes:
    seconds per outer iteration, peak memory, losses, launches."""
    from diffmusic_tpu_torch import kernels
    ditto = dataclasses.replace(pipe, scheduler_name="ditto")
    lat = torch.randn(LATENTS, generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out, losses = ditto(audio_length_in_s=10.0, num_inference_steps=STEPS, eta=DITTO_ETA,
                        measurement=meas, ip_guidance_rate=DITTO_RATE,
                        optim_outer_loop=DITTO_OUTER, latents=lat,
                        generator=torch.Generator().manual_seed(4),
                        prompt_embeds=torch.zeros(2, 512), return_losses=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"ditto: {STEPS} steps x {DITTO_OUTER} outer, eta {DITTO_ETA}, rate {DITTO_RATE}, "
        f"latents {LATENTS}: {secs:.2f} s with the final decode, "
        f"{secs / DITTO_OUTER:.2f} s per outer iteration; losses per outer iteration "
        f"{[round(float(v), 4) for v in losses]}; peak memory {peak / 2**30:.2f} GiB")
    log(f"ditto: launches {counts}")
    if not np.isfinite(losses).all() or not np.isfinite(out.audios).all():
        raise AssertionError("ditto produced non-finite losses or audio")
    if out.audios.shape != (1, 160000):
        raise AssertionError(f"ditto audio shape {out.audios.shape}")
    check_launches("ditto", counts, ditto_launches(STEPS, DITTO_OUTER))


def phase_ditto_optim_prompt() -> None:
    """Full width, seeded random bf16 weights, the default route, the slice's
    10-s box inpainting: DITTO (STEPS steps x DITTO_OUTER outer iterations at
    ditto.yaml's eta and rate) through __call__ and its split, then DPS
    without and with optim_prompt on MusicLDM and on AudioLDM2 (fuse_cross
    on), each with its launches checked."""
    from diffmusic_tpu_torch.models.configs import HiFiGANConfig, UNetConfig, VAEConfig
    pipe, meas = build_pipe(UNetConfig(), VAEConfig(), HiFiGANConfig(), 10.0, "cuda",
                            torch.bfloat16)
    run_ditto_full(pipe, meas)   # the pipeline's first run: its weight copies
    embeds = torch.zeros(1, 512, device=pipe.device)
    lat = randn(LATENTS, torch.Generator().manual_seed(16), pipe.device, torch.float32)
    ditto_split(pipe, meas, lat, embeds)
    for on in (False, True):
        want = (optim_prompt_launches(STEPS, "fused_transformer_block") if on
                else expected_launches("fused_transformer_block"))
        drive(f"musicldm optim_prompt={on} ({prompt_fires(STEPS) if on else 0} embedding "
              f"steps)", pipe, meas, want, prompt_embeds=torch.zeros(2, 512), optim_prompt=on,
              optim_prompt_learning_rate=OPTIM_PROMPT_LR)
    del pipe
    a2, meas = build_audioldm2(audioldm2_unet_config(), VAEConfig(), HiFiGANConfig(), 10.0,
                               "cuda", torch.bfloat16, True)
    repacks = {"phase_convtranspose": VOCODER_PER_STEP["phase_convtranspose"],
               "conv1d_pair": 2 * VOCODER_PER_STEP["conv1d_fused_pair"]
               + VOCODER_PER_STEP["conv1d_fused"]}
    for on in (False, True):
        drive(f"audioldm2 fuse_cross=True optim_prompt={on}", a2, meas,
              optim_prompt_launches(STEPS, "fused_transformer_block_cross") if on
              else expected_launches("fused_transformer_block_cross"),
              repacks if not on else None, prompt="", optim_prompt=on,
              optim_prompt_learning_rate=OPTIM_PROMPT_LR)


# ------------------------------------------------------------------- clap
# The CLAP audio tower (HTSAT) and AudioLDM2's VITS stream: no kernel of
# their own, plain PyTorch around the kernels of the paths they sit on.
# Reference bounds, card against CPU, each with the planted fault it must
# fail: the tower's embeddings as a fraction of max (F.interpolate in place
# of JAX's bicubic resize); the style loss's waveform gradient, norm-relative
# (the gram divided by D instead of T'); the prompt encodings as a fraction
# of max (VITS without its relative-position terms); the re-ranking
# similarities (cosines) in absolute terms, with the order equal (the top-dB
# clamp per clip instead of over the batch). On an H100 80GB HBM3 (700 W)
# the sound readings were 1.8e-7 / 3.5e-7 (pooled / frames), 3.9e-6, 1.5e-6
# / 5.9e-7 (clap / TTS) and 1.2e-7, the planted ones 3.2e-4 / 2.4e-3, 1.0,
# 0.28 and 6.6e-4.
REF_CLAP_EMBED_TOL = 1e-5
REF_STYLE_GRAD_TOL = 1e-4
REF_ENCODE_TOL = 1e-4
REF_SCORE_TOL = 1e-5
REF_STYLE_LATENT_TOL = 1e-3    # the DiffMusic run's final latents, norm-relative
REF_STYLE_STEPS = 3
STYLE_RATE = 0.08               # configs/diffmusic.yaml
REF_STYLE_AUDIO_S = 1.0
REF_DEVICES = ("cuda", "cpu")   # the card, then the CPU reference
CLAP_DEVICE = "cuda"            # the full-width runs' device


@contextlib.contextmanager
def planted(owner, attr, value):
    """owner.attr replaced by value inside the block: a fault a bound must catch."""
    old = getattr(owner, attr)
    setattr(owner, attr, value)
    try:
        yield
    finally:
        setattr(owner, attr, old)


def interpolate_resize(x, dim, n_out):
    """The planted resize: PyTorch's bicubic (a = -0.75, no edge
    renormalisation) in place of JAX's."""
    size = list(x.shape[2:])
    size[dim - 2] = n_out
    return F.interpolate(x, size=tuple(size), mode="bicubic", align_corners=False)


def per_clip_mel_features(wav, cfg):
    """The planted CLAP features: the top-dB clamp against each clip's own
    maximum instead of the batch's."""
    from diffmusic_tpu_torch.models import clap_features as cf
    from diffmusic_tpu_torch.ops.stft import spectrogram
    spec = spectrogram(wav, cfg.fft_window_size, cfg.hop_length, cfg.fft_window_size,
                       power=2.0, center=True, use_hann=True)
    db = 10.0 * torch.log10(torch.clamp(torch.einsum(
        "bft,fm->bmt", spec, cf._slaney_filterbank(cfg, spec.device, spec.dtype)), min=1e-10))
    db = torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - 80.0)
    return db.transpose(1, 2)[:, None]


def gram_over_d(self, audio):
    """The planted style target: the gram matrix divided by D, not T'."""
    feats = self.clap_embed(audio)
    return torch.einsum("btd,bte->bde", feats, feats) / feats.shape[2]


def clap_clips(n: int, seconds: float, quiet: bool = False) -> torch.Tensor:
    """(n, L) 16-kHz candidates: harmonic stacks of seeded fundamentals plus
    a little noise; with `quiet` the last is 70 dB down, so that the batch's
    top-dB clamp floors most of it."""
    rng = np.random.default_rng(3)
    tt = np.arange(int(seconds * 16000)) / 16000
    clips = []
    for i in range(n):
        f0 = 110.0 * 2.0 ** rng.uniform(0.0, 3.0)
        x = sum(0.25 / (h + 1) * np.sin(2 * np.pi * f0 * (h + 1) * tt) for h in range(4))
        x = x + 0.02 * rng.standard_normal(tt.size)
        clips.append(x * (10 ** (-70 / 20) if quiet and i == n - 1 else 1.0))
    return torch.as_tensor(np.stack(clips), dtype=torch.float32)


def check_bound(label: str, reading: float, tol: float, planted_reading=None,
                phase: str = "clap reference") -> None:
    """A reading within its bound; the planted fault's reading outside it
    (`planted_reading` a number, or {fault: reading} for several faults)."""
    faults = ({} if planted_reading is None else planted_reading
              if isinstance(planted_reading, dict) else {"planted fault": planted_reading})
    extra = "".join(f"; {name} {r:.3e}" for name, r in faults.items())
    log(f"{phase}: {label} {reading:.3e} (tol {tol:.0e}){extra}")
    if not reading <= tol:
        raise AssertionError(f"{phase}: {label} {reading:.3e} over its bound {tol:.0e}")
    for name, r in faults.items():
        if not r > tol:
            raise AssertionError(f"{phase}: {label}'s bound {tol:.0e} let its {name} pass "
                                 f"({r:.3e})")


def norm_rel(a, b) -> float:
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).norm() / max(b.norm().item(), 1e-30))


def phase_reference_clap():
    """Small fp32 models, card against CPU (plain versions): the tiny tower's
    pooled and frame embeddings; the style loss's gradient with respect to
    the waveform; 3 DiffMusic steps of the tiny MusicLDM under style guidance
    (eta 1, the CPU generator's draws); the tiny AudioLDM2's encode_prompt
    with prompt_type "clap" and, in its TTS variant, with a transcription;
    score_waveforms' order on 4 candidates. Each bound fails its planted
    fault."""
    from diffmusic_tpu_torch import kernels
    from diffmusic_tpu_torch.inverse_problem import StyleGuidanceOperator
    from diffmusic_tpu_torch.models import clap_features as cf
    from diffmusic_tpu_torch.models import htsat
    from diffmusic_tpu_torch.pipelines import AudioLDM2Pipeline, MusicLDMPipeline
    from diffmusic_tpu_torch.pipelines.musicldm import per_clip_loss
    devs = dict(zip(("cuda", "cpu"), REF_DEVICES))
    card = devs["cuda"]
    # the tiny tower at its own projection width 16, so that T' (32) != D
    embeds = {k: cf.make_tiny_clap_audio_embeds(7, device=dev) for k, dev in devs.items()}
    clips = clap_clips(2, 1.0)
    for features, i in (("pooled", 0), ("frames", 1)):
        with torch.no_grad():
            out = {k: embeds[k][i](clips.to(dev)).cpu() for k, dev in devs.items()}
            with planted(htsat, "bicubic_resize", interpolate_resize):
                bad = embeds["cuda"][i](clips.to(card)).cpu()
        check_bound(f"tiny tower {features} embeddings {tuple(out['cpu'].shape)}, max|err| / "
                    f"max", rel_err(out["cuda"], out["cpu"])[1], REF_CLAP_EMBED_TOL,
                    rel_err(bad, out["cpu"])[1])

    target, x = clap_clips(1, 1.0), clap_clips(2, 1.0)[1:] * 0.5

    def style_grad(embed, dev):
        op = StyleGuidanceOperator(clap_embed=embed)
        tgt = op.transform(target.to(dev)).detach()
        xx = x.to(dev).requires_grad_(True)
        return torch.autograd.grad(per_clip_loss(tgt, op, xx, "mel_spectrogram"), xx)[0]

    grads = {k: style_grad(embeds[k][1], dev) for k, dev in devs.items()}
    with planted(StyleGuidanceOperator, "transform", gram_over_d):
        bad = style_grad(embeds["cuda"][1], card)
    check_bound("style loss gradient with respect to the waveform, norm-rel",
                norm_rel(grads["cuda"], grads["cpu"]), REF_STYLE_GRAD_TOL,
                norm_rel(bad, grads["cpu"]))

    runs = {}
    meas = torch.as_tensor(harmonic_stack(int(REF_STYLE_AUDIO_S * 16000), 16000))
    lat = torch.randn((1, 8, 50, 32), generator=torch.Generator().manual_seed(8))
    for k, dev in devs.items():
        pipe = MusicLDMPipeline.tiny("diffmusic", device=dev)
        pipe = dataclasses.replace(pipe, operator=StyleGuidanceOperator(
            clap_embed=pipe.clap_frame_embed))
        kernels.reset_launch_counts()
        res, losses = pipe(audio_length_in_s=REF_STYLE_AUDIO_S,
                           num_inference_steps=REF_STYLE_STEPS, eta=1.0,
                           prompt_embeds=torch.zeros(2, 32), measurement=meas,
                           ip_guidance_rate=STYLE_RATE, latents=lat,
                           generator=torch.Generator().manual_seed(3), output_type="latent",
                           return_losses=True)
        runs[k] = (res.audios, losses, kernels.launch_counts())
    compare_reference(f"tiny MusicLDM, fp32, {REF_STYLE_STEPS} DiffMusic steps under style "
                      f"guidance, eta 1, rate {STYLE_RATE}", runs, REF_STYLE_LATENT_TOL,
                      ("fused_transformer_block",))

    meas = clap_clips(1, 1.0)
    enc = {}
    for k, dev in devs.items():
        a2 = AudioLDM2Pipeline.tiny(device=dev)
        tts = AudioLDM2Pipeline.tiny(device=dev, tts=True)
        enc[k] = (a2.encode_prompt("piano", "noise", True, measurement=meas.to(dev),
                                   prompt_type="clap"),
                  tts.encode_prompt("speech", None, True, transcription="hello there"))
    no_rel = copy.deepcopy(tts.vits)
    for name, p in no_rel.named_parameters():
        if "emb_rel" in name:
            p.data.zero_()
    bad = dataclasses.replace(AudioLDM2Pipeline.tiny(device=card, tts=True), vits=no_rel.to(
        card)).encode_prompt("speech", None, True, transcription="hello there")

    def streams_err(got, want):
        return max(rel_err(a.cpu(), b.cpu())[1] for a, b in zip(got, want)
                   if a.is_floating_point())

    check_bound("tiny AudioLDM2 encode_prompt, prompt_type clap (streams), max|err| / max",
                streams_err(enc["cuda"][0], enc["cpu"][0]), REF_ENCODE_TOL)
    check_bound("tiny AudioLDM2-TTS encode_prompt with a transcription (streams), max|err| "
                "/ max", streams_err(enc["cuda"][1], enc["cpu"][1]), REF_ENCODE_TOL,
                streams_err(bad, enc["cpu"][1]))

    cands = clap_clips(4, 1.0, quiet=True)
    ranked = {}
    for k, dev in devs.items():
        pipe = MusicLDMPipeline.tiny(device=dev)
        ranked[k] = pipe.score_waveforms("a piano", cands.to(dev))
    with planted(cf, "clap_mel_features", per_clip_mel_features):
        bad = MusicLDMPipeline.tiny(device=card).score_waveforms("a piano", cands.to(card))
    order = {k: [int(np.flatnonzero((cands.numpy() == a).all(1))[0]) for a in r[0]]
             for k, r in ranked.items()}
    sims = {k: torch.as_tensor(r[1]) for k, r in ranked.items()}
    log(f"clap reference: score_waveforms order card {order['cuda']} cpu {order['cpu']}; "
        f"similarities card {sims['cuda'].tolist()} cpu {sims['cpu'].tolist()}")
    if order["cuda"] != order["cpu"]:
        raise AssertionError("clap reference: score_waveforms ranks otherwise on the card")
    check_bound("score_waveforms similarities, max|err|",
                rel_err(sims["cuda"], sims["cpu"])[0], REF_SCORE_TOL,
                rel_err(torch.as_tensor(bad[1]), sims["cpu"])[0])


def full_width_clap(seed: int, device="cuda"):
    """A seeded random tower at ClapAudioConfig's defaults (fp32) with the
    48-kHz features: (pooled embed, frame embed)."""
    from diffmusic_tpu_torch.models import clap_features as cf
    from diffmusic_tpu_torch.models.htsat import ClapAudioConfig
    return cf.random_clap_audio_embeds(ClapAudioConfig(), cf.ClapFeatureConfig(), seed, device)


def time_rerank(label: str, pipe, cands) -> None:
    """score_waveforms on the candidates: seconds, first call and again."""
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio, sims = pipe.score_waveforms("a piano", cands)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    log(f"clap: {label} score_waveforms of {tuple(cands.shape)} candidates: {secs[0]:.3f} s "
        f"first, {secs[1]:.3f} s again; similarities {np.round(sims, 4).tolist()}")
    if audio.shape != tuple(cands.shape) or not np.all(np.diff(sims) <= 0):
        raise AssertionError(f"clap: {label} score_waveforms returned {audio.shape}, {sims}")


def time_encode(label: str, pipe, **kw):
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        embeds = pipe.encode_prompt("", None, True, **kw)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    log(f"clap: {label}: {secs[0]:.3f} s first, {secs[1]:.3f} s again; streams "
        f"{[tuple(a.shape) for a in embeds]}")
    return embeds


def style_split(pipe, meas) -> None:
    """The style loss head's forward+backward at the slice's shapes (median
    ms, CUDA events): the whole head from the latents, the CLAP features
    alone (resample, STFT, mel, dB) and the tower alone, and the rest."""
    from diffmusic_tpu_torch.models.clap_features import prepare_clap_input
    gen = torch.Generator().manual_seed(11)
    loss_fn = pipe.make_loss_fn(meas, 160000, "mel_spectrogram")
    x = randn(LATENTS, gen, CLAP_DEVICE, torch.float32)
    wav = randn((1, 160000), gen, CLAP_DEVICE, torch.float32, 0.1)
    embed = pipe.clap_frame_embed
    with torch.no_grad():
        feats = prepare_clap_input(wav, embed.cfg)
        frames = embed.tower(feats, features="frames")
    g_feats = randn(feats.shape, gen, CLAP_DEVICE, torch.float32)
    g_frames = randn(frames.shape, gen, CLAP_DEVICE, torch.float32)

    def head():
        xx = x.clone().requires_grad_(True)
        torch.autograd.grad(loss_fn(xx), xx)

    def features():
        ww = wav.clone().requires_grad_(True)
        torch.autograd.grad(prepare_clap_input(ww, embed.cfg), ww, g_feats)

    def tower():
        ff = feats.clone().requires_grad_(True)
        torch.autograd.grad(embed.tower(ff, features="frames"), ff, g_frames)

    times = {name: time_ms(fn, reps=5, inner=1, warmup=1)
             for name, fn in (("loss head", head), ("CLAP features", features),
                              ("tower", tower))}
    rest = times["loss head"] - times["CLAP features"] - times["tower"]
    log(f"clap: style loss head fwd+bwd (median ms, CUDA events): whole {times['loss head']:.2f}"
        f"; CLAP features {times['CLAP features']:.2f}; tower {times['tower']:.2f}; the rest "
        f"(VAE decode, vocoder, gram and norm) {rest:.2f}; features {tuple(feats.shape)}, "
        f"frames {tuple(frames.shape)}")


def phase_clap() -> None:
    """Full width, seeded random weights: MusicLDM (bf16, JAX's default
    routes) under style guidance with the tower at ClapAudioConfig's
    defaults, 20 DiffMusic steps at diffmusic.yaml's eta and rate, the loss
    head's split; AudioLDM2 from the 10-s measurement's CLAP embedding
    (prompt_type "clap") with fuse_cross off and on; score_waveforms on 4
    ten-second candidates on both; AudioLDM2-TTS (VITS at VitsConfig's
    defaults in T5's place, the UNet's second stream 192 wide) from a fixed
    id sequence. Every run's launches are its default route's."""
    from diffmusic_tpu_torch.inverse_problem import StyleGuidanceOperator
    from diffmusic_tpu_torch.models.clap import ClapTextModelWithProjection
    from diffmusic_tpu_torch.models.configs import (ClapTextConfig, HiFiGANConfig,
                                                    ProjectionConfig, UNetConfig, VAEConfig)
    from diffmusic_tpu_torch.models.convert import init_flax_style
    from diffmusic_tpu_torch.models.unet import UNet2DConditionModel
    from diffmusic_tpu_torch.models.vits import VitsConfig
    from diffmusic_tpu_torch.pipelines.base import byte_tokenizer
    phase_reference_clap()
    t0 = time.time()
    pipe, _ = build_pipe(UNetConfig(), VAEConfig(), HiFiGANConfig(), 10.0, CLAP_DEVICE,
                         torch.bfloat16)
    audio_embed, frame_embed = full_width_clap(30, CLAP_DEVICE)
    text = init_flax_style(ClapTextModelWithProjection(ClapTextConfig()), 3)
    pipe = dataclasses.replace(
        pipe, scheduler_name="diffmusic", operator=StyleGuidanceOperator(clap_embed=frame_embed),
        text_encoder=text.to(CLAP_DEVICE, torch.bfloat16), tokenizer=byte_tokenizer,
        clap_audio_embed=audio_embed, clap_frame_embed=frame_embed)
    meas = torch.as_tensor(harmonic_stack(160000, 16000), device=CLAP_DEVICE)
    log(f"clap: full-width MusicLDM (bf16) with the HTSAT tower at ClapAudioConfig's "
        f"defaults (fp32, {sum(p.numel() for p in frame_embed.tower.parameters()) / 1e6:.1f} M "
        f"parameters) built in {time.time() - t0:.1f} s")
    repacks = {"phase_convtranspose": VOCODER_PER_STEP["phase_convtranspose"],
               "conv1d_pair": 2 * VOCODER_PER_STEP["conv1d_fused_pair"]
               + VOCODER_PER_STEP["conv1d_fused"]}
    drive("clap style guidance", pipe, meas, expected_launches("fused_transformer_block"),
          repacks, eta=1.0, rate=STYLE_RATE, prompt_embeds=torch.zeros(2, 512),
          generator=torch.Generator().manual_seed(4))
    style_split(pipe, meas)
    cands = clap_clips(4, 10.0).to(CLAP_DEVICE)
    time_rerank("MusicLDM", pipe, cands)
    del pipe, text
    torch.cuda.empty_cache()

    pipe, meas = build_audioldm2(audioldm2_unet_config(), VAEConfig(), HiFiGANConfig(), 10.0, CLAP_DEVICE,
                                 torch.bfloat16, False)
    audio_embed, frame_embed = full_width_clap(31, CLAP_DEVICE)
    pipe = dataclasses.replace(pipe, clap_audio_embed=audio_embed, clap_frame_embed=frame_embed)
    embeds = time_encode("AudioLDM2 text stack with prompt_type clap (the 10-s measurement's "
                         "CLAP embedding; negative prompt '')", pipe, measurement=meas,
                         prompt_type="clap")
    drive("clap audioldm2 prompt_type clap fuse_cross=False", pipe, meas,
          expected_launches("flash_attention"), repacks, prompt_embeds=embeds)
    with pipe.device:
        fused = UNet2DConditionModel(pipe.unet_cfg, fuse_cross=True)
    fused.to(next(pipe.unet.parameters()).dtype).load_state_dict(pipe.unet.state_dict())
    drive("clap audioldm2 prompt_type clap fuse_cross=True",
          dataclasses.replace(pipe, unet=fused), meas,
          expected_launches("fused_transformer_block_cross"), prompt_embeds=embeds)
    time_rerank("AudioLDM2", pipe, cands)
    del pipe, fused, embeds
    torch.cuda.empty_cache()

    vits_cfg = VitsConfig()

    def phonemes(texts):
        """A fixed id sequence of 48 tokens for a transcription, none for ''."""
        ids = np.zeros((len(texts), 48), np.int64)
        mask = np.zeros((len(texts), 48), np.int64)
        for i, t in enumerate(texts):
            if t:
                ids[i] = 1 + (np.arange(48) * 7) % (vits_cfg.vocab_size - 1)
                mask[i] = 1
        return ids, mask

    t0 = time.time()
    pipe, meas = build_audioldm2(
        audioldm2_unet_config(cross_attention_dims=(768, vits_cfg.hidden_size)), VAEConfig(),
        HiFiGANConfig(), 10.0, CLAP_DEVICE, torch.bfloat16, False, vits_cfg=vits_cfg,
        proj_cfg=ProjectionConfig(512, vits_cfg.hidden_size, 768), vits_tokenizer=phonemes)
    log(f"clap: full-width AudioLDM2-TTS (VITS {vits_cfg.num_hidden_layers} layers x "
        f"{vits_cfg.hidden_size}, UNet cross dims (768, {vits_cfg.hidden_size})), seeded random "
        f"bf16 weights, built in {time.time() - t0:.1f} s")
    embeds = time_encode("AudioLDM2-TTS text stack (CLAP, VITS of a 48-token transcription, "
                         "projection, 8 GPT-2 steps)", pipe, transcription="a fixed line")
    drive("clap audioldm2-tts transcription fuse_cross=False", pipe, meas,
          expected_launches("flash_attention"), repacks, prompt_embeds=embeds)
    del pipe, embeds
    torch.cuda.empty_cache()


# ------------------------------------------------------------- stable_audio
REF_SA_MODULE_TOL = 1e-4   # tiny fp32 DiT and Oobleck, card against CPU, max|err| / max
# the tiny pipeline's final latents after 10 EDM steps at CFG 7: fp32 against
# float64 on the CPU reads 1.3e-5 of max, the card against the CPU 3.8e-5
REF_SA_LATENT_TOL = 3e-4
# its decoded audio: the tiny decoder (random snake scales) amplifies the
# latents' last digits; fp32 against float64 on the CPU reads 2.5e-4 of max
REF_SA_AUDIO_TOL = 2e-3
REF_SA_STEPS = 10
REF_SA_FRAMES = 24         # latent frames of the tiny reference (hop 8)
SA_STEPS = 20              # of stable_audio.yaml's 200: every step does the same work
SA_SECONDS = 10.0          # stable_audio.yaml's audio_end_in_s
SA_WAVES = 3               # its num_waveforms_per_prompt
SA_GUIDANCE = 7.0          # the pipeline's default guidance scale
SA_TEXT_TOKENS = 512       # the T5 tokenizer's padded length
SA_DEVICE = "cuda"         # the full-width runs' device


def snake_without_exp(self, x):
    """The planted snake: alpha and beta read as linear scales, not log."""
    xf = x.float()
    return (xf + (1.0 / (self.beta.float() + 1e-9))
            * torch.sin(self.alpha.float() * xf).square()).to(x.dtype)


def tiled_kv_heads(kv, rep):
    """The planted GQA expansion: the KV heads tiled ([h0, h1, h0, h1])."""
    return kv.repeat(1, 1, rep, 1)


def tiled_rows(a, batch):
    """The planted CFG conditioning: the rows tiled ([u, c, u, c, u, c])."""
    return a.repeat(batch, *([1] * (a.ndim - 1)))


def second_order_first_step(x0, x0_prev, r, first):
    """The planted solver: the 2M formula at the first step too (r = 1, the
    zero history)."""
    return (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * x0_prev


def tiny_stable_audio(device):
    """The tiny fp32 StableAudio pipeline (its weights drawn on the CPU, so
    equal on every device) with Snake's alpha and beta moved off zero."""
    from diffmusic_tpu_torch.models.oobleck import Snake1d
    from diffmusic_tpu_torch.pipelines import StableAudioPipeline
    pipe = StableAudioPipeline.tiny(device=device)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for m in pipe.vae.modules():
            if isinstance(m, Snake1d):
                m.alpha.copy_(0.3 * torch.randn(m.alpha.shape, generator=gen))
                m.beta.copy_(0.3 * torch.randn(m.beta.shape, generator=gen))
    return pipe


def phase_reference_stable_audio():
    """The tiny fp32 pipeline on the card and on the CPU with the same
    weights: the DiT forward (CFG batch of 3 waveforms), Oobleck's encode
    and decode, and REF_SA_STEPS EDM steps at CFG 7 from the same latents
    and prompt_embeds with the decoded audio; each bound fails its planted
    faults (run on the card): the KV heads and rope on every channel in the
    DiT, the snake's scales read as linear in Oobleck, the CFG conditioning
    tiled and a second-order first step in the sampler."""
    from diffmusic_tpu_torch.models import oobleck
    from diffmusic_tpu_torch.models import stable_audio_dit as sad
    from diffmusic_tpu_torch.pipelines import stable_audio as psa
    from diffmusic_tpu_torch.samplers import edm
    devs = dict(zip(("cuda", "cpu"), REF_DEVICES))
    pipes = {k: tiny_stable_audio(dev) for k, dev in devs.items()}
    card = pipes["cuda"]
    cfg, vcfg = card.dit_cfg, card.vae_cfg
    gen = torch.Generator().manual_seed(21)
    n = 2 * SA_WAVES
    x = torch.randn((n, cfg.in_channels, REF_SA_FRAMES), generator=gen)
    c_noise = torch.as_tensor(np.repeat(edm.EDMDPMSolverMultistepSchedule().timesteps(
        REF_SA_STEPS)[[0, 5]], SA_WAVES))
    ctx = torch.randn((n, 12, cfg.cross_attention_input_dim), generator=gen)
    glob = torch.randn((n, cfg.global_states_input_dim), generator=gen)

    @torch.no_grad()
    def dit(key):
        dev = devs[key]
        return pipes[key].dit(x.to(dev), c_noise.to(dev), ctx.to(dev), glob.to(dev)).cpu()

    want = dit("cpu")
    faults = {}
    for name, owner, attr, fault in (
            ("KV heads tiled", sad, "expand_kv_heads", tiled_kv_heads),
            ("rope on every channel", sad, "apply_partial_rotary",
             lambda q, cos, sin, rd, real=sad.apply_partial_rotary: real(
                 q, *sad.rotary_tables(q.shape[-1], q.shape[1], device=q.device),
                 q.shape[-1]))):
        with planted(owner, attr, fault):
            faults[name] = rel_err(dit("cuda"), want)[1]
    check_bound(f"tiny DiT forward {tuple(want.shape)} (GQA {cfg.num_attention_heads} over "
                f"{cfg.num_key_value_attention_heads} heads, rotary {cfg.rotary_dim} of "
                f"{cfg.attention_head_dim}), max|err| / max", rel_err(dit("cuda"), want)[1],
                REF_SA_MODULE_TOL, faults, phase="stable_audio reference")

    wav = 0.5 * torch.randn((2, vcfg.audio_channels, vcfg.hop_length * REF_SA_FRAMES),
                            generator=gen)
    z = torch.randn((2, vcfg.decoder_input_channels, REF_SA_FRAMES), generator=gen)

    @torch.no_grad()
    def vae(key):
        dev = devs[key]
        mean, std = pipes[key].vae.encode(wav.to(dev))
        return mean.cpu(), std.cpu(), pipes[key].vae.decode(z.to(dev)).cpu()

    want = vae("cpu")

    def vae_err():
        return max(rel_err(a, b)[1] for a, b in zip(vae("cuda"), want))

    reading = vae_err()
    with planted(oobleck.Snake1d, "forward", snake_without_exp):
        bad = vae_err()
    check_bound(f"tiny Oobleck encode (mean, std {tuple(want[0].shape)}) and decode "
                f"{tuple(want[2].shape)}, max|err| / max", reading, REF_SA_MODULE_TOL,
                {"snake scales linear": bad}, phase="stable_audio reference")

    hop, sr = vcfg.hop_length, vcfg.sampling_rate
    kw = dict(audio_end_in_s=REF_SA_FRAMES * hop / sr, num_inference_steps=REF_SA_STEPS,
              guidance_scale=SA_GUIDANCE, num_waveforms_per_prompt=SA_WAVES,
              latents=torch.randn((SA_WAVES, cfg.in_channels, REF_SA_FRAMES), generator=gen),
              prompt_embeds=torch.randn((2, 12, card.text_cfg.d_model), generator=gen))
    runs = {k: (p(**kw, output_type="latent").audios, p(**kw).audios) for k, p in pipes.items()}

    def chain_err(got):
        return [rel_err(torch.from_numpy(a), torch.from_numpy(b))[1]
                for a, b in zip(got, runs["cpu"])]

    faults = {}
    for name, owner, attr, fault in (("CFG conditioning tiled", psa, "repeat_rows", tiled_rows),
                                     ("second-order first step", edm, "dpm_solver_d",
                                      second_order_first_step)):
        with planted(owner, attr, fault):
            faults[name] = chain_err((card(**kw, output_type="latent").audios,
                                      card(**kw).audios))
    for i, (what, tol) in enumerate(((f"final latents {runs['cpu'][0].shape}",
                                      REF_SA_LATENT_TOL),
                                     (f"decoded audio {runs['cpu'][1].shape}",
                                      REF_SA_AUDIO_TOL))):
        check_bound(f"tiny pipeline, {REF_SA_STEPS} EDM steps at CFG {SA_GUIDANCE} of "
                    f"{SA_WAVES} waveforms: {what}, max|err| / max", chain_err(runs["cuda"])[i],
                    tol, {k: v[i] for k, v in faults.items()}, phase="stable_audio reference")


def full_width_stable_audio():
    """stabilityai/stable-audio-open-1.0's published widths with seeded
    random bf16 weights drawn on the card: the DiT (24 x 1536, 24 query and
    12 KV heads of 64, rotary 32), Oobleck (128 x (1, 2, 4, 8, 16), ratios
    (2, 4, 4, 8, 8), 44.1-kHz stereo), T5-base (12 x 768, d_ff 3072, ReLU)
    and the projection (768, seconds 0-512); the byte tokenizer padded to
    SA_TEXT_TOKENS, as the real tokenizer pads."""
    import functools
    from diffmusic_tpu_torch.models.configs import (OobleckConfig, StableAudioDiTConfig,
                                                    StableAudioProjectionConfig, T5Config)
    from diffmusic_tpu_torch.pipelines import StableAudioPipeline
    from diffmusic_tpu_torch.pipelines.stable_audio import stable_audio_byte_tokenizer
    t5 = T5Config(vocab_size=32128, d_model=768, d_kv=64, d_ff=3072, num_layers=12,
                  num_heads=12, is_gated_act=False)
    return StableAudioPipeline.random(
        StableAudioDiTConfig(), OobleckConfig(), t5, StableAudioProjectionConfig(), seed=50,
        device=SA_DEVICE, weight_dtype=torch.bfloat16, draw_on_device=True,
        tokenizer=functools.partial(stable_audio_byte_tokenizer, maxlen=SA_TEXT_TOKENS))


def stable_audio_cli(root: Path, device: str = "cuda") -> None:
    """`diffmusic_tpu_torch.run.main -m stable_audio -t music_generation
    --tiny` on the card, 2 steps, a 1-s clip (stable_audio.yaml's 3
    waveforms): the output tree, a stereo wav at the tiny Oobleck's 16 kHz,
    the generation order kept (no CLAP tower)."""
    from diffmusic_tpu_torch import run
    from diffmusic_tpu_torch.data import read_wav, write_wav
    clips = root / "clips"
    clips.mkdir(parents=True)
    write_wav(clips / "track.wav", harmonic_stack(16000 * 16, 16000), 16000)
    argv = ["-m", "stable_audio", "-t", "music_generation", "-c", "ddim", "--tiny",
            "--num_inference_steps", "2", "-o", f"data.root={clips}",
            "-o", "model.pipe.audio_end_in_s=1", "--device", device]
    cwd = Path.cwd()
    os.chdir(root)
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            run.main(argv)
        secs = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    done = root / "outputs" / "stable_audio" / "moises" / "ddim" / "music_generation"
    made = sorted(str(p.relative_to(done)) for p in done.rglob("*.*"))
    wav, sr = read_wav(done / "wav_recon" / "track.wav")
    kept = "keeping generation order" in out.getvalue()
    log(f"stable_audio cli: python -m diffmusic_tpu_torch.run {' '.join(argv)}: {secs:.2f} s, "
        f"wrote {made}; wav_recon {wav.shape} at {sr} Hz; generation order kept: {kept}")
    if len(made) != 6 or wav.shape != (2, 16000) or sr != 16000 or not np.isfinite(wav).all():
        raise AssertionError(f"stable_audio cli wrote {made}, wav {wav.shape} at {sr} Hz")
    if not kept:
        raise AssertionError("stable_audio cli: -nw 3 without a CLAP tower did not log "
                             "'keeping generation order'")


def phase_stable_audio() -> None:
    """The reference half, then full width (`full_width_stable_audio`) at
    stable_audio.yaml's settings: a 10-s clip (216 latent frames and the
    global token), 3 waveforms at CFG 7 (the DiT's batch 6), the empty prompt
    through T5 padded to 512 tokens; SA_STEPS EDM steps (ms per step from
    CUDA events at each DiT call), the text stack's seconds, Oobleck's
    decode of the 3 clips alone, peak memory; then the CLI's tiny run. No
    ported kernel is on this path: the launch counts must not move."""
    from diffmusic_tpu_torch import kernels
    before = kernels.launch_counts()
    phase_reference_stable_audio()
    t0 = time.time()
    pipe = full_width_stable_audio()
    torch.cuda.synchronize()
    sizes = {n: sum(p.numel() for p in getattr(pipe, n).parameters()) / 1e6
             for n in ("dit", "vae", "text_encoder", "projection")}
    log(f"stable_audio: full-width stable-audio-open-1.0 widths, seeded random bf16 weights "
        f"drawn on the card, built in {time.time() - t0:.1f} s; M parameters "
        f"{ {k: round(v, 1) for k, v in sizes.items()} }")
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            embeds = pipe.encode_prompt("", None, True)
            seconds = (torch.zeros(2, device=SA_DEVICE),
                       torch.full((2,), SA_SECONDS, device=SA_DEVICE))
            cond = pipe._conditioning(embeds, *seconds)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    log(f"stable_audio: text stack (T5-base over {tuple(embeds.shape)} tokens of the empty "
        f"prompt and negative prompt, the projection and duration conditioners) "
        f"{secs[0]:.3f} s first, {secs[1]:.3f} s again; conditioning "
        f"{[tuple(c.shape) for c in cond]} ({CARD})")

    stamps = []

    def stamp(*_):
        stamps.append(torch.cuda.Event(enable_timing=True))
        stamps[-1].record()

    hook = pipe.dit.register_forward_pre_hook(stamp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        audio = pipe(prompt="", audio_end_in_s=SA_SECONDS, num_inference_steps=SA_STEPS,
                     guidance_scale=SA_GUIDANCE, num_waveforms_per_prompt=SA_WAVES,
                     generator=torch.Generator(SA_DEVICE).manual_seed(0)).audios
    finally:
        hook.remove()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(b) for a, b in zip(stamps, stamps[1:])]
    q1, med, q3 = statistics.quantiles(step_ms[1:], n=4)
    hop = pipe.vae_cfg.hop_length
    frames = math.ceil(int(SA_SECONDS * pipe.vae_cfg.sampling_rate) / hop)
    log(f"stable_audio: {SA_STEPS} EDM DPM-Solver++ 2M steps of stable_audio.yaml's 200 (every "
        f"step does the same work: one DiT call on the CFG batch {2 * SA_WAVES} x "
        f"({frames} latent frames + the global token), cross-attention to "
        f"{SA_TEXT_TOKENS} tokens), {SA_WAVES} waveforms of {SA_SECONDS:g} s: ms per step "
        f"(DiT call to DiT call, CUDA events, after the first) median {med:.2f}, quartiles "
        f"{q1:.2f}/{q3:.2f} (first {step_ms[0]:.1f}); the call {wall:.2f} s wall with the "
        f"text stack and the decode; peak memory {peak / 2**30:.2f} GiB; audio {audio.shape} "
        f"({CARD})")
    if audio.shape != (SA_WAVES, 2, int(SA_SECONDS * 44100)) or not np.isfinite(audio).all():
        raise AssertionError(f"stable_audio: audio {audio.shape}, finite "
                             f"{np.isfinite(audio).all()}; expected ({SA_WAVES}, 2, 441000)")

    z = randn((SA_WAVES, pipe.vae_cfg.decoder_input_channels, frames),
              torch.Generator().manual_seed(51), SA_DEVICE, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        decode_ms = time_ms(lambda: pipe.vae.decode(z), reps=3, inner=1, warmup=1)
    log(f"stable_audio: Oobleck decode of {tuple(z.shape)} latents ({SA_WAVES} x "
        f"{SA_SECONDS:g} s, {frames * hop} samples a channel before the cut): {decode_ms:.2f} ms "
        f"(median of 3, CUDA events); peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB ({CARD})")
    del pipe, embeds, cond, z
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        stable_audio_cli(Path(tmp), SA_DEVICE)
    after = kernels.launch_counts()
    log(f"stable_audio: kernel launches across the phase {after == before} (none of the "
        f"ported kernels is on this path)")
    if after != before:
        raise AssertionError(f"stable_audio: the launch counts moved: {before} -> {after}")



def in_memory_musicldm(modules: dict, device, dtype):
    """A MusicLDM pipeline with a snapshot's weights handed over in memory:
    each state dict through the port's converter and `from_flax` into the
    modules, with no file between (the CLAP model's audio tower in fp32)."""
    from diffmusic_tpu_torch.models import checkpoint as ckpt
    from diffmusic_tpu_torch.models.clap import ClapTextModelWithProjection
    from diffmusic_tpu_torch.models.clap_features import (make_clap_audio_embed,
                                                          make_clap_frame_embed)
    from diffmusic_tpu_torch.models.convert import from_flax
    from diffmusic_tpu_torch.models.hifigan import SpeechT5HifiGan
    from diffmusic_tpu_torch.models.htsat import ClapAudioModelWithProjection
    from diffmusic_tpu_torch.models.unet import UNet2DConditionModel
    from diffmusic_tpu_torch.models.vae import AutoencoderKL
    from diffmusic_tpu_torch.pipelines import MusicLDMPipeline
    clap_json = modules["text_encoder"][0]
    audio_cfg = ckpt.clap_audio_config_from_json(clap_json)
    cfgs = {"unet": ckpt.unet_config_from_json(modules["unet"][0]),
            "vae": ckpt.vae_config_from_json(modules["vae"][0]),
            "vocoder": ckpt.hifigan_config_from_json(modules["vocoder"][0]),
            "text_encoder": ckpt.clap_text_config_from_json(clap_json), "tower": audio_cfg}
    text_tree, audio_tree = ckpt.clap_trees(modules["text_encoder"][1], cfgs["text_encoder"],
                                            audio_cfg)
    trees = {"unet": ckpt.convert_unet(modules["unet"][1], cfgs["unet"]),
             "vae": ckpt.convert_vae(modules["vae"][1], cfgs["vae"]),
             "vocoder": ckpt.vocoder_tree(modules["vocoder"][1], cfgs["vocoder"]),
             "text_encoder": text_tree, "tower": audio_tree}
    classes = {"unet": UNet2DConditionModel, "vae": AutoencoderKL, "vocoder": SpeechT5HifiGan,
               "text_encoder": ClapTextModelWithProjection,
               "tower": ClapAudioModelWithProjection}
    models = {}
    for name, cls in classes.items():
        cfg = cfgs[name]
        with torch.device("meta"):
            model = cls(cfg)
        model.load_state_dict(from_flax(trees[name], cfg), assign=True, strict=True)
        models[name] = model.to(device=device,
                                dtype=torch.float32 if name == "tower" else dtype)
    return MusicLDMPipeline(models["unet"], models["vae"], models["vocoder"],
                            text_encoder=models["text_encoder"], scheduler_name="dps",
                            clap_audio_embed=make_clap_audio_embed(models["tower"]),
                            clap_frame_embed=make_clap_frame_embed(models["tower"]))


CLI_AUDIO_S = 5.0                 # configs/model/{musicldm,audioldm2}.yaml
TINY_LEVEL_BLOCKS = (3, 4)        # the tiny UNet's transformer blocks per level:
                                  # down 1 + up 2; down 1 + mid 1 + up 2


def cli_launches(model: str, sched: str, steps: int, outer: int, audio_s: float) -> dict:
    """The UNet's launches of a --tiny CLI run on the default route: each UNet
    forward launches the block kernel (MusicLDM) or flash attention
    (AudioLDM2, fuse_cross off) once for every transformer block on a level
    of at least 512 tokens (the latent of the tiny VAE, which halves the
    mel's frames and 64 bins, halved again at level 1; the 16- and
    32-channel blocks run padded to one 64-channel slice); a step takes one
    forward, a DITTO step two (the forward and the recompute) per outer
    iteration."""
    from diffmusic_tpu_torch.pipelines.base import compute_geometry
    frames, _ = compute_geometry(audio_s, 16000, 160, 2)
    h, w = frames // 2, 64 // 2
    blocks = sum(n for level, n in enumerate(TINY_LEVEL_BLOCKS)
                 if -(-h // 2 ** level) * (w // 2 ** level) >= 512)
    forwards = 2 * steps * outer if sched == "ditto" else steps
    name = "fused_transformer_block" if model == "musicldm" else "flash_attention"
    return {name: forwards * blocks}


# the CLAP and TTS paths of the CLI: (model, extra flags), each -c dps in its
# own directory
CLI_CLAP_RUNS = (("musicldm", ["-t", "style_guidance"]),
                 ("audioldm2", ["--prompt_type", "clap"]),
                 ("musicldm", ["-nw", "2"]),
                 ("audioldm2", ["--transcription", "hello there"]))


def cli_run(root: Path, clips: Path, device: str, model: str, sched: str, extra=()) -> tuple:
    """One `diffmusic_tpu_torch.run.main --tiny` run, 2 steps, in `root`:
    (seconds, files written under its task directory, launch counts, its
    standard output)."""
    from diffmusic_tpu_torch import kernels, run
    argv = ["--tiny", "-m", model, "-c", sched, "--num_inference_steps", "2",
            "--device", device, "-o", f"data.root={clips}", *extra]
    if sched == "ditto":
        argv += ["-o", "scheduler.optim_outer_loop=2"]
    cwd = Path.cwd()
    os.chdir(root)
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            run.main(argv)
        secs = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    counts = kernels.launch_counts()
    task = "style_guidance" if "style_guidance" in extra else "music_inpainting"
    done = root / "outputs" / model / "moises" / sched / task
    made = sorted(str(p.relative_to(done)) for p in done.rglob("*.*"))
    log(f"cli: python -m diffmusic_tpu_torch.run {' '.join(argv)}: {secs:.2f} s, wrote "
        f"{made}; launches { {n: k for n, k in counts.items() if k} }")
    if len(made) != 6:
        raise AssertionError(f"cli run {model} {sched} {extra} wrote {made}")
    if device == "cuda":
        want = cli_launches(model, sched, 2, 2 if sched == "ditto" else 1, CLI_AUDIO_S)
        check_launches(f"cli {model} {sched} {' '.join(extra)}",
                       {n: counts[n] for n in want}, want)
    return secs, made, counts, out.getvalue()


def cli_runs(root: Path, device: str) -> None:
    """`diffmusic_tpu_torch.run.main` on the card with --tiny for -c dps,
    ditto and diffmusic x -m musicldm and audioldm2, 2 steps each, on a WAV
    dataset in `root` (ditto with 2 outer iterations of its config's 100),
    then CLI_CLAP_RUNS, each in a directory of its own; each run must write
    its output tree and launch the UNet's kernel as `cli_launches` says, and
    -nw 2 must log its CLAP re-ranking, best first."""
    from diffmusic_tpu_torch.data import write_wav
    clips = root / "clips"
    clips.mkdir(parents=True)
    write_wav(clips / "track.wav", harmonic_stack(16000 * 16, 16000), 16000)
    for model in ("musicldm", "audioldm2"):
        for sched in ("dps", "ditto", "diffmusic"):
            cli_run(root, clips, device, model, sched)
    for i, (model, extra) in enumerate(CLI_CLAP_RUNS):
        (root / f"clap_{i}").mkdir()
        stdout = cli_run(root / f"clap_{i}", clips, device, model, "dps", extra)[3]
        ranked = [ln for ln in stdout.splitlines() if ln.startswith("CLAP re-ranking")]
        if "-nw" in extra:
            sims = [float(v) for v in ranked[0].split("[")[1].rstrip("]").split()]
            log(f"cli: -nw 2 logged {ranked[0]!r}")
            if len(sims) != 2 or sims[0] < sims[1]:
                raise AssertionError(f"cli -nw 2: re-ranking logged {ranked}")
        elif ranked:
            raise AssertionError(f"cli {extra}: re-ranked one candidate")
    from diffmusic_tpu_torch.pipelines import base
    log(f"cli: matplotlib on this host: {base.have_matplotlib()} (else the 8-bit grey PNGs)")


def phase_checkpoint_cli(device: str = "cuda") -> None:
    """A full-width MusicLDM snapshot (fp32, seeded, the diffusers layout)
    written to a temporary directory and loaded by `from_pretrained` on the
    card: the load's seconds and MB/s; its 2 DPS steps from prompt embeds
    equal, to the bit, those of the same weights handed over in memory; then
    the CLI's runs."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import test_torch_port_snapshot as snap
    from diffmusic_tpu_torch.models.configs import (ClapTextConfig, HiFiGANConfig,
                                                    UNetConfig, VAEConfig)
    from diffmusic_tpu_torch.models.htsat import ClapAudioConfig
    from diffmusic_tpu_torch.pipelines import MusicLDMPipeline
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        modules = snap.musicldm_modules(UNetConfig(), VAEConfig(), HiFiGANConfig(),
                                        ClapTextConfig(), seed=20, audio_cfg=ClapAudioConfig())
        t1 = time.perf_counter()
        snap.write_snapshot(root / "musicldm", modules)
        snap.write_roberta_tokenizer(root / "musicldm" / "tokenizer")
        t2 = time.perf_counter()
        nbytes = sum(p.stat().st_size for p in (root / "musicldm").rglob("*.safetensors"))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        loaded = MusicLDMPipeline.from_pretrained(root / "musicldm", scheduler_name="dps",
                                                  device=device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t3
        log(f"checkpoint: full-width MusicLDM snapshot, {nbytes / 1e6:.1f} MB fp32 "
            f"safetensors (values {t1 - t0:.1f} s, written {t2 - t1:.1f} s); "
            f"from_pretrained on the card {load_s:.2f} s, {nbytes / 1e6 / load_s:.0f} MB/s")
        memory = in_memory_musicldm(modules, device, torch.float32)
        del modules
        towers = [p.clap_audio_embed.tower for p in (loaded, memory)]
        for name, (a, b) in [(n, (getattr(loaded, n), getattr(memory, n)))
                             for n in ("unet", "vae", "vocoder", "text_encoder")] + [
                                 ("CLAP audio tower", towers)]:
            a, b = a.state_dict(), b.state_dict()
            if sorted(a) != sorted(b) or not all(torch.equal(a[k], b[k]) for k in a):
                raise AssertionError(f"checkpoint: the loaded {name} differs from the same "
                                     f"weights handed over in memory")
        if not all(p.dtype == torch.float32 for p in towers[0].parameters()):
            raise AssertionError("checkpoint: the CLAP audio tower did not load in fp32")
        wav = torch.as_tensor(harmonic_stack(160000, 16000), device=device)
        op, meas = inpainting(10.0, device)
        lat = torch.randn(LATENTS, generator=torch.Generator().manual_seed(17))

        def two_steps(pipe):
            res, losses = dataclasses.replace(pipe, operator=op)(
                audio_length_in_s=10.0, num_inference_steps=2, eta=0.0, measurement=meas,
                ip_guidance_rate=2.0, latents=lat, prompt_embeds=torch.zeros(2, 512),
                return_losses=True)
            return res.audios, losses

        # deterministic algorithms where PyTorch has them (the nearest
        # upsampling's index_add backward, cuDNN's choices), so that two runs
        # of the same weights can agree to the bit
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        try:
            outs = [two_steps(loaded), two_steps(memory)]
            same = all(np.array_equal(a, b) for a, b in zip(*outs))
            again = same or all(np.array_equal(a, b) for a, b in zip(outs[1],
                                                                      two_steps(memory)))
            with torch.no_grad():
                pooled = [p.clap_audio_embed(wav) for p in (loaded, memory)]
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
        log(f"checkpoint: 2 fp32 DPS steps of the loaded pipeline and of the in-memory one: "
            f"losses {outs[0][1].tolist()} / {outs[1][1].tolist()}, outputs equal to the bit: "
            f"{same}" + ("" if same else f" (the in-memory pipeline against itself: {again})"))
        if not same or not np.isfinite(outs[0][0]).all():
            raise AssertionError("checkpoint: the loaded pipeline's output differs from the "
                                 "in-memory one's")
        n_tower = sum(p.numel() for p in towers[0].parameters())
        log(f"checkpoint: the snapshot's CLAP audio tower ({n_tower / 1e6:.1f} M parameters, "
            f"fp32) loaded equal to the bit; its pooled embedding of the 10-s harmonic stack "
            f"equal to the in-memory tower's: {torch.equal(*pooled)}")
        if not torch.equal(*pooled) or not torch.isfinite(pooled[0]).all():
            raise AssertionError("checkpoint: the loaded tower's embedding differs")
        check_tokenizers(loaded, root)
        del loaded, memory
        torch.cuda.empty_cache()
        cli_runs(root / "cli", device)


TOKENIZER_PROMPT = "A calm piano with soft jazz drums, slow beat"


def check_tokenizers(pipe, root: Path) -> None:
    """The snapshot's RoBERTa tokenizer and a T5 tokenizer.json, both read by
    the port's own readers on a host that may lack transformers: a prompt's
    ids, and the loaded pipeline's CLAP text embedding of it."""
    import importlib.util
    from diffmusic_tpu_torch.models.checkpoint import _make_hf_tokenizer
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import test_torch_port_snapshot as snap
    t5 = _make_hf_tokenizer(snap.write_t5_tokenizer_json(root / "t5_tokenizer"))
    for label, tok in (("the snapshot's tokenizer/", pipe.tokenizer), ("a T5 tokenizer.json", t5)):
        ids, mask = tok([TOKENIZER_PROMPT])
        n = int(mask.sum())
        log(f"checkpoint: {label} read by {tok.reader}; transformers importable here: "
            f"{importlib.util.find_spec('transformers') is not None}; {TOKENIZER_PROMPT!r} -> "
            f"{n} ids {ids[0, :n].tolist()} padded to {ids.shape[1]}")
        if n < 3 or not (ids[0, n:] == ids[0, -1]).all():
            raise AssertionError(f"checkpoint: {label} encoded {ids[0].tolist()}")
    with torch.no_grad():
        emb = pipe.encode_prompt(TOKENIZER_PROMPT, do_classifier_free_guidance=False)
    log(f"checkpoint: the loaded pipeline's CLAP text embedding of the prompt "
        f"{tuple(emb.shape)}, norm {emb.norm().item():.6f}")
    if emb.shape != (1, 512) or not torch.isfinite(emb).all() or abs(emb.norm().item() - 1) > 1e-4:
        raise AssertionError("checkpoint: the prompt's CLAP embedding")


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


def compare_eval_card_cpu(root: Path, ckpt: Path) -> dict:
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
    return scores["cuda"]


FADTK_SCORE_TOL = 1e-6   # the fadtk CLI's FAD against the eval's, relative


def fadtk_call(fn, argv) -> tuple:
    """(return value, standard output, seconds) of a fadtk command line's main."""
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        value = fn(argv)
    return value, out.getvalue(), time.perf_counter() - t0


def fadtk_command_lines(root: Path, card_scores: dict, device: str = "cuda") -> None:
    """The four fadtk command lines on the card, on fresh copies of the
    card-vs-CPU directories (EVAL_CARD_CPU_PAIRS pairs, two of them 44.1-kHz
    stereo): `fadtk` MODEL GT RECON (and --inf) must give the in-process
    eval's FAD (and FAD-inf) from cold caches; `fadtk.embeds` with 2 spawn
    workers on the card must cache what `fadtk` cached for the 16-kHz files
    (the loaders resample 44.1 kHz with scipy, the eval with ops/resample);
    `fadtk.package`'s bundle as the baseline must give the FAD of its
    directory; `fadtk.test`, the golden gate, must exit 0."""
    from diffmusic_tpu_torch.fadtk import __main__ as fadtk_main
    from diffmusic_tpu_torch.fadtk import embeds, package
    from diffmusic_tpu_torch.fadtk.test import __main__ as gate
    src = root / "card_cpu_cuda"
    copies = {}
    for name in ("main", "embeds"):
        copies[name] = root / f"fadtk_{name}"
        for sub in ("gt", "recon"):
            (copies[name] / sub).mkdir(parents=True)
            for f in sorted((src / sub).glob("*.wav")):
                shutil.copy(f, copies[name] / sub / f.name)
    d = copies["main"]
    fad, out, secs = fadtk_call(fadtk_main.main, ["mfcc-stack", str(d / "gt"),
                                                  str(d / "recon"), "--device", device])
    fad_inf, out_inf, _ = fadtk_call(fadtk_main.main, ["mfcc-stack", str(d / "gt"),
                                                       str(d / "recon"), "--inf",
                                                       "--device", device])
    want, want_inf = card_scores["FAD (mfcc-stack)"], card_scores["FAD-inf (mfcc-stack)"]
    errs = [abs(fad - want) / abs(want), abs(fad_inf - want_inf) / abs(want_inf)]
    log(f"fadtk: python -m diffmusic_tpu_torch.fadtk mfcc-stack GT RECON on "
        f"{EVAL_CARD_CPU_PAIRS} pairs from cold caches, {secs:.2f} s: {out.strip()!r}, and "
        f"--inf {out_inf.strip()!r}; the eval's FAD {want:.6f}, FAD-inf {want_inf:.6f}; rel "
        f"diff {errs[0]:.1e}, {errs[1]:.1e} (tol {FADTK_SCORE_TOL:.0e})")
    if max(errs) > FADTK_SCORE_TOL:
        raise AssertionError("fadtk: the command line's FAD differs from the eval's")

    e = copies["embeds"]
    _, out, secs = fadtk_call(embeds.main, ["-m", "mfcc-stack", "-d", str(e / "gt"),
                                            str(e / "recon"), "-w", "2", "--device", device])
    sixteen = {f"{i:03d}" for i in range(EVAL_CARD_CPU_PAIRS) if i not in (1, 2)}
    diffs = {}
    for sub in ("gt", "recon"):
        for f in sorted((e / sub / "embeddings" / "mfcc-stack").glob("*.npy")):
            a, b = np.load(f), np.load(d / sub / "embeddings" / "mfcc-stack" / f.name)
            diffs[f"{sub}/{f.stem}"] = (rel_err(torch.from_numpy(a), torch.from_numpy(b))[1]
                                        if a.shape == b.shape else float("inf"))
    log(f"fadtk: python -m diffmusic_tpu_torch.fadtk.embeds -w 2 (spawn workers on the card), "
        f"{secs:.2f} s: {out.strip().splitlines()}; caches against fadtk's, max|err| / max "
        f"{({k: f'{v:.1e}' for k, v in diffs.items()})} (16-kHz files within {TOL_FP32:.0e})")
    if len(diffs) != 2 * EVAL_CARD_CPU_PAIRS or any(
            v > TOL_FP32 for k, v in diffs.items() if k.split("/")[1] in sixteen):
        raise AssertionError("fadtk.embeds: the workers' caches differ from fadtk's")

    _, out, secs = fadtk_call(package.main, ["-m", "mfcc-stack", "-d", str(e / "gt"),
                                             "-o", str(e / "bundles"), "--device", device])
    from_bundle, _, _ = fadtk_call(fadtk_main.main, ["mfcc-stack",
                                                     str(e / "bundles" / "mfcc-stack.npz"),
                                                     str(e / "recon"), "--device", device])
    from_dir, _, _ = fadtk_call(fadtk_main.main, ["mfcc-stack", str(e / "gt"),
                                                  str(e / "recon"), "--device", device])
    rel = abs(from_bundle - from_dir) / abs(from_dir)
    log(f"fadtk: python -m diffmusic_tpu_torch.fadtk.package, {secs:.2f} s: {out.strip()!r}; "
        f"FAD from the bundle {from_bundle:.6f}, from its directory {from_dir:.6f}, rel diff "
        f"{rel:.1e}")
    if not rel <= FADTK_SCORE_TOL:
        raise AssertionError("fadtk.package: the bundle's FAD differs from its directory's")

    code, out, secs = fadtk_call(gate.main, ["--device", device])
    log(f"fadtk: python -m diffmusic_tpu_torch.fadtk.test on the card, {secs:.2f} s: exit "
        f"{code}; {out.strip().splitlines()}")
    if code != 0:
        raise AssertionError(f"fadtk.test exited {code}")


CLAP_LAION_TOL = 1e-3           # clap-laion embeddings, card vs CPU, fraction of max


def compare_clap_laion(root: Path, ckpt: Path) -> None:
    """clap-laion-audio from a CLAP directory in the checkpoint root (a
    ClapModel's audio tower and projection at ClapAudioConfig's defaults,
    seeded, in transformers' names) on the first EVAL_CARD_CPU_PAIRS pairs,
    card against CPU: each file's embeddings (10-s chunks at a 1-s hop, one
    batch through the tower) within CLAP_LAION_TOL of max."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import test_torch_port_snapshot as snap
    from diffmusic_tpu_torch.fadtk import get_model
    from diffmusic_tpu_torch.models.configs import ClapTextConfig
    from diffmusic_tpu_torch.models.htsat import ClapAudioConfig
    cfg = ClapAudioConfig()
    snap.write_snapshot(ckpt, {"clap": (snap.clap_json(ClapTextConfig(), cfg),
                                        snap.clap_audio_values(cfg, 40))})
    files = [f for d in ("gt", "recon") for f in sorted((root / d).glob("*.wav"))
             [:EVAL_CARD_CPU_PAIRS]]
    emb, secs = {}, {}
    for key, dev in zip(("cuda", "cpu"), REF_DEVICES):
        model = get_model("clap-laion-audio", ckpt, dev)
        wavs = [model.load_wav(f) for f in files]
        model.get_embedding(wavs[0][:16000])     # loads the tower
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb[key] = [model.get_embedding(w) for w in wavs]
        torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t0
    err = max(rel_err(torch.from_numpy(a), torch.from_numpy(b))[1]
              for a, b in zip(emb["cuda"], emb["cpu"]))
    log(f"eval clap-laion-audio (HTSAT at ClapAudioConfig's defaults, fp32) on "
        f"{len(files)} files of {EVAL_CARD_CPU_PAIRS} pairs, {[e.shape for e in emb['cuda']][0]} "
        f"each: card {secs['cuda']:.2f} s, CPU {secs['cpu']:.2f} s; card vs CPU max|err| / max "
        f"{err:.2e} (tol {CLAP_LAION_TOL:.0e})")
    if not err <= CLAP_LAION_TOL or not all(np.isfinite(e).all() for e in emb["cuda"]):
        raise AssertionError("the clap-laion embeddings on the card disagree with the CPU's")


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
        want = dict.fromkeys(COUNTERS, 0)
        want["fused_mel_spectrogram"] = eval_mel_launches(EVAL_PAIRS)
        check_launches("eval", counts, want)
        card_scores = compare_eval_card_cpu(root, ckpt)
        fadtk_command_lines(root, card_scores)
        compare_clap_laion(root, ckpt)
    return counts


# ---------------------------------------------------------- eval embedders
EMBED_TOL = 1e-4      # tiny fp32 embedders, card against CPU, max |err| / max |CPU|, TF32 off
EMBED_DEVICE = "cuda"  # the full-width runs' device
EMBED_REPS = 5        # timed clips per full-width embedder, after one warm-up


def tiny_embedders() -> dict:
    """family -> (config, sample rate, planted fault (owner, attr, value) or
    None) of the reference's tiny models."""
    from diffmusic_tpu_torch.models import encodec, wav2vec2, whisper
    small = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=64, conv_dim=(16,) * 7)
    return {
        "w2v2 (pre-LN)": (wav2vec2.Wav2Vec2Config(do_stable_layer_norm=True,
                                                  feat_extract_norm="layer", conv_bias=True,
                                                  **small), 16000,
                          (wav2vec2, "stable_last", lambda pre, post: pre)),
        "hubert": (wav2vec2.Wav2Vec2Config(model_type="hubert", **small), 16000, None),
        "wavlm": (wav2vec2.Wav2Vec2Config(model_type="wavlm", num_buckets=16,
                                          max_bucket_distance=40, **small), 16000,
                  (wav2vec2, "pass_on_bias", lambda bias, gated: gated)),
        "whisper": (whisper.WhisperEncoderConfig(d_model=32, encoder_layers=2,
                                                 encoder_attention_heads=2,
                                                 encoder_ffn_dim=64), 16000,
                    (whisper, "drop_last_frame", lambda power: power[..., 1:])),
        "encodec 24k": (encodec.EncodecConfig(hidden_size=16, num_filters=4), 24000,
                        (encodec, "conv_padding",
                         lambda total, extra, causal: (total - total // 2, total // 2 + extra))),
    }


def embedder(cfg, device):
    """(module, clip -> embedding tensor) of a config on `device`, its
    weights the module's default init under a fixed seed."""
    from diffmusic_tpu_torch.fadtk.model_loader import full_fp32
    from diffmusic_tpu_torch.models import encodec, wav2vec2, whisper
    torch.manual_seed(0)
    with torch.device(device):
        if isinstance(cfg, wav2vec2.Wav2Vec2Config):
            model = wav2vec2.Wav2Vec2Model(cfg)
            run = lambda x: model(x[None])[-1][0]  # noqa: E731
        elif isinstance(cfg, whisper.WhisperEncoderConfig):
            model, feats = whisper.WhisperEncoder(cfg), whisper.WhisperFeatureConfig()
            run = lambda x: model(whisper.log_mel_features(x[None], feats))[0]  # noqa: E731
        else:
            model = encodec.EncodecEncoder(cfg)
            run = lambda x: model(x[None, None])[0].T  # noqa: E731
    model.eval().requires_grad_(False)

    def embed(x):
        with torch.no_grad(), full_fp32():
            return run(x.to(device))
    return model, embed


def phase_eval_embedders() -> None:
    """The eval's transformers-family embedders: the tiny reference card
    against CPU with each family's planted fault, then the full-width models
    on one 10-s clip."""
    for family, (cfg, sr, fault) in tiny_embedders().items():
        clip = torch.from_numpy(0.1 * np.random.default_rng(5).standard_normal(sr)).float()
        cpu_model, cpu_embed = embedder(cfg, "cpu")
        card_model, card_embed = embedder(cfg, REF_DEVICES[0])
        card_model.load_state_dict(cpu_model.state_dict())
        ref = cpu_embed(clip)
        err = rel_err(card_embed(clip).cpu(), ref)[1]
        faults = None
        if fault is not None:
            with planted(*fault):
                faults = rel_err(card_embed(clip).cpu(), ref)[1]
        check_bound(f"{family} {tuple(ref.shape)} card against CPU", err, EMBED_TOL, faults,
                    phase="eval_embedders reference")
    full_width_embedders()


def full_width_configs() -> tuple:
    """(name, loader, config) of the full-width runs: w2v2-base (768 x 12,
    group-norm extractor, post-LN), WavLM-large (1024 x 24, layer-norm
    extractor, pre-LN, buckets 320 / 800), Whisper-large's encoder (1280 x
    32, 20 heads, FF 5120, 80 mels), EnCodec 24 kHz (EncodecConfig's
    defaults)."""
    from diffmusic_tpu_torch.fadtk import model_loader as ml
    from diffmusic_tpu_torch.models import encodec, wav2vec2, whisper
    return (
        ("w2v2-base", ml.W2V2Model("base", device=EMBED_DEVICE), wav2vec2.Wav2Vec2Config()),
        ("wavlm-large", ml.WavLMModel("large", device=EMBED_DEVICE), wav2vec2.Wav2Vec2Config(
            model_type="wavlm", hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
            intermediate_size=4096, feat_extract_norm="layer", do_stable_layer_norm=True)),
        ("whisper-large", ml.WhisperModel("large", device=EMBED_DEVICE),
         whisper.WhisperEncoderConfig(d_model=1280, encoder_layers=32,
                                      encoder_attention_heads=20, encoder_ffn_dim=5120)),
        ("encodec-emb", ml.EncodecEmbModel("24k", device=EMBED_DEVICE), encodec.EncodecConfig()),
    )


def full_width_embedders() -> None:
    from diffmusic_tpu_torch.models import encodec, wav2vec2, whisper
    for name, loader, cfg in full_width_configs():
        torch.manual_seed(1)
        with torch.device(EMBED_DEVICE):
            model = (wav2vec2.Wav2Vec2Model if isinstance(cfg, wav2vec2.Wav2Vec2Config) else
                     whisper.WhisperEncoder if isinstance(cfg, whisper.WhisperEncoderConfig)
                     else encodec.EncodecEncoder)(cfg)
        loader.model, loader.loaded = model.eval().requires_grad_(False), True
        if isinstance(cfg, wav2vec2.Wav2Vec2Config):
            loader.layer = cfg.num_hidden_layers
        if isinstance(cfg, whisper.WhisperEncoderConfig):
            loader.features = whisper.WhisperFeatureConfig()
        clip = (0.1 * np.random.default_rng(6).standard_normal(10 * loader.sr)).astype(np.float32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        emb = loader.get_embedding(clip)
        times = []
        for _ in range(EMBED_REPS):
            t0 = time.perf_counter()
            loader.get_embedding(clip)   # ends in a copy to the host
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_params = sum(p.numel() for p in model.parameters())
        log(f"eval_embedders: {name} at its published widths, seeded random fp32 weights "
            f"({n_params / 1e6:.1f} M parameters), one 10-s clip at {loader.sr} Hz through "
            f"get_embedding: {statistics.median(times):.2f} ms per clip (median of "
            f"{EMBED_REPS}; {min(times):.2f}-{max(times):.2f}), peak {peak:.3f} GiB, "
            f"embedding {emb.shape}, finite {bool(np.isfinite(emb).all())}; {CARD}")
        want_dim = loader.num_features
        if emb.ndim != 2 or emb.shape[1] != want_dim or not np.isfinite(emb).all():
            raise AssertionError(f"eval_embedders: {name} gave {emb.shape}")
        loader.model = None   # one model on the card at a time: each peak is its own
        del model
        torch.cuda.empty_cache()


# ------------------------------------------------------------------- mesh
MESH_LATENTS = (2,) + LATENTS[1:]   # num_waveforms_per_prompt 2
# Each clip of the batch-2 run against its own batch-1 run, ||a - b|| / ||b||
# of the audio, in fp32 with the waveform loss: a joint norm in place of the
# per-clip norm (`joint_norm_loss`, planted) must exceed it. In bf16 the
# plain ops' batch-dependent rounding (one bf16 ulp: the UNet 1.26e-2 of max
# at batch 2 against batch 1, the vocoder 1.53e-2, while every kernel gives
# batch 2 equal to the bit to its rows) carries to 1.6e-2 of the audio and
# hides the joint norm (H100 80GB HBM3, 700 W); in fp32 batch 2 stood 8.8e-5
# from batch 1 after 20 steps and the joint norm 1.75e-2.
MESH_CLIP_TOL = 1e-3
MESH_FP32_STEPS = 5    # the fp32 runs' steps: ~570 ms each at batch 2 on an H100
# the guidance rate of the mesh phase: a joint norm rescales each clip's
# unit guidance gradient by ||r_b|| / ||r_joint||, a change in proportion to
# the rate (at the slice's 2.0 it moved a small model's audio by 1e-3 in 3
# steps on the CPU)
MESH_RATE = 20.0
MESH_CACHE_TOL = 1e-5   # batched eval caches against per-file, max |err| / max
# the kernels of the slice's default route, by the model module that calls
# each, for the check of batch 2 against its rows run alone
MESH_KERNELS = (("layers", "fused_transformer_block"), ("hifigan", "conv1d_fused_pair"),
                ("hifigan", "conv1d_fused"), ("hifigan", "phase_convtranspose"))


def joint_norm_loss(target, op, audio, supervised_space):
    """The planted fault: one Frobenius norm over the batch for the per-clip sum."""
    pred = op.forward(audio)
    diff = target - (op.transform(pred) if supervised_space == "mel_spectrogram" else pred)
    return torch.linalg.vector_norm(diff)


def mesh_pipe(device, dtype=torch.float32):
    """The slice's full-width MusicLDM (seeded random weights, DPS, the box
    inpainting) on `device`: fp32 for the per-clip checks, the build of each
    rank of the two-card check."""
    from diffmusic_tpu_torch.models.configs import HiFiGANConfig, UNetConfig, VAEConfig
    return build_pipe(UNetConfig(), VAEConfig(), HiFiGANConfig(), 10.0, device, dtype)[0]


def mesh_rank_run(mesh, kw: dict) -> np.ndarray:
    """A rank of the two-card check (`parallel.launch`): `mesh_pipe` in fp32
    on the rank's card with TF32 off, as this script runs (a spawned rank
    starts from PyTorch's defaults, under which cuDNN's convolutions take
    TF32), called with `kw` on `mesh` and a generator seeded alike on every
    rank; returns the whole batch's audio."""
    from diffmusic_tpu_torch.parallel.mesh import seeded_generator
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipe = dataclasses.replace(mesh_pipe(mesh.device), mesh=mesh)
    return pipe(generator=seeded_generator(0, "cpu"), **kw).audios


def mesh_call_kw(meas, lat, steps: int = STEPS) -> dict:
    """The mesh phase's call: `steps` DPS steps of the slice from latents
    `lat` (its batch the number of waveforms), eta 0, MESH_RATE, the
    waveform loss."""
    return dict(audio_length_in_s=10.0, num_inference_steps=steps, eta=0.0, measurement=meas,
                ip_guidance_rate=MESH_RATE, latents=lat, prompt_embeds=torch.zeros(2, 512),
                supervised_space="wav_form", num_waveforms_per_prompt=lat.shape[0])


def mesh_run(label: str, pipe, kw: dict) -> tuple:
    """One run through the pipeline's __call__ with its ms per step (host
    clock between the steps' synchronised callbacks), peak memory and
    launches (counts set to 0 just before, read just after); returns (audio,
    launches)."""
    from diffmusic_tpu_torch import kernels
    stamps = []

    def on_step(i, t, x):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    start = time.perf_counter()
    out, losses = pipe(return_losses=True, callback=on_step, **kw)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_ms = [1e3 * (b - a) for a, b in zip([start] + stamps[:-1], stamps)]
    q1, med, q3 = statistics.quantiles(step_ms[1:], n=4)
    log(f"mesh {label}: latents {tuple(kw['latents'].shape)}, {len(step_ms)} DPS steps, waveform "
        f"loss; ms/step after the first: median {med:.2f}, quartiles {q1:.2f}/{q3:.2f} "
        f"(first {step_ms[0]:.1f}); peak memory {peak / 2**30:.2f} GiB; loss first "
        f"{losses[0]:.4f} last {losses[-1]:.4f}; launches "
        f"{ {n: k for n, k in counts.items() if k} }")
    if not np.isfinite(out.audios).all() or not np.isfinite(losses).all():
        raise AssertionError(f"mesh {label}: non-finite audio or losses")
    if out.audios.shape != (kw["latents"].shape[0], 160000):
        raise AssertionError(f"mesh {label}: audio {out.audios.shape}")
    return out.audios, counts


def kernel_rows(pipe, meas, lat) -> None:
    """Each kernel of the slice's default route, at the first call of each
    shape in 2 steps of the batch-2 run, against the same call on each row
    alone: equal to the bit, or within the kernel's bf16 tolerance."""
    from diffmusic_tpu_torch.models import hifigan, layers
    owners = {"layers": layers, "hifigan": hifigan}
    found = {}

    def rows_of(fn, name):
        def checked(x, *a, **k):
            y = fn(x, *a, **k)
            if x.shape[0] == 2 and (name, tuple(x.shape)) not in found:
                def row(v, i):
                    return v[i:i + 1] if torch.is_tensor(v) and v.ndim and v.shape[0] == 2 else v
                with torch.no_grad():
                    r = torch.cat([fn(x[i:i + 1].detach(), *[row(v, i) for v in a],
                                      **{n: row(v, i) for n, v in k.items()}) for i in range(2)])
                found[(name, tuple(x.shape))] = (torch.equal(r, y.detach()),
                                                 rel_err(y.detach(), r)[1])
            return y
        return checked

    with contextlib.ExitStack() as stack:
        for owner, name in MESH_KERNELS:
            stack.enter_context(planted(owners[owner], name,
                                        rows_of(getattr(owners[owner], name), name)))
        pipe(**dict(mesh_call_kw(meas, lat), num_inference_steps=2))
    log(f"mesh: each kernel at batch 2 against its rows alone (equal to the bit, max|err| / "
        f"max): {({f'{n} {s}': (eq, f'{e:.1e}') for (n, s), (eq, e) in found.items()})}")
    tol = {"fused_transformer_block": TOL_BLOCK_BF16}
    if {n for n, _ in found} != {n for _, n in MESH_KERNELS} or any(
            e > tol.get(n, TOL_CONV_BF16) for (n, _), (_, e) in found.items()):
        raise AssertionError("mesh: a kernel's batch-2 result differs from its rows alone")


def clip_errors(audio, refs) -> list:
    """||audio[i] - refs[i]|| / ||refs[i]|| per clip."""
    return [norm_rel(torch.from_numpy(audio[i]), torch.from_numpy(np.asarray(refs[i])))
            for i in range(len(refs))]


def mesh_eval(restored: np.ndarray) -> None:
    """The eval of EVAL_PAIRS pairs with mfcc-stack on the card per file and
    with --mesh dp=1 (each equal-length group of a directory in one batched
    call): seconds and the mel launches of each, the caches within
    MESH_CACHE_TOL."""
    from diffmusic_tpu_torch import eval as E
    from diffmusic_tpu_torch import kernels
    from diffmusic_tpu_torch.fadtk.engine import _load_16k
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_eval_dirs(root / "plain", restored)
        shutil.copytree(root / "plain", root / "mesh")
        groups = tuple(len({len(_load_16k(f)) for f in (root / "plain" / d).glob("*.wav")})
                       for d in ("gt", "recon"))
        counts, secs = {}, {}
        for side, extra in (("plain", []), ("mesh", ["--mesh", "dp=1"])):
            split = Counter()
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with eval_split(split), contextlib.redirect_stdout(io.StringIO()):
                E.main(["-gt", str(root / side / "gt"), "-r", str(root / side / "recon"),
                        "--embedding", "mfcc-stack", "--device", "cuda", *extra])
            torch.cuda.synchronize()
            secs[side] = (time.perf_counter() - t0, split["embedding mfcc-stack"])
            counts[side] = kernels.launch_counts()["fused_mel_spectrogram"]
        errs = [rel_err(torch.from_numpy(np.load(f)), torch.from_numpy(
                    np.load(root / "plain" / f.relative_to(root / "mesh"))))[1]
                for d in ("gt", "recon")
                for f in sorted((root / "mesh" / d / "embeddings" / "mfcc-stack").glob("*.npy"))]
        want = {"plain": eval_mel_launches(EVAL_PAIRS),
                "mesh": eval_mel_launches(EVAL_PAIRS, groups)}
        log(f"mesh eval: {EVAL_PAIRS} pairs, mfcc-stack, cold caches: per file "
            f"{secs['plain'][0]:.2f} s wall ({secs['plain'][1]:.2f} s embedding the caches), "
            f"--mesh dp=1 {secs['mesh'][0]:.2f} s wall ({secs['mesh'][1]:.2f} s embedding {groups} "
            f"equal-length groups); mel launches {counts} (expected {want}); {len(errs)} caches "
            f"max|err| / max {max(errs):.2e} (tol {MESH_CACHE_TOL:.0e})")
        if len(errs) != 2 * EVAL_PAIRS or max(errs) > MESH_CACHE_TOL:
            raise AssertionError("mesh eval: the batched caches differ from the per-file ones")
        if counts != want:
            raise AssertionError(f"mesh eval: mel launches {counts}, expected {want}")


def phase_mesh(restored: np.ndarray) -> None:
    """17. mesh: the slice's full-width MusicLDM at num_waveforms_per_prompt
    2, bf16, through `make_mesh(1)` (the path of --mesh dp=1), and at batch
    1 with no mesh, with their ms per step, peak memory and launches; each
    kernel at batch 2 against its rows alone;
    in fp32 each clip against its own batch-1 run within MESH_CLIP_TOL (the
    planted joint norm must exceed it); the eval through --mesh dp=1 against
    per file; the CLI's --mesh dp=1 tiny run; where two cards are visible,
    dp=2 across them over NCCL against the one-card fp32 batch-2 run."""
    from diffmusic_tpu_torch.parallel import make_mesh
    from diffmusic_tpu_torch.pipelines import musicldm
    t_phase = t0 = time.perf_counter()
    pipe = mesh_pipe("cuda", torch.bfloat16)
    _, meas = inpainting(10.0, "cuda")
    lat = torch.randn(MESH_LATENTS, generator=torch.Generator().manual_seed(0))
    log(f"mesh: full-width MusicLDM, seeded random bf16 weights, built in "
        f"{time.perf_counter() - t0:.1f} s")
    want = expected_launches("fused_transformer_block")
    counts = mesh_run("bf16 batch 2, make_mesh(1)", dataclasses.replace(pipe, mesh=make_mesh(1)),
                      mesh_call_kw(meas, lat))[1]
    check_launches("mesh batch 2", counts, want)
    counts = mesh_run("bf16 batch 1, clip 0", pipe, mesh_call_kw(meas, lat[:1]))[1]
    check_launches("mesh batch 1", counts, want)
    kernel_rows(pipe, meas, lat)
    del pipe
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pipe = mesh_pipe("cuda")
    log(f"mesh: the same model in fp32 (TF32 off), built in {time.perf_counter() - t0:.1f} s")
    kw = mesh_call_kw(meas, lat, MESH_FP32_STEPS)
    alone = mesh_run("fp32 batch 2", pipe, kw)[0]
    singles = [mesh_run(f"fp32 batch 1, clip {i}", pipe,
                        mesh_call_kw(meas, lat[i:i + 1], MESH_FP32_STEPS))[0][0]
               for i in range(MESH_LATENTS[0])]
    with planted(musicldm, "per_clip_loss", joint_norm_loss):
        joint = mesh_run("fp32 batch 2, planted joint norm", pipe, kw)[0]
    del pipe
    torch.cuda.empty_cache()
    errs, faults = clip_errors(alone, singles), clip_errors(joint, singles)
    log(f"mesh: each clip of fp32 batch 2 against its batch-1 run, ||err|| / ||batch 1||: "
        f"{[f'{e:.2e}' for e in errs]} (tol {MESH_CLIP_TOL:.0e}); with the joint norm planted "
        f"{[f'{e:.2e}' for e in faults]}")
    if max(errs) > MESH_CLIP_TOL or min(faults) <= MESH_CLIP_TOL:
        raise AssertionError("mesh: batch 2 disagrees with batch 1, or the bound let the "
                             "joint norm pass")
    mesh_eval(restored)
    with tempfile.TemporaryDirectory() as tmp:
        from diffmusic_tpu_torch.data import write_wav
        root = Path(tmp)
        (root / "clips").mkdir()
        write_wav(root / "clips" / "track.wav", harmonic_stack(16000 * 16, 16000), 16000)
        cli_run(root, root / "clips", "cuda", "musicldm", "dps", ["--mesh", "dp=1"])
    if torch.cuda.device_count() < 2:
        log(f"mesh: {torch.cuda.device_count()} card visible: the dp=2 check across two cards "
            f"over NCCL was not run")
    else:
        mesh_across_cards(meas, lat, alone)
    log(f"mesh: the phase took {time.perf_counter() - t_phase:.1f} s")


def mesh_across_cards(meas, lat, alone: np.ndarray) -> None:
    """dp=2 over two cards with NCCL (`parallel.launch`, each rank building
    the fp32 model on its card, `mesh_rank_run`): the ranks hold the same
    audio, each clip within MESH_CLIP_TOL of `alone`, the one-card fp32
    batch-2 run of `lat`."""
    from diffmusic_tpu_torch.parallel import launch, make_mesh
    t0 = time.perf_counter()
    ranks = launch(make_mesh(2, dp=2), mesh_rank_run,
                   mesh_call_kw(meas.cpu(), lat, MESH_FP32_STEPS), timeout=900)
    secs = time.perf_counter() - t0
    audio = ranks[0]
    agree = all(np.array_equal(r, audio) for r in ranks)
    errs = clip_errors(audio, alone)
    log(f"mesh: dp=2 over 2 cards (NCCL), {secs:.1f} s with the ranks' start and build: the "
        f"ranks hold the same audio: {agree}; each clip against the one-card batch-2 run "
        f"{[f'{e:.2e}' for e in errs]} (tol {MESH_CLIP_TOL:.0e})")
    if not agree or max(errs) > MESH_CLIP_TOL:
        raise AssertionError("mesh: dp=2 across two cards disagrees with one card")


def ptxas_summary(build_log: str, kernel: str) -> str:
    """Registers, shared memory and spills that `nvcc -Xptxas -v` reported
    for the kernel whose mangled name contains `kernel`."""
    lines = build_log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            info = [ln.split(":", 1)[-1].strip() for ln in lines[i + 1:i + 4]
                    if "spill" in ln or "registers" in ln]
            return "; ".join(info) or "no ptxas lines"
    return "not found in the build log"


def ptxas_faults(build_log: str, kernel: str) -> list:
    """The ptxas lines that fault every instantiation of `kernel`: a warning
    that its wgmma are serialised (C75xx: C7514, C7515, C7520, ...) or spill
    stores or loads."""
    lines = build_log.splitlines()
    faults = [ln.strip() for ln in lines if "(C75" in ln and kernel in ln]
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            for ln in lines[i + 1:i + 4]:
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
                if spill and (int(spill.group(1)) or int(spill.group(2))):
                    faults.append(f"{line.strip()}: {ln.strip()}")
    return faults


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
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.out is not None:
        global LOG_FILE
        args.out = args.out.resolve()   # the CLI phase runs in another directory
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
    global CARD
    CARD = smi
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    t0 = time.time()
    build.library()
    log(f"build: {time.time() - t0:.1f} s ({build.BUILD_ROOT / build.source_hash()})")
    build_log = (build.BUILD_ROOT / build.source_hash() / "build.log")
    if build_log.exists():
        text = build_log.read_text()
        for line in text.splitlines():
            if ("entry function" in line or "registers" in line or "spill" in line
                    or "(C75" in line):   # C75xx: ptxas serialized a kernel's wgmma
                log(f"  ptxas: {line.strip()}")
        lib = build.library()
        for name, dyn in (("conv2d_wgmma_kernel", lib.dm_conv2d_same_smem(1)),
                          ("nchw_to_nhwc_kernel", None),
                          ("flash_mma_kernel", lib.dm_flash_attention_smem(1, 16)),
                          ("flash_hopper_kernelILi4E", lib.dm_flash_attention_wide_smem(1, 512)),
                          ("flash_wide_f32_kernel", lib.dm_flash_attention_wide_smem(0, 512)),
                          ("phase_ct_wgmma_kernel", lib.dm_phase_convtranspose_smem(1, -2, 1)),
                          ("conv1d_wgmma_kernelILb1E", lib.dm_conv1d_pair_smem(1, 512, 3, 1)),
                          ("conv1d_wgmma_kernelILb0E", lib.dm_conv1d_fused_smem(1, 11, 1)),
                          ("stage_wgmma_kernelILi1E", lib.dm_stage_bwd_smem(1)),
                          ("stage_wgmma_kernelILi2E", lib.dm_stage_bwd_smem(1)),
                          ("moments_bf16_kernelILi8E", None),
                          ("gn_cluster_kernelI13__nv_bfloat16Li8E", None),
                          ("mel_fft_kernelILi32E", None), ("mel_fft_kernelILi64E", None),
                          ("block_mma_kernel", lib.dm_transformer_block_smem(1, 256)),
                          ("leaky_mask_gt_kernelI13__nv_bfloat16", None),
                          ("leaky_mask_kernelI13__nv_bfloat16", None)):
            extra = "" if dyn is None else f"; {dyn} bytes of dynamic shared memory"
            log(f"  ptxas {name}: {ptxas_summary(text, name)}{extra}")
        if args.out is not None:
            args.out.mkdir(parents=True, exist_ok=True)
            shutil.copy(build_log, args.out / "build.log")
        faults = ptxas_faults(text, "flash_hopper_kernel")
        if faults:
            raise AssertionError("ptxas: flash_hopper_kernel spills or serialises its wgmma:\n"
                                 + "\n".join(faults))

    profile_dir = args.out if args.profile else None
    gen = torch.Generator().manual_seed(0)
    stats = phase_kernels(gen)
    phase_reference()
    phase_reference_routes()
    phase_reference_new_routes()
    phase_reference_audioldm2()
    slice_counts, restored = phase_slice(profile_dir)
    a2 = phase_audioldm2(profile_dir)
    phase_reference_tasks()
    phase_tasks()
    phase_reference_ditto()
    phase_ditto_optim_prompt()
    phase_clap()
    phase_stable_audio()
    phase_checkpoint_cli()
    eval_counts = phase_eval(restored)
    phase_eval_embedders()
    phase_mesh(restored)
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
                        ("fused_transformer_block_bsoft", "bsoft"),
                        ("conv2d_same_adjoint", "conv2d_bwd"),
                        ("conv1d_fused_adjoint", "adjoint")):
        counts[name] = slice_counts[route][name]
    # the VAE mid-block's flash attention: MusicLDM's blocks take the block kernel
    counts["flash_attention_d512"] = slice_counts["vae_flash"]["flash_attention"]
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
        if "wide" in s:   # the D 512 kernel's rates, launch and backward times
            kernels_line[-1].update(s["wide"])
        if "g_transposed" in s:
            kernels_line[-1]["g_transposed"] = {
                k: s["g_transposed"][k] for k in ("ms", "plain_ms", "library_ms")}
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
