"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA device and the CUDA toolkit (`nvcc`): without a
device they skip. The file imports no jax, so that it runs on a GPU machine
that has none; `tests/conftest.py` imports jax, so run it there with

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

TF32 is off for the fp32 cases. Tolerances, as a fraction of max |plain|:
fp32 1e-4 (another summation order than cuDNN/cuBLAS); bf16 2e-2 for the
convs, the flash attention and the guided step's route kernels (GroupNorm,
moments, conv2d, masks, the canvas convs and the stage backward) and 3e-2
for the transformer block (one bf16 rounding of an intermediate moves a
product by about 2^-8 relative). bf16 gradients of the vocoder kernels are
held by norm (a leaky-ReLU mask flips where an activation rounds across
zero differently in the two versions). Canvas outputs and gradients must be
exactly zero outside the signal. The fused mel spectrogram is fp32 only:
1e-4 of max |plain| forward, gradients too.
"""

import math

import numpy as np
import pytest
import torch

from diffmusic_tpu_torch import kernels
from diffmusic_tpu_torch.inverse_problem import MusicInpaintingOperator
from diffmusic_tpu_torch.kernels import attention as tattn
from diffmusic_tpu_torch.kernels import canvas as tcanvas
from diffmusic_tpu_torch.kernels import conv1d as tconv
from diffmusic_tpu_torch.kernels import conv2d as tconv2d
from diffmusic_tpu_torch.kernels import group_norm as tgn
from diffmusic_tpu_torch.kernels import mask as tmask
from diffmusic_tpu_torch.kernels import mel as tmel
from diffmusic_tpu_torch.kernels import stage_bwd as tstage
from diffmusic_tpu_torch.kernels import transformer_block as ttb
from diffmusic_tpu_torch.kernels import upsampler as tup
from diffmusic_tpu_torch.metrics.embeddings import MFCCStackEmbedding
from diffmusic_tpu_torch.models.configs import HiFiGANConfig, UNetConfig, VAEConfig
from diffmusic_tpu_torch.pipelines import MusicLDMPipeline

SLOPE = 0.1
MUSICLDM_KERNELS = ("fused_transformer_block", "conv1d_fused_pair", "conv1d_fused",
                    "phase_convtranspose")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(0)


def rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def arr(gen, *shape, scale=1.0, device="cuda", dtype=torch.float32):
    return torch.from_numpy((gen.standard_normal(shape) * scale).astype(np.float32)).to(
        device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_conv_kernels_on_card(cuda, gen, dtype, tol):
    c, t = 128, 333
    x = arr(gen, 2, t, c, dtype=dtype)
    w1 = arr(gen, 7, c, c, scale=0.03, dtype=dtype)
    w2 = arr(gen, 7, c, c, scale=0.03, dtype=dtype)
    b = arr(gen, c, scale=0.1, dtype=dtype)
    kernels.reset_launch_counts()
    y = tconv.conv1d_fused_pair(x, w1, b, w2, b, 3, SLOPE)
    assert rel(y, tconv.pair_plain(x, w1, b, w2, b, 3, SLOPE)[0]) <= tol
    y = tconv.conv1d_fused(x, w1, b, x, 5, SLOPE)
    assert rel(y, tconv.conv1d_plain(x, w1, b, 5, SLOPE, x)) <= tol
    wt = arr(gen, 16, c, 64, scale=0.03, dtype=dtype)
    bt = b[:64].contiguous()
    t_out = tup.output_length(t, 5, 16)
    y = tup.phase_convtranspose(x, wt, bt, 5, 16, t_out)
    assert rel(y, tup.convtranspose_plain(x, wt, bt, 5, 16)) <= tol
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"conv1d_fused": 1, "conv1d_fused_pair": 1,
                                       "phase_convtranspose": 1,
                                       "fused_transformer_block": 0,
                                       "fused_transformer_block_cross": 0,
                                       "fused_transformer_block_bsoft": 0,
                                       "flash_attention": 0, "fused_group_norm": 0,
                                       "channel_moments": 0, "conv2d_same": 0,
                                       "leaky_mask": 0, "leaky_mask_add": 0,
                                       "conv1d_fused_canvas": 0, "conv1d_pair_canvas": 0,
                                       "stage_resblocks_canvas": 0,
                                       "fused_mel_spectrogram": 0}


def block_params(gen, c, dtype, cross_dims=()):
    s = 1.0 / math.sqrt(c)
    p = dict(ln1_scale=1 + arr(gen, c, scale=0.1, dtype=dtype),
             ln1_bias=arr(gen, c, scale=0.1, dtype=dtype),
             wq=arr(gen, c, c, scale=s, dtype=dtype), wk=arr(gen, c, c, scale=s, dtype=dtype),
             wv=arr(gen, c, c, scale=s, dtype=dtype), wo=arr(gen, c, c, scale=s, dtype=dtype),
             bo=arr(gen, c, scale=0.1, dtype=dtype),
             ln3_scale=1 + arr(gen, c, scale=0.1, dtype=dtype),
             ln3_bias=arr(gen, c, scale=0.1, dtype=dtype),
             wi=arr(gen, c, 8 * c, scale=s, dtype=dtype),
             bi=arr(gen, 8 * c, scale=0.1, dtype=dtype),
             wo2=arr(gen, 4 * c, c, scale=0.5 * s, dtype=dtype),
             bo2=arr(gen, c, scale=0.1, dtype=dtype))
    for i, cd in enumerate(cross_dims):
        p.update({f"ln2{i}_scale": 1 + arr(gen, c, scale=0.1, dtype=dtype),
                  f"ln2{i}_bias": arr(gen, c, scale=0.1, dtype=dtype),
                  f"cwq{i}": arr(gen, c, c, scale=s, dtype=dtype),
                  f"cwk{i}": arr(gen, cd, c, scale=1 / math.sqrt(cd), dtype=dtype),
                  f"cwv{i}": arr(gen, cd, c, scale=1 / math.sqrt(cd), dtype=dtype),
                  f"cwo{i}": arr(gen, c, c, scale=s, dtype=dtype),
                  f"cbo{i}": arr(gen, c, scale=0.1, dtype=dtype)})
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_transformer_block_kernel_on_card(cuda, gen, dtype, tol):
    c = 128
    x = arr(gen, 2, 700, c, dtype=dtype)
    p = block_params(gen, c, dtype)
    out = ttb.fused_transformer_block(x, p, c // 8, 8)
    assert rel(out, ttb.transformer_block_plain(x, p, c // 8, 8)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_dual_cross_block_kernel_on_card(cuda, gen, dtype, tol):
    """Two streams: 8 unmasked keys of width 96, then 40 keys of width 64
    whose second row masks its last 15 (two key chunks of the kernel)."""
    c = 128
    x = arr(gen, 2, 700, c, dtype=dtype)
    p = block_params(gen, c, dtype, (96, 64))
    ctx = (arr(gen, 2, 8, 96, dtype=dtype), arr(gen, 2, 40, 64, dtype=dtype))
    mask = torch.ones(2, 40, device=cuda)
    mask[1, 25:] = 0
    biases = (torch.zeros(2, 1, 8, device=cuda), torch.where(mask > 0, 0.0, -1e9)[:, None])
    kernels.reset_launch_counts()
    out = ttb.fused_transformer_block(x, p, c // 8, 8, ctx, biases)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_transformer_block_cross"] == 1
    assert kernels.launch_counts()["fused_transformer_block"] == 0
    assert rel(out, ttb.transformer_block_plain(x, p, c // 8, 8, ctx, biases)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t,heads", [(700, 16), (333, 4), (1000, 32)])
def test_flash_attention_kernel_on_card(cuda, gen, dtype, tol, t, heads):
    q, k, v = (arr(gen, 2, t, heads, 8, dtype=dtype) for _ in range(3))
    kernels.reset_launch_counts()
    out = tattn.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 1
    assert rel(out, tattn.attention_plain(q, k, v)) <= tol


@pytest.mark.cuda
def test_new_wrappers_raise_for_head_dim_16(cuda, gen):
    """The kernels take head_dim 8 only; a CUDA tensor of another head_dim
    raises rather than falling back to the plain version."""
    q = arr(gen, 1, 600, 4, 16)
    with pytest.raises(ValueError, match="head_dim 8"):
        tattn.flash_attention(q, q, q)
    c = 64
    p = block_params(gen, c, torch.float32, (32,))
    x = arr(gen, 1, 600, c)
    with pytest.raises(ValueError, match="head_dim 8"):
        ttb.fused_transformer_block(x, p, c // 16, 16, (arr(gen, 1, 8, 32),),
                                    (torch.zeros(1, 1, 8, device=cuda),))


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda, gen):
    x = arr(gen, 1, 40, 128)
    w = arr(gen, 3, 128, 128)
    b = arr(gen, 128)
    with pytest.raises(TypeError):     # mixed dtypes
        tconv.conv1d_fused(x, w.to(torch.bfloat16), b, None, 1, SLOPE)
    with pytest.raises(ValueError):    # non-contiguous input
        tconv.conv1d_fused(arr(gen, 1, 80, 128)[:, ::2], w, b, None, 1, SLOPE)
    with pytest.raises(ValueError):    # channels the tiles do not divide
        tconv.conv1d_fused(arr(gen, 1, 40, 48), arr(gen, 3, 48, 48), arr(gen, 48),
                           None, 1, SLOPE)
    c = 64
    p = {n: arr(gen, *shape, dtype=torch.bfloat16) for n, shape in (
        ("ln1_scale", (c,)), ("ln1_bias", (c,)), ("wq", (c, c)), ("wk", (c, c)),
        ("wv", (c, c)), ("wo", (c, c)), ("bo", (c,)), ("ln3_scale", (c,)),
        ("ln3_bias", (c,)), ("wi", (c, 8 * c)), ("bi", (8 * c,)), ("wo2", (4 * c, c)),
        ("bo2", (c,)))}
    with pytest.raises(TypeError):     # fp32 activations, bf16 weights
        ttb.fused_transformer_block(arr(gen, 1, 600, c), p, c // 8, 8)


@pytest.mark.cuda
def test_pipeline_draws_from_a_cpu_generator_on_card(cuda):
    """No latents and eta > 0: the initial latents and the DPS noise come from
    a CPU generator, and one seed gives the card the CPU's numbers. fp32 with
    the waveform loss; final latents within 1e-4 (norm) of the CPU run."""
    audio_s = 0.64       # latents (1, 8, 32, 32): level-0 T = 1024, fused block
    unet_cfg = UNetConfig(block_out_channels=(128, 128), layers_per_block=1,
                          norm_num_groups=32, has_attention=(True, False))
    vae_cfg = VAEConfig(block_out_channels=(32, 64), layers_per_block=1, norm_num_groups=16)
    # in fp32 the ch512 k=7 pairs exceed pair_ok's 9 MB and take conv1d_fused
    voc_cfg = HiFiGANConfig(resblock_kernel_sizes=(3, 7),
                            resblock_dilation_sizes=((1, 3), (1, 3)))
    wave = np.random.default_rng(0).standard_normal((1, int(audio_s * 16000)))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        op = MusicInpaintingOperator(audio_length_in_s=audio_s, sample_rate=16000,
                                     mask_type="box", start_inpainting_s=audio_s * 0.4,
                                     end_inpainting_s=audio_s * 0.6)
        pipe = MusicLDMPipeline.random(unet_cfg, vae_cfg, voc_cfg, seed=0, device=dev,
                                       scheduler_name="dps", operator=op)
        meas = op.forward(torch.from_numpy(0.1 * wave).float().to(dev))
        kernels.reset_launch_counts()
        res, losses = pipe(audio_length_in_s=audio_s, num_inference_steps=2, eta=0.5,
                           generator=torch.Generator().manual_seed(3),
                           prompt_embeds=torch.zeros(2, 512), measurement=meas,
                           ip_guidance_rate=2.0, output_type="latent",
                           return_losses=True, supervised_space="wav_form")
        out[dev.type] = res.audios, losses, kernels.launch_counts()
    (lat_g, loss_g, counts), (lat_c, loss_c, _) = out["cuda"], out["cpu"]
    assert all(counts[n] > 0 for n in MUSICLDM_KERNELS), counts
    assert np.isfinite(lat_g).all() and np.isfinite(loss_g).all()
    assert np.linalg.norm(lat_g - lat_c) / np.linalg.norm(lat_c) <= 1e-4


def grads(fn, x, g):
    xx = x.clone().requires_grad_(True)
    y = fn(xx)
    return y.detach(), torch.autograd.grad(y, xx, g)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_group_norm_kernels_on_card(cuda, gen, dtype, tol):
    """Fused GroupNorm (+SiLU) and the channel moments, values and input
    gradients; the groups of (1, 128, 9, 7) and the rows of (2, 256, 9, 7)
    are runs of 252 and 63 elements, which take the scalar paths."""
    kernels.reset_launch_counts()
    for shape, silu in (((2, 128, 16, 16), True), ((1, 128, 9, 7), False),
                        ((2, 256, 9, 7), True)):
        b, c, h, w = shape
        x = arr(gen, *shape, scale=2.0, dtype=dtype) + 0.3
        wt = 1 + arr(gen, c, scale=0.2, dtype=dtype)
        bt = arr(gen, c, scale=0.1, dtype=dtype)
        g = arr(gen, *shape, dtype=dtype)
        y, dx = grads(lambda xx: tgn.fused_group_norm(xx, wt, bt, 32, 1e-5, silu), x, g)
        y0, dx0 = grads(lambda xx: tgn.group_norm_plain(xx, wt, bt, 32, 1e-5, silu), x, g)
        assert rel(y, y0) <= tol
        assert rel(dx, dx0) <= tol
        gm = arr(gen, b, 2, c)
        m, dm = grads(lambda xx: tgn.channel_moments(xx.reshape(b, c, h * w)), x, gm)
        m0, dm0 = grads(lambda xx: tgn.moments_plain(xx.reshape(b, c, h * w)), x, gm)
        assert m.dtype == torch.float32 and rel(m, m0) <= 1e-4
        assert rel(dm, dm0) <= tol
        assert rel(tgn.stats_group_norm(x, wt, bt, 32, 1e-6, silu),
                   tgn.group_norm_plain(x, wt, bt, 32, 1e-6, silu)) <= tol
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["fused_group_norm"] == 3 and counts["channel_moments"] == 6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_conv2d_kernel_on_card(cuda, gen, dtype, tol):
    """The 'same' conv2d forward kernel and its plain adjoint backward
    against F.conv2d's, at ragged pixel tiles, a (1, 3) kernel and a
    channel-raising slice geometry (W 16)."""
    kernels.reset_launch_counts()
    for xs, ws in (((2, 128, 9, 20), (128, 128, 3, 3)), ((1, 64, 10, 12), (64, 64, 1, 3)),
                   ((1, 128, 32, 16), (256, 128, 3, 3))):
        x = arr(gen, *xs, dtype=dtype)
        w = arr(gen, *ws, scale=1.0 / math.sqrt(ws[1] * ws[2] * ws[3]), dtype=dtype)
        b = arr(gen, ws[0], scale=0.1, dtype=dtype)
        g = arr(gen, xs[0], ws[0], xs[2], xs[3], dtype=dtype)
        y, dx = grads(lambda xx: tconv2d.conv2d_same(xx, w, b), x, g)
        y0, dx0 = grads(lambda xx: tconv2d.conv2d_plain(xx, w, b), x, g)
        assert rel(y, y0) <= tol
        assert rel(dx, dx0) <= tol
    torch.cuda.synchronize()
    assert kernels.launch_counts()["conv2d_same"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.bfloat16, 2e-2)])
def test_leaky_mask_kernels_on_card(cuda, gen, dtype, tol):
    """Both masks against the plain versions, with a ragged tail
    ((1, 1001, 100): 100100 elements, not a multiple of 8) and the slice's
    ch512 stage."""
    kernels.reset_launch_counts()
    for shape in ((1, 1001, 100), (1, 5001, 512)):
        h, g, r = (arr(gen, *shape, dtype=dtype) for _ in range(3))
        assert rel(tmask.leaky_mask(h, g, SLOPE), tmask.leaky_mask_plain(h, g, SLOPE)) <= tol
        assert rel(tmask.leaky_mask_add(h, g, r, SLOPE),
                   tmask.leaky_mask_plain(h, g, SLOPE, r)) <= tol
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["leaky_mask"] == 2 and counts["leaky_mask_add"] == 2


@pytest.mark.cuda
def test_route_wrappers_reject_what_the_kernels_do_not_take(cuda, gen):
    """A CUDA tensor the kernels do not take raises; nothing falls back."""
    x = arr(gen, 1, 64, 16, 16)
    with pytest.raises(ValueError):    # Cout not a multiple of 64
        tconv2d.conv2d_same(x, arr(gen, 32, 64, 3, 3), arr(gen, 32))
    with pytest.raises(TypeError):     # bf16 x, fp32 scale and shift
        tgn.fused_group_norm(x.to(torch.bfloat16), arr(gen, 64), arr(gen, 64), 32, 1e-5)
    with pytest.raises(ValueError):    # non-contiguous rows
        tgn.channel_moments(arr(gen, 1, 16, 64).transpose(1, 2))
    with pytest.raises(ValueError):    # shapes differ
        tmask.leaky_mask(arr(gen, 1, 40, 128), arr(gen, 1, 41, 128), SLOPE)


def norm_rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def outside(a, t: int) -> float:
    """max |a| over the canvas rows outside the signal [512, 512 + t)."""
    a = a.detach().float()
    return max(float(a[:, :512].abs().max()), float(a[:, 512 + t:].abs().max()))


def canvas(gen, t, c, dtype):
    return tcanvas.to_canvas(arr(gen, 1, t, c, dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_canvas_conv_kernels_on_card(cuda, gen, dtype, tol):
    """conv1d_fused_canvas (forward and its adjoint launch, bwd "kernel")
    and conv1d_pair_canvas against autograd through their plain versions,
    at a signal that ends inside a 64-row tile and inside a 512-row block;
    exact zeros outside the signal."""
    t, c = 1100, 128
    kernels.reset_launch_counts()
    for k, d in ((11, 3), (3, 1)):
        xc, rc, gc = (canvas(gen, t, c, dtype) for _ in range(3))
        w = arr(gen, k, c, c, scale=1 / math.sqrt(k * c), dtype=dtype)
        b = arr(gen, c, scale=0.1, dtype=dtype)
        res = rc if d == 1 else None
        y, dx = grads(lambda xx: tconv.conv1d_fused_canvas(xx, w, b, res, t, d, SLOPE, "kernel"),
                      xc, gc)
        y0, dx0 = grads(lambda xx: tconv.canvas_plain(xx, w, b, t, d, SLOPE, res), xc, gc)
        assert rel(y, y0) <= tol and norm_rel(dx, dx0) <= tol
        assert outside(y, t) == 0 and outside(dx, t) == 0
        w2 = arr(gen, k, c, c, scale=1 / math.sqrt(k * c), dtype=dtype)
        y, dx = grads(lambda xx: tconv.conv1d_pair_canvas(xx, w, b, w2, b, t, d, SLOPE), xc, gc)
        y0, dx0 = grads(lambda xx: tconv.pair_canvas_plain(xx, w, b, w2, b, t, d, SLOPE)[0],
                        xc, gc)
        h = tconv.pair_canvas_forward(xc, w, b, w2, b, t, d, SLOPE)[1]
        h0 = tconv.pair_canvas_plain(xc, w, b, w2, b, t, d, SLOPE)[1]
        assert rel(y, y0) <= tol and rel(h, h0) <= tol and norm_rel(dx, dx0) <= tol
        assert outside(y, t) == 0 and outside(h, t) == 0 and outside(dx, t) == 0
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["conv1d_fused_canvas"] == 4 and counts["conv1d_pair_canvas"] == 4, counts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_stage_kernel_on_card(cuda, gen, dtype, tol):
    """The stage route at KS (3, 7, 11), dilations (1, 3, 5) x 3, t 700: its
    forward (9 pair launches) against the plain stage, its one-launch
    backward against `stage_bwd_plain` on the same saved tensors (the same
    roundings) and, in fp32, against autograd through the plain stage (in
    bf16 that autograd rounds every cotangent to bf16 where the kernel keeps
    them in fp32, and differs from it by several per cent); exact zeros
    outside the signal."""
    t, c = 700, 128
    ks, dils = (3, 7, 11), ((1, 3, 5),) * 3
    params = [(arr(gen, k, c, c, scale=0.05, dtype=dtype), arr(gen, c, scale=0.1, dtype=dtype),
               arr(gen, k, c, c, scale=0.05, dtype=dtype), arr(gen, c, scale=0.1, dtype=dtype))
              for k, ds in zip(ks, dils) for _ in ds]
    xc, gc = canvas(gen, t, c, dtype), canvas(gen, t, c, dtype)
    kernels.reset_launch_counts()
    y, dx = grads(lambda xx: tstage.stage_resblocks_canvas(xx, params, t, ks, dils, SLOPE),
                  xc, gc)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["stage_resblocks_canvas"] == 1 and counts["conv1d_pair_canvas"] == 9, counts
    x = tcanvas.from_canvas(xc, t)
    y0, dx0 = grads(lambda xx: tstage.stage_plain(xx, params, ks, dils, SLOPE), x,
                    tcanvas.from_canvas(gc, t))
    assert rel(tcanvas.from_canvas(y, t), y0) <= tol
    if dtype == torch.float32:
        assert norm_rel(tcanvas.from_canvas(dx, t), dx0) <= tol
    _, xs, hs = tstage.stage_forward(xc, params, t, ks, dils, SLOPE)
    w1s, w2s = [p[0] for p in params], [p[2] for p in params]
    dk = tstage._launch(gc, xs, hs, w1s, w2s, t, ks, dils, SLOPE)
    dp = tstage.stage_bwd_plain(gc, xs, hs, w1s, w2s, t, ks, dils, SLOPE)
    assert torch.equal(dk, dx)
    assert norm_rel(dk, dp) <= tol
    assert outside(y, t) == 0 and outside(dx, t) == 0 and outside(dk, t) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("amp", [0.3, 5.0])
def test_bsoft_block_kernel_on_card(cuda, gen, dtype, tol, amp):
    """The bounded-softmax mode, self-attention and dual-cross, against the
    plain version in bsoft mode; at amplitude 5.0 the LayerNorm scale is
    raised too, so the logits and the bound's slack are large."""
    c = 128
    x = arr(gen, 2, 700, c, dtype=dtype) * amp
    for cross_dims in ((), (96, 64)):
        p = block_params(gen, c, dtype, cross_dims)
        p["ln1_scale"] = p["ln1_scale"] * amp
        ctx = tuple(arr(gen, 2, n, cd, dtype=dtype) for n, cd in zip((8, 40), cross_dims))
        biases = tuple(torch.zeros(2, 1, n, device=cuda) for n in (8, 40)[:len(cross_dims)])
        kernels.reset_launch_counts()
        out = ttb.fused_transformer_block(x, p, c // 8, 8, ctx, biases, bsoft=True)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["fused_transformer_block_bsoft"] == 1
        ref = ttb.transformer_block_plain(x, p, c // 8, 8, ctx, biases, bsoft=True)
        assert torch.isfinite(out).all()
        assert rel(out, ref) <= tol


MEL_MFCC = dict(n_fft=400, hop_length=160, win_length=400, n_mels=64, sample_rate=16000,
                f_min=125.0, f_max=7500.0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw", [((2, 160000), MEL_MFCC), ((1, 160000), {}),
                                      ((2, 32123), {}), ((3, 2, 4000), dict(power=1.0)),
                                      ((1, 8000), dict(n_fft=512, hop_length=128,
                                                       win_length=400, n_mels=40)),
                                      ((2, 16001), dict(hop_length=100)),
                                      ((1, 16000), dict(n_mels=128)),
                                      ((2, 16001), dict(hop_length=100, n_mels=128,
                                                        power=1.5))])
def test_fused_mel_kernel_on_card(cuda, gen, shape, kw):
    """The mel kernel and its backward against autograd through the plain
    version: the MFCC and default geometries, an odd length (not a
    multiple of 4: the span takes its scalar loads), a batch shape with
    power 1, 40 mels at hop 128, and every other variant the wrapper takes:
    hop 100 (scalar frame reads), 128 mel columns, and the powf epilogue."""
    x = arr(gen, *shape, scale=0.3)
    n_frames = 1 + shape[-1] // kw.get("hop_length", 160)
    g = arr(gen, *shape[:-1], kw.get("n_mels", 64), n_frames)
    kernels.reset_launch_counts()
    y, dx = grads(lambda xx: tmel.fused_mel_spectrogram(xx, **kw), x, g)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_mel_spectrogram"] == 1
    y0, dx0 = grads(lambda xx: tmel.fused_mel_plain(xx, **kw), x, g)
    assert y.shape == y0.shape and torch.isfinite(y).all()
    assert rel(y, y0) <= 1e-4 and rel(dx, dx0) <= 1e-4


@pytest.mark.cuda
def test_mfcc_stack_embedding_card_against_cpu(cuda, gen):
    """The MFCC-stack embedder of a 10-s clip on the card (the mel kernel)
    and on the CPU (its plain version) within 1e-4 of max."""
    wav = (gen.standard_normal(160000) * 0.3).astype(np.float32)
    kernels.reset_launch_counts()
    card = MFCCStackEmbedding("cuda")(wav)
    assert kernels.launch_counts()["fused_mel_spectrogram"] == 1
    cpu = MFCCStackEmbedding("cpu")(wav)
    assert card.shape == cpu.shape == (19, 160)
    assert float(np.abs(card - cpu).max() / np.abs(cpu).max()) <= 1e-4


@pytest.mark.cuda
def test_mel_wrapper_rejects_what_the_kernel_does_not_take(cuda, gen):
    with pytest.raises(ValueError):    # reflect padding needs L > n_fft // 2
        tmel.fused_mel_spectrogram(arr(gen, 1, 300), n_fft=1024)
    with pytest.raises(ValueError):    # more mels than the kernel's 128 columns
        tmel.fused_mel_spectrogram(arr(gen, 1, 4000), n_mels=160)
