"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA device and the CUDA toolkit (`nvcc`): without a
device they skip. The file imports no jax, so that it runs on a GPU machine
that has none; `tests/conftest.py` imports jax, so run it there with

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

TF32 is off for the fp32 cases. Tolerances, as a fraction of max |plain|:
fp32 1e-4 (another summation order than cuDNN/cuBLAS); bf16 2e-2 for the
convs and the flash attention and 3e-2 for the transformer block (one bf16
rounding of an intermediate moves a product by about 2^-8 relative).
"""

import math

import numpy as np
import pytest
import torch

from diffmusic_tpu_torch import kernels
from diffmusic_tpu_torch.inverse_problem import MusicInpaintingOperator
from diffmusic_tpu_torch.kernels import attention as tattn
from diffmusic_tpu_torch.kernels import conv1d as tconv
from diffmusic_tpu_torch.kernels import transformer_block as ttb
from diffmusic_tpu_torch.kernels import upsampler as tup
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
                                       "flash_attention": 0}


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
