"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA device and the CUDA toolkit (`nvcc`): without a
device they skip. The file imports no jax, so that it runs on a GPU machine
that has none; `tests/conftest.py` imports jax, so run it there with

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

TF32 is off for the fp32 cases. Tolerances, as a fraction of max |plain|:
fp32 1e-4 (another summation order than cuDNN/cuBLAS); bf16 2e-2 for the
convs and their adjoint routes, the flash attention (at head_dim 8 and
32-512) and the guided step's route kernels (GroupNorm, moments, conv2d,
masks, the canvas convs and the stage backward) and 3e-2
for the transformer block (one bf16 rounding of an intermediate moves a
product by about 2^-8 relative). bf16 gradients of the vocoder kernels are
held by norm (a leaky-ReLU mask flips where an activation rounds across
zero differently in the two versions). Canvas outputs and gradients must be
exactly zero outside the signal. The bf16 stage backward (the conv core's
passes) runs at the slice's stage 2, the channel moments at every geometry
of the stats route (within 1e-5 of sum |x| and sum x^2), and one
full-width step's models count 83 moments and one stage backward. The
bf16 conv1d pair (TMA + wgmma) runs at each of the slice's 24 (C, k,
dilation), on the canvas and off it; the bf16
single conv (the same pass) at the slice's 6 ch512 k11 calls and, on the
canvas, forward and adjoint, at every resblock conv of stages 0-2. The bf16
transformer block (mma.sync attention, a cluster per 32-row tile) runs at
both slice levels in all three modes, and, with the fp32 one, at the tiny
configs' 16 and 32 channels, padded to one 64-channel slice. The fused GroupNorm (a cluster of
blocks a group, on its plan) runs at each of the fused route's 20 calls in
bf16 and fp32, and a full-width UNet forward counts its 60 launches. The
fused mel spectrogram is fp32 only, on both of its paths: 1e-4 of max
|plain| forward, gradients too. The dereverberation filter's input gradient
(no kernel of the port's: a correlation with the reversed response) runs at
the dereverberation cell's shapes against a float64 oracle, within 1e-5 by
relative L2, under cuDNN's default flags (TF32 allowed) and with TF32 off.
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
from diffmusic_tpu_torch.kernels import repack
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


# (Cin, Cout, k, stride, t_in) of the 10-s slice's upsamplers 0-2
UPSAMPLERS = ((1024, 512, 16, 5, 1000), (512, 256, 16, 4, 5001), (256, 128, 8, 2, 20004))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_conv_kernels_on_card(cuda, gen, dtype, tol):
    """The conv1d pair and single conv, and the upsampler: at a ragged input
    (t 333, Cout 64, half a channel tile), in bf16 at the slice's three
    upsampler geometries (the TMA + wgmma kernel), then a repeated call on a
    weight whose tap-major copy is cached, and one after the weight is
    written in place; fp32 takes the scalar path and makes no copy."""
    c, t = 128, 333
    x = arr(gen, 2, t, c, dtype=dtype)
    w1 = arr(gen, 7, c, c, scale=0.03, dtype=dtype)
    w2 = arr(gen, 7, c, c, scale=0.03, dtype=dtype)
    b = arr(gen, c, scale=0.1, dtype=dtype)
    kernels.reset_launch_counts()
    repack.REPACKS["phase_convtranspose"] = 0
    y = tconv.conv1d_fused_pair(x, w1, b, w2, b, 3, SLOPE)
    assert rel(y, tconv.pair_plain(x, w1, b, w2, b, 3, SLOPE)[0]) <= tol
    y = tconv.conv1d_fused(x, w1, b, x, 5, SLOPE)
    assert rel(y, tconv.conv1d_plain(x, w1, b, 5, SLOPE, x)) <= tol
    wt = arr(gen, 16, c, 64, scale=0.03, dtype=dtype)
    bt = b[:64].contiguous()
    t_out = tup.output_length(t, 5, 16)
    y = tup.phase_convtranspose(x, wt, bt, 5, 16, t_out)
    assert rel(y, tup.convtranspose_plain(x, wt, bt, 5, 16)) <= tol
    geoms = UPSAMPLERS if dtype == torch.bfloat16 else ()
    for cin, cout, k, s, t_in in geoms:
        xu = arr(gen, 1, t_in, cin, dtype=dtype)
        wu = arr(gen, k, cin, cout, scale=1.0 / math.sqrt(k * cout), dtype=dtype)
        bu = arr(gen, cout, scale=0.1, dtype=dtype)
        y = tup.phase_convtranspose(xu, wu, bu, s, k, tup.output_length(t_in, s, k))
        y0 = tup.convtranspose_plain(xu, wu, bu, s, k)
        assert rel(y, y0) <= tol, (cin, cout, k, s)
    repacks = 1 + len(geoms) if dtype == torch.bfloat16 else 0    # one per bf16 weight
    assert repack.REPACKS["phase_convtranspose"] == repacks
    with torch.no_grad():
        assert torch.equal(tup.phase_convtranspose(x, wt, bt, 5, 16, t_out),
                           tup.phase_convtranspose(x, wt, bt, 5, 16, t_out))   # cached copy
        assert repack.REPACKS["phase_convtranspose"] == repacks
        wt.mul_(-1.0)                                              # _version moves
        assert rel(tup.phase_convtranspose(x, wt, bt, 5, 16, t_out),
                   tup.convtranspose_plain(x, wt, bt, 5, 16)) <= tol
    assert repack.REPACKS["phase_convtranspose"] == repacks + (dtype == torch.bfloat16)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"conv1d_fused": 1, "conv1d_fused_pair": 1,
                                       "phase_convtranspose": 4 + len(geoms),
                                       "fused_transformer_block": 0,
                                       "fused_transformer_block_cross": 0,
                                       "fused_transformer_block_bsoft": 0,
                                       "flash_attention": 0, "fused_group_norm": 0,
                                       "channel_moments": 0, "conv2d_same": 0,
                                       "leaky_mask": 0, "leaky_mask_add": 0,
                                       "conv1d_fused_canvas": 0, "conv1d_pair_canvas": 0,
                                       "stage_resblocks_canvas": 0,
                                       "fused_mel_spectrogram": 0, "conv2d_same_adjoint": 0,
                                       "conv1d_fused_adjoint": 0}


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
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("c,cross,bsoft", [(16, (), False), (32, (), False), (32, (96, 64), False),
                                           (16, (), True)])
def test_narrow_block_kernel_on_card(cuda, gen, dtype, tol, c, cross, bsoft):
    """The tiny configs' 16- and 32-channel blocks run padded to one
    64-channel slice, with the LayerNorms over their own channels."""
    x = arr(gen, 2, 600, c, dtype=dtype)
    p = block_params(gen, c, dtype, cross)
    ctx = tuple(arr(gen, 2, 8, d, dtype=dtype) for d in cross)
    biases = tuple(torch.zeros(2, 1, 8, device=cuda) for _ in cross)
    kernels.reset_launch_counts()
    out = ttb.fused_transformer_block(x, p, c // 8, 8, ctx, biases, bsoft)
    torch.cuda.synchronize()
    assert sum(kernels.launch_counts().values()) == 1 and out.shape == x.shape
    assert rel(out, ttb.transformer_block_plain(x, p, c // 8, 8, ctx, biases, bsoft)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t,heads", [(700, 16), (333, 4), (1000, 32), (4000, 16), (1001, 8)])
def test_flash_attention_kernel_on_card(cuda, gen, dtype, tol, t, heads):
    """bf16 runs the tensor-core kernel (64-key chunks: 333, 1001 and 700 end
    in a ragged chunk; 4 heads leave half a block's warps idle), fp32 the
    scalar core."""
    q, k, v = (arr(gen, 2, t, heads, 8, dtype=dtype) for _ in range(3))
    kernels.reset_launch_counts()
    out = tattn.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 1
    assert rel(out, tattn.attention_plain(q, k, v)) <= tol


# shape -> (key splits on a 132-SM H100, 64-channel atoms a consumer warpgroup owns)
WIDE_SHAPES = {(1, 4000, 1, 512): (2, 4), (2, 333, 1, 128): (2, 1), (1, 512, 1, 32): (4, 1),
               (1, 300, 2, 96): (2, 1), (1, 40, 1, 512): (1, 4), (3, 1000, 1, 256): (2, 2),
               (1, 4001, 1, 64): (2, 1), (1, 300, 1, 320): (2, 3), (1, 333, 2, 384): (2, 3),
               (1, 1000, 1, 512): (8, 4)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", list(WIDE_SHAPES), ids=str)
def test_flash_attention_wide_kernel_on_card(cuda, gen, dtype, tol, shape):
    """Head_dim 32-512: bf16 runs the Hopper kernel (64-row tiles, 64-key
    chunks, key splits in a cluster, `WIDE_SHAPES`: 2 at T 4000, 4001, 3 x
    1000, 333 and 300, 4 at 512, 8 at 1000 (8 rows of each tile combined per
    block), 1 at 40; each consumer warpgroup's atoms 1 at D 32-128 (PV on
    m64n64k16), 2 at 256 (n128), 3 at 320 and 384 (n192), 4 at 512 (n256);
    333, 300, 4001 and 40 end in a ragged tile and key chunk, T 40 is one
    chunk of 40 keys; D 32, 96, 64 and 320 are zero-padded to a multiple of
    128 channels, a warpgroup's atoms past D unread; in 3 batches of 1000 the
    ragged last tile of a batch must read zeros, not the next batch's rows),
    the split count asserted through `wide_splits` and the library's launch
    plan; fp32 the scalar kernel; the input gradients of both backward forms
    against the plain attention's."""
    if dtype == torch.bfloat16:
        splits, atoms = WIDE_SHAPES[shape]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        assert tattn.wide_splits(*shape[:3], sms) == splits
        plan = tattn.wide_launch_plan(*shape)
        assert plan["grid"] == (-(-shape[1] // 64), shape[0] * shape[2], splits)
        assert plan["channels"] == 2 * 64 * atoms
    q, k, v, g = (arr(gen, *shape, dtype=dtype) for _ in range(4))
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = tattn.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 1
    assert rel(out, tattn.attention_plain(q, k, v)) <= tol
    qq = q.clone().requires_grad_(True)
    (dq0,) = torch.autograd.grad(tattn.attention_plain(qq, k, v), qq, g)
    for bwd in tattn.FLASH_BWD:
        (dq,) = torch.autograd.grad(tattn.flash_attention(qq, k, v, bwd), qq, g)
        assert norm_rel(dq, dq0) <= tol, bwd


@pytest.mark.cuda
def test_flash_attention_wide_kernel_matches_its_emulation(cuda, gen):
    """bf16 at (1, 300, 1, 512) (2 key splits of 2 and 3 chunks, a ragged
    tile and chunk) against `emulate_wide`'s bf16-P result on the same inputs:
    within 4e-3 of max |emulation|, two roundings of the bf16 output (2^-9
    relative each) for the rest (the sums' order, ex2.approx, a P value that
    rounds across a bf16 boundary in one version only)."""
    from flash_wide_emulation import emulate_wide
    shape = (1, 300, 1, 512)
    q, k, v = (arr(gen, *shape, dtype=torch.bfloat16) for _ in range(3))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert tattn.wide_splits(1, 300, 1, sms) == 2
    with torch.no_grad():
        out = tattn.flash_attention(q, k, v)
    torch.cuda.synchronize()
    want = emulate_wide(q.cpu().float(), k.cpu().float(), v.cpu().float(), p_bf16=True)
    assert torch.isfinite(out).all()
    assert rel(out.float(), want) <= 4e-3


@pytest.mark.cuda
def test_new_wrappers_raise_for_head_dim_16(cuda, gen):
    """The block takes head_dim 8 only, the flash kernel 8 or 32-512 in steps
    of 32; a CUDA tensor of another head_dim raises rather than falling back
    to the plain version."""
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
    against F.conv2d's, at ragged pixel tiles, a (1, 3) kernel, a
    channel-raising geometry (W 16) and one slice geometry of each tile
    width (W 8, 16, 32, 64; W 20 and 12 take tiles wider than the image and
    Cout 64 half a channel tile; bf16 runs the tensor-core kernel, fp32 the
    scalar path); then a repeated call on a weight whose tap-major copy is
    cached, and one after the weight is written in place."""
    kernels.reset_launch_counts()
    tconv2d.REPACKS["conv2d_same"] = 0
    geoms = (((2, 128, 9, 20), (128, 128, 3, 3)), ((1, 64, 10, 12), (64, 64, 1, 3)),
             ((1, 128, 32, 16), (256, 128, 3, 3)), ((1, 128, 125, 8), (256, 128, 3, 3)),
             ((1, 512, 250, 16), (512, 512, 3, 3)), ((1, 256, 500, 32), (256, 256, 3, 3)),
             ((1, 128, 1000, 64), (128, 128, 3, 3)))
    for xs, ws in geoms:
        x = arr(gen, *xs, dtype=dtype)
        w = arr(gen, *ws, scale=1.0 / math.sqrt(ws[1] * ws[2] * ws[3]), dtype=dtype)
        b = arr(gen, ws[0], scale=0.1, dtype=dtype)
        g = arr(gen, xs[0], ws[0], xs[2], xs[3], dtype=dtype)
        y, dx = grads(lambda xx: tconv2d.conv2d_same(xx, w, b), x, g)
        y0, dx0 = grads(lambda xx: tconv2d.conv2d_plain(xx, w, b), x, g)
        assert rel(y, y0) <= tol, (xs, ws)
        assert rel(dx, dx0) <= tol, (xs, ws)
    repacks = len(geoms) if dtype == torch.bfloat16 else 0    # one per bf16 weight
    assert tconv2d.REPACKS["conv2d_same"] == repacks
    with torch.no_grad():
        assert torch.equal(tconv2d.conv2d_same(x, w, b), y)        # the cached copy
        assert tconv2d.REPACKS["conv2d_same"] == repacks
        w.mul_(-1.0)                                               # _version moves
        assert rel(tconv2d.conv2d_same(x, w, b), -(y0 - b[:, None, None])
                   + b[:, None, None]) <= tol
    assert tconv2d.REPACKS["conv2d_same"] == repacks + (dtype == torch.bfloat16)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["conv2d_same"] == len(geoms) + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_conv2d_adjoint_route_on_card(cuda, gen, dtype, tol):
    """conv2d_bwd="kernel": the input gradient through the conv2d kernel on
    the cotangent (the VAE's 512 -> 512 at (250, 16), a channel-raising and a
    channel-lowering geometry) against the plain adjoint's, the adjoint
    operands made once per weight; below the route's rule (H*W < 512) the
    plain adjoint."""
    kernels.reset_launch_counts()
    repack.REPACKS["conv2d_adjoint"] = 0
    geoms = (((1, 512, 250, 16), (512, 512, 3, 3)), ((1, 128, 32, 16), (256, 128, 3, 3)),
             ((1, 256, 1000, 64), (128, 256, 3, 3)), ((2, 128, 9, 20), (128, 128, 3, 3)))
    for xs, ws in geoms:
        x = arr(gen, *xs, dtype=dtype)
        w = arr(gen, *ws, scale=1.0 / math.sqrt(ws[1] * ws[2] * ws[3]), dtype=dtype)
        b = arr(gen, ws[0], scale=0.1, dtype=dtype)
        g = arr(gen, xs[0], ws[0], xs[2], xs[3], dtype=dtype)
        for _ in range(2):
            y, dx = grads(lambda xx: tconv2d.conv2d_same(xx, w, b, "kernel"), x, g)
        y0, dx0 = grads(lambda xx: tconv2d.conv2d_plain(xx, w, b), x, g)
        assert rel(y, y0) <= tol and rel(dx, dx0) <= tol, (xs, ws)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["conv2d_same_adjoint"] == 2 * (len(geoms) - 1)
    assert repack.REPACKS["conv2d_adjoint"] == len(geoms) - 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_conv1d_adjoint_route_on_card(cuda, gen, dtype, tol):
    """adjoint_kernel: conv1d_fused's input gradient through the kernel's
    adjoint mode (bf16: the slice's ch512 k11 convs at each dilation; fp32 a
    ragged T) against the plain version's, held by norm (the leaky mask)."""
    cases = ([((1, 5001, 512), 11, d) for d in (1, 3, 5)] if dtype == torch.bfloat16
             else [((2, 333, 128), 11, 5), ((1, 300, 256), 3, 1)])
    kernels.reset_launch_counts()
    for shape, k, d in cases:
        c = shape[-1]
        x, g = arr(gen, *shape, dtype=dtype), arr(gen, *shape, dtype=dtype)
        w = arr(gen, k, c, c, scale=1.0 / math.sqrt(k * c), dtype=dtype)
        b = arr(gen, c, scale=0.1, dtype=dtype)
        y, dx = grads(lambda xx: tconv.conv1d_fused(xx, w, b, None, d, SLOPE,
                                                    adjoint_kernel=True), x, g)
        y0, dx0 = grads(lambda xx: tconv.conv1d_plain(xx, w, b, d, SLOPE), x, g)
        assert rel(y, y0) <= tol and norm_rel(dx, dx0) <= tol, (shape, k, d)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["conv1d_fused_adjoint"] == len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.bfloat16, 2e-2)])
def test_leaky_mask_kernels_on_card(cuda, gen, dtype, tol):
    """Both masks against the plain versions, with a ragged tail
    ((1, 1001, 100): 100100 elements, not a multiple of 8) and the slice's
    three stages; at those, g also as the transposed view of a (B, C, T)
    tensor, as the adjoint conv leaves it (T 5001 and 20004 leave its rows
    off 16 bytes in bf16, 5001 in fp32: the tile's scalar loads), and at a
    batch of 2 with a ragged last tile in both t and c."""
    kernels.reset_launch_counts()
    shapes = ((1, 1001, 100), (1, 5001, 512), (1, 20004, 256), (1, 40008, 128), (2, 999, 136))
    launches = 0
    for shape in shapes:
        h, g, r = (arr(gen, *shape, dtype=dtype) for _ in range(3))
        forms = [g]
        if shape[2] % 8 == 0:
            forms.append(arr(gen, shape[0], shape[2], shape[1], dtype=dtype).transpose(1, 2))
        for gg in forms:
            assert rel(tmask.leaky_mask(h, gg, SLOPE),
                       tmask.leaky_mask_plain(h, gg, SLOPE)) <= tol, (shape, gg.stride())
            assert rel(tmask.leaky_mask_add(h, gg, r, SLOPE),
                       tmask.leaky_mask_plain(h, gg, SLOPE, r)) <= tol, (shape, gg.stride())
            launches += 1
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["leaky_mask"] == launches and counts["leaky_mask_add"] == launches


@pytest.mark.cuda
def test_raw_stream_handle_is_the_current_stream(cuda):
    """The launch path's raw stream handle is PyTorch's current stream, on the
    default stream and under a side stream."""
    from diffmusic_tpu_torch.kernels import build
    assert build.stream_ptr(cuda) == torch.cuda.current_stream(cuda).cuda_stream
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        assert build.stream_ptr(cuda) == torch.cuda.current_stream(cuda).cuda_stream
        assert build.stream_ptr(torch.device("cuda", 0)) == side.cuda_stream
    assert build.stream_ptr(cuda) != side.cuda_stream


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
    with pytest.raises(ValueError):    # g in neither layout: every other row
        tmask.leaky_mask(arr(gen, 1, 40, 128), arr(gen, 1, 80, 128)[:, ::2], SLOPE)
    with pytest.raises(ValueError):    # g in neither layout: a permuted batch
        tmask.leaky_mask(arr(gen, 2, 40, 128), arr(gen, 40, 2, 128).transpose(0, 1), SLOPE)


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


# (C, k, dilation) of the 10-s slice's 24 resblock pairs (vocoder stages 0-2;
# ch512 k11 is over pair_ok's weight budget)
SLICE_PAIRS = [(c, k, d) for c, ks in ((512, (3, 7)), (256, (3, 7, 11)), (128, (3, 7, 11)))
               for k in ks for d in (1, 3, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,d", SLICE_PAIRS)
def test_bf16_pair_kernel_at_the_slice_geometries(cuda, gen, c, k, d):
    """The bf16 pair (TMA + wgmma, two passes) against autograd through the
    plain version at each (C, k, dilation) of the slice: off the canvas at a
    ragged T with two batch rows, and on the canvas of a signal that ends
    inside a row tile; y, the saved h and the input gradient within 2e-2
    (the gradient by norm); exact zeros outside the signal."""
    bf, tol, t = torch.bfloat16, 2e-2, 1031
    w1, w2 = (arr(gen, k, c, c, scale=1 / math.sqrt(k * c), dtype=bf) for _ in range(2))
    b1, b2 = (arr(gen, c, scale=0.1, dtype=bf) for _ in range(2))
    x, g = arr(gen, 2, t, c, dtype=bf), arr(gen, 2, t, c, dtype=bf)
    y, dx = grads(lambda xx: tconv.conv1d_fused_pair(xx, w1, b1, w2, b2, d, SLOPE), x, g)
    y0, dx0 = grads(lambda xx: tconv.pair_plain(xx, w1, b1, w2, b2, d, SLOPE)[0], x, g)
    h = tconv._launch_pair(x, w1, b1, w2, b2, d, SLOPE)[1]
    h0 = tconv.pair_plain(x, w1, b1, w2, b2, d, SLOPE)[1]
    assert rel(y, y0) <= tol and rel(h, h0) <= tol and norm_rel(dx, dx0) <= tol
    tc = 700
    xc, gc = canvas(gen, tc, c, bf), canvas(gen, tc, c, bf)
    y, dx = grads(lambda xx: tconv.conv1d_pair_canvas(xx, w1, b1, w2, b2, tc, d, SLOPE), xc, gc)
    y0, dx0 = grads(lambda xx: tconv.pair_canvas_plain(xx, w1, b1, w2, b2, tc, d, SLOPE)[0],
                    xc, gc)
    h = tconv.pair_canvas_forward(xc, w1, b1, w2, b2, tc, d, SLOPE)[1]
    h0 = tconv.pair_canvas_plain(xc, w1, b1, w2, b2, tc, d, SLOPE)[1]
    assert rel(y, y0) <= tol and rel(h, h0) <= tol and norm_rel(dx, dx0) <= tol
    assert outside(y, tc) == 0 and outside(h, tc) == 0 and outside(dx, tc) == 0


@pytest.mark.cuda
def test_bf16_pair_kernel_short_input_and_weight_copies(cuda, gen):
    """A T under one row tile (the input box longer than the tensor) and C
    64 (half a Cout tile), then the weight copies: one tap-major copy per
    weight tensor, shared by the plain and the canvas form, none made again
    by later calls, one remade after an in-place write; a launch counts once
    for its two passes."""
    bf, tol = torch.bfloat16, 2e-2
    for c, t, k, d in ((128, 100, 7, 3), (64, 333, 3, 5)):
        w1, w2 = (arr(gen, k, c, c, scale=1 / math.sqrt(k * c), dtype=bf) for _ in range(2))
        b = arr(gen, c, scale=0.1, dtype=bf)
        x = arr(gen, 1, t, c, dtype=bf)
        y, h = tconv._launch_pair(x, w1, b, w2, b, d, SLOPE)
        y0, h0 = tconv.pair_plain(x, w1, b, w2, b, d, SLOPE)
        assert rel(y, y0) <= tol and rel(h, h0) <= tol, (c, t)
    c, t, k = 256, 300, 11
    w1, w2 = (arr(gen, k, c, c, scale=1 / math.sqrt(k * c), dtype=bf) for _ in range(2))
    b = arr(gen, c, scale=0.1, dtype=bf)
    x, xc = arr(gen, 1, t, c, dtype=bf), canvas(gen, t, c, bf)
    repack.REPACKS["conv1d_pair"] = 0
    kernels.reset_launch_counts()
    with torch.no_grad():
        for _ in range(2):
            tconv.conv1d_fused_pair(x, w1, b, w2, b, 5, SLOPE)
            tconv.conv1d_pair_canvas(xc, w1, b, w2, b, t, 5, SLOPE)
        assert repack.REPACKS["conv1d_pair"] == 2
        w2.mul_(-1.0)                                              # _version moves
        y = tconv.conv1d_fused_pair(x, w1, b, w2, b, 5, SLOPE)
    assert repack.REPACKS["conv1d_pair"] == 3
    assert rel(y, tconv.pair_plain(x, w1, b, w2, b, 5, SLOPE)[0]) <= tol
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["conv1d_fused_pair"] == 3 and counts["conv1d_pair_canvas"] == 2, counts


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
def test_bf16_stage_backward_at_the_slice_stage(cuda, gen):
    """The bf16 stage backward (the conv core's passes) at the slice's stage
    2, (1, 40008, 128), KS (3, 7, 11), dilations (1, 3, 5) x 3, against
    `stage_bwd_plain` on the same saved tensors within 2e-2 by norm; exact
    zeros outside the signal; one adjoint tensor map per weight tensor, made
    in the first call and none in the second, which gives the same dx; one
    launch counted per call."""
    bf, tol, t, c = torch.bfloat16, 2e-2, 40008, 128
    ks, dils = (3, 7, 11), ((1, 3, 5),) * 3
    params = [(arr(gen, k, c, c, scale=0.05, dtype=bf), arr(gen, c, scale=0.1, dtype=bf),
               arr(gen, k, c, c, scale=0.05, dtype=bf), arr(gen, c, scale=0.1, dtype=bf))
              for k, ds in zip(ks, dils) for _ in ds]
    xc, gc = canvas(gen, t, c, bf), canvas(gen, t, c, bf)
    w1s, w2s = [p[0] for p in params], [p[2] for p in params]
    with torch.no_grad():
        _, xs, hs = tstage.stage_forward(xc, params, t, ks, dils, SLOPE)
        repack.REPACKS["conv1d_adjoint"] = 0
        kernels.reset_launch_counts()
        dk = tstage._launch(gc, xs, hs, w1s, w2s, t, ks, dils, SLOPE)
        assert repack.REPACKS["conv1d_adjoint"] == 18
        dk2 = tstage._launch(gc, xs, hs, w1s, w2s, t, ks, dils, SLOPE)
        torch.cuda.synchronize()
        assert repack.REPACKS["conv1d_adjoint"] == 18
        assert kernels.launch_counts()["stage_resblocks_canvas"] == 2
        dp = tstage.stage_bwd_plain(gc, xs, hs, w1s, w2s, t, ks, dils, SLOPE)
    assert dk.dtype == bf and torch.isfinite(dk).all() and torch.equal(dk, dk2)
    assert norm_rel(dk, dp) <= tol
    assert outside(dk, t) == 0


# (B, C, H, W) of the guided step's GroupNorm inputs that take the moments
# kernel on the stats route (UNet and VAE decoder at latents (1, 8, 250, 16);
# tests/test_torch_port_moments_tiles.py holds them against chip_smoke.py)
STATS_GEOMETRIES = ((1, 128, 125, 8), (1, 128, 250, 16), (1, 128, 1000, 64), (1, 256, 62, 4),
                    (1, 256, 125, 8), (1, 256, 250, 16), (1, 256, 500, 32),
                    (1, 256, 1000, 64), (1, 384, 31, 2), (1, 384, 62, 4), (1, 384, 125, 8),
                    (1, 384, 250, 16), (1, 512, 125, 8), (1, 512, 250, 16),
                    (1, 512, 500, 32), (1, 640, 31, 2), (1, 640, 62, 4), (1, 640, 125, 8),
                    (1, 768, 62, 4), (1, 1024, 31, 2), (1, 1024, 62, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", STATS_GEOMETRIES, ids=str)
def test_moments_at_the_stats_geometries(cuda, gen, shape, dtype, tol):
    """The channel moments at each of the stats route's geometries against
    `moments_plain` within 1e-5 of sum |x| and of sum x^2 per channel, with
    and without autograd; the stats GroupNorm around them against the plain
    GroupNorm within the route's tolerance."""
    b, c, h, w = shape
    x = arr(gen, *shape, scale=2.0, dtype=dtype) + 0.3
    x3 = x.reshape(b, c, h * w)
    kernels.reset_launch_counts()
    with torch.no_grad():
        m = tgn.channel_moments(x3)
    mg = tgn.channel_moments(x3.clone().requires_grad_(True))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["channel_moments"] == 2
    xf = x3.double()
    scale = torch.stack([xf.abs().sum(-1), (xf * xf).sum(-1)], dim=1)
    m0 = tgn.moments_plain(x3)
    for got in (m, mg.detach()):
        assert got.dtype == torch.float32
        assert float(((got.double() - m0.double()).abs() / scale).max()) <= 1e-5
    wt = 1 + arr(gen, c, scale=0.2, dtype=dtype)
    bt = arr(gen, c, scale=0.1, dtype=dtype)
    assert rel(tgn.stats_group_norm(x, wt, bt, 32, 1e-5, True),
               tgn.group_norm_plain(x, wt, bt, 32, 1e-5, True)) <= tol


@pytest.mark.cuda
def test_route_launches_of_a_full_width_step(cuda):
    """The full-width bf16 models of the 10-s slice on the routes: the UNet
    forward (no gradient) and the VAE decode (with one) on `gn_mode="stats"`
    launch the moments 59 + 24 = 83 times, and the vocoder forward and
    backward on the stage route launch the stage backward once."""
    from diffmusic_tpu_torch.models.hifigan import SpeechT5HifiGan
    from diffmusic_tpu_torch.models.unet import UNet2DConditionModel
    from diffmusic_tpu_torch.models.vae import AutoencoderKL
    bf = torch.bfloat16
    unet, vae, voc = MusicLDMPipeline._random_models(
        [UNet2DConditionModel(UNetConfig(), gn_mode="stats"),
         AutoencoderKL(VAEConfig(), gn_mode="stats"),
         SpeechT5HifiGan(HiFiGANConfig(), canvas="xbwd", stage_bwd=True)], 0, cuda, bf)
    lat = torch.randn(1, 8, 250, 16, device=cuda, dtype=bf)
    kernels.reset_launch_counts()
    with torch.no_grad():
        unet(lat, torch.ones(1, device=cuda), class_labels=torch.zeros(1, 512, device=cuda,
                                                                          dtype=bf))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["channel_moments"] == 59
    z = lat.clone().requires_grad_(True)
    mel = vae.decode(z)
    torch.autograd.grad(mel.float().square().sum(), z)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["channel_moments"] == 83
    m = torch.randn(1, 1000, 64, device=cuda, dtype=bf, requires_grad=True)
    wav = voc(m)
    (dm,) = torch.autograd.grad(wav.float().square().sum(), m)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["stage_resblocks_canvas"] == 1 and torch.isfinite(dm).all(), counts


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
                                                        power=1.5)),
                                      ((1, 160000), MEL_MFCC), ((64, 160000), MEL_MFCC),
                                      ((2, 16001), dict(MEL_MFCC, power=1.0)),
                                      ((2, 16001), dict(MEL_MFCC, power=1.5, n_mels=128)),
                                      ((2, 16001), dict(n_fft=262, win_length=262)),
                                      ((2, 16001), dict(n_fft=389, win_length=300,
                                                        n_mels=128, power=1.0)),
                                      ((2, 16001), dict(n_fft=389, win_length=389,
                                                        power=1.5))])
def test_fused_mel_kernel_on_card(cuda, gen, shape, kw):
    """The mel kernel and its backward against autograd through the plain
    version: the MFCC and default geometries, an odd length (not a
    multiple of 4: the span takes its scalar loads), a batch shape with
    power 1, 40 mels at hop 128, and every other variant the wrapper takes:
    hop 100 (scalar frame reads), 128 mel columns, and the powf epilogue;
    the eval's per-clip shape and a 64-clip batch; on the dense path (n_fft
    262 = 2 x 131 and 389, a prime: no split into factors of at most 64)
    every epilogue and mel width (the power-2 backward, the JAX package's
    VJP, takes an even n_fft only). The plan's path is checked."""
    x = arr(gen, *shape, scale=0.3)
    n_frames = 1 + shape[-1] // kw.get("hop_length", 160)
    g = arr(gen, *shape[:-1], kw.get("n_mels", 64), n_frames)
    kernels.reset_launch_counts()
    y, dx = grads(lambda xx: tmel.fused_mel_spectrogram(xx, **kw), x, g)
    with torch.no_grad():
        y_ng = tmel.fused_mel_spectrogram(x, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_mel_spectrogram"] == 2
    y0, dx0 = grads(lambda xx: tmel.fused_mel_plain(xx, **kw), x, g)
    assert y.shape == y0.shape and torch.isfinite(y).all() and torch.equal(y, y_ng)
    assert rel(y, y0) <= 1e-4 and rel(dx, dx0) <= 1e-4
    assert (tmel.fft_split(kw.get("n_fft", 1024)) is None) == (kw.get("n_fft") in (262, 389))


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


# (shape, eps, use_silu) of every fused GroupNorm call on the fused route
# (the UNet at latents (1, 8, 250, 16); tests/test_torch_port_gn_tiles.py
# holds them against chip_smoke.py)
FUSED_GN_CALLS = (((1, 128, 125, 8), 1e-05, True), ((1, 128, 250, 16), 1e-06, False),
                  ((1, 128, 250, 16), 1e-05, True), ((1, 256, 62, 4), 1e-05, True),
                  ((1, 256, 125, 8), 1e-06, False), ((1, 256, 125, 8), 1e-05, True),
                  ((1, 256, 250, 16), 1e-05, True), ((1, 384, 31, 2), 1e-05, True),
                  ((1, 384, 62, 4), 1e-06, False), ((1, 384, 62, 4), 1e-05, True),
                  ((1, 384, 125, 8), 1e-05, True), ((1, 512, 125, 8), 1e-05, True),
                  ((1, 640, 31, 2), 1e-06, False), ((1, 640, 31, 2), 1e-05, True),
                  ((1, 640, 62, 4), 1e-05, True), ((1, 640, 125, 8), 1e-05, True),
                  ((1, 768, 62, 4), 1e-05, True), ((1, 1024, 31, 2), 1e-05, True),
                  ((1, 1024, 62, 4), 1e-05, True), ((1, 1280, 31, 2), 1e-05, True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,eps,silu", FUSED_GN_CALLS, ids=str)
def test_fused_group_norm_at_the_route_geometries(cuda, gen, shape, eps, silu, dtype, tol):
    """The fused GroupNorm (the cluster kernel, on its plan) at each of the
    fused route's 20 calls, forward with and without autograd and the
    recompute backward, against the plain version; one launch a call."""
    b, c, h, w = shape
    x = arr(gen, *shape, scale=2.0, dtype=dtype) + 0.3
    wt = 1 + arr(gen, c, scale=0.2, dtype=dtype)
    bt = arr(gen, c, scale=0.1, dtype=dtype)
    g = arr(gen, *shape, dtype=dtype)
    kernels.reset_launch_counts()
    with torch.no_grad():
        y_ng = tgn.fused_group_norm(x, wt, bt, 32, eps, silu)
    y, dx = grads(lambda xx: tgn.fused_group_norm(xx, wt, bt, 32, eps, silu), x, g)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_group_norm"] == 2
    y0, dx0 = grads(lambda xx: tgn.group_norm_plain(xx, wt, bt, 32, eps, silu), x, g)
    assert torch.equal(y_ng, y) and torch.isfinite(y).all()
    assert rel(y, y0) <= tol and rel(dx, dx0) <= tol


@pytest.mark.cuda
def test_fused_group_norm_launches_of_a_full_width_step(cuda):
    """The full-width bf16 UNet of the 10-s slice on `gn_mode="fused"`
    launches the fused GroupNorm 60 times a forward, as chip_smoke.py's
    expected launches say; the VAE decoder's groups fail `fused_gn_ok`."""
    from diffmusic_tpu_torch.models.unet import UNet2DConditionModel
    from diffmusic_tpu_torch.models.vae import AutoencoderKL
    bf = torch.bfloat16
    unet, vae = MusicLDMPipeline._random_models(
        [UNet2DConditionModel(UNetConfig(), gn_mode="fused"),
         AutoencoderKL(VAEConfig(), gn_mode="fused")], 0, cuda, bf)
    lat = torch.randn(1, 8, 250, 16, device=cuda, dtype=bf)
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = unet(lat, torch.ones(1, device=cuda),
                   class_labels=torch.zeros(1, 512, device=cuda, dtype=bf))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_group_norm"] == 60 and torch.isfinite(out).all()
    z = lat.clone().requires_grad_(True)
    torch.autograd.grad(vae.decode(z).float().square().sum(), z)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_group_norm"] == 60


# (T, C) of the vocoder's stages 0-2 and the resblock convs of each branch k:
# conv1 at dilations 1, 3, 5, conv2 (dilation 1) with the residual
VOCODER_STAGES = ((5001, 512), (20004, 256), (40008, 128))
SINGLE_CALLS = ((1, False), (3, False), (5, False), (1, True))


@pytest.mark.cuda
def test_bf16_single_conv_at_the_slice_geometries(cuda, gen):
    """conv1d_fused (the TMA + wgmma pass) at the slice's 6 ch512 k11 calls,
    forward and input gradient against autograd through the plain version;
    the forward reads the tap-major copy that one weight gets once."""
    bf, tol, (t, c), k = torch.bfloat16, 2e-2, VOCODER_STAGES[0], 11
    w = arr(gen, k, c, c, scale=1 / math.sqrt(k * c), dtype=bf)
    b = arr(gen, c, scale=0.1, dtype=bf)
    x, g, r = (arr(gen, 1, t, c, dtype=bf) for _ in range(3))
    repack.REPACKS["conv1d_pair"] = 0
    kernels.reset_launch_counts()
    for d, res in SINGLE_CALLS:
        rr = r if res else None
        y, dx = grads(lambda xx: tconv.conv1d_fused(xx, w, b, rr, d, SLOPE), x, g)
        y0, dx0 = grads(lambda xx: tconv.conv1d_plain(xx, w, b, d, SLOPE, rr), x, g)
        assert rel(y, y0) <= tol and norm_rel(dx, dx0) <= tol, (d, res)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["conv1d_fused"] == 4
    assert repack.REPACKS["conv1d_pair"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("t,c", VOCODER_STAGES)
@pytest.mark.parametrize("k", [3, 7, 11])
def test_bf16_canvas_conv_at_the_slice_geometries(cuda, gen, t, c, k):
    """conv1d_fused_canvas at every resblock conv of the stage, forward (with
    the slope, the bias and, for conv2, the residual) and the adjoint pass
    (no slope, no bias, w read as it lies) against `canvas_plain` of the conv
    and of the flipped transposed conv; exact zeros outside the signal; the
    adjoint makes no weight copy, one tensor map per weight."""
    bf, tol = torch.bfloat16, 2e-2
    w = arr(gen, k, c, c, scale=1 / math.sqrt(k * c), dtype=bf)
    b = arr(gen, c, scale=0.1, dtype=bf)
    xc, gc, rc = (canvas(gen, t, c, bf) for _ in range(3))
    w_adj = w.flip(0).transpose(1, 2)
    repack.REPACKS["conv1d_pair"] = repack.REPACKS["conv1d_adjoint"] = 0
    kernels.reset_launch_counts()
    with torch.no_grad():
        for d, res in SINGLE_CALLS:
            rr = rc if res else None
            y = tconv._launch_fused(xc, w, b, rr, d, SLOPE, t)
            dx = tconv._launch_fused(gc, w, None, None, d, None, t, adjoint=True)
            y0 = tconv.canvas_plain(xc, w, b, t, d, SLOPE, rr)
            dx0 = tconv.canvas_plain(gc, w_adj, None, t, d)
            assert rel(y, y0) <= tol and rel(dx, dx0) <= tol, (d, res)
            assert outside(y, t) == 0 and outside(dx, t) == 0
    torch.cuda.synchronize()
    assert kernels.launch_counts()["conv1d_fused_canvas"] == 8
    assert repack.REPACKS["conv1d_pair"] == 1 and repack.REPACKS["conv1d_adjoint"] == 1


BLOCK_MODES = {"self": (0, False, 1.0), "cross": (2, False, 1.0), "bsoft": (0, True, 1.0),
               "bsoft-amp5": (0, True, 5.0), "bsoft-cross": (2, True, 1.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("t,c", [(4000, 128), (1000, 256)])
@pytest.mark.parametrize("mode", list(BLOCK_MODES))
def test_bf16_block_at_the_slice_shapes(cuda, gen, t, c, mode):
    """The bf16 block at both UNet levels of the 10-s slices, in each mode:
    self-attention, dual-cross with AudioLDM2's streams (8 keys of 768, 12 of
    1024 whose last 7 are masked), bounded at amplitude 1 and 5 (the
    LayerNorm scale raised with x) and bounded dual-cross; within 3e-2 of
    max |plain|, one launch counted under the mode's name."""
    bf = torch.bfloat16
    n_cross, bsoft, amp = BLOCK_MODES[mode]
    cross_dims = (768, 1024)[:n_cross]
    p = block_params(gen, c, bf, cross_dims)
    p["ln1_scale"] = p["ln1_scale"] * amp
    x = arr(gen, 1, t, c, dtype=bf) * amp
    ctx = tuple(arr(gen, 1, n, cd, dtype=bf) for n, cd in zip((8, 12), cross_dims))
    mask = torch.arange(12, device=cuda) < 5
    biases = (torch.zeros(1, 1, 8, device=cuda),
              torch.where(mask, 0.0, -1e9)[None, None])[:n_cross]
    kernels.reset_launch_counts()
    out = ttb.fused_transformer_block(x, p, c // 8, 8, ctx, biases, bsoft)
    torch.cuda.synchronize()
    name = ("fused_transformer_block_bsoft" if bsoft else
            "fused_transformer_block_cross" if n_cross else "fused_transformer_block")
    assert kernels.launch_counts()[name] == 1
    ref = ttb.transformer_block_plain(x, p, c // 8, 8, ctx, biases, bsoft)
    assert torch.isfinite(out).all()
    assert rel(out, ref) <= 3e-2


def rel_l2(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.cuda
@pytest.mark.parametrize("allow_tf32", [True, False])
def test_filter_adjoint_at_the_dereverberation_cell(cuda, allow_tf32):
    """x (3, 160000), 5000 taps, decay 0.99: the input gradient, one
    correlation of g with the reversed response, and the old route, cuDNN's
    data gradient through the plain `F.conv1d`, each within relative L2 1e-5
    of the library's float64 data gradient on the CPU and of each other.
    TF32's 10-bit operands read about 3e-4 there, so the bound fails a TF32
    engine; PyTorch's default allows one for cuDNN, as the benchmark runs."""
    from diffmusic_tpu_torch.ops.filters import convolve1d, generate_impulse_response
    gen = torch.Generator().manual_seed(23)
    ir = generate_impulse_response(gen, 5000, 0.99)
    x = torch.randn(3, 160000, generator=gen)
    g = torch.randn(3, 160001, generator=gen)
    oracle = torch.nn.grad.conv1d_input((3, 1, 160000), ir.double().reshape(1, 1, -1),
                                        g.double().reshape(3, 1, -1), padding=2500)
    xc, irc, gc = x.to(cuda).requires_grad_(True), ir.to(cuda), g.to(cuda)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
    try:
        (new,) = torch.autograd.grad(convolve1d(xc, irc), xc, gc)
        y = torch.nn.functional.conv1d(xc.reshape(3, 1, -1), irc.reshape(1, 1, -1),
                                       padding=2500)
        (old,) = torch.autograd.grad(y.reshape(3, -1), xc, gc)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    oracle = oracle.reshape(3, -1)
    assert rel_l2(new, oracle) <= 1e-5, rel_l2(new, oracle)
    assert rel_l2(old, oracle) <= 1e-5, rel_l2(old, oracle)
    assert rel_l2(new, old) <= 1e-5
