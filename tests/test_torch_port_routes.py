"""CPU parity of the guided step's kernel routes against the JAX package:
the fused GroupNorm and the channel moments (`gn_mode`), the 'same' conv2d
(`conv2d_kernel`) and the leaky-ReLU backward masks (`mask_kernel`).

On the CPU the port's wrappers run their plain versions; the JAX functions
run their Pallas kernels in interpret mode (`_INTERPRET = True`, set with
`monkeypatch`, as the JAX package's own tests do). Inputs come from a numpy
seed. Tolerances, as a fraction of max |reference|: 1e-5 for values and
1e-4 for gradients in fp32 (another summation order), 1e-2 for bf16 outputs
(one bf16 rounding is 2^-8 relative); the whole slice as
`test_torch_port_slice.py` holds it: losses 1e-4 relative, final latents
1e-3 of max.

The whole-slice test runs the JAX pipeline under `DIFFMUSIC_TPU_GN=stats`
(and `fused`), `DIFFMUSIC_TPU_CONV2D=pallas`, `DIFFMUSIC_TPU_MASK=pallas` and
`DIFFMUSIC_TPU_VAE_SWAP=0`. Two of those JAX routes need a TPU even in
interpret mode, so there the JAX side computes the same function through
XLA: `layers._conv2d_pallas_on` returns `_on_tpu()`, and the conv1d
backwards take the mask kernels only under `conv1d_kernel._INTERPRET` or on
a TPU. The port's side takes every route (spied below).
"""

import dataclasses
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from diffmusic_tpu.inverse_problem import MusicInpaintingOperator as JInpaint
from diffmusic_tpu.models import configs as jcfg
from diffmusic_tpu.models.hifigan import SpeechT5HifiGan as JHifiGan
from diffmusic_tpu.models.unet import UNet2DConditionModel as JUNet
from diffmusic_tpu.models.vae import AutoencoderKL as JVAE
from diffmusic_tpu.pallas import conv2d_kernel as ck
from diffmusic_tpu.pallas import groupnorm_kernel as gk
from diffmusic_tpu.pallas import mask_kernel as mk
from diffmusic_tpu.pipelines.musicldm import MusicLDMPipeline as JPipeline
from diffmusic_tpu_torch import kernels
from diffmusic_tpu_torch.inverse_problem import MusicInpaintingOperator
from diffmusic_tpu_torch.kernels import conv1d as tconv1d
from diffmusic_tpu_torch.kernels import conv2d as tconv2d
from diffmusic_tpu_torch.kernels import group_norm as tgn
from diffmusic_tpu_torch.kernels import mask as tmask
from diffmusic_tpu_torch.models import configs as tcfg
from diffmusic_tpu_torch.models import layers as tlayers
from diffmusic_tpu_torch.models.convert import from_flax
from diffmusic_tpu_torch.models.hifigan import SpeechT5HifiGan
from diffmusic_tpu_torch.models.unet import UNet2DConditionModel
from diffmusic_tpu_torch.models.vae import AutoencoderKL
from diffmusic_tpu_torch.pipelines import MusicLDMPipeline
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

SLOPE = 0.1


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def arr(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def nchw(a):
    """numpy NHWC -> torch NCHW (contiguous)."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


@pytest.fixture
def interpret(monkeypatch):
    for module in (gk, ck, mk):
        monkeypatch.setattr(module, "_INTERPRET", True)
    monkeypatch.setenv("DIFFMUSIC_TPU_MASK", "pallas")


# ------------------------------------------------------------------ GroupNorm
GN_SHAPES = [(2, 50, 16, 128), (1, 63, 4, 128)]   # NHWC; 252 rows: JAX pads to 256


@pytest.mark.parametrize("shape", GN_SHAPES, ids=str)
@pytest.mark.parametrize("use_silu", [False, True])
def test_group_norms_match_jax(interpret, rng, shape, use_silu):
    """Fused and stats GroupNorm, values and input gradients, fp32."""
    x = arr(rng, *shape, scale=2.0, shift=0.3)
    c = shape[-1]
    scale, bias = arr(rng, c, scale=0.2, shift=1.0), arr(rng, c, scale=0.1)
    g = arr(rng, *shape)
    jargs = (jnp.asarray(scale), jnp.asarray(bias))
    for jfn, tfn in ((gk.fused_group_norm, tgn.fused_group_norm),
                     (gk.stats_group_norm, tgn.stats_group_norm)):
        jy, vjp = jax.vjp(lambda x_: jfn(x_, *jargs, 32, 1e-5, use_silu), jnp.asarray(x))
        (jdx,) = vjp(jnp.asarray(g))
        xt = nchw(x).requires_grad_(True)
        y = tfn(xt, torch.from_numpy(scale), torch.from_numpy(bias), 32, 1e-5, use_silu)
        (dx,) = torch.autograd.grad(y, xt, nchw(g))
        assert rel(to_nhwc(y), jy) <= 1e-5, tfn.__name__
        assert rel(to_nhwc(dx), jdx) <= 1e-4, tfn.__name__
        # both agree with the plain GroupNorm
        assert rel(y.detach(), tgn.group_norm_plain(nchw(x), torch.from_numpy(scale),
                                                    torch.from_numpy(bias), 32, 1e-5,
                                                    use_silu)) <= 1e-5


def test_group_norms_match_jax_in_bf16(interpret, rng):
    x = arr(rng, 2, 25, 8, 256, scale=2.0, shift=0.3)
    scale, bias = arr(rng, 256, scale=0.2, shift=1.0), arr(rng, 256, scale=0.1)
    xb = jnp.asarray(x, jnp.bfloat16)
    sb, bb = jnp.asarray(scale, jnp.bfloat16), jnp.asarray(bias, jnp.bfloat16)
    xt = nchw(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    st = torch.from_numpy(np.array(sb.astype(jnp.float32))).to(torch.bfloat16)
    bt = torch.from_numpy(np.array(bb.astype(jnp.float32))).to(torch.bfloat16)
    for jfn, tfn in ((gk.fused_group_norm, tgn.fused_group_norm),
                     (gk.stats_group_norm, tgn.stats_group_norm)):
        jy = jfn(xb, sb, bb, 32, 1e-6, True)
        y = tfn(xt, st, bt, 32, 1e-6, True)
        assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
        assert rel(to_nhwc(y), jy.astype(jnp.float32)) <= 1e-2, tfn.__name__


def test_channel_moments_and_vjp_match_jax(interpret, rng):
    x = arr(rng, 2, 200, 128, scale=1.5, shift=0.2)        # JAX (B, N, C)
    g = arr(rng, 2, 2, 128)
    jm, vjp = jax.vjp(gk.channel_moments, jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))).requires_grad_(True)
    m = tgn.channel_moments(xt)
    (dx,) = torch.autograd.grad(m, xt, torch.from_numpy(g))
    assert m.shape == (2, 2, 128) and m.dtype == torch.float32
    assert rel(m.detach(), jm) <= 1e-5
    assert rel(dx.transpose(1, 2), jdx) <= 1e-6
    assert rel(tgn.moments_plain(xt.detach()), jm) <= 1e-5


# --------------------------------------------------------------------- conv2d
@pytest.mark.parametrize("b,h,w,cin,cout", [(1, 32, 16, 128, 128), (2, 16, 32, 128, 256)])
def test_conv2d_matches_jax(interpret, rng, b, h, w, cin, cout):
    x = arr(rng, b, h, w, cin)
    wt = arr(rng, 3, 3, cin, cout, scale=1.0 / math.sqrt(9 * cin))   # HWIO
    bias = arr(rng, cout, scale=0.1)
    g = arr(rng, b, h, w, cout)
    assert ck._eligible(x, wt)                                      # the Pallas kernel runs
    jy, vjp = jax.vjp(lambda x_: ck.conv2d_same_fused(x_, jnp.asarray(wt), jnp.asarray(bias)),
                      jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    xt = nchw(x).requires_grad_(True)
    w_oihw = torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1)))
    y = tconv2d.conv2d_same(xt, w_oihw, torch.from_numpy(bias))
    (dx,) = torch.autograd.grad(y, xt, nchw(g))
    assert tconv2d.conv2d_ok(xt, w_oihw)
    assert rel(to_nhwc(y), jy) <= 1e-5
    assert rel(to_nhwc(dx), jdx) <= 1e-5


def test_conv2d_module_keeps_conv2d_parameters():
    """`Conv2dSame` is an `nn.Conv2d` (names, init and `from_flax` unchanged)
    and routes only where `conv2d_ok` holds."""
    m = tlayers.Conv2dSame(128, 128, 3, conv2d_kernel=True)
    assert isinstance(m, torch.nn.Conv2d) and m.padding == (1, 1)
    assert [n for n, _ in m.named_parameters()] == ["weight", "bias"]
    x = torch.randn(1, 128, 8, 16)                          # H*W = 128 < 512: plain
    assert not tconv2d.conv2d_ok(x, m.weight)
    assert torch.equal(m(x), torch.nn.functional.conv2d(x, m.weight, m.bias, padding=1))


# ----------------------------------------------------------------------- mask
@pytest.mark.parametrize("shape", [(1, 4096, 128), (1, 5001, 256)], ids=str)
def test_leaky_masks_match_jax(interpret, rng, shape):
    h, g, r = arr(rng, *shape), arr(rng, *shape), arr(rng, *shape)
    jh, jg, jr = map(jnp.asarray, (h, g, r))
    th, tg, tr = map(torch.from_numpy, (h, g, r))
    assert rel(tmask.leaky_mask(th, tg, SLOPE), mk.leaky_mask(jh, jg, SLOPE)) <= 1e-6
    assert rel(tmask.leaky_mask_add(th, tg, tr, SLOPE),
               mk.leaky_mask_add(jh, jg, jr, SLOPE)) <= 1e-6


def test_conv1d_backward_masks_route(rng, monkeypatch):
    """With `mask_kernel` the conv1d backwards call the mask wrappers for
    eligible x (`_pair_bwd`: leaky_mask for dh, leaky_mask_add for dx), and
    the gradients equal the plain route's."""
    calls = {}
    for name in ("leaky_mask", "leaky_mask_add"):
        fn = getattr(tconv1d, name)
        monkeypatch.setattr(tconv1d, name,
                            lambda *a, _fn=fn, _n=name: calls.__setitem__(_n, calls.get(_n, 0) + 1)
                            or _fn(*a))
    x = torch.from_numpy(arr(rng, 1, 4096, 128))
    w = torch.from_numpy(arr(rng, 3, 128, 128, scale=0.05))
    b = torch.zeros(128)
    g = torch.from_numpy(arr(rng, 1, 4096, 128))
    grads = {}
    for mask_kernel in (False, True):
        xx = x.clone().requires_grad_(True)
        y = tconv1d.conv1d_fused_pair(xx, w, b, w, b, 3, SLOPE, mask_kernel)
        y = tconv1d.conv1d_fused(y, w, b, None, 1, SLOPE, mask_kernel)
        (grads[mask_kernel],) = torch.autograd.grad(y, xx, g)
    assert calls == {"leaky_mask": 2, "leaky_mask_add": 1}
    assert torch.equal(grads[True], grads[False])


# -------------------------------------------------------------------- routing
def test_routes_match_jax_at_the_slice_geometries():
    """Each route decision equals the JAX package's rule at every GroupNorm,
    3x3 conv and vocoder stage of the 10-s slice (the geometries from
    full-width forwards on the meta device, which allocate and compute
    nothing), and the eligible calls add up to the launches `chip_smoke.py`
    expects of one guided step."""
    seen = chip_smoke.slice_geometries()
    assert len(seen["unet"]["gn"]) == 61 and len(seen["vae"]["gn"]) == 24
    for name, model in seen.items():
        counts = {"fused_group_norm": 0, "channel_moments": 0, "conv2d_same": 0}
        for (b, c, h, w), _, _ in model["gn"]:
            x = torch.empty(b, c, h, w, device="meta")
            fused = tgn.fused_gn_ok(x)
            moments = tgn.moments_ok(x.reshape(b, c, h * w))
            assert fused == gk._eligible(SimpleNamespace(ndim=4, shape=(b, h, w, c)))
            assert moments == gk._moments_eligible(SimpleNamespace(shape=(b, h * w, c)))
            counts["fused_group_norm"] += fused
            counts["channel_moments"] += moments
        for xs, (cout, cin, kh, kw) in model["conv"]:
            x = torch.empty(xs, device="meta")
            w = torch.empty(cout, cin, kh, kw, device="meta")
            jx = SimpleNamespace(shape=(xs[0], xs[2], xs[3], xs[1]))
            jax_route = kh > 1 and xs[3] <= 64 and ck._eligible(
                jx, SimpleNamespace(shape=(kh, kw, cin, cout)))
            assert tconv2d.conv2d_ok(x, w) == jax_route
            counts["conv2d_same"] += jax_route
        want = chip_smoke.ROUTE_LAUNCHES[name]
        assert counts == {"fused_group_norm": want["fused"]["fused_group_norm"],
                          "channel_moments": want["stats"]["channel_moments"],
                          "conv2d_same": want["stats"]["conv2d_same"]}, (name, counts)
    stages = chip_smoke.mask_geometries()
    assert [shape for shape, _, _ in stages] == [(1, 5001, 512), (1, 20004, 256),
                                                 (1, 40008, 128), (1, 80016, 64),
                                                 (1, 160032, 32)]
    for shape, n_mask, _ in stages:
        h = torch.empty(shape, device="meta")
        assert tmask.mask_ok(h) == mk.mask_ok(SimpleNamespace(shape=shape)) == (n_mask > 0)
    assert chip_smoke.MASKS_PER_STEP == {
        "leaky_mask": sum(n for _, n, _ in stages), "leaky_mask_add": sum(n for *_, n in stages)}


# ------------------------------------------------------------ the whole slice
AUDIO_S = 0.256      # 64 mel frames at hop 64: latents (1, 8, 32, 32)
UNET = jcfg.UNetConfig(sample_size=32, block_out_channels=(128, 128), layers_per_block=1,
                       norm_num_groups=32, has_attention=(True, False),
                       projection_class_embeddings_input_dim=32)
VAE = jcfg.VAEConfig(block_out_channels=(32, 128), layers_per_block=1, norm_num_groups=32,
                     scaling_factor=0.5)
# one ch128 stage at T = 4096 = 64 x 64 frames: mask_ok holds
VOC = jcfg.HiFiGANConfig(upsample_initial_channel=256, upsample_rates=(64,),
                         upsample_kernel_sizes=(128,), resblock_kernel_sizes=(3,),
                         resblock_dilation_sizes=((1, 3),))
STEPS = 3


def port(model_cls, params, cfg, **routes):
    pcfg = getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))
    model = model_cls(pcfg, **routes)
    model.load_state_dict(from_flax(params, pcfg), strict=True)
    return model


@pytest.fixture(scope="module")
def params():
    k1, k2, k3 = jax.random.split(jax.random.key(4), 3)
    unet_p = jax.jit(JUNet(UNET).init)(k1, jnp.zeros((1, 8, 8, 8)), jnp.asarray([0]),
                                       class_labels=jnp.zeros((1, 32)))
    vae_p = jax.jit(JVAE(VAE).init)(k2, jnp.zeros((1, 1, 8, 8)))
    voc_p = jax.jit(JHifiGan(VOC).init)(k3, jnp.zeros((1, 2, 64)))
    return unet_p, vae_p, voc_p


@pytest.mark.parametrize("gn_mode", ["stats", "fused"])
def test_dps_slice_with_routes_matches_jax(interpret, rng, params, monkeypatch, gn_mode):
    for var, value in (("DIFFMUSIC_TPU_GN", gn_mode), ("DIFFMUSIC_TPU_CONV2D", "pallas"),
                       ("DIFFMUSIC_TPU_VAE_SWAP", "0")):
        monkeypatch.setenv(var, value)
    unet_p, vae_p, voc_p = params
    kw = dict(audio_length_in_s=AUDIO_S, sample_rate=16000, mask_type="box",
              start_inpainting_s=AUDIO_S * 0.4, end_inpainting_s=AUDIO_S * 0.6)
    jpipe = JPipeline(unet_cfg=UNET, vae_cfg=VAE, vocoder_cfg=VOC,
                      text_cfg=jcfg.tiny_clap_text_config(), unet_params=unet_p,
                      vae_params=vae_p, vocoder_params=voc_p, text_params={},
                      scheduler_name="dps", operator=JInpaint(**kw))
    routes = dict(gn_mode=gn_mode, conv2d_kernel=True)
    tpipe = MusicLDMPipeline(port(UNet2DConditionModel, unet_p, UNET, **routes),
                             port(AutoencoderKL, vae_p, VAE, **routes),
                             port(SpeechT5HifiGan, voc_p, VOC, mask_kernel=True),
                             scheduler_name="dps", operator=MusicInpaintingOperator(**kw))
    owl = int(AUDIO_S * 16000)
    tt = np.arange(owl) / 16000
    gt = (0.25 * np.sin(2 * np.pi * 220 * tt) + 0.1 * np.sin(2 * np.pi * 660 * tt))[None]
    measurement = np.array(jpipe.operator.forward(jnp.asarray(gt, jnp.float32)))
    latents = rng.standard_normal((1, 8, 32, 32)).astype(np.float32)
    embeds = np.zeros((2, 32), np.float32)
    call = dict(audio_length_in_s=AUDIO_S, num_inference_steps=STEPS, guidance_scale=2.0,
                eta=0.0, ip_guidance_rate=0.5, return_losses=True)
    jlat = {}   # per-step latents, through the JAX pipeline's callback
    _, jlosses = jpipe(prompt_embeds=jnp.asarray(embeds), measurement=jnp.asarray(measurement),
                       latents=jnp.asarray(latents),
                       callback=lambda i, t, x: jlat.__setitem__(i, np.asarray(x)), **call)

    calls = {}
    spied = [(tlayers, "stats_group_norm" if gn_mode == "stats" else "fused_group_norm"),
             (tlayers, "conv2d_same"), (tconv1d, "leaky_mask"), (tconv1d, "leaky_mask_add")]
    if gn_mode == "stats":
        spied.append((tgn, "channel_moments"))
    for module, name in spied:
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _fn=fn, _n=name: calls.__setitem__(
            _n, calls.get(_n, 0) + 1) or _fn(*a))
    kernels.reset_launch_counts()
    out, tlosses = tpipe(prompt_embeds=torch.from_numpy(embeds),
                         measurement=torch.from_numpy(measurement),
                         latents=torch.from_numpy(latents), output_type="latent", **call)
    assert all(v == 0 for v in kernels.launch_counts().values())   # CPU: plain versions
    assert sorted(calls) == sorted(name for _, name in spied) and all(calls.values()), calls
    np.testing.assert_allclose(tlosses, np.asarray(jlosses), rtol=1e-4)
    assert rel(out.audios, jlat[STEPS - 1]) <= 1e-3
