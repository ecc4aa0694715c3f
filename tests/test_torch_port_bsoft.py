"""CPU parity of the bounded-softmax mode of the fused transformer block
(`bsoft`) against the JAX package, and of the whole slice with the new routes
on: `bsoft`, the vocoder's `canvas="xbwd"` and `stage_bwd`.

On the JAX side the Pallas kernels run in interpret mode (`_INTERPRET`, set
with `monkeypatch`) under `DIFFMUSIC_TPU_BSOFT=1`, and for the slice
`DIFFMUSIC_TPU_CANVAS=xbwd` and `DIFFMUSIC_TPU_STAGE_BWD=1`; the port's
wrappers run their plain versions, because the tensors lie on the CPU.
Inputs come from a numpy seed, fp32. Tolerances, as a fraction of max
|reference|: 1e-4 for the block (another summation order, as
`test_torch_port_cross.py` holds the fused blocks); the slice as
`test_torch_port_slice.py` holds it: losses 1e-4 relative, final latents 1e-3
of max.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffmusic_tpu.pallas.conv1d_kernel as ck
import diffmusic_tpu.pallas.mask_kernel as mk
import diffmusic_tpu.pallas.stage_bwd_kernel as sk
import diffmusic_tpu.pallas.transformer_kernel as jtk
from diffmusic_tpu.inverse_problem import MusicInpaintingOperator as JInpaint
from diffmusic_tpu.models import configs as jcfg
from diffmusic_tpu.models.hifigan import SpeechT5HifiGan as JHifiGan
from diffmusic_tpu.models.unet import UNet2DConditionModel as JUNet
from diffmusic_tpu.models.vae import AutoencoderKL as JVAE
from diffmusic_tpu.pipelines.musicldm import MusicLDMPipeline as JPipeline
from diffmusic_tpu_torch import kernels
from diffmusic_tpu_torch.inverse_problem import MusicInpaintingOperator
from diffmusic_tpu_torch.kernels import attention as tattn
from diffmusic_tpu_torch.kernels import transformer_block as ttb
from diffmusic_tpu_torch.models import configs as tcfg
from diffmusic_tpu_torch.models import hifigan as thifigan
from diffmusic_tpu_torch.models import layers as tlayers
from diffmusic_tpu_torch.models.convert import from_flax
from diffmusic_tpu_torch.models.hifigan import SpeechT5HifiGan
from diffmusic_tpu_torch.models.unet import UNet2DConditionModel
from diffmusic_tpu_torch.models.vae import AutoencoderKL
from diffmusic_tpu_torch.pipelines import MusicLDMPipeline
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

HEADS, T, C = 4, 300, 32
CROSS = ((8, 24), (12, 40))   # (keys, width) of the two streams


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def arr(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def block_params(rng, n_cross: int) -> dict:
    s = 1.0 / math.sqrt(C)
    p = dict(ln1_scale=arr(rng, C, scale=0.1, shift=1.0), ln1_bias=arr(rng, C, scale=0.1),
             wq=arr(rng, C, C, scale=s), wk=arr(rng, C, C, scale=s), wv=arr(rng, C, C, scale=s),
             wo=arr(rng, C, C, scale=s), bo=arr(rng, C, scale=0.1),
             ln3_scale=arr(rng, C, scale=0.1, shift=1.0), ln3_bias=arr(rng, C, scale=0.1),
             wi=arr(rng, C, 8 * C, scale=s), bi=arr(rng, 8 * C, scale=0.1),
             wo2=arr(rng, 4 * C, C, scale=0.5 * s), bo2=arr(rng, C, scale=0.1))
    for i, (_, cd) in enumerate(CROSS[:n_cross]):
        p.update({f"ln2{i}_scale": arr(rng, C, scale=0.1, shift=1.0),
                  f"ln2{i}_bias": arr(rng, C, scale=0.1), f"cwq{i}": arr(rng, C, C, scale=s),
                  f"cwk{i}": arr(rng, cd, C, scale=1 / math.sqrt(cd)),
                  f"cwv{i}": arr(rng, cd, C, scale=1 / math.sqrt(cd)),
                  f"cwo{i}": arr(rng, C, C, scale=s), f"cbo{i}": arr(rng, C, scale=0.1)})
    return p


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("amp", [0.3, 5.0])
def test_bsoft_block_matches_jax(rng, monkeypatch, amp, cross):
    """The block in bsoft mode, self-attention and dual-cross (the second
    stream masks its last 5 keys), against the JAX kernel in interpret mode
    under DIFFMUSIC_TPU_BSOFT=1. At amplitude 5.0 the bound is slack (the
    JAX package's own bsoft test, `tests/test_pallas_transformer.py`)."""
    monkeypatch.setattr(jtk, "_INTERPRET", True)
    monkeypatch.setenv("DIFFMUSIC_TPU_BSOFT", "1")
    x = arr(rng, 1, T, C, scale=amp)
    p = block_params(rng, 2 if cross else 0)
    ctx = tuple(arr(rng, 1, tk, cd, scale=0.5) for tk, cd in CROSS) if cross else ()
    mask = np.arange(12) < 7
    biases = (np.zeros((1, 1, 8), np.float32),
              np.where(mask, 0.0, -1e9).astype(np.float32)[None, None]) if cross else ()
    ref = jtk.fused_transformer_block(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                                      HEADS, 8, tuple(map(jnp.asarray, ctx)),
                                      tuple(map(jnp.asarray, biases)))
    kernels.reset_launch_counts()
    out = ttb.fused_transformer_block(torch.from_numpy(x),
                                      {k: torch.from_numpy(v) for k, v in p.items()}, HEADS, 8,
                                      tuple(map(torch.from_numpy, ctx)),
                                      tuple(map(torch.from_numpy, biases)), bsoft=True)
    assert not any(kernels.launch_counts().values())   # CPU: the plain version
    assert np.isfinite(out.numpy()).all()
    err = rel(out, ref)
    assert err <= 1e-4, err


def test_bounded_attention_is_the_softmax(rng):
    """Softmax is shift-invariant: the bounded plain attention equals the
    exact one while the bound's slack stays far from underflow."""
    q, k, v = (torch.from_numpy(arr(rng, 2, 300, 4, 8, scale=1.5)) for _ in range(3))
    assert rel(ttb.bounded_attention_plain(q, k, v), tattn.attention_plain(q, k, v)) <= 1e-5
    kmax = ttb.key_norm_max(k.reshape(2, 300, 32), 4)
    assert torch.allclose(kmax, k.norm(dim=-1).amax(1))


def test_bsoft_gradient_is_the_exact_softmax_recompute(rng):
    """The backward recomputes through the exact softmax in either mode, as
    the JAX `_ftb_bwd` does."""
    p = {k: torch.from_numpy(v) for k, v in block_params(rng, 0).items()}
    x = torch.from_numpy(arr(rng, 1, T, C))
    g = torch.from_numpy(arr(rng, 1, T, C))
    grads = []
    for bsoft in (False, True):
        xx = x.clone().requires_grad_(True)
        (dx,) = torch.autograd.grad(ttb.fused_transformer_block(xx, p, HEADS, 8, bsoft=bsoft),
                                    xx, g)
        grads.append(dx)
    assert torch.equal(grads[0], grads[1])


# ------------------------------------------------------------ the whole slice
AUDIO_S = 0.32                    # latents (1, 8, 16, 32): level 0 T = 512
UNET = jcfg.tiny_unet_config()
VAE = jcfg.tiny_vae_config()
# stage 0 is ch128: the stage rule holds there
VOC = jcfg.HiFiGANConfig(upsample_initial_channel=256, resblock_kernel_sizes=(3, 7),
                         resblock_dilation_sizes=((1, 3), (1, 3)))
STEPS = 3


def port(model_cls, params, cfg, **routes):
    pcfg = getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))
    model = model_cls(pcfg, **routes)
    model.load_state_dict(from_flax(params, pcfg), strict=True)
    return model


def test_dps_slice_with_bsoft_canvas_and_stage_matches_jax(rng, monkeypatch):
    for var, value in (("DIFFMUSIC_TPU_BSOFT", "1"), ("DIFFMUSIC_TPU_CANVAS", "xbwd"),
                       ("DIFFMUSIC_TPU_STAGE_BWD", "1")):
        monkeypatch.setenv(var, value)
    for module in (jtk, ck, sk, mk):
        monkeypatch.setattr(module, "_INTERPRET", True)
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    unet_p = jax.jit(JUNet(UNET).init)(k1, jnp.zeros((1, 8, 8, 8)), jnp.asarray([0]),
                                       class_labels=jnp.zeros((1, 32)))
    vae_p = jax.jit(JVAE(VAE).init)(k2, jnp.zeros((1, 1, 8, 8)))
    voc_p = jax.jit(JHifiGan(VOC).init)(k3, jnp.zeros((1, 2, 64)))
    kw = dict(audio_length_in_s=AUDIO_S, sample_rate=16000, mask_type="box",
              start_inpainting_s=AUDIO_S * 0.4, end_inpainting_s=AUDIO_S * 0.6)
    jpipe = JPipeline(unet_cfg=UNET, vae_cfg=VAE, vocoder_cfg=VOC,
                      text_cfg=jcfg.tiny_clap_text_config(), unet_params=unet_p,
                      vae_params=vae_p, vocoder_params=voc_p, text_params={},
                      scheduler_name="dps", operator=JInpaint(**kw))
    tpipe = MusicLDMPipeline(port(UNet2DConditionModel, unet_p, UNET, bsoft=True),
                             port(AutoencoderKL, vae_p, VAE),
                             port(SpeechT5HifiGan, voc_p, VOC, canvas="xbwd", stage_bwd=True),
                             scheduler_name="dps", operator=MusicInpaintingOperator(**kw))
    owl = int(AUDIO_S * 16000)
    tt = np.arange(owl) / 16000
    gt = (0.25 * np.sin(2 * np.pi * 220 * tt) + 0.1 * np.sin(2 * np.pi * 660 * tt))[None]
    measurement = np.array(jpipe.operator.forward(jnp.asarray(gt, jnp.float32)))
    latents = rng.standard_normal((1, 8, 16, 32)).astype(np.float32)
    embeds = np.zeros((2, 32), np.float32)
    call = dict(audio_length_in_s=AUDIO_S, num_inference_steps=STEPS, guidance_scale=2.0,
                eta=0.0, ip_guidance_rate=0.5, return_losses=True)
    jlat = {}
    _, jlosses = jpipe(prompt_embeds=jnp.asarray(embeds), measurement=jnp.asarray(measurement),
                       latents=jnp.asarray(latents),
                       callback=lambda i, t, x: jlat.__setitem__(i, np.asarray(x)), **call)

    calls = {}
    for module, name in ((tlayers, "fused_transformer_block"),
                         (thifigan, "stage_resblocks_canvas")):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _fn=fn, _n=name, **k: calls.__setitem__(
            _n, calls.get(_n, 0) + 1) or _fn(*a, **k))
    out, tlosses = tpipe(prompt_embeds=torch.from_numpy(embeds),
                         measurement=torch.from_numpy(measurement),
                         latents=torch.from_numpy(latents), output_type="latent", **call)
    assert calls.get("fused_transformer_block") and calls.get("stage_resblocks_canvas"), calls
    np.testing.assert_allclose(tlosses, np.asarray(jlosses), rtol=1e-4)
    assert rel(out.audios, jlat[STEPS - 1]) <= 1e-3
