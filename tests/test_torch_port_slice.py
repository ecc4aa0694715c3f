"""CPU parity of the whole slice: MusicLDM DPS box inpainting through the
port's `MusicLDMPipeline.__call__` against the JAX package's, with the weights
carried over by `from_flax`, the same injected initial latents and
measurement, and eta = 0 (no sampling noise enters).

Small models whose routes cover every kernel wrapper (plain versions on the
CPU): UNet latent (1, 8, 16, 32) gives level 0 T = 512 tokens (fused block);
the vocoder's ch128 stage runs pairs and its first upsampler the phase
ConvTranspose. Tolerances: per-step losses 1e-4 relative, final latents 1e-3
of max |reference|, decoded mel and waveform 1e-2 (the BASELINE.md bar).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmusic_tpu.inverse_problem import MusicInpaintingOperator as JInpaint
from diffmusic_tpu.models import configs as jcfg
from diffmusic_tpu.models.hifigan import SpeechT5HifiGan as JHifiGan
from diffmusic_tpu.models.unet import UNet2DConditionModel as JUNet
from diffmusic_tpu.models.vae import AutoencoderKL as JVAE
from diffmusic_tpu.pipelines.musicldm import MusicLDMPipeline as JPipeline
from diffmusic_tpu_torch import kernels
from diffmusic_tpu_torch.inverse_problem import MusicInpaintingOperator
from diffmusic_tpu_torch.models import configs as tcfg
from diffmusic_tpu_torch.models.clap import ClapTextModelWithProjection
from diffmusic_tpu_torch.models.convert import from_flax, init_flax_style
from diffmusic_tpu_torch.models.hifigan import SpeechT5HifiGan
from diffmusic_tpu_torch.models.unet import UNet2DConditionModel
from diffmusic_tpu_torch.models.vae import AutoencoderKL
from diffmusic_tpu_torch.pipelines import MusicLDMPipeline
from diffmusic_tpu_torch.pipelines.audioldm2 import byte_tokenizer
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

AUDIO_S = 0.32
UNET = jcfg.tiny_unet_config()
VAE = jcfg.tiny_vae_config()
VOC = jcfg.HiFiGANConfig(upsample_initial_channel=256, resblock_kernel_sizes=(3, 7),
                         resblock_dilation_sizes=((1, 3), (1, 3)))
STEPS = 3
RATE = 0.5


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def port(model_cls, params, cfg):
    pcfg = getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))
    model = model_cls(pcfg)
    model.load_state_dict(from_flax(params, pcfg), strict=True)
    return model


def operators():
    kw = dict(audio_length_in_s=AUDIO_S, sample_rate=16000, mask_type="box",
              start_inpainting_s=AUDIO_S * 0.4, end_inpainting_s=AUDIO_S * 0.6)
    return JInpaint(**kw), MusicInpaintingOperator(**kw)


@pytest.fixture(scope="module")
def pipelines():
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    unet_p = jax.jit(JUNet(UNET).init)(k1, jnp.zeros((1, 8, 8, 8)), jnp.asarray([0]),
                                       class_labels=jnp.zeros((1, 32)))
    vae_p = jax.jit(JVAE(VAE).init)(k2, jnp.zeros((1, 1, 8, 8)))
    voc_p = jax.jit(JHifiGan(VOC).init)(k3, jnp.zeros((1, 2, 64)))
    jop, top = operators()
    jpipe = JPipeline(unet_cfg=UNET, vae_cfg=VAE, vocoder_cfg=VOC,
                      text_cfg=jcfg.tiny_clap_text_config(), unet_params=unet_p,
                      vae_params=vae_p, vocoder_params=voc_p, text_params={},
                      scheduler_name="dps", operator=jop)
    tpipe = MusicLDMPipeline(port(UNet2DConditionModel, unet_p, UNET),
                             port(AutoencoderKL, vae_p, VAE),
                             port(SpeechT5HifiGan, voc_p, VOC),
                             scheduler_name="dps", operator=top)
    return jpipe, tpipe


def test_dps_slice_matches_jax(rng, pipelines):
    jpipe, tpipe = pipelines
    owl = int(AUDIO_S * 16000)
    tt = np.arange(owl) / 16000
    gt = (0.25 * np.sin(2 * np.pi * 220 * tt) + 0.1 * np.sin(2 * np.pi * 660 * tt))[None]
    measurement = np.array(jpipe.operator.forward(jnp.asarray(gt, jnp.float32)))
    latents = rng.standard_normal((1, 8, 16, 32)).astype(np.float32)
    embeds = np.zeros((2, 32), np.float32)   # empty prompt: degenerate CFG
    kw = dict(audio_length_in_s=AUDIO_S, num_inference_steps=STEPS, guidance_scale=2.0,
              eta=0.0, ip_guidance_rate=RATE, return_losses=True)
    jlat, tlat = {}, {}   # per-step latents, through each pipeline's callback

    jout, jlosses = jpipe(prompt_embeds=jnp.asarray(embeds), measurement=jnp.asarray(measurement),
                          latents=jnp.asarray(latents),
                          callback=lambda i, t, x: jlat.__setitem__(i, np.asarray(x)), **kw)
    kernels.reset_launch_counts()
    tout, tlosses = tpipe(prompt_embeds=torch.from_numpy(embeds),
                          measurement=torch.from_numpy(measurement),
                          latents=torch.from_numpy(latents),
                          callback=lambda i, t, x: tlat.__setitem__(i, x.numpy()), **kw)
    assert all(v == 0 for v in kernels.launch_counts().values())   # CPU: plain versions

    assert tlosses.shape == (STEPS,)
    assert np.all(np.diff(tlosses) != 0)
    np.testing.assert_allclose(tlosses, np.asarray(jlosses), rtol=1e-4)
    final = tlat[STEPS - 1]
    assert rel(final, jlat[STEPS - 1]) <= 1e-3
    assert not np.allclose(final, latents)
    assert tout.audios.shape == jout.audios.shape == (1, int(AUDIO_S * 16000))
    assert rel(tout.audios, jout.audios) <= 1e-2

    jmel = np.asarray(jax.jit(jpipe.decode_mel)(jnp.asarray(jlat[STEPS - 1])))
    tmel = tpipe.decode_mel(torch.from_numpy(final)).numpy()
    assert tmel.shape == jmel.shape == (1, 1, 32, 64)
    assert rel(tmel, jmel) <= 1e-2


def test_port_pipeline_outputs_audio_and_rejects_text_prompts(pipelines):
    """Audio from prompt embeds; a text prompt raises without a tokenizer and
    CLAP text tower, and runs with them."""
    _, tpipe = pipelines
    _, top = operators()
    meas = top.forward(torch.zeros(1, int(AUDIO_S * 16000)))
    out, losses = tpipe(audio_length_in_s=AUDIO_S, num_inference_steps=2, eta=0.0,
                        prompt_embeds=torch.zeros(2, 32), measurement=meas,
                        generator=torch.Generator().manual_seed(0), return_losses=True)
    assert out.audios.shape == (1, int(AUDIO_S * 16000))
    assert np.isfinite(out.audios).all() and np.isfinite(losses).all()
    with pytest.raises(ValueError, match="text tower"):
        tpipe(prompt="piano", audio_length_in_s=AUDIO_S, num_inference_steps=1)
    with pytest.raises(ValueError, match="measurement"):
        tpipe(prompt_embeds=torch.zeros(1, 32), audio_length_in_s=AUDIO_S,
              num_inference_steps=1)
    text = init_flax_style(ClapTextModelWithProjection(tcfg.tiny_clap_text_config()), seed=7)
    texted = dataclasses.replace(tpipe, text_encoder=text, tokenizer=byte_tokenizer)
    out, losses = texted(prompt="piano", audio_length_in_s=AUDIO_S, num_inference_steps=2,
                         eta=0.0, measurement=meas, generator=torch.Generator().manual_seed(0),
                         return_losses=True)
    assert out.audios.shape == (1, int(AUDIO_S * 16000))
    assert np.isfinite(out.audios).all() and np.isfinite(losses).all()
