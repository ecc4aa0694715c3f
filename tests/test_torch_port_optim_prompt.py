"""CPU parity of `optim_prompt` against the JAX package: at each timestep
with t % 30 == 1 one SGD step on the prompt embeddings along the gradient
of the loss of x0-hat through the UNet, then the sampler's step.

DPS, 4 steps (t = 751 and 1 take the embedding step), on the tiny MusicLDM
and on a tiny AudioLDM2 under classifier-free guidance on both UNet routes
(flash attention, and the fused dual-cross block), with the waveform loss:
per-step losses within 1e-4 relative, final latents within 1e-4 of their
max, and the embedding steps move the result. With the dB-mel loss the run
is ill-conditioned: JAX's own final latents are 9e-4 (of their max) from
the port's float64 run, the port's fp32 ones 8e-5; with the waveform loss
both are within 3e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_samplers as samplers_test
import test_torch_port_slice as slice_test
from diffmusic_tpu.models import configs as jcfg
from diffmusic_tpu.models.hifigan import SpeechT5HifiGan as JHifiGan
from diffmusic_tpu.models.unet import UNet2DConditionModel as JUNet
from diffmusic_tpu.models.vae import AutoencoderKL as JVAE
from diffmusic_tpu.pipelines import musicldm as jmusicldm
from diffmusic_tpu.pipelines.audioldm2 import AudioLDM2Pipeline as JAudioLDM2
from diffmusic_tpu_torch.models.hifigan import SpeechT5HifiGan
from diffmusic_tpu_torch.models.unet import UNet2DConditionModel
from diffmusic_tpu_torch.models.vae import AutoencoderKL
from diffmusic_tpu_torch.pipelines import AudioLDM2Pipeline
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

rel = slice_test.rel
AUDIO_S = slice_test.AUDIO_S
OWL = int(AUDIO_S * 16000)
PROMPT_STEPS, PROMPT_RATE, PROMPT_LR = 4, 0.5, 0.5
jnp_denoise = jmusicldm.denoise_with_nan_retry


def norm_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))

def optim_prompt_runs(monkeypatch, jpipe, tpipe, embeds, measurement, latents,
                      guidance_scale):
    """JAX's run of DPS with optim_prompt, and the port's with and without it:
    (per-step losses, final latents) of each."""
    kw = dict(audio_length_in_s=AUDIO_S, num_inference_steps=PROMPT_STEPS,
              guidance_scale=guidance_scale, eta=0.0, ip_guidance_rate=PROMPT_RATE,
              optim_prompt_learning_rate=PROMPT_LR, supervised_space="wav_form")
    # JAX returns no losses with the latents: its denoise result is caught
    # on the way out (no decode to compile)
    caught = []

    def catch(*a, **k):
        caught.append(jnp_denoise(*a, **k))
        return caught[-1]

    monkeypatch.setattr(jmusicldm, "denoise_with_nan_retry", catch)
    jlat = jpipe(prompt_embeds=jax.tree.map(jnp.asarray, embeds),
                 measurement=jnp.asarray(measurement), latents=jnp.asarray(latents),
                 optim_prompt=True, output_type="latent", **kw).audios
    (_, jl), = caught
    runs = {}
    for on in (True, False):
        tout, tl = tpipe(prompt_embeds=jax.tree.map(torch.from_numpy, embeds),
                         measurement=torch.from_numpy(measurement),
                         latents=torch.from_numpy(latents), optim_prompt=on,
                         output_type="latent", return_losses=True, **kw)
        runs[on] = (tl, tout.audios)
    return (np.asarray(jl), np.asarray(jlat)), runs


def assert_optim_prompt_agrees(out, latents):
    (jl, jlat), runs = out
    tl, tlat = runs[True]
    assert tl.shape == (PROMPT_STEPS,) and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert rel(tlat, jlat) <= 1e-4
    assert not np.allclose(tlat, latents)
    # the embedding steps (t = 751, before its sampler step, and t = 1) move
    # the run away from the same run without them (DPS, held against JAX
    # in test_torch_port_samplers.py and test_torch_port_slice.py)
    tl_off, tlat_off = runs[False]
    assert np.abs(tl / tl_off - 1).min() > 1e-5
    assert norm_rel(tlat, tlat_off) > 1e-4   # the runs agree to ~3e-6


@pytest.fixture(scope="module")
def musicldm():
    jop, top = slice_test.operators()
    return samplers_test.tiny_pipelines(jop, top, "dps")


def test_optim_prompt_musicldm_matches_jax(rng, monkeypatch, musicldm):
    jpipe, tpipe = musicldm
    measurement = np.array(jpipe.operator.forward(
        jnp.asarray(samplers_test.harmonic(OWL), jnp.float32)))
    latents = rng.standard_normal((1, 8, 16, 32)).astype(np.float32)
    embeds = np.zeros((2, 32), np.float32)
    runs = optim_prompt_runs(monkeypatch, jpipe, tpipe, embeds, measurement, latents, 2.0)
    assert_optim_prompt_agrees(runs, latents)


@pytest.fixture(scope="module")
def audioldm2():
    """A tiny AudioLDM2 (JAX's tiny UNet with two 32-wide cross streams) in
    both packages, its weights from seeded flax-style parameters."""
    unet_cfg = jcfg.tiny_unet_config(cross_attention_dims=(32, 32))
    unet_p = samplers_test.flax_style_params(
        JUNet(unet_cfg).init, jnp.zeros((1, 8, 8, 8)), jnp.asarray([0]),
        encoder_hidden_states=jnp.zeros((1, 8, 32)),
        encoder_hidden_states_1=jnp.zeros((1, 4, 32)), seed=5)
    vae_p = samplers_test.flax_style_params(JVAE(slice_test.VAE).init,
                                            jnp.zeros((1, 1, 8, 8)), seed=6)
    voc_p = samplers_test.flax_style_params(JHifiGan(slice_test.VOC).init,
                                            jnp.zeros((1, 2, 64)), seed=7)
    jop, top = slice_test.operators()
    jpipe = JAudioLDM2(unet_cfg=unet_cfg, vae_cfg=slice_test.VAE, vocoder_cfg=slice_test.VOC,
                       text_cfg=jcfg.tiny_clap_text_config(), unet_params=unet_p,
                       vae_params=vae_p, vocoder_params=voc_p, text_params={},
                       scheduler_name="dps", operator=jop)
    vae = slice_test.port(AutoencoderKL, vae_p, slice_test.VAE)
    voc = slice_test.port(SpeechT5HifiGan, voc_p, slice_test.VOC)
    unets = {}
    for fuse in (False, True):
        unet = UNet2DConditionModel(slice_test.port(UNet2DConditionModel, unet_p,
                                                    unet_cfg).cfg, fuse_cross=fuse)
        unet.load_state_dict(slice_test.port(UNet2DConditionModel, unet_p,
                                             unet_cfg).state_dict())
        unets[fuse] = AudioLDM2Pipeline(unet, vae, voc, scheduler_name="dps", operator=top)
    return jpipe, unets


@pytest.mark.parametrize("fuse_cross", [False, True])
def test_optim_prompt_audioldm2_matches_jax(rng, monkeypatch, audioldm2, fuse_cross):
    """Random, distinct CFG halves (the batch doubles, guidance 3.5): the
    GPT-2 states and the T5 sequence take the embedding step, the mask does
    not."""
    from diffmusic_tpu_torch.models import layers as tlayers
    jpipe, pipes = audioldm2
    tpipe = pipes[fuse_cross]
    measurement = np.array(jpipe.operator.forward(
        jnp.asarray(samplers_test.harmonic(OWL), jnp.float32)))
    latents = rng.standard_normal((1, 8, 16, 32)).astype(np.float32)
    mask = np.ones((2, 5), np.int32)
    mask[0, 3:] = 0
    embeds = (rng.standard_normal((2, 8, 32)).astype(np.float32),
              rng.standard_normal((2, 5, 32)).astype(np.float32), mask)
    routes = []
    block, flash = tlayers.fused_transformer_block, tlayers.flash_attention
    monkeypatch.setattr(tlayers, "fused_transformer_block",
                        lambda *a, **k: routes.append("block") or block(*a, **k))
    monkeypatch.setattr(tlayers, "flash_attention",
                        lambda *a: routes.append("flash") or flash(*a))
    runs = optim_prompt_runs(monkeypatch, jpipe, tpipe, embeds, measurement, latents, 3.5)
    assert set(routes) == {"block" if fuse_cross else "flash"}
    assert_optim_prompt_agrees(runs, latents)
