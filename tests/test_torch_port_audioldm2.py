"""CPU parity of the AudioLDM2 slice: DPS box inpainting from a text prompt
through the port's `AudioLDM2Pipeline.__call__` against the JAX package's,
with the weights of `diffmusic_tpu.pipelines.AudioLDM2Pipeline.tiny` carried
over by `from_flax`, the same tokenizers, injected initial latents and
measurement, and eta = 0 (no sampling noise enters). Also the MusicLDM text
prompt, now encoded by the port's CLAP text tower.

The tiny UNet at latent (1, 8, 16, 32) has T = 512 tokens at level 0, so its
3 level-0 blocks take the flash attention route (plain version on the CPU).
Tolerances, as in `test_torch_port_slice.py`: per-step losses 1e-4 relative,
final latents 1e-3 of max |reference|, waveform 1e-2; prompt encodings 1e-4
(8 GPT-2 generation steps). The same JAX tiny pipeline also holds the prompt
encodings with prompt_type="clap" (the measurement through its tiny CLAP
audio tower) and with a transcription (a tiny VITS in T5's place, added to
copies of both pipelines), and `score_waveforms`' order and similarities
(1e-5) on 4 candidates.
"""

import dataclasses
import inspect


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmusic_tpu.inverse_problem import MusicInpaintingOperator as JInpaint
from diffmusic_tpu.models import vits as jvits
from diffmusic_tpu.pipelines.audioldm2 import AudioLDM2Pipeline as JAudioLDM2
from diffmusic_tpu.pipelines.musicldm import MusicLDMPipeline as JMusicLDM
from diffmusic_tpu_torch import kernels
from diffmusic_tpu_torch.inverse_problem import MusicInpaintingOperator
from diffmusic_tpu_torch.models import configs as tcfg
from diffmusic_tpu_torch.models import layers as tlayers
from diffmusic_tpu_torch.models import clap_features as tcf
from diffmusic_tpu_torch.models import htsat, vits
from diffmusic_tpu_torch.models.clap import ClapTextModelWithProjection
from diffmusic_tpu_torch.models.convert import from_flax
from diffmusic_tpu_torch.models.gpt2 import GPT2Model
from diffmusic_tpu_torch.models.hifigan import SpeechT5HifiGan
from diffmusic_tpu_torch.models.projection import AudioLDM2ProjectionModel
from diffmusic_tpu_torch.models.t5 import T5EncoderModel
from diffmusic_tpu_torch.models.unet import UNet2DConditionModel
from diffmusic_tpu_torch.models.vae import AutoencoderKL
from diffmusic_tpu_torch.pipelines import AudioLDM2Pipeline, MusicLDMPipeline
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

AUDIO_S = 0.32
STEPS = 3
RATE = 0.5


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def port(model_cls, params, cfg):
    import dataclasses
    pcfg = getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))
    model = model_cls(pcfg)
    model.load_state_dict(from_flax(params, pcfg), strict=True)
    return model


def port_tower(jembed):
    """The port's tower and feature config from a JAX embed closure's own
    variables."""
    cells = inspect.getclosurevars(jembed).nonlocals
    jcfg_ = cells["htsat_model"].cfg
    cfg = htsat.ClapAudioConfig(**dataclasses.asdict(jcfg_))
    tower = htsat.ClapAudioModelWithProjection(cfg)
    tower.load_state_dict(from_flax(cells["htsat_params"], cfg), strict=True)
    return tower.requires_grad_(False), tcf.ClapFeatureConfig(
        **dataclasses.asdict(cells["cfg"]))


def operators():
    kw = dict(audio_length_in_s=AUDIO_S, sample_rate=16000, mask_type="box",
              start_inpainting_s=AUDIO_S * 0.4, end_inpainting_s=AUDIO_S * 0.6)
    return JInpaint(**kw), MusicInpaintingOperator(**kw)


@pytest.fixture(scope="module")
def pipelines():
    jop, top = operators()
    j = JAudioLDM2.tiny("dps", operator=jop)
    t = AudioLDM2Pipeline(
        port(UNet2DConditionModel, j.unet_params, j.unet_cfg),
        port(AutoencoderKL, j.vae_params, j.vae_cfg),
        port(SpeechT5HifiGan, j.vocoder_params, j.vocoder_cfg),
        scheduler_name="dps", operator=top,
        text_encoder=port(ClapTextModelWithProjection, j.text_params, j.text_cfg),
        tokenizer=j.tokenizer, t5=port(T5EncoderModel, j.t5_params, j.t5_cfg),
        gpt2=port(GPT2Model, j.gpt2_params, j.gpt2_cfg),
        projection=port(AudioLDM2ProjectionModel, j.proj_params, j.proj_cfg),
        t5_tokenizer=j.t5_tokenizer)
    tower, f_cfg = port_tower(j.clap_audio_embed)
    t.clap_audio_embed = tcf.make_clap_audio_embed(tower, f_cfg)
    t.clap_frame_embed = tcf.make_clap_frame_embed(tower, f_cfg)
    return j, t


def test_prompt_encoding_matches_jax(pipelines):
    j, t = pipelines
    ref = j.encode_prompt("piano", "noise", True)
    out = t.encode_prompt("piano", "noise", True)
    assert [tuple(a.shape) for a in out] == [a.shape for a in ref]
    assert rel(out[0], ref[0]) <= 1e-4      # generated GPT-2 states
    assert rel(out[1], ref[1]) <= 1e-5      # T5 sequences
    assert np.array_equal(out[2].numpy(), np.asarray(ref[2]))
    assert t._cfg_is_degenerate(t.encode_prompt("", None, True))
    assert not t._cfg_is_degenerate(out)


@pytest.mark.parametrize("prompt", ["", "piano"])
def test_audioldm2_dps_matches_jax(rng, pipelines, monkeypatch, prompt):
    """An empty prompt takes the degenerate-CFG skip (one UNet row); "piano"
    runs classifier-free guidance at 3.5 (the batch doubles)."""
    j, t = pipelines
    owl = int(AUDIO_S * 16000)
    tt = np.arange(owl) / 16000
    gt = (0.25 * np.sin(2 * np.pi * 220 * tt) + 0.1 * np.sin(2 * np.pi * 660 * tt))[None]
    measurement = np.array(j.operator.forward(jnp.asarray(gt, jnp.float32)))
    latents = rng.standard_normal((1, 8, 16, 32)).astype(np.float32)
    kw = dict(prompt=prompt, audio_length_in_s=AUDIO_S, num_inference_steps=STEPS,
              guidance_scale=3.5, eta=0.0, ip_guidance_rate=RATE, return_losses=True)
    jlat, tlat, rows = {}, {}, []
    jout, jlosses = j(measurement=jnp.asarray(measurement), latents=jnp.asarray(latents),
                      callback=lambda i, t_, x: jlat.__setitem__(i, np.asarray(x)), **kw)
    flash = tlayers.flash_attention
    monkeypatch.setattr(tlayers, "flash_attention",
                        lambda q, k, v, *bwd: rows.append(q.shape[0]) or flash(q, k, v, *bwd))
    kernels.reset_launch_counts()
    tout, tlosses = t(measurement=torch.from_numpy(measurement),
                      latents=torch.from_numpy(latents),
                      callback=lambda i, t_, x: tlat.__setitem__(i, x.numpy()), **kw)
    assert all(v == 0 for v in kernels.launch_counts().values())   # CPU: plain versions
    # level 0 (T = 512): 3 flash calls per UNet pass, on 1 row or 2 under CFG
    assert rows == [1 if prompt == "" else 2] * (3 * STEPS)
    assert tlosses.shape == (STEPS,)
    np.testing.assert_allclose(tlosses, np.asarray(jlosses), rtol=1e-4)
    final = tlat[STEPS - 1]
    assert rel(final, jlat[STEPS - 1]) <= 1e-3
    assert not np.allclose(final, latents)
    assert tout.audios.shape == jout.audios.shape == (1, owl)
    assert rel(tout.audios, jout.audios) <= 1e-2


def assert_same_encoding(out, ref):
    assert [tuple(a.shape) for a in out] == [a.shape for a in ref]
    assert rel(out[0], ref[0]) <= 1e-4      # generated GPT-2 states
    assert rel(out[1], ref[1]) <= 1e-5      # the second stream
    assert np.array_equal(out[2].numpy(), np.asarray(ref[2]))


def test_clap_prompt_encoding_matches_jax(rng, pipelines):
    j, t = pipelines
    meas = (rng.standard_normal((1, 12000)) * 0.3).astype(np.float32)
    ref = j.encode_prompt("piano", "noise", True, measurement=jnp.asarray(meas),
                          prompt_type="clap")
    out = t.encode_prompt("piano", "noise", True, measurement=torch.from_numpy(meas),
                          prompt_type="clap")
    assert_same_encoding(out, ref)
    text = t.encode_prompt("piano", "noise", True)
    assert rel(out[0][1:], text[0][1:]) > 1e-3      # the audio took the text's place
    assert torch.equal(out[1], text[1])
    with pytest.raises(ValueError, match="clap_audio_embed"):
        dataclasses.replace(t, clap_audio_embed=None).encode_prompt(
            "x", None, True, measurement=torch.from_numpy(meas), prompt_type="clap")


def vits_tokenizer(texts, maxlen=10):
    ids = np.zeros((len(texts), maxlen), np.int32)
    mask = np.zeros((len(texts), maxlen), np.int32)
    for i, text in enumerate(texts):
        b = [1 + (c % 60) for c in text.encode()][:maxlen]
        ids[i, :len(b)] = b
        mask[i, :len(b)] = 1
    return ids, mask


def test_transcription_encoding_matches_jax(pipelines):
    """A tiny VITS of T5's width in both pipelines' second stream: the
    transcription's encoding for the prompt, the empty one's for the
    negative prompt."""
    j, t = pipelines
    with pytest.raises(ValueError, match="VITS"):
        t.encode_prompt("x", None, True, transcription="hello")
    cfg = jvits.VitsConfig(vocab_size=64, hidden_size=j.t5_cfg.d_model, num_hidden_layers=2,
                           num_attention_heads=2, ffn_dim=32)
    params = jvits.VitsTextEncoder(cfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    jt = dataclasses.replace(j, vits_cfg=cfg, vits_params=params,
                             vits_tokenizer=vits_tokenizer)
    model = vits.VitsTextEncoder(vits.VitsConfig(**dataclasses.asdict(cfg)))
    model.load_state_dict(from_flax(params, model.cfg), strict=True)
    tt = dataclasses.replace(t, vits=model, vits_tokenizer=vits_tokenizer)
    for args in (("speech", "noise", True), ("speech", None, False)):
        ref = jt.encode_prompt(*args, transcription="hello there")
        out = tt.encode_prompt(*args, transcription="hello there")
        assert_same_encoding(out, ref)
    assert out[1].shape == (1, 10, j.t5_cfg.d_model)


def test_score_waveforms_matches_jax(rng, pipelines):
    j, t = pipelines
    tt = np.arange(16000) / 16000
    audio = np.stack([np.sin(2 * np.pi * f * tt) * a for f, a in
                      ((220, 0.3), (1500, 0.2), (440, 0.5), (5000, 0.1))]).astype(np.float32)
    audio += (0.01 * rng.standard_normal(audio.shape)).astype(np.float32)
    for keep in (None, 2):
        jaudio, jsim = j.score_waveforms("a piano", jnp.asarray(audio), keep)
        taudio, tsim = t.score_waveforms("a piano", torch.from_numpy(audio), keep)
        assert np.array_equal(taudio, jaudio)      # the same order
        assert rel(tsim, jsim) <= 1e-5
    assert np.all(np.diff(tsim) <= 0) and taudio.shape == (2, 16000)


def test_musicldm_text_prompt_matches_jax():
    """MusicLDM's CLAP text features, CFG-stacked, against JAX's encode_prompt."""
    j = JMusicLDM.tiny()
    text = port(ClapTextModelWithProjection, j.text_params, j.text_cfg)
    t = MusicLDMPipeline(port(UNet2DConditionModel, j.unet_params, j.unet_cfg),
                         port(AutoencoderKL, j.vae_params, j.vae_cfg),
                         port(SpeechT5HifiGan, j.vocoder_params, j.vocoder_cfg),
                         text_encoder=text, tokenizer=j.tokenizer)
    for args in (("solo piano", None, True), ("drums", "noise", True), ("bass", None, False)):
        ref = j.encode_prompt(*args)
        out = t.encode_prompt(*args)
        assert out.shape == ref.shape
        assert rel(out, ref) <= 1e-5
