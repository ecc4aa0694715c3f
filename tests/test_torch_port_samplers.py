"""CPU parity of the port's MPGD, DSG and DiffMusic samplers against the JAX
package (fp32, inputs from a numpy seed).

- The steps at eta 0 and 1, t 951 / 501 / 1, on a batch of 1, of 2 (the
  norms run over the whole batch tensor) and on a 3-D sample (DSG's radius
  then counts every element). The JAX step's normal draw for its key is
  handed to the port through `samplers.steps.randn`, so the port keeps JAX's
  API. Tolerance: prev, x0-hat and the loss within 1e-5 relative.
- `slerp`: the endpoints, the lerp fallback (parallel, anti-parallel and
  near-parallel directions) and general directions, within 1e-6.
- The tiny MusicLDM under each sampler, 3 steps of box inpainting through
  `MusicLDMPipeline.__call__` against the JAX pipeline at eta 0 (no draw
  enters): per-step losses within 1e-4 relative, final latents within 1e-3
  of max |reference|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_slice as slice_test
from diffmusic_tpu.models.hifigan import SpeechT5HifiGan as JHifiGan
from diffmusic_tpu.models.unet import UNet2DConditionModel as JUNet
from diffmusic_tpu.models.vae import AutoencoderKL as JVAE
from diffmusic_tpu.models import configs as jcfg
from diffmusic_tpu.pipelines.musicldm import MusicLDMPipeline as JPipeline
from diffmusic_tpu.samplers import (DiffusionSchedule as JSchedule,
                                    SamplerConfig as JSamplerConfig,
                                    make_step_fn as jmake_step_fn)
from diffmusic_tpu.samplers.steps import slerp as jslerp
from diffmusic_tpu_torch.models.hifigan import SpeechT5HifiGan
from diffmusic_tpu_torch.models.unet import UNet2DConditionModel
from diffmusic_tpu_torch.models.vae import AutoencoderKL
from diffmusic_tpu_torch.pipelines import MusicLDMPipeline
from diffmusic_tpu_torch.samplers import (DiffusionSchedule, SamplerConfig, make_step_fn,
                                          slerp)
from diffmusic_tpu_torch.samplers import steps as tsteps
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

rel = slice_test.rel
AUDIO_S = slice_test.AUDIO_S
STEPS = 3
SAMPLERS = ("mpgd", "dsg", "diffmusic")


def jax_normal(key, shape) -> torch.Tensor:
    """The draw a JAX step makes for `key`, as a torch tensor."""
    return torch.from_numpy(np.array(jax.random.normal(key, tuple(shape), jnp.float32)))


def feed_draws(monkeypatch, keys):
    """Make the port's steps draw, in order, JAX's normals for `keys`; returns
    the list of shapes drawn."""
    keys, drawn = iter(keys), []

    def randn(shape, generator, dtype, device):
        drawn.append(tuple(shape))
        return jax_normal(next(keys), shape).to(device, dtype)

    monkeypatch.setattr(tsteps, "randn", randn)
    return drawn


@pytest.mark.parametrize("shape", [(1, 8, 6, 4), (2, 8, 6, 4), (8, 6, 4)])
@pytest.mark.parametrize("eta", [0.0, 1.0])
@pytest.mark.parametrize("name", SAMPLERS)
def test_guided_steps_match_jax(rng, monkeypatch, name, eta, shape):
    eps, x, target = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    jloss = lambda x0: jnp.sqrt(jnp.sum(jnp.square(jnp.sin(x0) - target)))
    tloss = lambda x0: (torch.sin(x0) - torch.from_numpy(target)).square().sum().sqrt()
    kw = dict(name=name, eta=eta, ip_guidance_rate=0.3, num_inference_steps=20)
    jstep = jmake_step_fn(JSchedule(), JSamplerConfig(**kw), jloss)
    tstep = make_step_fn(DiffusionSchedule(), SamplerConfig(**kw), tloss)
    keys = [jax.random.key(i) for i in range(3)]
    drawn = feed_draws(monkeypatch, keys)
    for key, t in zip(keys, (951, 501, 1)):
        jprev, jx0, jl = jstep(jnp.asarray(eps), jnp.int32(t), jnp.asarray(x), key)
        tprev, tx0, tl = tstep(torch.from_numpy(eps), t, torch.from_numpy(x))
        assert tprev.shape == tx0.shape == shape and tl.dtype == torch.float32
        assert rel(tprev, jprev) <= 1e-5
        assert rel(tx0, jx0) <= 1e-5
        assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    # MPGD draws only at eta > 0; DSG and DiffMusic at every step
    assert drawn == ([] if name == "mpgd" and eta == 0.0 else [shape] * 3)


def test_sampler_config_and_step_names():
    assert SamplerConfig() == SamplerConfig(name="diffmusic", eta=1.0, ip_guidance_rate=0.08)
    assert SamplerConfig().name == JSamplerConfig().name
    for name in ("dps",) + SAMPLERS:
        with pytest.raises(ValueError, match="requires a loss_fn"):
            make_step_fn(DiffusionSchedule(), SamplerConfig(name=name))
    # DITTO's inner step needs no loss_fn, and takes its drawn noise
    ditto = make_step_fn(DiffusionSchedule(), SamplerConfig(name="ditto", eta=0.0,
                                                            num_inference_steps=20))
    prev, x0, loss = ditto(torch.ones(1, 8, 2, 2), 501, torch.ones(1, 8, 2, 2), None)
    assert prev.shape == x0.shape == (1, 8, 2, 2) and float(loss) == 0.0
    # at eta > 0 it needs that noise: a chain without its draws must not
    # quietly run noise-free
    ditto = make_step_fn(DiffusionSchedule(), SamplerConfig(name="ditto", eta=1.0,
                                                            num_inference_steps=20))
    with pytest.raises(ValueError, match="needs its noise"):
        ditto(torch.ones(1, 8, 2, 2), 501, torch.ones(1, 8, 2, 2), None)
    with pytest.raises(ValueError, match="Unknown sampler"):
        make_step_fn(DiffusionSchedule(), SamplerConfig(name="euler"), lambda x: x.sum())


def test_slerp_matches_jax(rng):
    a, b = (rng.standard_normal((2, 8, 6, 4)).astype(np.float32) for _ in range(2))
    cases = [(a, b, 0.0), (a, b, 1.0), (a, b, 0.3), (a, b, 0.08), (a, -b, 0.7),
             (a, 2 * a, 0.3), (a, -a, 0.3), (a, a + 1e-3 * b, 0.08)]
    for x0, x1, gamma in cases:
        ref = np.asarray(jslerp(jnp.asarray(x0), jnp.asarray(x1), gamma))
        out = slerp(torch.from_numpy(x0), torch.from_numpy(x1), gamma).numpy()
        assert rel(out, ref) <= 1e-6, (gamma, rel(out, ref))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert rel(slerp(ta, tb, 0.0), a) <= 1e-6
    assert rel(slerp(ta, tb, 1.0), b) <= 1e-6
    # the lerp fallback wherever |cos theta| > 0.9995
    for x1 in (2 * ta, -ta, ta + 1e-3 * tb):
        assert torch.equal(slerp(ta, x1, 0.3), ta + 0.3 * (x1 - ta))
    # general directions stay on the arc: the norm is interpolated, not shrunk
    mid = slerp(ta / ta.norm(), tb / tb.norm(), 0.5)
    assert float(mid.norm()) == pytest.approx(1.0, rel=1e-5)


def flax_style_params(init, *args, seed: int, **kwargs):
    """Seeded parameters of the shapes `init` gives, traced, not compiled:
    kernels normal over sqrt(fan-in) (flax's lecun scale), biases 0, scales 1."""
    rng = np.random.default_rng(seed)

    def leaf(path, shape):
        if path[-1].key == "kernel":
            w = rng.standard_normal(shape.shape) / np.sqrt(np.prod(shape.shape[:-1]))
            return jnp.asarray(w, jnp.float32)
        return (jnp.zeros if path[-1].key == "bias" else jnp.ones)(shape.shape, jnp.float32)

    shapes = jax.eval_shape(init, jax.random.key(0), *args, **kwargs)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def tiny_pipelines(jop, top, scheduler_name: str):
    """The tiny MusicLDM of `test_torch_port_slice.py` in both packages, the
    port's weights carried over from the JAX package's by `from_flax`."""
    unet_p = flax_style_params(JUNet(slice_test.UNET).init, jnp.zeros((1, 8, 8, 8)),
                               jnp.asarray([0]), class_labels=jnp.zeros((1, 32)), seed=1)
    vae_p = flax_style_params(JVAE(slice_test.VAE).init, jnp.zeros((1, 1, 8, 8)), seed=2)
    voc_p = flax_style_params(JHifiGan(slice_test.VOC).init, jnp.zeros((1, 2, 64)), seed=3)
    jpipe = JPipeline(unet_cfg=slice_test.UNET, vae_cfg=slice_test.VAE,
                      vocoder_cfg=slice_test.VOC, text_cfg=jcfg.tiny_clap_text_config(),
                      unet_params=unet_p, vae_params=vae_p, vocoder_params=voc_p,
                      text_params={}, scheduler_name=scheduler_name, operator=jop)
    tpipe = MusicLDMPipeline(slice_test.port(UNet2DConditionModel, unet_p, slice_test.UNET),
                             slice_test.port(AutoencoderKL, vae_p, slice_test.VAE),
                             slice_test.port(SpeechT5HifiGan, voc_p, slice_test.VOC),
                             scheduler_name=scheduler_name, operator=top)
    return jpipe, tpipe


def harmonic(owl: int) -> np.ndarray:
    tt = np.arange(owl) / 16000
    return (0.25 * np.sin(2 * np.pi * 220 * tt) + 0.1 * np.sin(2 * np.pi * 660 * tt))[None]


def run_both(jpipe, tpipe, measurement, latents, key=None, phase_aware=None, **kw):
    """One run of each pipeline on the same latents and measurement, the
    empty prompt, the JAX pipeline from `key`: ((losses, final latents,
    audio) of JAX, the same of the port)."""
    embeds = np.zeros((2, 32), np.float32)   # empty prompt: degenerate CFG
    kw = dict(audio_length_in_s=AUDIO_S, num_inference_steps=STEPS, guidance_scale=2.0,
              return_losses=True, **kw)
    jlat, tlat = {}, {}
    jout, jlosses = jpipe(prompt_embeds=jnp.asarray(embeds),
                          measurement=jnp.asarray(measurement), latents=jnp.asarray(latents),
                          callback=lambda i, t, x: jlat.__setitem__(i, np.asarray(x)), key=key,
                          **kw)
    tout, tlosses = tpipe(prompt_embeds=torch.from_numpy(embeds),
                          measurement=torch.from_numpy(np.asarray(measurement)),
                          latents=torch.from_numpy(latents),
                          callback=lambda i, t, x: tlat.__setitem__(i, x.numpy()),
                          phase_aware=phase_aware, **kw)
    return ((np.asarray(jlosses), jlat[STEPS - 1], jout.audios),
            (tlosses, tlat[STEPS - 1], tout.audios))


@pytest.fixture(scope="module")
def pipelines():
    jop, top = slice_test.operators()
    return tiny_pipelines(jop, top, "mpgd")


@pytest.mark.parametrize("name, rate", [("mpgd", 0.5), ("dsg", 0.08), ("diffmusic", 0.08)])
def test_pipeline_matches_jax(rng, pipelines, name, rate):
    jpipe, tpipe = (dataclasses.replace(p, scheduler_name=name) for p in pipelines)
    owl = int(AUDIO_S * 16000)
    measurement = np.array(jpipe.operator.forward(jnp.asarray(harmonic(owl), jnp.float32)))
    latents = rng.standard_normal((1, 8, 16, 32)).astype(np.float32)
    (jl, jlat, jaudio), (tl, tlat, taudio) = run_both(jpipe, tpipe, measurement, latents,
                                                      eta=0.0, ip_guidance_rate=rate)
    assert tl.shape == (STEPS,) and np.all(np.diff(tl) != 0)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert rel(tlat, jlat) <= 1e-3
    assert not np.allclose(tlat, latents)
    assert taudio.shape == jaudio.shape == (1, owl)
    assert rel(taudio, jaudio) <= 1e-2
