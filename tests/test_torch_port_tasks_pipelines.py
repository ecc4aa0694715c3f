"""CPU parity of the tiny MusicLDM under the DiffMusic sampler on each task
against the JAX package: the inverse problems of `test_torch_port_tasks.py`
and style guidance (the gram matrix of the tiny CLAP audio tower's frame
features), 3 steps at eta 1 with the JAX scan's own normal draws handed to
the port (`samplers.steps.randn`). Tolerances, relative to max |reference|:
per-step losses within 1e-4, final latents within 1e-3, audio within 1e-2
(as `test_torch_port_slice.py`). Where an operator draws (the random mask,
the reverb impulse response), the port's operator is given the JAX
operator's array; the style operator's tower carries the JAX tower's
variables through `from_flax`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_samplers as samplers_test
from diffmusic_tpu.inverse_problem import StyleGuidanceOperator as JStyle
from diffmusic_tpu.models import clap_features as jcf
from diffmusic_tpu.models import htsat as jhtsat
from diffmusic_tpu_torch.inverse_problem import StyleGuidanceOperator
from diffmusic_tpu_torch.models import clap_features as tcf
from diffmusic_tpu_torch.models import htsat
from diffmusic_tpu_torch.models.convert import from_flax
from diffmusic_tpu_torch.ops.stft import spectrogram
from test_torch_port_htsat import jax_tower
from test_torch_port_tasks import OWL, fp32, operator_pairs, rel
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)


# -------------------------------------------------------------- pipelines
def scan_draws(key, n: int):
    """The keys of the n normal draws the JAX pipeline's scan makes from
    `key` (`pipelines/musicldm.py`, `pipelines/base.py::run_denoise_scan`)."""
    _, _, scan_key = jax.random.split(key, 3)
    k = jax.random.fold_in(scan_key, 0)
    subs = []
    for _ in range(n):
        k, sub = jax.random.split(k)
        subs.append(sub)
    return subs


@pytest.fixture(scope="module")
def pipelines():
    _, jop, top = operator_pairs()[0]
    return samplers_test.tiny_pipelines(jop, top, "diffmusic")


def task_pipelines(pipelines, case):
    """(task name, the JAX and the port pipeline with that task's operators)."""
    name, jop, top = operator_pairs()[case]
    return name, dataclasses.replace(pipelines[0], operator=jop), \
        dataclasses.replace(pipelines[1], operator=top)


def run_task(monkeypatch, jpipe, tpipe, rng, **kw):
    """DiffMusic, eta 1, rate 0.08 on the harmonic stack's measurement; the
    JAX scan's draws fed to the port. Returns (measurement, latents, runs)."""
    jop = jpipe.operator
    measurement = np.array(fp32(jop.forward, jnp.asarray(samplers_test.harmonic(OWL),
                                                         jnp.float32)))
    latents = rng.standard_normal((1, 8, 16, 32)).astype(np.float32)
    key = jax.random.key(11)
    drawn = samplers_test.feed_draws(monkeypatch, scan_draws(key, samplers_test.STEPS))
    out = samplers_test.run_both(jpipe, tpipe, measurement, latents, eta=1.0,
                                 ip_guidance_rate=0.08, key=key, **kw)
    assert drawn == [latents.shape] * samplers_test.STEPS
    return measurement, latents, out


def assert_runs_agree(name, latents, out):
    (jl, jlat, jaudio), (tl, tlat, taudio) = out
    assert tl.shape == (samplers_test.STEPS,) and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=name)
    assert rel(tlat, jlat) <= 1e-3, (name, rel(tlat, jlat))
    assert not np.allclose(tlat, latents)
    assert taudio.shape == jaudio.shape == (1, OWL)
    assert rel(taudio, jaudio) <= 1e-2, name


@pytest.mark.parametrize("case", [0, 1, 3, 4])
def test_diffmusic_pipeline_on_each_task_matches_jax(rng, monkeypatch, pipelines, case):
    name, jpipe, tpipe = task_pipelines(pipelines, case)
    _, latents, out = run_task(monkeypatch, jpipe, tpipe, rng)
    assert_runs_agree(name, latents, out)


def test_phase_retrieval_pipeline_and_phase_aware_output_match_jax(monkeypatch, pipelines):
    """Phase retrieval under DiffMusic, with the projection on (the default
    for a noiseless noiser in both packages; `DIFFMUSIC_TPU_PHASE_AWARE=1` in
    JAX) and off (`phase_aware=False`, `=0`): each run against JAX's; the
    port's projection of JAX's own sampled audio against JAX's projected
    output within 1e-4 (the runs' audio differs by ~4e-5, which the
    projection amplifies about 3x); the projection brings the output's |STFT|
    closer to the measurement."""
    name, jpipe, tpipe = task_pipelines(pipelines, 2)
    runs = {}
    for flag, env in ((None, "1"), (False, "0")):   # one JAX pipeline: one compile
        monkeypatch.setenv("DIFFMUSIC_TPU_PHASE_AWARE", env)
        meas, latents, out = run_task(monkeypatch, jpipe, tpipe, np.random.default_rng(0),
                                      phase_aware=flag)
        assert_runs_agree(name, latents, out)
        runs[flag] = out
    on, off = runs[None], runs[False]
    assert np.array_equal(on[1][1], off[1][1])    # the same sampling
    op = tpipe.operator
    projected = tpipe.phase_aware_output(torch.from_numpy(off[0][2].copy()),
                                         torch.from_numpy(meas), OWL)
    assert rel(projected, on[0][2]) <= 1e-4

    def mag_err(audio):
        mag = spectrogram(torch.from_numpy(audio), op.n_fft, op.hop_length, op.win_length,
                          power=1.0, use_hann=False)
        return float(torch.linalg.vector_norm(mag - torch.from_numpy(meas)))

    assert mag_err(on[1][2]) < 0.5 * mag_err(off[1][2])


def style_pipelines(pipelines):
    """Both pipelines under style guidance, each operator's frame features
    from the tiny tower of the same seeded JAX variables."""
    cfg, f_cfg = jhtsat.tiny_clap_audio_config(), jcf.tiny_clap_feature_config()
    variables = jax_tower(cfg, 7)
    jop = JStyle(clap_embed=jcf.make_clap_frame_embed(jhtsat.ClapAudioModelWithProjection(cfg),
                                                      variables, f_cfg))
    pcfg = htsat.ClapAudioConfig(**dataclasses.asdict(cfg))
    tower = htsat.ClapAudioModelWithProjection(pcfg)
    tower.load_state_dict(from_flax(variables, pcfg), strict=True)
    top = StyleGuidanceOperator(clap_embed=tcf.make_clap_frame_embed(
        tower.requires_grad_(False), tcf.ClapFeatureConfig(**dataclasses.asdict(f_cfg))))
    return (dataclasses.replace(pipelines[0], operator=jop),
            dataclasses.replace(pipelines[1], operator=top))


def test_style_guidance_pipeline_matches_jax(rng, monkeypatch, pipelines):
    jpipe, tpipe = style_pipelines(pipelines)
    _, latents, out = run_task(monkeypatch, jpipe, tpipe, rng)
    assert_runs_agree("style_guidance", latents, out)
