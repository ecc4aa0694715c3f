"""The public names that the port carries beside the JAX package's, each held
against its JAX namesake on the same input:

- `pipelines.get_pipeline` (and `run.py` dispatching through it);
- `samplers.SCHEDULER_REGISTRY`, `samplers.get_scheduler`;
- `samplers.steps.InverseProblemSchedulerOutput`;
- `fadtk.utils.get_cache_embedding_path` (and `fadtk.engine.cache_path`);
- `models.clap.get_text_features`;
- `ops/freeu.py`: `fourier_filter`, `apply_freeu`, on the inputs of
  `tests/test_utils_freeu.py`.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmusic_tpu import pipelines as jpipelines
from diffmusic_tpu import samplers as jsamplers
from diffmusic_tpu.fadtk import utils as jfutils
from diffmusic_tpu.models import configs as jcfg
from diffmusic_tpu.models.clap import ClapTextModelWithProjection as JClap
from diffmusic_tpu.models.clap import get_text_features as jget_text_features
from diffmusic_tpu.ops import freeu as jfreeu
from diffmusic_tpu.samplers import steps as jsteps
from diffmusic_tpu_torch import pipelines, run, samplers
from diffmusic_tpu_torch.fadtk import engine, utils
from diffmusic_tpu_torch.models import configs as tcfg
from diffmusic_tpu_torch.models.clap import ClapTextModelWithProjection, get_text_features
from diffmusic_tpu_torch.models.convert import from_flax
from diffmusic_tpu_torch.ops import freeu
from diffmusic_tpu_torch.samplers import steps


@pytest.mark.parametrize("name", ["musicldm", "audioldm2", "stable_audio"])
def test_get_pipeline_matches_jax(name):
    assert pipelines.get_pipeline(name).__name__ == jpipelines.get_pipeline(name).__name__


def test_get_pipeline_unknown_raises_as_jax():
    with pytest.raises(ValueError) as jerr:
        jpipelines.get_pipeline("riffusion")
    with pytest.raises(ValueError) as err:
        pipelines.get_pipeline("riffusion")
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("name", ["musicldm", "audioldm2", "stable_audio"])
def test_run_loads_through_get_pipeline(monkeypatch, name):
    """`run.load_pipeline` takes its class from `get_pipeline`: a stand-in
    class returned there is the one whose `tiny` runs."""
    class Stub:
        @staticmethod
        def tiny(**kwargs):
            return SimpleNamespace(kwargs=kwargs)
    asked = []
    monkeypatch.setattr(pipelines, "get_pipeline", lambda n: asked.append(n) or Stub)
    args = SimpleNamespace(tiny=True, device="cpu", transcription=None, checkpoint_dir=None)
    sched = SimpleNamespace(num_train_timesteps=1000, beta_start=0.0015, beta_end=0.0195,
                            beta_schedule="scaled_linear", set_alpha_to_one=False,
                            steps_offset=1, timestep_spacing="leading")
    config = SimpleNamespace(name="dps", model=SimpleNamespace(name=name, scheduler=sched))
    pipe = run.load_pipeline(args, config, operator=None)
    assert asked == [name] and pipe.kwargs["device"] == "cpu"


def test_scheduler_registry_matches_jax():
    assert samplers.SCHEDULER_REGISTRY == jsamplers.SCHEDULER_REGISTRY
    for name in samplers.SCHEDULER_REGISTRY:
        assert samplers.get_scheduler(name) == jsamplers.get_scheduler(name) == name
    with pytest.raises(ValueError) as jerr:
        jsamplers.get_scheduler("euler")
    with pytest.raises(ValueError) as err:
        samplers.get_scheduler("euler")
    assert str(err.value) == str(jerr.value)


def test_scheduler_output_fields_match_jax():
    ours = [(f.name, f.default) for f in dataclasses.fields(steps.InverseProblemSchedulerOutput)]
    theirs = [(f.name, f.default)
              for f in dataclasses.fields(jsteps.InverseProblemSchedulerOutput)]
    assert [n for n, _ in ours] == [n for n, _ in theirs]
    assert [d for _, d in ours] == [d for _, d in theirs]
    x = torch.ones(1, 8, 4, 4)
    out = samplers.InverseProblemSchedulerOutput(x, pred_original_sample=2 * x)
    assert out.prev_sample is x and out.loss is None and out.pred_original_sample.sum() == 256


@pytest.mark.parametrize("path", ["data/clips/a.wav", "/tmp/x/b.song.mp3", "c.opus"])
def test_cache_embedding_path_matches_jax(path):
    want = jfutils.get_cache_embedding_path(path, "vggish")
    assert utils.get_cache_embedding_path(path, "vggish") == want
    assert engine.cache_path(path, "vggish") == want


def test_get_text_features_matches_jax(rng):
    cfg = jcfg.tiny_clap_text_config()
    params = JClap(cfg).init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))
    port_cfg = tcfg.ClapTextConfig(**dataclasses.asdict(cfg))
    model = ClapTextModelWithProjection(port_cfg)
    model.load_state_dict(from_flax(params, port_cfg), strict=True)
    ids = np.ones((2, 10), np.int32)
    mask = np.zeros((2, 10), np.int32)
    for i, n in enumerate((10, 4)):
        ids[i, :n] = np.concatenate([[0], rng.integers(2, cfg.vocab_size, n - 1)])
        mask[i, :n] = 1
    ref = np.asarray(jget_text_features(JClap(cfg), params, jnp.asarray(ids),
                                        jnp.asarray(mask)))
    with torch.no_grad():
        out = get_text_features(model, torch.from_numpy(ids).long(),
                                torch.from_numpy(mask).long()).numpy()
    assert out.shape == ref.shape == (2, cfg.projection_dim)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, rtol=1e-6)
    assert np.abs(out - ref).max() <= 1e-5


@pytest.mark.parametrize("case", ["noise_scale_one", "ones_scale_zero", "noise_scale_half",
                                  "threshold_2"])
def test_fourier_filter_matches_jax(rng, case):
    x = {"noise_scale_one": rng.standard_normal((1, 2, 8, 8)),
         "ones_scale_zero": np.ones((1, 1, 8, 8)),
         "noise_scale_half": rng.standard_normal((2, 3, 8, 6)),
         "threshold_2": rng.standard_normal((1, 8, 4, 4))}[case].astype(np.float32)
    threshold, scale = {"noise_scale_one": (1, 1.0), "ones_scale_zero": (1, 0.0),
                        "noise_scale_half": (1, 0.5), "threshold_2": (2, 0.2)}[case]
    ref = np.asarray(jfreeu.fourier_filter(jnp.asarray(x), threshold=threshold, scale=scale))
    out = freeu.fourier_filter(torch.from_numpy(x), threshold=threshold, scale=scale)
    assert out.dtype == torch.float32 and out.shape == x.shape
    assert np.abs(out.numpy() - ref).max() <= 1e-5


def test_fourier_filter_keeps_the_dtype():
    x = torch.randn(1, 2, 8, 8, generator=torch.Generator().manual_seed(0))
    out = freeu.fourier_filter(x.bfloat16(), threshold=1, scale=0.5)
    assert out.dtype == torch.bfloat16
    assert (out.float() - freeu.fourier_filter(x.bfloat16().float(), 1, 0.5)).abs().max() < 2e-2


@pytest.mark.parametrize("resolution", [0, 1, 2])
def test_apply_freeu_matches_jax(rng, resolution):
    h = rng.standard_normal((1, 8, 4, 4)).astype(np.float32)
    r = rng.standard_normal((1, 8, 4, 4)).astype(np.float32)
    kw = dict(b1=1.2, b2=1.4, s1=0.9, s2=0.2)
    jh, jr = jfreeu.apply_freeu(resolution, jnp.asarray(h), jnp.asarray(r), **kw)
    th, tr = freeu.apply_freeu(resolution, torch.from_numpy(h), torch.from_numpy(r), **kw)
    assert np.abs(th.numpy() - np.asarray(jh)).max() <= 1e-6
    assert np.abs(tr.numpy() - np.asarray(jr)).max() <= 1e-5
    if resolution == 2:
        assert torch.equal(th, torch.from_numpy(h)) and torch.equal(tr, torch.from_numpy(r))
