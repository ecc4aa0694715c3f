"""Whole runs of tiny cells made only of added files (a manifest, a
configuration, a traffic mix and limits written to a fresh root), on the
CPU: the harness finds them by name, a sound run comes out correct, and
each fault the cells can have, planted in the timed path underneath, and
the control come out not correct under the real cells' limits."""

import dataclasses
import math
import time
import types

import pytest
import torch

from benchmark import control, harness, manifest, program
from tiny import write_root

SECONDS = 3.0


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    return root, write_root(root)


def run(root, cell, prog=program, seed=2 ** 31 + 99):
    spec = manifest.load(cell, root)
    return harness.run_cell(spec, seed, SECONDS, False, "cpu", time.perf_counter(), prog)


def planted(step=None, unet_hook=None):
    """`program` with the pipeline's step function or its UNet output altered."""
    def build(*a, **k):
        pipe = program.build(*a, **k)
        if unet_hook is not None:
            pipe.unet.register_forward_hook(unet_hook)
        return pipe
    prog = types.SimpleNamespace(**{n: getattr(program, n) for n in program.__all__})
    prog.build = build
    return prog


def unchanged(make):
    def make_step(*a, **k):
        real = make(*a, **k)
        return lambda eps, t, sample, g=None: (sample,) + tuple(real(eps, t, sample, g)[1:])
    return make_step


def half_batch(make):
    def make_step(*a, **k):
        real = make(*a, **k)

        def step(eps, t, sample, g=None):
            prev, x0, loss = real(eps, t, sample, g)
            h = sample.shape[0] // 2
            return torch.cat([prev[:h], sample[h:]]), x0, loss
        return step
    return make_step


def guidance_times(factor):
    """The guided step with its guidance rate times `factor`: 0 drops the
    loss's gradient through the VAE, vocoder, operator and mel head from the
    update, -1 negates it."""
    def wrap(make):
        def make_step(schedule, cfg, loss_fn=None):
            rate = cfg.ip_guidance_rate * factor
            return make(schedule, dataclasses.replace(cfg, ip_guidance_rate=rate), loss_fn)
        return make_step
    return wrap


def flip_first_answer(module, args, out):
    out = out.clone()
    out[0] = -out[0]
    return out


@pytest.mark.parametrize("name", ["tiny-musicldm.inpaint-dps", "tiny-audioldm2-music.generate-cfg",
                                  "tiny-musicldm.dereverb-diffmusic"])
def test_sound_run_is_correct(cells, name):
    root, _ = cells
    r = run(root, name)
    assert r["correct"], r["checks"]
    assert r["timing"]["steps"] >= 2 and math.isfinite(r["timing"]["step_ms_p90"])
    assert {"cond", "eps"} <= set(r["checks"])


@pytest.mark.parametrize("name", ["tiny-musicldm.inpaint-dps", "tiny-audioldm2-music.generate-cfg"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "flipped_answer"])
def test_faults_come_out_not_correct(cells, name, fault, monkeypatch):
    root, _ = cells
    from diffmusic_tpu_torch.pipelines import musicldm
    prog = program
    if fault == "flipped_answer":
        prog = planted(unet_hook=flip_first_answer)
    else:
        wrap = unchanged if fault == "unchanged" else half_batch
        monkeypatch.setattr(musicldm, "make_step_fn", wrap(musicldm.make_step_fn))
    r = run(root, name, prog)
    assert not r["correct"], (fault, r["checks"])


@pytest.mark.parametrize("name", ["tiny-musicldm.inpaint-dps", "tiny-musicldm.dereverb-diffmusic"])
@pytest.mark.parametrize("factor", [0.0, -1.0], ids=["dropped", "negated"])
def test_guidance_faults_come_out_not_correct(cells, name, factor, monkeypatch):
    root, _ = cells
    from diffmusic_tpu_torch.pipelines import musicldm
    monkeypatch.setattr(musicldm, "make_step_fn", guidance_times(factor)(musicldm.make_step_fn))
    r = run(root, name)
    assert not r["correct"], (factor, r["checks"])
    assert r["checks"]["guide"]["value"] > r["checks"]["guide"]["limit"], r["checks"]


@pytest.mark.parametrize("name", ["tiny-musicldm.inpaint-dps", "tiny-audioldm2-music.generate-cfg"])
def test_control_is_not_correct(cells, name):
    root, _ = cells
    spec = manifest.load(name, root)
    numbers = control.control_readings(spec, 2 ** 31 + 5, "cpu")["numbers"]
    assert any(v > spec["limits"][k] for k, v in numbers.items()), numbers
