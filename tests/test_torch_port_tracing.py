"""The port's `tracing` on the CPU, beside the JAX package's:

- `trace(logdir)` writes a Chrome trace that holds the ranges `annotate`
  names, and the denoise loop's "unet_forward" and "guided_step" ranges, once
  a step (`pipelines/base.py::run_denoise_loop`, as JAX's scan body);
- `debug_nans` raises FloatingPointError at log(-1), as JAX's
  `jax_debug_nans` does, lets finite work through, and is off again after
  `debug_nans(False)`;
- `device_memory_stats` returns a dict, as JAX's does.
"""

import json

import jax
import jax.numpy as jnp
import pytest
import torch

from diffmusic_tpu import tracing as jtracing
from diffmusic_tpu_torch import tracing
from diffmusic_tpu_torch.pipelines.base import run_denoise_loop


def trace_events(logdir):
    (path,) = logdir.glob("trace_*.json")
    return [e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]]


def test_trace_writes_the_annotated_ranges(tmp_path):
    with tracing.trace(tmp_path) as prof:
        with tracing.annotate("vae_decode"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    names = trace_events(tmp_path)
    assert "vae_decode" in names
    assert any(e.key == "vae_decode" for e in prof.key_averages())


def test_trace_holds_the_denoise_loop_ranges(tmp_path):
    def model_fn(x, t):
        return 0.5 * x

    def step_fn(eps, t, x, gen):
        return x - 0.1 * eps, x, (x - eps).square().sum()

    with tracing.trace(tmp_path):
        final, losses = run_denoise_loop(step_fn, model_fn, torch.ones(1, 4), [3, 2, 1])
    names = trace_events(tmp_path)
    assert names.count("unet_forward") == names.count("guided_step") == 3
    assert losses.shape == (3,) and torch.allclose(final, torch.full((1, 4), 0.95 ** 3))


def test_debug_nans_raises_and_turns_off():
    try:
        tracing.debug_nans(True)
        assert float(torch.log(torch.tensor(2.0))) == pytest.approx(0.6931, abs=1e-4)
        assert int((torch.arange(3) * 2).sum()) == 6
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(torch.tensor(-1.0))
    finally:
        tracing.debug_nans(False)
    assert torch.isnan(torch.log(torch.tensor(-1.0)))
    tracing.debug_nans(False)   # off twice is a no-op


def test_debug_nans_matches_jax():
    try:
        jtracing.debug_nans(True)
        with pytest.raises(FloatingPointError):
            jax.jit(jnp.log)(jnp.float32(-1.0)).block_until_ready()
    finally:
        jtracing.debug_nans(False)
    try:
        tracing.debug_nans(True)
        with pytest.raises(FloatingPointError):
            torch.log(torch.tensor(-1.0))
    finally:
        tracing.debug_nans(False)


def test_device_memory_stats_is_a_dict():
    got, want = tracing.device_memory_stats(), jtracing.device_memory_stats()
    assert isinstance(got, dict) and isinstance(want, dict)
    if not torch.cuda.is_available():
        assert got == {}
