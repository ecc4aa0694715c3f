"""The port's `tracing` on the CPU, beside the JAX package's:

- `trace(logdir)` writes a Chrome trace that holds the ranges `annotate`
  names, and the denoise loop's "unet_forward" and "guided_step" ranges, once
  a step (`pipelines/base.py::run_denoise_loop`, as JAX's scan body);
- `debug_nans` raises FloatingPointError at log(-1), as JAX's
  `jax_debug_nans` does, lets finite work through, and is off again after
  `debug_nans(False)`;
- `device_memory_stats` returns a dict, as JAX's does;
- the recorder: under `torch.profiler` one guided step of a tiny MusicLDM
  records "unet_forward", "guided_step", the loss's three stages and
  "guided.backward" inside it, and the backward's three stages in the order
  loss head, vocoder, VAE, each on the profiler's clock, and the call's
  final "decode" after it, inside no span; with no profiler it records
  nothing and registers no hook; a plan cache or weight copy missed
  twice counts two "kernels.cache_miss" events.
"""

import json
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from diffmusic_tpu import tracing as jtracing
from diffmusic_tpu_torch import tracing
from diffmusic_tpu_torch.inverse_problem import MusicInpaintingOperator
from diffmusic_tpu_torch.kernels import group_norm, mask, repack
from diffmusic_tpu_torch.pipelines import MusicLDMPipeline
from diffmusic_tpu_torch.pipelines.base import run_denoise_loop
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

AUDIO_S = 0.64
STAGES = ("guided.vae", "guided.vocoder", "guided.loss_head")
BACKWARD = tuple(f"{n}.backward" for n in ("guided.loss_head", "guided.vocoder", "guided.vae"))


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


def guided_step(sampler):
    """A one-step guided call of a tiny MusicLDM on box inpainting."""
    op = MusicInpaintingOperator(audio_length_in_s=AUDIO_S, sample_rate=16000, mask_type="box",
                                 start_inpainting_s=0.2, end_inpainting_s=0.4)
    pipe = MusicLDMPipeline.tiny(sampler, operator=op, device="cpu")
    gen = torch.Generator().manual_seed(0)
    meas = op.forward(torch.randn(1, int(AUDIO_S * 16000), generator=gen))
    return lambda: pipe(audio_length_in_s=AUDIO_S, num_inference_steps=1, measurement=meas,
                        generator=gen, prompt="", eta=1.0)


def recorded_since(t0):
    return [r for r in tracing.spans() if r["start"] >= t0]


def profiled(call):
    """(the records `call` adds, the profiler's host events by name)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm-up"):   # the profiler's first event
            pass
        t0 = time.time_ns()
        call()
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return recorded_since(t0), events


@pytest.fixture(scope="module")
def dps_step():
    return profiled(guided_step("dps"))


@pytest.mark.parametrize("sampler", ["dps", "mpgd", "dsg", "diffmusic"])
def test_guided_step_records_its_stages(sampler, dps_step):
    recs, _ = dps_step if sampler == "dps" else profiled(guided_step(sampler))
    spans = sorted((r for r in recs if r["kind"] == "span"), key=lambda r: r["start"])
    by = {}
    for r in spans:
        by.setdefault(r["name"], []).append(r)
    assert set(by) == {"unet_forward", "guided_step", "guided.backward", *STAGES, *BACKWARD,
                       "decode"}
    assert all(len(v) == 1 for v in by.values()), {k: len(v) for k, v in by.items()}
    step = by["guided_step"][0]
    assert step["step"] == by["unet_forward"][0]["step"] and step["step"][0] == 0
    # the call's final decode follows the denoise loop, inside no span
    decode = by.pop("decode")[0]
    assert decode["parent"] is None and decode["step"] is None
    assert decode["start"] >= step["end"]
    spans = [r for r in spans if r is not decode]
    assert all(r["step"] == step["step"] for r in spans)
    inside = [by[n][0] for n in (*STAGES, "guided.backward")]
    assert [r["name"] for r in inside] == [*STAGES, "guided.backward"]
    for r in inside:
        assert r["parent"] == step["id"] and step["start"] <= r["start"] <= r["end"] <= step["end"]
    bwd = by["guided.backward"][0]
    pieces = [by[n][0] for n in BACKWARD]
    assert [r["name"] for r in sorted(pieces, key=lambda r: r["start"])] == list(BACKWARD)
    assert all(r["parent"] == bwd["id"] for r in pieces)
    assert bwd["start"] <= pieces[0]["start"] and pieces[-1]["end"] == bwd["end"]
    assert all(a["end"] == b["start"] for a, b in zip(pieces, pieces[1:]))


def test_spans_lie_on_the_profilers_clock(dps_step):
    recs, events = dps_step
    timed = [r for r in recs if r["kind"] == "span" and r["name"] in events]
    assert {r["name"] for r in timed} == {"unet_forward", "guided_step", "guided.backward",
                                          *STAGES, "decode"}
    for r in timed:
        start, end = min(events[r["name"]], key=lambda e: abs(e[0] - r["start"]))
        assert abs(start - r["start"]) < 1e6 and abs(end - r["end"]) < 1e6, (r, start, end)


def test_nothing_recorded_and_no_hook_with_the_profiler_off(monkeypatch):
    call = guided_step("dps")
    hooks = []
    register = torch.Tensor.register_hook
    monkeypatch.setattr(torch.Tensor, "register_hook",
                        lambda t, fn: hooks.append(fn) or register(t, fn))
    t0 = time.time_ns()
    call()
    assert recorded_since(t0) == [] and hooks == []
    recs, _ = profiled(call)
    assert len(hooks) == 3 and recs


def test_annotate_nests_and_counts_inherit_the_step():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = time.time_ns()
        with tracing.annotate("outer", (4, 981)):
            with tracing.annotate("inner"):
                tracing.count("probe", "what")
    recs = {r["name"]: r for r in recorded_since(t0)}
    outer, inner, probe = recs["outer"], recs["inner"], recs["probe"]
    assert inner["parent"] == outer["id"] and probe["parent"] == inner["id"]
    assert outer["step"] == inner["step"] == probe["step"] == (4, 981)
    assert probe["kind"] == "count" and probe["what"] == "what" and probe["start"] == probe["end"]
    assert inner["thread"] == outer["thread"] and outer["parent"] is None


CUDA = torch.device("cuda")   # a device object only: the plans below reach no card


@pytest.mark.parametrize("cache", ["group_norm.moments_plan", "mask.launch_plan",
                                   "repack.conv1d_pair"])
def test_a_cache_missed_twice_counts_two_misses(cache):
    stamp = time.time_ns() % 100003 + 7     # keys no other test has made
    if cache == "group_norm.moments_plan":
        def call(k):
            group_norm.moments_plan((1, 3, stamp + k), (3 * (stamp + k), stamp + k, 1),
                                    torch.float32, CUDA)
    elif cache == "mask.launch_plan":
        def call(k):
            shape = (1, stamp + k, 8)
            mask.launch_plan("leaky_mask", (shape, shape), ((8 * (stamp + k), 8, 1),) * 2,
                             (torch.float32,) * 2, (CUDA, CUDA))
    else:
        weights = [torch.zeros(3, stamp % 7 + 1, 2) for _ in range(2)]

        def call(k):
            repack.cached("conv1d_pair", weights[k], lambda w: w.clone())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = time.time_ns()
        for k in (0, 1, 0, 1):
            call(k)
    misses = [r for r in recorded_since(t0) if r["name"] == "kernels.cache_miss"]
    assert [r["what"] for r in misses] == [cache, cache]
