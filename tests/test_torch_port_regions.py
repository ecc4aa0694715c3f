"""The port's regions (`tracing.region`) and the benchmark's readers of them
(`benchmark/regions.py`), on the CPU:

- under `torch.profiler` each dual-cross transformer block of the tiny
  AudioLDM2 UNet records one "unet.self_attn", two "unet.cross_attn" (what
  0 and 1) and one "unet.ff" region a forward, each inside the step's
  "unet_forward" span and inheriting its step; the tiny MusicLDM UNet's
  fused blocks (T >= 512) record one "unet.fused_block", its others
  "unet.self_attn" and "unet.ff"; a pipeline call records the text stack's
  spans once a prompt and one "decode" span, each inside no span;
- regions are neither profiler ranges nor NVTX ranges, and with no profiler
  a region is one check of the flag and a shared no-op context: nothing is
  recorded;
- on a synthetic traced span, every reader of the spans returns the same
  value with and without region records, and the three region readers
  return the numbers worked out by hand (None without regions).
"""

import time

import pytest
import torch

from benchmark import manifest, regions, spans
from diffmusic_tpu_torch import tracing
from diffmusic_tpu_torch.models.layers import BasicTransformerBlock
from diffmusic_tpu_torch.pipelines import AudioLDM2Pipeline, MusicLDMPipeline
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

AUDIO_S = 0.64
TEXT = ("text.clap", "text.t5", "text.projection", "text.gpt2")


def recorded_since(t0):
    return [r for r in tracing.spans() if r["start"] >= t0]


def profiled(call):
    """The records `call` adds under a recording profiler, and the
    profiler's host event names."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        call()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    return recorded_since(t0), names


def block_tokens(unet, call):
    """(records, per block call its token count) of `call` profiled."""
    seen = []
    hooks = [m.register_forward_pre_hook(lambda _m, args: seen.append(args[0].shape[1]))
             for m in unet.modules() if isinstance(m, BasicTransformerBlock)]
    try:
        recs, names = profiled(call)
    finally:
        for h in hooks:
            h.remove()
    return recs, names, seen


@pytest.fixture(scope="module")
def audioldm2():
    return AudioLDM2Pipeline.tiny(device="cpu")


@pytest.fixture(scope="module")
def audioldm2_call(audioldm2):
    """Two DDIM steps of the tiny AudioLDM2 under CFG, profiled."""
    def call():
        audioldm2(prompt="calm solo piano", negative_prompt="", guidance_scale=3.5,
                  num_inference_steps=2, audio_length_in_s=AUDIO_S, num_waveforms_per_prompt=2,
                  generator=torch.Generator().manual_seed(0))
    return block_tokens(audioldm2.unet, call)


def test_dual_cross_blocks_record_their_sub_layers(audioldm2_call):
    recs, _, seen = audioldm2_call
    regs = [r for r in recs if r["kind"] == "region"]
    per_block = [("unet.self_attn", None), ("unet.cross_attn", 0), ("unet.cross_attn", 1),
                 ("unet.ff", None)]
    assert len(seen) > 0 and [(r["name"], r["what"]) for r in regs] == per_block * len(seen)
    unet = {r["id"]: r for r in recs if r["kind"] == "span" and r["name"] == "unet_forward"}
    assert len(unet) == 2
    for r in regs:
        u = unet[r["parent"]]
        assert r["step"] == u["step"] and u["start"] <= r["start"] <= r["end"] <= u["end"]
    half = len(regs) // 2
    assert sorted(r["step"][0] for r in regs) == [0] * half + [1] * half


def test_text_stack_and_decode_spans(audioldm2_call):
    recs, names, _ = audioldm2_call
    by = {}
    for r in recs:
        if r["kind"] == "span":
            by.setdefault(r["name"], []).append(r)
    # the prompt and the negative prompt, each through the four stages in turn
    assert all(len(by[n]) == 2 for n in TEXT) and len(by["decode"]) == 1
    first = sorted((r for n in TEXT for r in by[n]), key=lambda r: r["start"])
    assert [r["name"] for r in first] == list(TEXT) * 2
    assert all(a["end"] <= b["start"] for a, b in zip(first, first[1:]))
    loop = by["unet_forward"] + by["guided_step"]
    assert first[-1]["end"] <= min(r["start"] for r in loop)
    assert by["decode"][0]["start"] >= max(r["end"] for r in loop)
    assert all(r["parent"] is None and r["step"] is None for n in (*TEXT, "decode")
               for r in by[n])
    # spans are profiler ranges; regions are not
    assert {*TEXT, "decode", "unet_forward"} <= names
    assert not names & {"unet.self_attn", "unet.cross_attn", "unet.ff", "unet.fused_block"}


def test_fused_blocks_record_one_region():
    pipe = MusicLDMPipeline.tiny(device="cpu")
    x = torch.randn(1, 8, 32, 32, generator=torch.Generator().manual_seed(1))
    ts, label = torch.full((1,), 500), torch.randn(1, 32, generator=torch.Generator())
    recs, _, seen = block_tokens(pipe.unet, lambda: pipe.unet(x, ts, class_labels=label))
    want = []
    for t in seen:
        want += [("unet.fused_block", None)] if t >= 512 else [("unet.self_attn", None),
                                                                ("unet.ff", None)]
    assert any(t >= 512 for t in seen) and any(t < 512 for t in seen)
    assert [(r["name"], r["what"]) for r in recs if r["kind"] == "region"] == want


def test_no_profiler_one_flag_check_and_nothing_recorded(monkeypatch, audioldm2):
    def fail(*a, **k):
        raise AssertionError("a region pushed a range")

    checks = []
    recording = tracing._recording
    monkeypatch.setattr(tracing, "_recording", lambda: checks.append(1) or recording())
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", fail)
    monkeypatch.setattr(torch.profiler, "record_function", fail)
    assert tracing.region("unet.ff") is tracing.region("unet.cross_attn", 1)
    assert len(checks) == 2
    checks.clear()
    block = next(m for m in audioldm2.unet.modules() if isinstance(m, BasicTransformerBlock))
    g = torch.Generator().manual_seed(2)
    dim = block.norm1.normalized_shape[0]
    x = torch.randn(2, 16, dim, generator=g)
    ctx = tuple(torch.randn(2, 3, getattr(block, f"attn2_{i}").to_k.weight.shape[0], generator=g)
                for i in range(2))
    t0 = time.time_ns()
    block(x, ctx)
    assert recorded_since(t0) == [] and len(checks) == 4
    # recording: the regions are there, and still no range is pushed
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = time.time_ns()
        block(x, ctx)
    assert [r["name"] for r in recorded_since(t0)] == [
        "unet.self_attn", "unet.cross_attn", "unet.cross_attn", "unet.ff"]


# ---------------------------------------------------------------- the readers
T0 = 1_792_350_066_000_000_000     # Unix-epoch ns, as the profiler stamps
MAIN, DEVICE = 11, 22               # the host thread and autograd's device thread
SPAN_READERS = ("unet.device_ms", "unet.idle_ms", "guided.device_ms", "guided.vae.device_ms",
                "guided.vocoder.device_ms", "guided.loss_head.device_ms",
                "guided.vae.idle_ms", "guided.vocoder.idle_ms", "guided.loss_head.idle_ms",
                "kernels.cache_misses_per_step")
REGION_READERS = ("unet.self_attn.device_ms", "unet.cross_attn.device_ms",
                  "unet.cross_attn.idle_ms")
STEP_US = 500


def record(kind, name, start, end, thread=MAIN, what=None):
    return {"kind": kind, "name": name, "start": T0 + start * 1000, "end": T0 + end * 1000,
            "thread": thread, "id": None, "parent": None, "step": None, "what": what}


def step_spans(at):
    """One step's spans (us from `at`): the UNet, the guided step, its
    stages, the backward and its pieces on the device thread."""
    s = lambda name, a, b, thread=MAIN: record("span", name, at + a, at + b, thread)
    return [s("unet_forward", 0, 100), s("guided_step", 100, 400),
            s("guided.vae", 110, 150), s("guided.vocoder", 150, 180),
            s("guided.loss_head", 180, 200), s("guided.backward", 210, 390),
            s("guided.vae.backward", 300, 390, DEVICE)]


def step_regions(at):
    """One dual-cross block's regions inside the step's UNet."""
    return [record("region", "unet.self_attn", at + 5, at + 30),
            record("region", "unet.cross_attn", at + 30, at + 45, what=0),
            record("region", "unet.cross_attn", at + 45, at + 60, what=1),
            record("region", "unet.ff", at + 60, at + 80)]


# (launch, device start, device end, host range) in us from a step's start:
# a resnet's op, two self-attention ops, one a cross stream, the FF, an op
# after the block, then the VAE, the loss head and the VAE's backward
ACTS = [(2, 3, 8, "unet_forward"), (10, 12, 26, "unet_forward"), (20, 28, 30, "unet_forward"),
        (35, 36, 40, "unet_forward"), (50, 51, 55, "unet_forward"),
        (65, 70, 90, "unet_forward"), (85, 92, 98, "unet_forward"),
        (120, 130, 160, "guided_step"), (190, 200, 220, "guided_step"),
        (320, 340, 420, "guided_step")]


def summary(steps):
    acts = [{"name": "k", "launch": T0 + (STEP_US * k + launch) * 1000,
             "start": T0 + (STEP_US * k + start) * 1000, "end": T0 + (STEP_US * k + end) * 1000,
             "host": host, "port": False}
            for k in range(steps) for launch, start, end, host in ACTS]
    return {"steps": steps, "acts": acts}


def ctx(steps=2, with_regions=True):
    recs = []
    for k in range(steps):
        recs += step_spans(STEP_US * k) + (step_regions(STEP_US * k) if with_regions else [])
    recs.append(dict(record("count", "kernels.cache_miss", 120, 120), what="mask.launch_plan"))
    return {"summary": summary(steps), "spans": recs}


def read(name, c):
    return manifest.reader(name)(c)


@pytest.mark.parametrize("steps", [1, 2, 3])
def test_span_readers_ignore_regions(steps):
    with_r, without = ctx(steps), ctx(steps, with_regions=False)
    assert spans.joined(with_r) == spans.joined(without)
    for name in SPAN_READERS:
        v = read(name, with_r)
        assert v is not None and v == read(name, without), name
    # per step: 40 us of gaps inside the UNet, 83 between steps after the first
    assert read("unet.idle_ms", with_r) == pytest.approx((40 * steps + 83 * (steps - 1))
                                                         / 1000 / steps)
    assert read("unet.device_ms", with_r) == pytest.approx(55 / 1000)


@pytest.mark.parametrize("steps", [1, 2, 3])
def test_region_readers(steps):
    c = ctx(steps)
    # self-attention 14 + 2 us a step, the streams 4 + 4, the gaps their
    # launches close 6 + 11
    assert read("unet.self_attn.device_ms", c) == pytest.approx(16 / 1000)
    assert read("unet.cross_attn.device_ms", c) == pytest.approx(8 / 1000)
    assert read("unet.cross_attn.idle_ms", c) == pytest.approx(17 / 1000)
    table = regions.table(c)
    want = {("unet.self_attn", None): (16, 6, 2), ("unet.cross_attn", 0): (4, 6, 1),
            ("unet.cross_attn", 1): (4, 11, 1), ("unet.ff", None): (20, 15, 1),
            (None, None): (11, 2 + 83 * (steps - 1) / steps, 2)}
    assert set(table) == set(want)
    for lab, (dev, idle, n) in want.items():
        assert table[lab] == pytest.approx([dev / 1000, idle / 1000, n]), lab
    # the UNet's regions and the rest hold all of its device time
    assert sum(v[0] for v in table.values()) == pytest.approx(read("unet.device_ms", c))


def test_region_readers_none_without_regions():
    for c in (ctx(with_regions=False), {"summary": summary(2), "spans": []}):
        assert all(read(n, c) is None for n in REGION_READERS)
        assert regions.table(c) == {}
    far = ctx()
    far["spans"] = [dict(r, start=r["start"] - 10**12, end=r["end"] - 10**12)
                    if r["kind"] == "region" else r for r in far["spans"]]
    assert all(read(n, far) is None for n in REGION_READERS)


def test_region_outside_the_unet_labels_nothing():
    c = ctx(1)
    # a region around the guided step's VAE launch: its work is not the UNet's
    c["spans"].append(record("region", "unet.self_attn", 115, 125))
    assert read("unet.self_attn.device_ms", c) == pytest.approx(16 / 1000)
