"""`benchmark/spans.py` and its eight readers on a synthetic traced span
(CPU): activities labelled by the innermost span across two threads, idle
gaps named by the span that launched the work closing them, 0.0 for a zero
count, None when no span falls inside the span or the port records none,
and the stages' device time within the guided step's."""

import types

import pytest

from benchmark import manifest, spans

READERS = ("guided.vae.device_ms", "guided.vocoder.device_ms", "guided.loss_head.device_ms",
           "guided.vae.idle_ms", "guided.vocoder.idle_ms", "guided.loss_head.idle_ms",
           "unet.idle_ms", "kernels.cache_misses_per_step")
T0 = 1_792_350_066_000_000_000     # Unix-epoch ns, as the profiler stamps
MAIN, DEVICE = 11, 22               # the host thread and autograd's device thread


def span(name, start, end, thread=MAIN):
    return {"kind": "span", "name": name, "start": T0 + start, "end": T0 + end,
            "thread": thread, "id": None, "parent": None, "step": None, "what": None}


def one_step(at):
    """One step's spans from `at` (us): the UNet, the guided step, its three
    forward stages, the backward on the host thread and its pieces, cut on
    the device thread."""
    s = lambda name, a, b, thread=MAIN: span(name, (at + a) * 1000, (at + b) * 1000, thread)
    return [s("unet_forward", 0, 100), s("guided_step", 100, 400),
            s("guided.vae", 110, 150), s("guided.vocoder", 150, 180),
            s("guided.loss_head", 180, 200), s("guided.backward", 210, 390),
            s("guided.loss_head.backward", 215, 250, DEVICE),
            s("guided.vocoder.backward", 250, 300, DEVICE),
            s("guided.vae.backward", 300, 390, DEVICE)]


# (launch, device start, device end, the host range trace.py would name) in
# us from a step's start: one activity per stage and piece, laid out so
# that the gaps before the vae's and the vocoder's backward are idle
ACTS = [(10, 20, 90, "unet_forward"), (120, 130, 160, "guided_step"),
        (160, 165, 185, "guided_step"), (190, 200, 220, "guided_step"),
        (205, 222, 230, "guided_step"), (220, 231, 250, "guided_step"),
        (260, 270, 300, "guided_step"), (320, 340, 420, "guided_step"),
        (395, 425, 430, "guided_step")]


def summary(steps=2):
    acts = []
    for k in range(steps):
        at = 500 * k
        for launch, start, end, host in ACTS:
            acts.append({"name": "k", "launch": T0 + (at + launch) * 1000,
                         "start": T0 + (at + start) * 1000, "end": T0 + (at + end) * 1000,
                         "host": host, "port": False})
    return {"steps": steps, "acts": acts}


def ctx(records, steps=2):
    return {"summary": summary(steps), "spans": records}


def read(name, c):
    return manifest.reader(name)(c)


def test_innermost_span_across_two_threads():
    c = ctx(one_step(0) + one_step(500))
    labels = [n for _, n in spans.joined(c)["acts"]][:len(ACTS)]
    assert labels == ["unet_forward", "guided.vae", "guided.vocoder", "guided.loss_head",
                      "guided_step", "guided.loss_head.backward", "guided.vocoder.backward",
                      "guided.vae.backward", "guided_step"]
    # two steps, each stage one launch of 30 / 20 / 20 us forward and 19 / 30 / 80 backward
    assert read("guided.vae.device_ms", c) == pytest.approx((30 + 80) / 1000)
    assert read("guided.vocoder.device_ms", c) == pytest.approx((20 + 30) / 1000)
    assert read("guided.loss_head.device_ms", c) == pytest.approx((20 + 19) / 1000)


def test_gap_is_named_by_the_span_that_launched_the_work_closing_it():
    c = ctx(one_step(0) + one_step(500))
    step = [(40000, "guided.vae"), (5000, "guided.vocoder"), (15000, "guided.loss_head"),
            (2000, "guided_step"), (1000, "guided.loss_head.backward"),
            (20000, "guided.vocoder.backward"), (40000, "guided.vae.backward"),
            (5000, "guided_step")]
    # the span's first activity opens no gap; 90 us between the steps end
    # at the next step's first UNet launch
    assert spans.joined(c)["gaps"] == step + [(90000, "unet_forward")] + step
    assert read("guided.vae.idle_ms", c) == pytest.approx((40 + 40) / 1000)
    assert read("guided.vocoder.idle_ms", c) == pytest.approx((5 + 20) / 1000)
    assert read("guided.loss_head.idle_ms", c) == pytest.approx((15 + 1) / 1000)
    assert read("unet.idle_ms", c) == pytest.approx(90 / 1000 / 2)


def test_zero_counts_read_zero():
    records = one_step(0) + one_step(500)
    assert read("kernels.cache_misses_per_step", ctx(records)) == 0.0
    miss = dict(span("kernels.cache_miss", 120_000, 120_000), kind="count",
                what="conv1d.pair_plan")
    early = dict(miss, start=T0 - 10**9, end=T0 - 10**9)     # before the span
    assert read("kernels.cache_misses_per_step", ctx(records + [miss, early])) == 0.5
    # a stage that launched nothing reads zero, not a missing metric
    c = ctx([s for s in records if not s["name"].startswith("guided.loss_head")])
    assert read("guided.loss_head.device_ms", c) == 0.0
    assert read("guided.loss_head.idle_ms", c) == 0.0


def test_none_when_no_span_falls_inside_the_traced_span():
    outside = [dict(s, start=s["start"] - 10**12, end=s["end"] - 10**12) for s in one_step(0)]
    for records in (outside, []):
        c = ctx(records)
        assert all(read(n, c) is None for n in READERS)


def test_none_from_a_port_without_the_recorder(monkeypatch):
    monkeypatch.setattr(spans, "tracing", types.SimpleNamespace())
    c = {"summary": summary()}
    assert spans.recorded() == []
    assert all(read(n, c) is None for n in READERS)


@pytest.mark.parametrize("steps", [1, 2, 3])
def test_stages_fit_inside_the_guided_step(steps):
    c = ctx([s for k in range(steps) for s in one_step(500 * k)], steps)
    stages = sum(read(f"guided.{st}.device_ms", c) for st in ("vae", "vocoder", "loss_head"))
    guided = read("guided.device_ms", c)
    assert 0 < stages <= guided
    # two launches a step outside any stage: between the forward and the
    # backward (8 us), and after the backward (5 us)
    assert stages == pytest.approx(guided - (8 + 5) / 1000)
