"""The port's own spans in the traced span, joined to its device activities.

The port records, while the profiler runs, a span for each range it marks
(`diffmusic_tpu_torch.tracing.spans()`: "unet_forward", "guided_step", the
guided step's "guided.vae", "guided.vocoder", "guided.loss_head",
"guided.backward" and the backward's "<stage>.backward" pieces) and a point
event for each count ("kernels.cache_miss"), all stamped on the clock of the
profiler's host events. This module keeps those that fall inside the traced
span, from its first launch to its last device end, and labels each device
activity of the summary (`benchmark/trace.py`) with the innermost span, on
any thread, that holds its launch time: the latest started, the shorter on a
tie. Each idle gap between the device's busy intervals, found as `trace.py`
finds them, is named by the label of the activity that closes it.

Besides `program.py`, the one module of the benchmark that imports the port.
A port that records no spans (no `tracing.spans`) gives none, and every
reader of them None.
"""

import bisect

from diffmusic_tpu_torch import tracing

from .trace import union

# each stage of the guided loss: its forward span and its backward's
STAGES = {stage: (stage, f"{stage}.backward")
          for stage in ("guided.vae", "guided.vocoder", "guided.loss_head")}


def recorded() -> list:
    """The port's spans and counts; [] where the port records none."""
    read = getattr(tracing, "spans", None)
    return read() if read is not None else []


def innermost(spans: list):
    """(points, labels): `labels[k]` names the innermost span holding every
    time in [points[k], points[k + 1]), None where no span does."""
    points = sorted({t for s in spans for t in (s["start"], s["end"])})
    best = [None] * max(len(points) - 1, 0)
    for s in spans:
        for k in range(bisect.bisect_left(points, s["start"]),
                       bisect.bisect_left(points, s["end"])):
            b = best[k]
            if b is None or (s["start"], -s["end"]) > (b["start"], -b["end"]):
                best[k] = s
    return points, [b["name"] if b is not None else None for b in best]


def joined(ctx: dict):
    """{"steps", "acts": [(device ns, label)], "gaps": [(idle ns, label)],
    "counts": [count records]} for the traced span, or None when no span of
    the port falls inside it. `ctx["spans"]`, where given, stands for the
    port's records; the result is kept in `ctx` for the other readers."""
    if "spans_joined" not in ctx:
        ctx["spans_joined"] = _join(ctx["summary"],
                                    ctx["spans"] if "spans" in ctx else recorded())
    return ctx["spans_joined"]


def _join(summary: dict, records: list):
    acts = summary["acts"]
    launches = [a["launch"] for a in acts if a["launch"] is not None]
    if not launches:
        return None
    lo, hi = min(launches), max(a["end"] for a in acts)
    spans = [r for r in records if r["kind"] == "span" and r["end"] >= lo and r["start"] <= hi]
    if not spans:
        return None
    first = min(lo, min(r["start"] for r in spans))
    points, labels = innermost(spans)

    def label(t):
        k = bisect.bisect_right(points, t) - 1 if t is not None else -1
        return labels[k] if 0 <= k < len(labels) else None

    named = [(a["end"] - a["start"], label(a["launch"])) for a in acts]
    starts = [a["start"] for a in acts]
    busy = union((a["start"], a["end"]) for a in acts)
    gaps = [(s1 - e0, named[bisect.bisect_left(starts, s1)][1])
            for (_, e0), (s1, _) in zip(busy, busy[1:])]
    counts = [r for r in records if r["kind"] == "count" and first <= r["start"] <= hi]
    return {"steps": summary["steps"], "acts": named, "gaps": gaps, "counts": counts}


def device_ms(ctx: dict, names):
    """Device ms a step of the activities launched inside spans `names`."""
    j = joined(ctx)
    if j is None:
        return None
    return sum(ns for ns, n in j["acts"] if n in names) / 1e6 / j["steps"]


def idle_ms(ctx: dict, names):
    """Device idle ms a step in the gaps closed by work launched inside
    spans `names`: how long the card waited on their host code."""
    j = joined(ctx)
    if j is None:
        return None
    return sum(ns for ns, n in j["gaps"] if n in names) / 1e6 / j["steps"]


def counts_per_step(ctx: dict, name: str):
    """Point events `name` in the span over its steps."""
    j = joined(ctx)
    if j is None:
        return None
    return sum(1 for c in j["counts"] if c["name"] == name) / j["steps"]
