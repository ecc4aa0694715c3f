"""The port's regions inside the UNet's forward, joined to its device
activities.

A region (`diffmusic_tpu_torch.tracing.region`) marks a sub-stage inside a
span and is recorded apart from the spans (kind "region"), so that
`benchmark/spans.py` and its readers never see it. The UNet's transformer
blocks mark "unet.self_attn", "unet.cross_attn" (`what`: the stream's
index), "unet.ff" and "unet.fused_block". On the clock and join of
`spans.py`, this module labels each device activity whose innermost span is
"unet_forward" by (name, what) of the innermost region holding its launch,
(None, None) where none does, and each idle gap by the label of the
activity that closes it. Activities and gaps outside "unet_forward" take no
label.

A port that records no regions gives none, and every reader of them None.
"""

import bisect

from . import spans
from .trace import union

UNET = "unet_forward"
OUTSIDE = (None, None)


def joined(ctx: dict):
    """{"steps", "acts": [(device ns, label)], "gaps": [(idle ns, label)]}
    of the traced span, the labels (name, what) of the regions, or None
    when no span or no region of the port falls inside it. Kept in `ctx`."""
    if "regions_joined" not in ctx:
        ctx["regions_joined"] = _join(ctx)
    return ctx["regions_joined"]


def _join(ctx: dict):
    j = spans.joined(ctx)
    if j is None:
        return None
    acts = ctx["summary"]["acts"]
    lo = min(a["launch"] for a in acts if a["launch"] is not None)
    hi = max(a["end"] for a in acts)
    records = ctx["spans"] if "spans" in ctx else spans.recorded()
    regions = [dict(r, name=(r["name"], r.get("what"))) for r in records
               if r["kind"] == "region" and r["end"] >= lo and r["start"] <= hi]
    if not regions:
        return None
    points, labels = spans.innermost(regions)

    def label(t):
        k = bisect.bisect_right(points, t) - 1 if t is not None else -1
        return labels[k] if 0 <= k < len(labels) and labels[k] is not None else OUTSIDE

    named = [(a["end"] - a["start"], label(a["launch"]) if span == UNET else None)
             for a, (_, span) in zip(acts, j["acts"])]
    starts = [a["start"] for a in acts]
    busy = union((a["start"], a["end"]) for a in acts)
    gaps = [(s1 - e0, named[bisect.bisect_left(starts, s1)][1])
            for (_, e0), (s1, _) in zip(busy, busy[1:])]
    return {"steps": j["steps"], "acts": named, "gaps": gaps}


def _per_step(pairs, names, steps) -> float:
    return sum(ns for ns, lab in pairs if lab is not None and lab[0] in names) / 1e6 / steps


def device_ms(ctx: dict, names):
    """Device ms a step of the UNet's activities launched inside regions
    `names` (every `what`)."""
    j = joined(ctx)
    return None if j is None else _per_step(j["acts"], names, j["steps"])


def idle_ms(ctx: dict, names):
    """Device idle ms a step in the gaps closed by the UNet's work launched
    inside regions `names`: how long the card waited on their host code."""
    j = joined(ctx)
    return None if j is None else _per_step(j["gaps"], names, j["steps"])


def table(ctx: dict) -> dict:
    """{label: [device ms, idle ms, launches] a step} over the UNet's
    activities, (None, None) for those outside any region; {} without
    regions. For the breakdown in `PERF.md`, read by no metric."""
    j = joined(ctx)
    if j is None:
        return {}
    out = {}
    for ns, lab in j["acts"]:
        if lab is not None:
            row = out.setdefault(lab, [0.0, 0.0, 0.0])
            row[0] += ns / 1e6 / j["steps"]
            row[2] += 1 / j["steps"]
    for ns, lab in j["gaps"]:
        if lab is not None:
            out.setdefault(lab, [0.0, 0.0, 0.0])[1] += ns / 1e6 / j["steps"]
    return out
