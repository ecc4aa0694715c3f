"""The traced span: `torch.profiler` over host and card (the activities
`diffmusic_tpu_torch.tracing.trace` records) for a contiguous run of steps,
its events kept in memory and reduced to a summary that the per-layer
readers (`benchmark/metrics/`) and the breakdown read. Nothing is written
to disk.

The summary holds the span's device activities (kernels, copies, sets),
each with the host time of the runtime call that launched it, joined by the
profiler's correlation ids whatever thread launched it (the guided step's
backward runs on autograd's device thread); the host ranges that
`pipelines/base.py::run_denoise_loop` marks ("unet_forward",
"guided_step"); the clip-local index of each step; and the port's launch
counters over the span (`diffmusic_tpu_torch.kernels.launch_counts`).
"""

import bisect

import torch
from torch.profiler import ProfilerActivity, profile

HOST_RANGES = ("unet_forward", "guided_step")


class Span:
    def __init__(self, steps: int, steps_per_clip: int, counters):
        """`counters`: (reset, read) of the port's launch counters."""
        self.steps, self.steps_per_clip = steps, steps_per_clip
        self.reset, self.read = counters
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.clip_local, self.launches = [], None

    def open(self) -> None:
        """Starts the profiler, once the window has closed: prepared any
        earlier, its callbacks would slow the window's launches."""
        torch.cuda.synchronize()
        self.reset()
        self.prof.prepare_trace()
        self.prof.start_trace()

    def step(self, i: int) -> bool:
        """After each step of the span (`i`: its index in its clip); True
        once the span is over, with the profiler stopped."""
        self.clip_local.append(i)
        if len(self.clip_local) < self.steps:
            return False
        self.prof.stop_trace()
        self.launches = dict(self.read())
        return True

    def events(self):
        """(device activities with their launch times, host ranges)."""
        runtime, device, ranges = {}, [], {n: [] for n in HOST_RANGES}
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.is_user_annotation():      # not a host range's device copy
                    device.append(e)
            elif e.name() in ranges:
                ranges[e.name()].append((e.start_ns(), e.end_ns()))
            elif e.name().startswith("cu"):
                runtime[e.correlation_id()] = e.start_ns()
        acts = []
        for e in device:
            launch = runtime.get(e.correlation_id())
            acts.append({"name": e.name(), "start": e.start_ns(), "end": e.end_ns(),
                         "launch": launch})
        acts.sort(key=lambda a: a["start"])
        return acts, {k: sorted(v) for k, v in ranges.items()}


def union(intervals) -> list:
    """The union of (start, end) intervals, sorted and merged."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(t, intervals) -> bool:
    k = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return k >= 0 and intervals[k][0] <= t <= intervals[k][1]


def summarize(span: Span, names: list) -> dict:
    """The reduction the readers take. Each device activity gets `host`, what
    the host was doing when it launched it: "unet_forward", "guided_step",
    "between steps" (between two steps of a clip) or "clip boundary"
    (between a clip's last step and the next clip's first: the final decode,
    the NaN check, the next prompt's encoding); and `port`, whether its name
    holds one of `names`, the port's own kernels."""
    acts, ranges = span.events()
    ends = [e for _, e in ranges["guided_step"]]
    starts = [s for s, _ in ranges["unet_forward"]]
    boundaries = []
    for k, i in enumerate(span.clip_local):
        if i == span.steps_per_clip - 1 and k < len(ends):
            j = bisect.bisect_right(starts, ends[k])
            boundaries.append((ends[k], starts[j] if j < len(starts) else float("inf")))
    for a in acts:
        t = a["launch"]
        if t is None:
            a["host"] = "unknown"
        else:
            a["host"] = next((n for n in HOST_RANGES if _inside(t, ranges[n])),
                             "clip boundary" if _inside(t, boundaries) else "between steps")
        a["port"] = any(n in a["name"] for n in names)
    busy = union((a["start"], a["end"]) for a in acts)
    starts_dev = [a["start"] for a in acts]
    gaps = []
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        gaps.append((s1 - e0, acts[bisect.bisect_left(starts_dev, s1)]["host"]))
    return {"steps": len(span.clip_local), "clip_local": span.clip_local,
            "steps_per_clip": span.steps_per_clip, "acts": acts,
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": (busy[-1][1] - busy[0][0]) / 1e9 if busy else 0.0,
            "gaps": gaps, "launches": span.launches}


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took the most time (summed by name) and the
    longest idle gaps, each named by what the host was doing as the work
    that ended it was launched."""
    by_name = {}
    for a in summary["acts"]:
        by_name[a["name"]] = by_name.get(a["name"], 0) + a["end"] - a["start"]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["gaps"], key=lambda g: -g[0])[:top]
    return {"device_ops": [[n[:120], ns / 1e9] for n, ns in ops],
            "idle_gaps": [[label, ns / 1e9] for ns, label in gaps]}
