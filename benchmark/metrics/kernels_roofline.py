"""The port's kernels' share of their roofline in the span: the sum over
their launches of the least time each could take, max(operations / the
bf16 peak, bytes / the HBM peak, exponentials / the MUFU's rate at the
card's top SM clock), over the sum of their device time, in percent. The
launches are those `benchmark/work` counts for the span's steps and clip
ends; a counter that disagrees with `diffmusic_tpu_torch.kernels.
launch_counts()` is printed and the metric left out."""

import sys


def read(ctx):
    s, calls, pk = ctx["summary"], ctx["calls"], ctx["peaks"]
    ends = sum(1 for i in s["clip_local"][:-1] if i == s["steps_per_clip"] - 1)
    want = dict.fromkeys(s["launches"], 0)
    bound = 0.0
    exp2_rate = pk["exp2_per_clock_per_sm"] * ctx["sms"] * ctx["sm_clock_hz"]
    for key, times in (("per_step", s["steps"]), ("per_clip", ends)):
        for counter, wk in calls[key]:
            want[counter] = want.get(counter, 0) + times
            bound += times * max(wk["flops"] / pk["bf16_flops_per_s"],
                                 wk["bytes"] / pk["hbm_bytes_per_s"], wk["exp2"] / exp2_rate)
    bad = {k: (s["launches"].get(k), n) for k, n in want.items() if s["launches"].get(k) != n}
    if bad:
        print(f"kernels_roofline: launches (counted, assumed) differ: {bad}", file=sys.stderr)
        return None
    dev = sum(a["end"] - a["start"] for a in s["acts"] if a["port"]) / 1e9
    return 100.0 * bound / dev if dev else None
