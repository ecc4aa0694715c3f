"""The port's own kernels' share of all device time in the span (their
names: `benchmark/kernels.json`)."""


def read(ctx):
    acts = ctx["summary"]["acts"]
    total = sum(a["end"] - a["start"] for a in acts)
    port = sum(a["end"] - a["start"] for a in acts if a["port"])
    return 100.0 * port / total if port else None
