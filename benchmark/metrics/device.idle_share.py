"""1 - (union of device activity) / (the span from its first device activity
to its last), in percent."""


def read(ctx):
    s = ctx["summary"]
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"]) if s["window_s"] > 0 else None
