"""Device activities (kernels, copies, sets) per step in the traced span:
an exact count of what the host enqueues a step."""


def read(ctx):
    s = ctx["summary"]
    return len(s["acts"]) / s["steps"] if s["acts"] else None
