"""One step's operations, counted from the plain reference at the cell's
shapes (frozen weights: input cotangents only), times the window's steps,
over the window's seconds times the bf16 peak, in percent. The same work
whatever implements it, so it bounds a later change that takes a kernel off
the path."""


def read(ctx):
    w, flops = ctx["window"], ctx.get("flops_step")
    if not flops:
        return None
    return 100.0 * flops * w["steps"] / (w["window_s"] * ctx["peaks"]["bf16_flops_per_s"])
