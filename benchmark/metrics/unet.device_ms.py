"""Device time per step of the activities launched inside the denoise loop's
"unet_forward" host range (the UNet's forward), joined by correlation id."""


def read(ctx):
    s = ctx["summary"]
    ns = sum(a["end"] - a["start"] for a in s["acts"] if a["host"] == "unet_forward")
    return ns / 1e6 / s["steps"] if ns else None
