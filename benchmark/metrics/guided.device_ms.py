"""Device time per step of the activities launched inside the denoise loop's
"guided_step" host range (the sampler's step: in a guided cell the loss
through the VAE decoder, the vocoder, the operator and the mel head, and
its gradient), joined by correlation id whatever thread launched them."""


def read(ctx):
    s = ctx["summary"]
    ns = sum(a["end"] - a["start"] for a in s["acts"] if a["host"] == "guided_step")
    return ns / 1e6 / s["steps"] if ns else None
