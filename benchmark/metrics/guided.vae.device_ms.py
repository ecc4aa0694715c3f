"""Device time per step of the activities launched inside the port's
"guided.vae" span or its backward, "guided.vae.backward" (`benchmark/spans.py`)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, spans.STAGES["guided.vae"])
