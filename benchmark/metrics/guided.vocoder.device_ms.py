"""Device time per step of the activities launched inside the port's
"guided.vocoder" span or its backward, "guided.vocoder.backward" (`benchmark/spans.py`)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, spans.STAGES["guided.vocoder"])
