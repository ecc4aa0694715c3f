"""Device time per step of the activities launched inside the port's
"guided.loss_head" span or its backward, "guided.loss_head.backward" (`benchmark/spans.py`)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, spans.STAGES["guided.loss_head"])
