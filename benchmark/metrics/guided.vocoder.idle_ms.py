"""Device idle time per step in the gaps closed by work launched inside the
port's "guided.vocoder" span or its backward (`benchmark/spans.py`): how long
the card waited on that stage's host code."""

from benchmark import spans


def read(ctx):
    return spans.idle_ms(ctx, spans.STAGES["guided.vocoder"])
