"""The port's "kernels.cache_miss" counts in the traced span over its steps:
a weight copy made (`kernels/repack.py`) or a launch plan computed (the
`lru_cache`'d plan functions) where a cached one was expected
(`benchmark/spans.py`)."""

from benchmark import spans


def read(ctx):
    return spans.counts_per_step(ctx, "kernels.cache_miss")
