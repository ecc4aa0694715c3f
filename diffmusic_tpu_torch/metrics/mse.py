"""Length-aligned waveform MSE (reference: diffmusic/metrics/mse.py:9-28).

A copy of `diffmusic_tpu/metrics/mse.py` (numpy only): the JAX package's
`metrics/__init__.py` imports jax, so the port keeps its own.
"""

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass
class MeanSquaredError:
    reduction: str = "mean"

    def score(self, background: Sequence[np.ndarray],
              eval_set: Sequence[np.ndarray]) -> float:
        total, n = 0.0, min(len(background), len(eval_set))
        for bg, ev in zip(background[:n], eval_set[:n]):
            a = np.asarray(bg, np.float64).reshape(-1)
            b = np.asarray(ev, np.float64).reshape(-1)
            m = min(a.size, b.size)
            err = np.nan_to_num((a[:m] - b[:m]) ** 2)
            total += float(err.mean() if self.reduction == "mean" else err.sum())
        return total / max(n, 1)
