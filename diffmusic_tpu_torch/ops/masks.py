"""Time-domain inpainting masks (numpy; port of `diffmusic_tpu/ops/masks.py`):
box, random and periodic. The random mask draws its span starts from a
`torch.Generator` in place of the JAX package's PRNG key."""

from typing import Optional

import numpy as np
import torch


def box_mask(total_samples: int, sample_rate: int,
             start_s: Optional[float], end_s: Optional[float]) -> np.ndarray:
    mask = np.ones((1, total_samples), np.float32)
    if start_s is not None and end_s is not None:
        mask[:, int(start_s * sample_rate):int(end_s * sample_rate)] = 0.0
    return mask


def random_mask(generator: Optional[torch.Generator], total_samples: int,
                sample_rate: int, mask_percentage: float,
                mask_duration_s: float) -> np.ndarray:
    """max(1, int(pct * total) // dur) spans of `mask_duration_s`, each
    starting uniformly in [0, total - dur)."""
    dur = int(mask_duration_s * sample_rate)
    mask_count = max(1, int(mask_percentage * total_samples) // dur)
    starts = torch.randint(0, total_samples - dur, (mask_count,), generator=generator,
                           device=generator.device if generator is not None else None)
    mask = np.ones((1, total_samples), np.float32)
    for s in starts.tolist():
        mask[:, s:s + dur] = 0.0
    return mask


def periodic_mask(total_samples: int, sample_rate: int,
                  interval_s: float, mask_duration_s: float) -> np.ndarray:
    """A span of `mask_duration_s` at the start of every `interval_s`."""
    interval = int(interval_s * sample_rate)
    dur = int(mask_duration_s * sample_rate)
    mask = np.ones((1, total_samples), np.float32)
    for start in range(0, total_samples, interval):
        mask[:, start:min(start + dur, total_samples)] = 0.0
    return mask
