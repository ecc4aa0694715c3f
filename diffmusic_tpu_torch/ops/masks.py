"""Time-domain inpainting masks (numpy; port of `diffmusic_tpu/ops/masks.py`).

Only the box mask of the MusicLDM inpainting slice is ported so far; the random
and periodic masks are still to be ported.
"""

from typing import Optional

import numpy as np


def box_mask(total_samples: int, sample_rate: int,
             start_s: Optional[float], end_s: Optional[float]) -> np.ndarray:
    mask = np.ones((1, total_samples), np.float32)
    if start_s is not None and end_s is not None:
        mask[:, int(start_s * sample_rate):int(end_s * sample_rate)] = 0.0
    return mask
