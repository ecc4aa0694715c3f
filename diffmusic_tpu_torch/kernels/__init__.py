"""Hand-written Hopper kernels: the counterparts of `diffmusic_tpu/pallas`.

Each module holds a kernel's wrapper, its plain PyTorch version and its launch
counter; the CUDA sources are in `csrc/` and `build.py` compiles them at first
use on a machine with `nvcc`. Ported so far: the four kernels of the MusicLDM
DPS main path, the flash attention and the dual-cross mode of the
transformer block on the AudioLDM2 path, and the guided step's optional
routes: the fused GroupNorm, the channel moments, the 'same' conv2d, the
leaky-ReLU backward masks, the vocoder's canvas convs and pairs
(`conv1d.py`), the stage backward (`stage_bwd.py`) and the bounded-softmax
mode of the transformer block; and the fused mel spectrogram of the eval
path's MFCC front end (`mel.py`).
"""

from . import (attention, conv1d, conv2d, group_norm, mask, mel, stage_bwd,
               transformer_block, upsampler)
from .mel import fused_mel_spectrogram

_COUNTERS = (conv1d.LAUNCHES, upsampler.LAUNCHES, transformer_block.LAUNCHES,
             attention.LAUNCHES, group_norm.LAUNCHES, conv2d.LAUNCHES, mask.LAUNCHES,
             stage_bwd.LAUNCHES, mel.LAUNCHES)


def launch_counts() -> dict:
    """Launches of each kernel since the last `reset_launch_counts()`."""
    out = {}
    for counter in _COUNTERS:
        out.update(counter)
    return out


def reset_launch_counts() -> None:
    for counter in _COUNTERS:
        for name in counter:
            counter[name] = 0
