"""The canvas: a margin-carrying layout for chains of vocoder convs.

The port's own copy of the contract of `diffmusic_tpu/pallas/conv1d_kernel.py`
(`TIME_BLOCK`, `canvas_blocks`, `to_canvas`, `from_canvas`,
`_canvas_row_mask`). A signal of t rows, (B, t, C), lives on a canvas of
(B, (blocks + 2) * 512, C) rows with the signal at [512, 512 + t) and exact
zeros everywhere else. The canvas kernels (`kernels/conv1d.py`,
`kernels/stage_bwd.py`) read their windows straight from it, with no padding
and no edge case, and write their outputs in the same layout with the zeros
re-established, so a resblock stage pads once and slices once. The 512-row
margin is part of the contract: the port's canvas tensors equal the JAX
package's element for element. A CUDA kernel's own time tile is its own.
"""

import math

import torch
import torch.nn.functional as F

TIME_BLOCK = 512


def canvas_blocks(t: int) -> int:
    return math.ceil(t / TIME_BLOCK)


def canvas_rows(t: int) -> int:
    """Rows of the canvas of a t-row signal."""
    return (canvas_blocks(t) + 2) * TIME_BLOCK


def to_canvas(x):
    """(B, t, C) -> (B, (blocks + 2) * 512, C); signal at [512, 512 + t)."""
    t = x.shape[1]
    return F.pad(x, (0, 0, TIME_BLOCK, canvas_rows(t) - TIME_BLOCK - t))


def from_canvas(xc, t: int):
    """Inverse of `to_canvas` for a signal of t rows."""
    return xc[:, TIME_BLOCK:TIME_BLOCK + t].contiguous()


def canvas_row_mask(tc: int, t: int, dtype=torch.float32, device=None):
    """(1, tc, 1) mask of the signal rows [512, 512 + t) of a canvas: 1 / 0."""
    r = torch.arange(tc, device=device)
    return ((r >= TIME_BLOCK) & (r < TIME_BLOCK + t)).to(dtype)[None, :, None]


def canvas_ok(cin: int, cout: int) -> bool:
    """The JAX rule's channel condition: both channel counts 128-aligned."""
    return cin % 128 == 0 and cout % 128 == 0
