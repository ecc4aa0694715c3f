"""1-D filters for the dereverberation operator (port of
`diffmusic_tpu/ops/filters.py`): applying a reverb impulse response, and
drawing one."""

from typing import Optional

import torch
import torch.nn.functional as F


def convolve1d(x: torch.Tensor, ir: torch.Tensor) -> torch.Tensor:
    """Cross-correlate (..., L) with ir (ir_len,), padding ir_len // 2 each
    side: the output has L + 2 (ir_len // 2) - ir_len + 1 samples (L + 1 for
    an even ir_len), as `torch.conv1d` with padding=ir_len // 2."""
    ir_len = ir.shape[-1]
    batch_shape = x.shape[:-1]
    k = ir.reshape(1, 1, ir_len).to(x.dtype)
    y = F.conv1d(x.reshape(-1, 1, x.shape[-1]), k, padding=ir_len // 2)
    return y.reshape(*batch_shape, y.shape[-1])


def generate_impulse_response(generator: Optional[torch.Generator], ir_length: int = 800,
                              decay_factor: float = 0.85) -> torch.Tensor:
    """White noise from `generator` -> cumulative sum times decay_factor ->
    normalised to a peak of 1, on the generator's device (the CPU without one)."""
    noise = torch.randn(ir_length, generator=generator,
                        device=generator.device if generator is not None else None)
    ir = torch.cumsum(noise, 0) * decay_factor
    return ir / ir.abs().max()
