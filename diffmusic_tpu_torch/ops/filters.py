"""1-D filters for the dereverberation operator (port of
`diffmusic_tpu/ops/filters.py`): applying a reverb impulse response, and
drawing one.

The filter's gradients are forward correlations too (`_Correlate`): the
input gradient is the output gradient correlated with the reversed
response, so it runs as one more call of the forward's kind and not as
cuDNN's data gradient of a one-channel filter."""

from typing import Optional

import torch
import torch.nn.functional as F


class _Correlate(torch.autograd.Function):
    """y = x correlated with k, padding K // 2: x (N, 1, L), k (1, 1, K) ->
    y (N, 1, L + 2 (K // 2) - K + 1). With g the gradient of y,
      dx = g correlated with k reversed, padding K - 1 - K // 2 (length L);
      dk = x correlated with g over the batch, padding K // 2 (length K),
    the second only when k needs one. Both in full fp32: cuDNN's TF32 is off
    for the backward whatever the caller allows."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.save_for_backward(x, k)
        return F.conv1d(x, k, padding=k.shape[-1] // 2)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        taps = k.shape[-1]
        dx = dk = None
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            if ctx.needs_input_grad[0]:
                dx = F.conv1d(g, k.flip(-1), padding=taps - 1 - taps // 2)
            if ctx.needs_input_grad[1]:
                n = x.shape[0]
                dk = F.conv1d(x.reshape(1, n, x.shape[-1]), g.reshape(1, n, g.shape[-1]),
                              padding=taps // 2)
        finally:
            torch.backends.cudnn.allow_tf32 = saved
        return dx, dk


def convolve1d(x: torch.Tensor, ir: torch.Tensor) -> torch.Tensor:
    """Cross-correlate (..., L) with ir (ir_len,), padding ir_len // 2 each
    side: the output has L + 2 (ir_len // 2) - ir_len + 1 samples (L + 1 for
    an even ir_len), as `torch.conv1d` with padding=ir_len // 2."""
    ir_len = ir.shape[-1]
    batch_shape = x.shape[:-1]
    k = ir.reshape(1, 1, ir_len).to(x.dtype)
    y = _Correlate.apply(x.reshape(-1, 1, x.shape[-1]), k)
    return y.reshape(*batch_shape, y.shape[-1])


def generate_impulse_response(generator: Optional[torch.Generator], ir_length: int = 800,
                              decay_factor: float = 0.85) -> torch.Tensor:
    """White noise from `generator` -> cumulative sum times decay_factor ->
    normalised to a peak of 1, on the generator's device (the CPU without one)."""
    noise = torch.randn(ir_length, generator=generator,
                        device=generator.device if generator is not None else None)
    ir = torch.cumsum(noise, 0) * decay_factor
    return ir / ir.abs().max()
