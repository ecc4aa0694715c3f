"""The arithmetic the reference runs in.

`FP32` is the reference proper: float32 everywhere, TF32 off. `CONTROL` is
the reference one step below the precision each part of the configuration
states, the step a later change would be tempted to take: the bfloat16
models' matrix products and convolutions with both operands rounded to
float8 e4m3 (a per-tensor scale, products accumulated in float32), the
float32 loss head's matrix products in TF32, and the float32 sampler
algebra in bfloat16.
"""

import contextlib
from dataclasses import dataclass

import torch

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a per-tensor scale, back in float32."""
    x = x.float()
    amax = x.abs().amax()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


@dataclass(frozen=True)
class Precision:
    name: str
    gemm_fp8: bool          # the bf16 models' GEMM and conv operands in float8
    tf32: bool              # float32 products (the loss head's) in TF32
    algebra: torch.dtype    # the sampler's elementwise algebra

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a model's matrix product or convolution."""
        return fp8(x) if self.gemm_fp8 else x

    @contextlib.contextmanager
    def mode(self):
        """TF32 on or off for matmuls and cuDNN convolutions while the
        reference runs, restored afterwards. (The control's float8-rounded
        operands are exact in TF32, so only its float32 loss head rounds.)"""
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


FP32 = Precision("fp32", False, False, torch.float32)
CONTROL = Precision("control", True, True, torch.bfloat16)
