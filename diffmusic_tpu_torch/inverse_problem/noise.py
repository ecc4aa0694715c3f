"""Measurement noise (port of `diffmusic_tpu/inverse_problem/noise.py`).

Random draws come from an explicit `torch.Generator`, the counterpart of the
JAX package's explicit PRNG keys. The two give different numbers from one
seed, so tests feed both sides the same arrays.
"""

from dataclasses import dataclass
from typing import Optional

import torch


def randn(shape, generator: Optional[torch.Generator], dtype,
          device) -> torch.Tensor:
    """Standard normal draws made on the generator's own device, then moved to
    `device`. A CPU generator (`torch.Generator().manual_seed(s)`) thus serves
    data on the card too, and gives the same numbers there as on the CPU."""
    src = generator.device if generator is not None else device
    return torch.randn(shape, generator=generator, dtype=dtype, device=src).to(device)


class BaseNoise:
    def __call__(self, data: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.forward(data, generator)

    def forward(self, data, generator=None):
        raise NotImplementedError


@dataclass(frozen=True)
class GaussianNoise(BaseNoise):
    sigma: float = 0.0

    def forward(self, data, generator=None):
        if self.sigma == 0.0 or generator is None:
            return data
        return data + randn(data.shape, generator, data.dtype, data.device) * self.sigma
