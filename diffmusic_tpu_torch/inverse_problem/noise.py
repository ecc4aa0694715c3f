"""Measurement noise (port of `diffmusic_tpu/inverse_problem/noise.py`).

Random draws come from an explicit `torch.Generator`, the counterpart of the
JAX package's explicit PRNG keys. The two give different numbers from one
seed, so tests feed both sides the same arrays. With no generator a noiser
returns its input: that is how the guided loss calls `operator.forward`.
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


@dataclass(frozen=True)
class PoissonNoise(BaseNoise):
    """Poisson counts of (data + 1) / 2 * 255 * rate, mapped back to [-1, 1],
    with a straight-through gradient (identity in the backward)."""
    rate: float = 1.0

    def forward(self, data, generator=None):
        if generator is None:
            return data
        x = torch.clamp((data + 1.0) / 2.0, 0.0, 1.0)
        lam = (x * 255.0 * self.rate).detach().to(generator.device)
        # drawn on the generator's device, as `randn` does
        counts = torch.poisson(lam, generator=generator).to(data.device, data.dtype)
        noisy = torch.clamp(counts / (255.0 * self.rate) * 2.0 - 1.0, -1.0, 1.0)
        return data + (noisy - data).detach()


def get_noiser(name: str, **kwargs) -> BaseNoise:
    """The noiser of a task's config by name (JAX `get_noiser`)."""
    if name == "gaussian":
        return GaussianNoise(sigma=float(kwargs.get("sigma", 0.0)))
    if name == "poisson":
        return PoissonNoise(rate=float(kwargs.get("rate", 1.0)))
    raise ValueError(f"Unknown noiser: {name}")
