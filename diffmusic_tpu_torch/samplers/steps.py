"""DDIM and DPS step functions (port of `diffmusic_tpu/samplers/steps.py`).

Each returns (prev_sample, pred_original_sample, rec_loss). `loss_fn` maps the
pred-x0 latent to a scalar; the DPS gradient is `torch.autograd.grad` of it with
respect to x_t, taken under `torch.enable_grad()` so that callers may run the
UNet under `torch.no_grad()`. The other guided samplers (MPGD, DSG, DiffMusic,
DITTO) are still to be ported.
"""

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..inverse_problem.noise import randn
from .schedule import DiffusionSchedule

LossFn = Callable[[torch.Tensor], torch.Tensor]  # pred_x0 latent -> scalar


@dataclass(frozen=True)
class SamplerConfig:
    name: str = "dps"
    eta: float = 1.0
    ip_guidance_rate: float = 0.08
    num_inference_steps: int = 200
    eps: float = 1e-8


def _common(schedule: DiffusionSchedule, t: int, num_inference_steps: int):
    t_prev = t - schedule.step_ratio(num_inference_steps)
    return schedule.alpha_prod_prev(t_prev), schedule.variance(t, t_prev)


def _recomposed_eps(schedule, t, sample, x0):
    """eps implied by (sample, x0): (x_t - sqrt(a_t) x0) / sqrt(1 - a_t)."""
    a_t = schedule.alpha_prod(t)
    return ((sample - float(a_t ** np.float32(0.5)) * x0)
            / float((np.float32(1.0) - a_t) ** np.float32(0.5)))


def ddim_step(schedule: DiffusionSchedule, cfg: SamplerConfig,
              eps: torch.Tensor, t: int, sample: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              loss_fn: Optional[LossFn] = None):
    """Plain (unguided) DDIM: prev = sqrt(a_prev) x0 + sqrt(1 - a_prev) eps.

    The loss slot is zero (the JAX step puts the timestep there)."""
    a_prev, _ = _common(schedule, t, cfg.num_inference_steps)
    x0 = schedule.pred_original(eps, t, sample)
    eps_rec = _recomposed_eps(schedule, t, sample, x0)
    prev = (float(a_prev ** np.float32(0.5)) * x0
            + float((np.float32(1.0) - a_prev) ** np.float32(0.5)) * eps_rec)
    return prev, x0, torch.zeros((), dtype=torch.float32, device=sample.device)


def dps_step(schedule: DiffusionSchedule, cfg: SamplerConfig,
             eps: torch.Tensor, t: int, sample: torch.Tensor,
             generator: Optional[torch.Generator], loss_fn: LossFn):
    """DPS: prev = DDIM(x_t) - rate * d rec_loss(x0(x_t)) / d x_t."""
    a_prev, var = _common(schedule, t, cfg.num_inference_steps)
    std = np.float32(cfg.eta) * var ** np.float32(0.5)
    eps = eps.detach()
    with torch.enable_grad():
        s = sample.detach().requires_grad_(True)
        x0 = schedule.pred_original(eps, t, s)
        loss = loss_fn(x0)
        (grad,) = torch.autograd.grad(loss, s)
    x0 = x0.detach()
    eps_rec = _recomposed_eps(schedule, t, sample, x0)
    prev = (float(a_prev ** np.float32(0.5)) * x0
            + float((np.float32(1.0) - a_prev - std * std) ** np.float32(0.5))
            * eps_rec)
    if cfg.eta > 0:
        prev = prev + float(std) * randn(sample.shape, generator, sample.dtype,
                                         sample.device)
    prev = prev - cfg.ip_guidance_rate * grad
    return prev, x0, loss.detach()


def make_step_fn(schedule: DiffusionSchedule, cfg: SamplerConfig,
                 loss_fn: Optional[LossFn] = None):
    """Bind a sampler into `(eps, t, sample, generator) -> (prev, x0, loss)`."""
    if cfg.name == "ddim":
        def step(eps, t, sample, generator=None):
            return ddim_step(schedule, cfg, eps, t, sample, generator)
        return step
    if cfg.name != "dps":
        raise ValueError(f"Sampler {cfg.name!r} is not ported yet (ddim, dps)")
    if loss_fn is None:
        raise ValueError(f"Sampler '{cfg.name}' requires a loss_fn")

    def step(eps, t, sample, generator=None):
        return dps_step(schedule, cfg, eps, t, sample, generator, loss_fn)
    return step
