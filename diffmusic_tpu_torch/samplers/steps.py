"""DDIM, DPS, MPGD, DSG, DiffMusic and DITTO step functions (port of
`diffmusic_tpu/samplers/steps.py`).

Each returns (prev_sample, pred_original_sample, rec_loss). `loss_fn` maps the
pred-x0 latent to a scalar; each guided gradient is `torch.autograd.grad` of it
on a detached leaf (x_t, or x0-hat for MPGD), taken under
`torch.enable_grad()` so that callers may run the UNet under
`torch.no_grad()`, inside a "guided.backward" range (`tracing.annotate`).
Norms and the slerp's weights stay device tensors: no step reads a value
back to the host.

DITTO's inner step is plain DDIM with eta noise, differentiable with respect
to the sample (the pipeline's outer loop differentiates the whole chain with
respect to the initial latents). It takes its noise already drawn
(`ditto_draws`), not a generator: the chain runs under
`torch.utils.checkpoint`, which restores the global RNG in the recompute but
not a generator passed in, so a draw inside the step would differ between
the forward and the recompute.

Under a mesh's sharded batch (`parallel.mesh.sharded_batch`) a step holds
this rank's rows of the batch: its draws are its rows of the whole batch's
draw, and the norms and the slerp's sums of DSG and DiffMusic, which run
over the whole batch tensor, are reduced over the dp ranks.
"""

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..parallel import mesh as pmesh
from ..tracing import annotate
from .schedule import DiffusionSchedule

LossFn = Callable[[torch.Tensor], torch.Tensor]  # pred_x0 latent -> scalar


def randn(shape, generator: Optional[torch.Generator], dtype, device) -> torch.Tensor:
    """A step's normal draw of the sample's shape (`parallel.mesh.batch_randn`:
    this rank's rows of the whole batch's draw under a sharded batch)."""
    return pmesh.batch_randn(shape, generator, dtype, device)


@dataclass(frozen=True)
class SamplerConfig:
    name: str = "diffmusic"
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


def _loss_and_grad_of_sample(schedule, eps, t, sample, loss_fn, scale=1.0):
    """(loss_fn(x0(x_t)) / scale, its gradient with respect to x_t, x0)."""
    with torch.enable_grad():
        s = sample.detach().requires_grad_(True)
        x0 = schedule.pred_original(eps.detach(), t, s)
        loss = loss_fn(x0) / scale
        with annotate("guided.backward"):
            (grad,) = torch.autograd.grad(loss, s)
    return loss.detach(), grad, x0.detach()


def _ddim_mean(a_prev, std, x0, eps):
    """sqrt(a_prev) x0 + sqrt(1 - a_prev - std^2) eps."""
    return (float(a_prev ** np.float32(0.5)) * x0
            + float((np.float32(1.0) - a_prev - std * std) ** np.float32(0.5)) * eps)


def ddim_step(schedule: DiffusionSchedule, cfg: SamplerConfig,
              eps: torch.Tensor, t: int, sample: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              loss_fn: Optional[LossFn] = None):
    """Plain (unguided) DDIM: prev = sqrt(a_prev) x0 + sqrt(1 - a_prev) eps.

    The loss slot holds the timestep as float32, as in the JAX step."""
    a_prev, _ = _common(schedule, t, cfg.num_inference_steps)
    x0 = schedule.pred_original(eps, t, sample)
    prev = _ddim_mean(a_prev, np.float32(0.0), x0, _recomposed_eps(schedule, t, sample, x0))
    return prev, x0, torch.full((), float(t), dtype=torch.float32, device=sample.device)


def dps_step(schedule: DiffusionSchedule, cfg: SamplerConfig,
             eps: torch.Tensor, t: int, sample: torch.Tensor,
             generator: Optional[torch.Generator], loss_fn: LossFn):
    """DPS: prev = DDIM(x_t) - rate * d rec_loss(x0(x_t)) / d x_t."""
    a_prev, var = _common(schedule, t, cfg.num_inference_steps)
    std = np.float32(cfg.eta) * var ** np.float32(0.5)
    loss, grad, x0 = _loss_and_grad_of_sample(schedule, eps, t, sample, loss_fn)
    prev = _ddim_mean(a_prev, std, x0, _recomposed_eps(schedule, t, sample, x0))
    if cfg.eta > 0:
        prev = prev + float(std) * randn(sample.shape, generator, sample.dtype,
                                         sample.device)
    prev = prev - cfg.ip_guidance_rate * grad
    return prev, x0, loss


def slerp(x0: torch.Tensor, x1: torch.Tensor, gamma: float,
          threshold: float = 0.9995) -> torch.Tensor:
    """Spherical interpolation between the flattened tensors, branch-free:
    lerp where the directions are near-(anti)parallel, chosen with
    `torch.where` over both results as the JAX package does, so that no value
    goes back to the host."""
    n0 = pmesh.batch_norm(x0)
    n1 = pmesh.batch_norm(x1)
    cos_theta = pmesh.batch_sum(((x0 / n0) * (x1 / n1)).sum())
    theta = torch.arccos(torch.clamp(cos_theta, -threshold, threshold))
    sin_theta = torch.sin(theta)
    w0 = torch.sin((1.0 - gamma) * theta) / sin_theta
    w1 = torch.sin(gamma * theta) / sin_theta
    lerp = x0 + gamma * (x1 - x0)
    return torch.where(torch.abs(cos_theta) > threshold, lerp, w0 * x0 + w1 * x1)


def mpgd_step(schedule: DiffusionSchedule, cfg: SamplerConfig,
              eps: torch.Tensor, t: int, sample: torch.Tensor,
              generator: Optional[torch.Generator], loss_fn: LossFn):
    """MPGD: guide x0-hat directly. The gradient is taken with respect to the
    detached x0-hat, which is updated before eps is recomposed from it."""
    a_prev, var = _common(schedule, t, cfg.num_inference_steps)
    std = np.float32(cfg.eta) * var ** np.float32(0.5)
    x0 = schedule.pred_original(eps.detach(), t, sample).detach()
    with torch.enable_grad():
        leaf = x0.requires_grad_(True)
        loss = loss_fn(leaf)
        with annotate("guided.backward"):
            (grad,) = torch.autograd.grad(loss, leaf)
    x0 = x0.detach() - cfg.ip_guidance_rate * grad
    prev = _ddim_mean(a_prev, std, x0, _recomposed_eps(schedule, t, sample, x0))
    if cfg.eta > 0:
        prev = prev + float(std) * randn(sample.shape, generator, sample.dtype,
                                         sample.device)
    return prev, x0, loss.detach()


def dsg_step(schedule: DiffusionSchedule, cfg: SamplerConfig,
             eps: torch.Tensor, t: int, sample: torch.Tensor,
             generator: Optional[torch.Generator], loss_fn: LossFn):
    """DSG: mix the noise and the guidance direction on the sphere of radius
    sqrt(numel) * std. The loss is divided by 1000 inside the gradient; the
    mean takes the raw eps; z is drawn at every step, whatever eta is, and
    the norms run over the whole batch tensor."""
    a_prev, var = _common(schedule, t, cfg.num_inference_steps)
    std = np.float32(cfg.eta) * var ** np.float32(0.5)
    scaled, grad, x0 = _loss_and_grad_of_sample(schedule, eps, t, sample, loss_fn, 1000.0)
    mean = _ddim_mean(a_prev, std, x0, eps.detach())
    numel = sample.numel() / sample.shape[0] if sample.ndim > 3 else pmesh.batch_numel(sample)
    r = float(np.sqrt(np.float32(numel)) * std)
    d_star = -r * grad / (pmesh.batch_norm(grad) + cfg.eps)
    d_sample = float(std) * randn(sample.shape, generator, sample.dtype, sample.device)
    mix = d_sample + cfg.ip_guidance_rate * (d_star - d_sample)
    prev = mean + r * mix / (pmesh.batch_norm(mix) + cfg.eps)
    return prev, x0, scaled * 1000.0


def diffmusic_step(schedule: DiffusionSchedule, cfg: SamplerConfig,
                   eps: torch.Tensor, t: int, sample: torch.Tensor,
                   generator: Optional[torch.Generator], loss_fn: LossFn):
    """DiffMusic: slerp-mix the noise z with the -gradient rescaled to |z|.
    The loss is divided by 1000 inside the gradient; the mean takes the raw
    eps; z is drawn at every step, whatever eta is."""
    a_prev, var = _common(schedule, t, cfg.num_inference_steps)
    std = np.float32(cfg.eta) * var ** np.float32(0.5)
    scaled, grad, x0 = _loss_and_grad_of_sample(schedule, eps, t, sample, loss_fn, 1000.0)
    mean = _ddim_mean(a_prev, std, x0, eps.detach())
    z = randn(sample.shape, generator, sample.dtype, sample.device)
    normalized_grad = (grad / (pmesh.batch_norm(grad) + cfg.eps)
                       * pmesh.batch_norm(z))
    prev = mean + float(std) * slerp(z, -normalized_grad, cfg.ip_guidance_rate)
    return prev, x0, scaled * 1000.0


def ditto_step(schedule: DiffusionSchedule, cfg: SamplerConfig,
               eps: torch.Tensor, t: int, sample: torch.Tensor,
               noise: Optional[torch.Tensor] = None, loss_fn: Optional[LossFn] = None):
    """DITTO's inner step: the DDIM mean from the recomposed eps, plus
    std * noise at eta > 0 (`noise` drawn beforehand by `ditto_draws`, and
    required there: JAX always draws); the loss, where a loss_fn is given, is
    taken on prev (0 otherwise). Nothing is detached."""
    if cfg.eta > 0 and noise is None:
        raise ValueError(f"ditto_step: eta {cfg.eta} needs its noise (ditto_draws)")
    a_prev, var = _common(schedule, t, cfg.num_inference_steps)
    std = np.float32(cfg.eta) * var ** np.float32(0.5)
    x0 = schedule.pred_original(eps, t, sample)
    prev = _ddim_mean(a_prev, std, x0, _recomposed_eps(schedule, t, sample, x0))
    if cfg.eta > 0:
        prev = prev + float(std) * noise
    loss = (loss_fn(prev) if loss_fn is not None
            else torch.zeros((), dtype=torch.float32, device=sample.device))
    return prev, x0, loss


def ditto_draws(cfg: SamplerConfig, shape, n: int, generator: Optional[torch.Generator],
                dtype, device) -> list:
    """The n steps' noise of a DITTO chain, drawn in step order before the
    chain runs; None for each step at eta 0 (no draw)."""
    if cfg.eta <= 0:
        return [None] * n
    return [randn(shape, generator, dtype, device) for _ in range(n)]


_GUIDED = {"dps": dps_step, "mpgd": mpgd_step, "dsg": dsg_step,
           "diffmusic": diffmusic_step}


def make_step_fn(schedule: DiffusionSchedule, cfg: SamplerConfig,
                 loss_fn: Optional[LossFn] = None):
    """Bind a sampler into `(eps, t, sample, generator) -> (prev, x0, loss)`;
    DITTO's step takes its drawn noise in the generator's place."""
    if cfg.name == "ddim":
        def step(eps, t, sample, generator=None):
            return ddim_step(schedule, cfg, eps, t, sample, generator)
        return step
    if cfg.name == "ditto":
        def step(eps, t, sample, noise=None):
            return ditto_step(schedule, cfg, eps, t, sample, noise, loss_fn)
        return step
    if cfg.name not in _GUIDED:
        raise ValueError(f"Unknown sampler {cfg.name!r}")
    if loss_fn is None:
        raise ValueError(f"Sampler '{cfg.name}' requires a loss_fn")
    raw = _GUIDED[cfg.name]

    def step(eps, t, sample, generator=None):
        return raw(schedule, cfg, eps, t, sample, generator, loss_fn)
    return step


@dataclass
class InverseProblemSchedulerOutput:
    """The reference's output record of a guided step (its
    schedulers/utils.py:8-16), for code that reads fields; the step
    functions themselves return (prev, x0, loss) tuples."""
    prev_sample: torch.Tensor
    pred_original_sample: Optional[torch.Tensor] = None
    loss: Optional[torch.Tensor] = None
    sample: Optional[torch.Tensor] = None
    encoder_hidden_states: Optional[torch.Tensor] = None
    encoder_hidden_states_1: Optional[torch.Tensor] = None
    init_latents: Optional[torch.Tensor] = None
