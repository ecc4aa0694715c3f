"""The plain reference of the DDIM schedule and of the DDIM, DPS and
DiffMusic steps. A frozen copy of the mathematics of
`diffmusic_tpu_torch/samplers/{schedule,steps}.py` on one device with no
mesh. It imports nothing of the port.

The step functions take the sampler's elementwise algebra dtype (`dt`):
float32 for the reference, bfloat16 for its control.
"""

import numpy as np
import torch


class Schedule:
    """diffusers' DDIMScheduler tables: `cfg` is the configuration file's
    "scheduler" group (scaled-linear betas, leading spacing)."""

    def __init__(self, cfg: dict):
        n = cfg["num_train_timesteps"]
        if cfg["beta_schedule"] != "scaled_linear" or cfg["timestep_spacing"] != "leading":
            raise ValueError("the reference schedule is scaled-linear with leading spacing")
        betas = np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5, n,
                            dtype=np.float64) ** 2
        self.n, self.offset = n, cfg["steps_offset"]
        self.ac = np.cumprod(1.0 - betas).astype(np.float32)
        self.final = np.float32(1.0) if cfg["set_alpha_to_one"] else self.ac[0]

    def timesteps(self, steps: int) -> np.ndarray:
        ratio = self.n // steps
        return (np.arange(0, steps) * ratio).round()[::-1].astype(np.int32) + self.offset

    def alpha(self, t: int) -> np.float32:
        return self.ac[int(np.clip(t, 0, self.n - 1))]

    def alpha_prev(self, t: int, steps: int) -> np.float32:
        tp = t - self.n // steps
        return self.alpha(tp) if tp >= 0 else np.float32(self.final)

    def variance(self, t: int, steps: int) -> np.float32:
        a_t, a_p = self.alpha(t), self.alpha_prev(t, steps)
        return ((np.float32(1.0) - a_p) / (np.float32(1.0) - a_t)) * (np.float32(1.0) - a_t / a_p)

    def x0(self, eps, t, x):
        a = self.alpha(t)
        return ((x - float((np.float32(1.0) - a) ** np.float32(0.5)) * eps)
                / float(a ** np.float32(0.5)))


def _mean(a_prev, std, x0, eps):
    return (float(a_prev ** np.float32(0.5)) * x0
            + float((np.float32(1.0) - a_prev - std * std) ** np.float32(0.5)) * eps)


def _recomposed(sched, t, x, x0):
    a = sched.alpha(t)
    return (x - float(a ** np.float32(0.5)) * x0) / float((np.float32(1.0) - a) ** np.float32(0.5))


def ddim(sched: Schedule, steps: int, eps, t: int, x, dt=torch.float32):
    eps, x = eps.to(dt), x.to(dt)
    x0 = sched.x0(eps, t, x)
    return _mean(sched.alpha_prev(t, steps), np.float32(0.0), x0,
                 _recomposed(sched, t, x, x0)).float()


# the steps that divide the loss by 1000 inside its gradient (DiffMusic then
# rescales the direction to |z|, so only the gradient's rounding sees it)
LOSS_SCALE = {"diffmusic": 1000.0}


def loss_scale(sampler: str) -> float:
    return LOSS_SCALE.get(sampler, 1.0)


def loss_and_grad(sched, eps, t, x, loss_fn, scale=1.0):
    """(loss(x0(x_t)) / scale, its gradient with respect to x_t, x0), fp32."""
    with torch.enable_grad():
        s = x.detach().float().requires_grad_(True)
        x0 = sched.x0(eps.detach().float(), t, s)
        loss = loss_fn(x0) / scale
        (grad,) = torch.autograd.grad(loss, s)
    return loss.detach(), grad, x0.detach()


def dps(sched, steps, eps, t, x, grad, x0, eta, rate, dt=torch.float32):
    """DPS at eta 0: the DDIM mean from the recomposed eps, minus rate times
    the gradient (grad, x0 from `loss_and_grad`)."""
    if eta != 0:
        raise ValueError("the reference DPS step is the eta-0 one the traffic runs")
    x, x0, grad = x.to(dt), x0.to(dt), grad.to(dt)
    prev = _mean(sched.alpha_prev(t, steps), np.float32(0.0), x0, _recomposed(sched, t, x, x0))
    return (prev - rate * grad).float()


def slerp(x0, x1, gamma, threshold=0.9995):
    n0, n1 = torch.linalg.vector_norm(x0), torch.linalg.vector_norm(x1)
    cos = ((x0 / n0) * (x1 / n1)).sum()
    theta = torch.arccos(torch.clamp(cos, -threshold, threshold))
    s = torch.sin(theta)
    w0, w1 = torch.sin((1.0 - gamma) * theta) / s, torch.sin(gamma * theta) / s
    return torch.where(torch.abs(cos) > threshold, x0 + gamma * (x1 - x0), w0 * x0 + w1 * x1)


def diffmusic(sched, steps, eps, t, x, grad, x0, z, eta, rate, dt=torch.float32, eps_norm=1e-8):
    """DiffMusic: the DDIM mean from the raw eps, plus std times the slerp of
    the draw z towards the negative gradient rescaled to |z|."""
    eps, x0, grad, z = eps.to(dt), x0.to(dt), grad.to(dt), z.to(dt)
    std = np.float32(eta) * sched.variance(t, steps) ** np.float32(0.5)
    mean = _mean(sched.alpha_prev(t, steps), std, x0, eps)
    ng = grad / (torch.linalg.vector_norm(grad) + eps_norm) * torch.linalg.vector_norm(z)
    return (mean + float(std) * slerp(z, -ng, rate)).float()
