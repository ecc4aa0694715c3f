"""EDM DPM-Solver++ (2M), StableAudio's sampler (port of
`diffmusic_tpu/samplers/edm.py`).

The JAX package scans the steps with `lax.scan`; here they are a Python loop.
The port follows the JAX package, not diffusers' current
EDMDPMSolverMultistepScheduler: the Karras sigma table with a trailing 0, the
model fed c_noise = 0.25 log(sigma) (fp32, not sigma and not an integer
timestep), the first step first-order, the final sigma = 0 step returning x0.

  c_skip = sd^2 / (s^2 + sd^2); c_out = +-s sd / sqrt(s^2 + sd^2)
  (negative under v_prediction); c_in = 1 / sqrt(s^2 + sd^2)
  x0_i = c_skip x + c_out F(x / sqrt(s^2 + sd^2), c_noise)
  x_{i+1} = (s_{i+1} / s_i) x - expm1(-h_i) D_i, h_i = log s_i - log s_{i+1},
  D_i = (1 + 1 / (2 r_i)) x0_i - 1 / (2 r_i) x0_{i-1}, r_i = h_{i-1} / h_i

The solver's scalars are fp32, computed once a call on the host as fp32
tensors (as JAX computes them in the scan), and the latents' algebra is fp32
whatever the model's dtype.
"""

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


@dataclass(frozen=True)
class EDMDPMSolverMultistepSchedule:
    sigma_min: float = 0.3
    sigma_max: float = 500.0
    sigma_data: float = 1.0
    rho: float = 7.0
    solver_order: int = 2
    prediction_type: str = "v_prediction"

    def sigmas(self, num_inference_steps: int) -> np.ndarray:
        """Karras rho-spaced sigma table, descending, with a trailing 0:
        float64, stored as float32."""
        ramp = np.linspace(0, 1, num_inference_steps, dtype=np.float64)
        inv_rho = 1.0 / self.rho
        s = (self.sigma_max ** inv_rho
             + ramp * (self.sigma_min ** inv_rho - self.sigma_max ** inv_rho)) ** self.rho
        return np.append(s, 0.0).astype(np.float32)

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """c_noise fed to the model as its `timestep`: 0.25 * log(sigma), fp32."""
        return 0.25 * np.log(self.sigmas(num_inference_steps)[:-1])

    def scale_input(self, sample, sigma):
        return sample / torch.sqrt(torch.as_tensor(sigma) ** 2 + self.sigma_data ** 2)

    def precondition_coefficients(self, sigma: torch.Tensor):
        """(c_skip, c_out) of sigma (a tensor)."""
        sd = self.sigma_data
        c_skip = sd ** 2 / (sigma ** 2 + sd ** 2)
        if self.prediction_type == "epsilon":
            c_out = sigma * sd / torch.sqrt(sigma ** 2 + sd ** 2)
        elif self.prediction_type == "v_prediction":
            c_out = -sigma * sd / torch.sqrt(sigma ** 2 + sd ** 2)
        else:
            raise ValueError(f"Unsupported prediction_type: {self.prediction_type}")
        return c_skip, c_out

    def precondition_outputs(self, sample, model_output, sigma):
        """x0-hat from the raw network output under EDM preconditioning."""
        c_skip, c_out = self.precondition_coefficients(torch.as_tensor(sigma))
        return c_skip * sample + c_out * model_output


def dpm_solver_d(x0, x0_prev, r: float, first: bool):
    """DPM-Solver++ 2M's D_i. The first step has no x0 history and is
    first-order, D_0 = x0 (diffusers' warm-up for order 2)."""
    if first:
        return x0
    return (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * x0_prev


def solver_scalars(schedule: EDMDPMSolverMultistepSchedule, num_inference_steps: int) -> dict:
    """Every step's fp32 scalars as Python floats (exact fp32 values), from
    fp32 tensor algebra: the input scale's divisor, c_skip, c_out, c_noise,
    s_next / s, expm1(-h), r, and whether the step ends at sigma 0. The logs
    are floored at 1e-10, so the final sigma = 0 gives finite h."""
    sig = torch.from_numpy(schedule.sigmas(num_inference_steps))
    s, s_next = sig[:-1], sig[1:]
    lam = torch.log(torch.clamp(s, min=1e-10))
    lam_next = torch.log(torch.clamp(s_next, min=1e-10))
    h = lam - lam_next
    lam_prev = torch.log(torch.clamp(sig[torch.clamp(torch.arange(len(s)) - 1, min=0)],
                                     min=1e-10))
    r = (lam_prev - lam) / torch.clamp(h, min=1e-10)
    r[0] = 1.0
    c_skip, c_out = schedule.precondition_coefficients(s)
    return {"sigma0": float(sig[0]),
            "divisor": torch.sqrt(s ** 2 + schedule.sigma_data ** 2).tolist(),
            "c_skip": c_skip.tolist(), "c_out": c_out.tolist(),
            "c_noise": schedule.timesteps(num_inference_steps).tolist(),
            "ratio": (s_next / s).tolist(), "expm1": torch.expm1(-h).tolist(),
            "r": r.tolist(), "final": (s_next == 0).tolist()}


def make_edm_sampler(schedule: EDMDPMSolverMultistepSchedule, num_inference_steps: int,
                     model_fn: Callable) -> Callable:
    """`sample(latents) -> final latents (fp32)` by DPM-Solver++ 2M.

    model_fn(scaled sample (fp32), c_noise (a Python float, fp32 exact)) ->
    the raw network output. The latents are scaled by sigma_0 first."""
    sc = solver_scalars(schedule, num_inference_steps)

    def sample(latents):
        x = latents.float() * sc["sigma0"]
        x0_prev = torch.zeros_like(x)
        for i in range(num_inference_steps):
            out = model_fn(x / sc["divisor"][i], sc["c_noise"][i])
            x0 = sc["c_skip"][i] * x + sc["c_out"][i] * out.float()
            d = dpm_solver_d(x0, x0_prev, sc["r"][i], i == 0)
            x = x0 if sc["final"][i] else sc["ratio"][i] * x - sc["expm1"][i] * d
            x0_prev = x0
        return x

    return sample
