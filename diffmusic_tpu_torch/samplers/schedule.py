"""DDIM noise schedule (port of `diffmusic_tpu/samplers/schedule.py`).

The tables are numpy; timesteps are host ints because the port's denoise loop
is a Python loop, so every lookup is a float32 scalar computed on the host in
the same float32 arithmetic as the JAX package.
"""

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class DiffusionSchedule:
    num_train_timesteps: int = 1000
    beta_start: float = 0.0015
    beta_end: float = 0.0195
    beta_schedule: str = "scaled_linear"
    set_alpha_to_one: bool = False
    steps_offset: int = 1
    timestep_spacing: str = "leading"
    prediction_type: str = "epsilon"
    alphas_cumprod: np.ndarray = field(init=False, repr=False)
    final_alpha_cumprod: float = field(init=False)

    def __post_init__(self):
        n = self.num_train_timesteps
        if self.beta_schedule == "linear":
            betas = np.linspace(self.beta_start, self.beta_end, n, dtype=np.float64)
        elif self.beta_schedule == "scaled_linear":
            betas = np.linspace(self.beta_start ** 0.5, self.beta_end ** 0.5, n,
                                dtype=np.float64) ** 2
        else:
            raise ValueError(f"Unsupported beta_schedule: {self.beta_schedule}")
        ac = np.cumprod(1.0 - betas).astype(np.float32)
        object.__setattr__(self, "alphas_cumprod", ac)
        object.__setattr__(self, "final_alpha_cumprod",
                           1.0 if self.set_alpha_to_one else float(ac[0]))

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Descending inference timesteps with `leading` spacing + steps_offset."""
        n = self.num_train_timesteps
        if self.timestep_spacing == "leading":
            step_ratio = n // num_inference_steps
            ts = (np.arange(0, num_inference_steps) * step_ratio).round()
            ts = ts[::-1].copy().astype(np.int32) + self.steps_offset
        elif self.timestep_spacing == "trailing":
            step_ratio = n / num_inference_steps
            ts = np.round(np.arange(n, 0, -step_ratio)).astype(np.int32) - 1
        else:
            raise ValueError(f"Unsupported timestep_spacing: {self.timestep_spacing}")
        return ts

    def step_ratio(self, num_inference_steps: int) -> int:
        return self.num_train_timesteps // num_inference_steps

    def alpha_prod(self, t: int) -> np.float32:
        return self.alphas_cumprod[int(np.clip(t, 0, self.num_train_timesteps - 1))]

    def alpha_prod_prev(self, t_prev: int) -> np.float32:
        if t_prev >= 0:
            return self.alpha_prod(t_prev)
        return np.float32(self.final_alpha_cumprod)

    def variance(self, t: int, t_prev: int) -> np.float32:
        """DDIM posterior variance (diffusers DDIMScheduler._get_variance)."""
        a_t = self.alpha_prod(t)
        a_prev = self.alpha_prod_prev(t_prev)
        b_t = np.float32(1.0) - a_t
        b_prev = np.float32(1.0) - a_prev
        return (b_prev / b_t) * (np.float32(1.0) - a_t / a_prev)

    def pred_original(self, eps, t: int, sample):
        """x0-hat for epsilon prediction: (x_t - sqrt(1-a_t) eps) / sqrt(a_t)."""
        a_t = self.alpha_prod(t)
        return ((sample - float((np.float32(1.0) - a_t) ** np.float32(0.5)) * eps)
                / float(a_t ** np.float32(0.5)))
