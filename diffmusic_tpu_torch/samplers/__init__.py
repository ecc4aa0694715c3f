"""DDIM schedule and guided step functions (port of `diffmusic_tpu/samplers`)."""

from .schedule import DiffusionSchedule
from .steps import (SamplerConfig, ddim_step, diffmusic_step, ditto_draws, ditto_step,
                    dps_step, dsg_step, make_step_fn, mpgd_step, slerp)

__all__ = ["DiffusionSchedule", "SamplerConfig", "ddim_step", "diffmusic_step",
           "ditto_draws", "ditto_step", "dps_step", "dsg_step", "make_step_fn",
           "mpgd_step", "slerp"]
