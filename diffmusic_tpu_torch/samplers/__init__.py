"""DDIM schedule and guided step functions (port of `diffmusic_tpu/samplers`)."""

from .schedule import DiffusionSchedule
from .steps import (InverseProblemSchedulerOutput, SamplerConfig, ddim_step, diffmusic_step,
                    ditto_draws, ditto_step, dps_step, dsg_step, make_step_fn, mpgd_step,
                    slerp)

SCHEDULER_REGISTRY = ("ddim", "dps", "mpgd", "dsg", "diffmusic", "ditto")


def get_scheduler(scheduler_name: str) -> str:
    """The scheduler name, checked against `SCHEDULER_REGISTRY` (the samplers
    are functions that `make_step_fn` selects by name)."""
    if scheduler_name not in SCHEDULER_REGISTRY:
        raise ValueError(f"Unknown scheduler: {scheduler_name}")
    return scheduler_name


__all__ = ["DiffusionSchedule", "InverseProblemSchedulerOutput", "SCHEDULER_REGISTRY",
           "SamplerConfig", "ddim_step", "diffmusic_step", "ditto_draws", "ditto_step",
           "dps_step", "dsg_step", "get_scheduler", "make_step_fn", "mpgd_step", "slerp"]
