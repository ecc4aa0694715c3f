"""Degradation operators and noise models (port of `diffmusic_tpu/inverse_problem`)."""

from .noise import BaseNoise, GaussianNoise
from .operator import BaseOperator, IdentityOperator, MusicInpaintingOperator

__all__ = ["BaseNoise", "GaussianNoise", "BaseOperator", "IdentityOperator",
           "MusicInpaintingOperator"]
