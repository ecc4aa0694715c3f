"""Degradation operators and noise models (port of `diffmusic_tpu/inverse_problem`)."""

from .noise import BaseNoise, GaussianNoise, PoissonNoise, get_noiser
from .operator import (BaseOperator, IdentityOperator, MusicDereverberationOperator,
                       MusicInpaintingOperator, PhaseRetrievalOperator,
                       StyleGuidanceOperator, SuperResolutionOperator)

__all__ = [
    "BaseNoise", "GaussianNoise", "PoissonNoise", "get_noiser",
    "BaseOperator", "IdentityOperator", "MusicInpaintingOperator",
    "PhaseRetrievalOperator", "SuperResolutionOperator",
    "MusicDereverberationOperator", "StyleGuidanceOperator",
]
