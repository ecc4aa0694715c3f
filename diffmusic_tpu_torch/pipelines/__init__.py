"""Pipelines (port of `diffmusic_tpu/pipelines`): MusicLDM so far."""

from .base import AudioPipelineOutput
from .musicldm import MusicLDMPipeline

__all__ = ["AudioPipelineOutput", "MusicLDMPipeline"]
