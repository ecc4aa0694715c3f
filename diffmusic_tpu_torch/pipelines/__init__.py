"""Pipelines (port of `diffmusic_tpu/pipelines`): MusicLDM and AudioLDM2."""

from .audioldm2 import AudioLDM2Pipeline
from .base import AudioPipelineOutput
from .musicldm import MusicLDMPipeline

__all__ = ["AudioLDM2Pipeline", "AudioPipelineOutput", "MusicLDMPipeline"]
