"""Pipelines (port of `diffmusic_tpu/pipelines`): MusicLDM, AudioLDM2 and
StableAudio."""

from .audioldm2 import AudioLDM2Pipeline
from .base import AudioPipelineOutput
from .musicldm import MusicLDMPipeline
from .stable_audio import StableAudioPipeline

__all__ = ["AudioLDM2Pipeline", "AudioPipelineOutput", "MusicLDMPipeline",
           "StableAudioPipeline"]
