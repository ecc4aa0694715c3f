"""Pipelines (port of `diffmusic_tpu/pipelines`): MusicLDM, AudioLDM2 and
StableAudio."""

from .audioldm2 import AudioLDM2Pipeline
from .base import AudioPipelineOutput
from .musicldm import MusicLDMPipeline
from .stable_audio import StableAudioPipeline


def get_pipeline(pip_name: str):
    """The pipeline class of a `-m` name, as the JAX package's factory
    (reachable StableAudio included)."""
    if pip_name == "musicldm":
        return MusicLDMPipeline
    if pip_name == "audioldm2":
        return AudioLDM2Pipeline
    if pip_name == "stable_audio":
        return StableAudioPipeline
    raise ValueError(f"Unknown pipeline: {pip_name}")


__all__ = ["AudioLDM2Pipeline", "AudioPipelineOutput", "MusicLDMPipeline",
           "StableAudioPipeline", "get_pipeline"]
