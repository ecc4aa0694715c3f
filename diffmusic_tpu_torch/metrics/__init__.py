"""FAD / KL / LSD / MSE metrics and the embedders (port of
`diffmusic_tpu/metrics`)."""

from .embeddings import MFCCStackEmbedding, get_embedding_model
from .frechet import FrechetAudioDistance, frechet_distance
from .kl import KullbackLeiblerDivergence
from .lsd import LogSpectralDistance
from .mse import MeanSquaredError

__all__ = ["frechet_distance", "FrechetAudioDistance",
           "KullbackLeiblerDivergence", "LogSpectralDistance",
           "MeanSquaredError", "MFCCStackEmbedding", "get_embedding_model"]
