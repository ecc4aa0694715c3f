"""Frechet Audio Distance with a numerically stable matrix sqrt.

Reference math: diffmusic/metrics/fad.py:107-163 (scipy sqrtm + NaN sanitization)
and fadtk/fad.py:50-119 (eigen-decomposition workaround). Here the sqrt uses the
symmetric eigendecomposition of sigma1^(1/2) sigma2 sigma1^(1/2), which is stable
without the NaN patching the reference needs.

A copy of `diffmusic_tpu/metrics/frechet.py` (numpy only): the JAX package's
`metrics/__init__.py` imports jax, so the port keeps its own.
"""

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np


def _stats(embeddings: np.ndarray):
    mu = embeddings.mean(axis=0)
    sigma = np.cov(embeddings, rowvar=False)
    return mu, np.atleast_2d(sigma)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FD(N(mu1, s1), N(mu2, s2)) = |mu1-mu2|^2 + tr(s1 + s2 - 2 (s1 s2)^(1/2))."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1 = np.asarray(sigma1, np.float64)
    sigma2 = np.asarray(sigma2, np.float64)

    diff = mu1 - mu2

    # sqrt of s1 via symmetric eigendecomposition
    w1, v1 = np.linalg.eigh(sigma1)
    w1 = np.maximum(w1, 0.0)
    s1_half = (v1 * np.sqrt(w1)[None, :]) @ v1.T

    inner = s1_half @ sigma2 @ s1_half
    w, _ = np.linalg.eigh(inner)
    w = np.maximum(w, 0.0)
    tr_covmean = np.sum(np.sqrt(w))

    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * tr_covmean)


@dataclass
class FrechetAudioDistance:
    """score(background_waveforms, eval_waveforms) -> FAD, with per-clip embedding
    via a pluggable model (reference FrechetAudioDistance.score,
    metrics/fad.py:165-227)."""
    embed_fn: Optional[Callable] = None
    verbose: bool = False

    def __post_init__(self):
        if self.embed_fn is None:
            from .embeddings import MFCCStackEmbedding
            self.embed_fn = MFCCStackEmbedding()

    def embeddings(self, waveforms: Sequence[np.ndarray]) -> np.ndarray:
        embs = [self.embed_fn(np.asarray(w).reshape(-1)) for w in waveforms]
        return np.concatenate(embs, axis=0)

    def score(self, background: Sequence[np.ndarray],
              eval_set: Sequence[np.ndarray]) -> float:
        mu_bg, s_bg = _stats(self.embeddings(background))
        mu_ev, s_ev = _stats(self.embeddings(eval_set))
        return frechet_distance(mu_bg, s_bg, mu_ev, s_ev)

    def score_from_stats(self, stats_npz_path, eval_set) -> float:
        z = np.load(stats_npz_path)
        mu_ev, s_ev = _stats(self.embeddings(eval_set))
        return frechet_distance(z["mu"], z["cov"], mu_ev, s_ev)
