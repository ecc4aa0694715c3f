"""Streaming statistics (reference: fadtk/utils.py).

`merge_stats` is the single-pass parallel mean/covariance merge the reference
uses to combine per-file embedding stats without concatenating all embeddings in
memory (fadtk/utils.py:19-46, Chan et al. parallel-variance formulas).

A copy of `diffmusic_tpu/fadtk/utils.py` (numpy only).
"""

from pathlib import Path
from typing import Iterable, Tuple

import numpy as np


def stats_of(emb: np.ndarray) -> Tuple[int, np.ndarray, np.ndarray]:
    """(n, mean, M2) where M2 is the sum of outer-product deviations."""
    emb = np.asarray(emb, np.float64)
    n = emb.shape[0]
    mu = emb.mean(axis=0)
    d = emb - mu
    return n, mu, d.T @ d


def merge_pair(a, b):
    n1, mu1, m1 = a
    n2, mu2, m2 = b
    n = n1 + n2
    delta = mu2 - mu1
    mu = mu1 + delta * (n2 / n)
    m = m1 + m2 + np.outer(delta, delta) * (n1 * n2 / n)
    return n, mu, m


def merge_stats(chunks: Iterable[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Streaming mean/cov over embedding chunks -> (mu, cov) with the same
    result as np.cov over the concatenation (ddof=1, like fadtk)."""
    acc = None
    for chunk in chunks:
        s = stats_of(chunk)
        acc = s if acc is None else merge_pair(acc, s)
    if acc is None:
        raise ValueError("no embedding chunks")
    n, mu, m2 = acc
    cov = m2 / max(n - 1, 1)
    return mu, cov


def stats_from_npy_dir(directory) -> Tuple[np.ndarray, np.ndarray]:
    """Streaming stats over <dir>/*.npy without loading all files at once."""
    files = sorted(Path(directory).glob("*.npy"))
    return merge_stats(np.load(f) for f in files)



def get_cache_embedding_path(audio_path, model_name: str) -> Path:
    """fadtk cache convention <dir>/embeddings/<model>/<stem>.npy
    (fadtk/utils.py:60-68)."""
    audio_path = Path(audio_path)
    return audio_path.parent / "embeddings" / model_name / (audio_path.stem + ".npy")
