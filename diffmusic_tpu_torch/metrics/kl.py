"""KL divergence between softmax-ed audio embeddings.

Reference: diffmusic/metrics/kl.py:100-110 — embeddings of every clip in a
directory are CONCATENATED over the frame axis (`get_embeddings`,
kl.py:69-98: one (frames, D) array per clip, `np.concatenate(..., axis=0)`),
then per-FRAME softmax over features and
  kl_div((p + eps).log(), (q + eps), reduction="sum") / len(p)
with p = softmax(eval frames), q = softmax(background frames), eps = 1e-6.
torch.nn.functional.kl_div(input, target, "sum") = sum(target * (log(target)
- input)), so the score is
  sum_{frames, feats} (q + eps) * (log(q + eps) - log(p + eps)) / N_eval_frames.
Parity vs a torch replication at 1e-6: tests/test_metrics.py
(TestKLReferenceParity).

A copy of `diffmusic_tpu/metrics/kl.py` (numpy only): the JAX package's
`metrics/__init__.py` imports jax, so the port keeps its own.
"""

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np


def _softmax(x, axis=-1):
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def kl_from_embeddings(embds_eval: np.ndarray, embds_background: np.ndarray,
                       eps: float = 1e-6) -> float:
    """Reference calculate_kl (kl.py:100-110) on (frames, D) arrays."""
    p = _softmax(np.asarray(embds_eval, np.float32))
    q = _softmax(np.asarray(embds_background, np.float32))
    if p.shape != q.shape:
        # torch.kl_div broadcasts like binary elementwise ops; unequal frame
        # counts (neither 1) raise there too — fail with a clearer message
        raise ValueError(
            f"eval/background frame counts differ ({p.shape} vs {q.shape}); "
            f"the reference formula requires aligned directories")
    kl = np.sum((q + eps) * (np.log(q + eps) - np.log(p + eps)))
    return float(kl / len(p))


@dataclass
class KullbackLeiblerDivergence:
    embed_fn: Optional[Callable] = None

    def __post_init__(self):
        if self.embed_fn is None:
            from .embeddings import MFCCStackEmbedding
            self.embed_fn = MFCCStackEmbedding()

    def _concat_embeddings(self, clips: Sequence[np.ndarray]) -> np.ndarray:
        # reference get_embeddings (kl.py:69-98): per-clip (frames, D)
        # embeddings concatenated over the frame axis, NOT pooled per clip
        return np.concatenate(
            [np.atleast_2d(self.embed_fn(np.asarray(c).reshape(-1)))
             for c in clips], axis=0)

    def score(self, background: Sequence[np.ndarray],
              eval_set: Sequence[np.ndarray]) -> float:
        if len(background) == 0 or len(eval_set) == 0:
            return -1.0  # reference empty-dir sentinel (kl.py:156-161)
        embds_background = self._concat_embeddings(background)
        embds_eval = self._concat_embeddings(eval_set)
        return kl_from_embeddings(embds_eval, embds_background)
