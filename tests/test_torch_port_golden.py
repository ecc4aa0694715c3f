"""The port's metrics (`diffmusic_tpu_torch.metrics`, on the CPU) on the
golden-regression fixtures of `tests/test_golden_regression.py`, against
`tests/golden_scores.json`'s `fad_mfcc_stack`, `kl`, `lsd` and `mse` within
that file's 5 % (fadtk/test/__main__.py:93). The JAX file is in the slow
tier (its MFCC embedder compiles); this one runs no JAX, so it stays in the
fast tier. The fixtures are a copy of its `_fixture_sets`.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from diffmusic_tpu_torch.metrics import (FrechetAudioDistance, KullbackLeiblerDivergence,
                                         LogSpectralDistance, MeanSquaredError,
                                         MFCCStackEmbedding)

GOLDEN_PATH = Path(__file__).parent / "golden_scores.json"
TOLERANCE = 0.05


def _fixture_sets():
    sr = 16000

    def clip(freqs, noise, seed_shift=0):
        t = np.arange(sr * 2) / sr
        w = sum(0.2 * np.sin(2 * np.pi * f * t) for f in freqs)
        w = w + noise * np.random.default_rng(seed_shift).standard_normal(len(t))
        return w.astype(np.float32)

    gt = [clip((220, 440), 0.01, i) for i in range(4)]
    recon = [clip((225, 445), 0.02, 100 + i) for i in range(4)]
    return gt, recon


@pytest.fixture(scope="module")
def scores():
    gt, recon = _fixture_sets()
    embed = MFCCStackEmbedding("cpu")
    return {"fad_mfcc_stack": FrechetAudioDistance(embed).score(gt, recon),
            "kl": KullbackLeiblerDivergence(embed).score(gt, recon),
            "lsd": LogSpectralDistance().score(gt, recon),
            "mse": MeanSquaredError().score(gt, recon)}


@pytest.mark.parametrize("key", ["fad_mfcc_stack", "kl", "lsd", "mse"])
def test_port_scores_within_5pct_of_golden(scores, key):
    want = json.loads(GOLDEN_PATH.read_text())[key]
    got = scores[key]
    assert np.isfinite(got) and abs(got - want) < TOLERANCE * abs(want), (key, got, want)
