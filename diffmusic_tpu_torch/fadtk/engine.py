"""fadtk-equivalent FAD engine: per-file embedding caches, mu/Sigma stats
bundles, score / score_inf / score_individual.

Port of `diffmusic_tpu/fadtk/engine.py` without its mesh (one card).
Reference: fadtk/fad.py (cache layout fadtk/utils.py:60-68; FAD-inf
extrapolation fad.py:303-350; per-song scores fad.py:352-394). Files are
embedded one call each, in name order, and each embedding is cached as
`<dir>/embeddings/<model>/<stem>.npy`; a cached file is not embedded again.
"""

import csv
from pathlib import Path

import numpy as np
import torch

from ..data import read_audio
from ..metrics.frechet import _stats, frechet_distance
from ..ops.resample import resample

# formats the engine scores directly (wav, and compressed audio through the
# native decoders of data/codecs.py)
AUDIO_EXTENSIONS = (".wav", ".mp3", ".opus", ".ogg")


def _audio_files(directory: Path):
    return sorted(p for p in Path(directory).iterdir()
                  if p.suffix.lower() in AUDIO_EXTENSIONS)


def cache_path(audio_path: Path, model_name: str) -> Path:
    """fadtk cache convention: <dir>/embeddings/<model>/<stem>.npy
    (fadtk/utils.py:60-68)."""
    audio_path = Path(audio_path)
    return audio_path.parent / "embeddings" / model_name / (audio_path.stem + ".npy")


def _load_16k(path) -> np.ndarray:
    """A file as mono float32 at 16 kHz (the port's resampler, on the host)."""
    wav, sr = read_audio(path)
    wav = wav.mean(axis=0)
    if sr != 16000:
        with torch.no_grad():
            wav = resample(torch.from_numpy(wav[None].astype(np.float32)), sr, 16000).numpy()[0]
    return wav.astype(np.float32)


def cache_embedding_files(directory, model) -> int:
    """Embed every audio file of `directory` that has no cache yet, caching
    <dir>/embeddings/<model>/*.npy. Returns the number of files newly
    embedded (fadtk's idempotence, fad.py:193-200)."""
    directory = Path(directory)
    load = getattr(model, "load_wav", _load_16k)
    todo = [f for f in _audio_files(directory)
            if not cache_path(f, model.name).exists()]
    if not todo:
        return 0
    # load the model before decoding: load_wav resamples to model.sr
    if hasattr(model, "loaded") and not model.loaded:
        model.load_model()
        model.loaded = True
    for f in todo:
        cache_path(f, model.name).parent.mkdir(parents=True, exist_ok=True)
    for f in todo:
        np.save(cache_path(f, model.name), model(load(f)))
    return len(todo)


class FADEngine:
    """FAD over directories with `model` (a `ModelLoader` or a callable with
    a `name`: waveform -> (frames, dim))."""

    def __init__(self, model):
        self.model = model

    def _dir_embeddings(self, directory) -> np.ndarray:
        directory = Path(directory)
        cache_embedding_files(directory, self.model)
        embs = [np.load(p) for p in sorted(
            (directory / "embeddings" / self.model.name).glob("*.npy"))]
        if not embs:
            raise FileNotFoundError(f"no audio embeddings under {directory}")
        return np.concatenate(embs, axis=0)

    def stats(self, directory):
        return _stats(self._dir_embeddings(directory))

    def save_stats(self, directory, out_npz):
        mu, cov = self.stats(directory)
        np.savez(out_npz, mu=mu, cov=cov)

    def _baseline(self, baseline_dir):
        """(mu, cov) of a directory, or of a precomputed .npz stats bundle."""
        if str(baseline_dir).endswith(".npz"):
            z = np.load(baseline_dir)
            return z["mu"], z["cov"]
        return self.stats(baseline_dir)

    def score(self, baseline_dir, eval_dir) -> float:
        """FAD between two directories (fadtk/fad.py:291-301)."""
        mu_b, cov_b = self._baseline(baseline_dir)
        mu_e, cov_e = self.stats(eval_dir)
        return frechet_distance(mu_b, cov_b, mu_e, cov_e)

    def score_inf(self, baseline_dir, eval_dir, steps: int = 25,
                  min_n: int = 500) -> tuple[float, float]:
        """FAD-inf: linear extrapolation of FAD vs 1/n to n -> inf
        (fadtk/fad.py:303-350). Returns (fad_inf_intercept, slope)."""
        mu_b, cov_b = self._baseline(baseline_dir)
        embs = self._dir_embeddings(eval_dir)
        total = embs.shape[0]
        min_n = min(min_n, max(2, total // 2))
        rng = np.random.default_rng(0)
        xs, ys = [], []
        for n in np.linspace(min_n, total, steps).astype(int):
            idx = rng.choice(total, size=n, replace=False)
            mu_e, cov_e = _stats(embs[idx])
            xs.append(1.0 / n)
            ys.append(frechet_distance(mu_b, cov_b, mu_e, cov_e))
        slope, intercept = np.polyfit(xs, ys, 1)
        return float(intercept), float(slope)

    def score_individual(self, baseline_dir, eval_dir, csv_out) -> Path:
        """Per-song FAD CSV (fadtk/fad.py:352-394)."""
        mu_b, cov_b = self._baseline(baseline_dir)
        eval_dir = Path(eval_dir)
        cache_embedding_files(eval_dir, self.model)
        rows = []
        for f in sorted((eval_dir / "embeddings" / self.model.name).glob("*.npy")):
            emb = np.load(f)
            if emb.shape[0] < 2:
                emb = np.repeat(emb, 2, axis=0)
            mu_e, cov_e = _stats(emb)
            rows.append((f.stem, frechet_distance(mu_b, cov_b, mu_e, cov_e)))
        csv_out = Path(csv_out)
        with open(csv_out, "w", newline="") as fh:
            csv.writer(fh).writerows(rows)
        return csv_out
