"""fadtk-equivalent FAD engine: per-file embedding caches, mu/Sigma stats
bundles, score / score_inf / score_individual.

Port of `diffmusic_tpu/fadtk/engine.py`. Reference: fadtk/fad.py (cache
layout fadtk/utils.py:60-68; FAD-inf extrapolation fad.py:303-350; per-song
scores fad.py:352-394). Files are embedded one call each, in name order, and
each embedding is cached as `<dir>/embeddings/<model>/<stem>.npy`; a cached
file is not embedded again. With a mesh (`parallel/mesh.py`), a model that
has `batch_embed` embeds each group of equal-length files in one call,
dp-sharded over the mesh's ranks, as the JAX package does; rank 0 writes
the caches.
"""

import csv
from pathlib import Path

import numpy as np
import torch

from ..data import read_audio
from ..metrics.frechet import _stats, frechet_distance
from ..ops.resample import resample
from ..parallel.mesh import leads
from .utils import get_cache_embedding_path

# formats the engine scores directly (wav, and compressed audio through the
# native decoders of data/codecs.py)
AUDIO_EXTENSIONS = (".wav", ".mp3", ".opus", ".ogg")


def _audio_files(directory: Path):
    return sorted(p for p in Path(directory).iterdir()
                  if p.suffix.lower() in AUDIO_EXTENSIONS)


def cache_path(audio_path: Path, model_name: str) -> Path:
    """The embedding cache of a file (`utils.get_cache_embedding_path`)."""
    return get_cache_embedding_path(audio_path, model_name)


def _load_16k(path) -> np.ndarray:
    """A file as mono float32 at 16 kHz (the port's resampler, on the host)."""
    wav, sr = read_audio(path)
    wav = wav.mean(axis=0)
    if sr != 16000:
        with torch.no_grad():
            wav = resample(torch.from_numpy(wav[None].astype(np.float32)), sr, 16000).numpy()[0]
    return wav.astype(np.float32)


def cache_embedding_files(directory, model, mesh=None) -> int:
    """Embed every audio file of `directory` that has no cache yet, caching
    <dir>/embeddings/<model>/*.npy. Returns the number of files newly
    embedded (fadtk's idempotence, fad.py:193-200).

    With a mesh, every rank of it calls this together: a batch-capable
    model (`batch_embed`) embeds each group of equal-length files as one
    batch, padded to a multiple of dp by cycling its files and dp-sharded
    over the ranks; any other model embeds file by file on rank 0. Rank 0
    writes the caches, and every rank returns once they are written. Rank
    0's list of files to embed is every rank's: a rank behind it could see
    caches it has written and skip the collectives of the others."""
    directory = Path(directory)
    load = getattr(model, "load_wav", _load_16k)
    todo = [f for f in _audio_files(directory)
            if not cache_path(f, model.name).exists()]
    if mesh is not None:
        todo = mesh.agree(todo)
    if not todo:
        return 0
    # load the model before decoding: load_wav resamples to model.sr
    if hasattr(model, "loaded") and not model.loaded:
        model.load_model()
        model.loaded = True
    lead = leads(mesh)
    if lead:
        for f in todo:
            cache_path(f, model.name).parent.mkdir(parents=True, exist_ok=True)
    if mesh is not None and hasattr(model, "batch_embed"):
        by_len: dict = {}
        wavs = {f: load(f) for f in todo}
        for f, w in wavs.items():
            by_len.setdefault(len(w), []).append(f)
        dp = mesh.shape["dp"]
        for files in by_len.values():
            batch = np.stack([wavs[f] for f in files])
            pad = (-len(files)) % dp   # the batch must divide by dp
            if pad:
                batch = batch[np.arange(len(files) + pad) % len(files)]
            embs = model.batch_embed(batch, mesh=mesh)
            if lead:
                for f, e in zip(files, embs):
                    np.save(cache_path(f, model.name), e)
    elif lead:
        for f in todo:
            np.save(cache_path(f, model.name), model(load(f)))
    if mesh is not None:
        mesh.barrier()   # the other ranks read the caches next
    return len(todo)


class FADEngine:
    """FAD over directories with `model` (a `ModelLoader` or a callable with
    a `name`: waveform -> (frames, dim)), its caches made over `mesh` if one
    is given (`cache_embedding_files`)."""

    def __init__(self, model, mesh=None):
        self.model = model
        self.mesh = mesh

    def _dir_embeddings(self, directory) -> np.ndarray:
        directory = Path(directory)
        cache_embedding_files(directory, self.model, mesh=self.mesh)
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
        cache_embedding_files(eval_dir, self.model, mesh=self.mesh)
        rows = []
        for f in sorted((eval_dir / "embeddings" / self.model.name).glob("*.npy")):
            emb = np.load(f)
            if emb.shape[0] < 2:
                emb = np.repeat(emb, 2, axis=0)
            mu_e, cov_e = _stats(emb)
            rows.append((f.stem, frechet_distance(mu_b, cov_b, mu_e, cov_e)))
        csv_out = Path(csv_out)
        if leads(self.mesh):
            with open(csv_out, "w", newline="") as fh:
                csv.writer(fh).writerows(rows)
        return csv_out


def make_engine(model_name: str, checkpoint_dir=None, device="cuda", mesh=None) -> FADEngine:
    """The JAX package's `FADEngine(model_name=...)`: mfcc-stack is the
    metrics embedder (no `load_wav`, so the engine resamples with
    `ops/resample.py`), any other name its loader (`model_loader.get_model`,
    which resamples with scipy's polyphase filter)."""
    if model_name == "mfcc-stack":
        from ..metrics import get_embedding_model
        return FADEngine(get_embedding_model(model_name, device=device), mesh)
    from .model_loader import get_model
    return FADEngine(get_model(model_name, checkpoint_dir, device), mesh)
