"""Batch embedding cache, in process or over a spawn pool (port of
`diffmusic_tpu/fadtk/fad_batch.py`; reference fadtk/fad_batch.py:25-48).

Files are split across spawned workers; each builds the embedder on `device`
(the card by default, the same device for every worker) and writes
per-file .npy caches. `workers=1` embeds in process.
"""

import multiprocessing
from pathlib import Path
from typing import Sequence, Union

import numpy as np

from .engine import _audio_files, cache_path


def _worker(args) -> int:
    model_name, checkpoint_dir, device, files = args
    from .model_loader import get_model
    model = get_model(model_name, checkpoint_dir, device)
    new = 0
    for f in files:
        out = cache_path(Path(f), model.name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        np.save(out, model.get_embedding(model.load_wav(f)))
        new += 1
    return new


def cache_embedding_files(files: Union[str, Path, Sequence], model_name: str = "mfcc-stack",
                          workers: int = 1, checkpoint_dir=None, device="cuda") -> int:
    """Embed every file (or every audio file of a directory) that has no
    cache yet, caching <dir>/embeddings/<model>/<stem>.npy through the
    model's loader (`model_loader.get_model`, its `load_wav`). Returns the
    number newly embedded; idempotent (reference fad.py:193-200)."""
    if isinstance(files, (str, Path)):
        files = _audio_files(files)
    files = [Path(f) for f in files if not cache_path(Path(f), model_name).exists()]
    if not files:
        return 0
    if workers <= 1 or len(files) == 1:
        return _worker((model_name, checkpoint_dir, device, files))
    chunks = [c for c in (files[i::workers] for i in range(workers)) if c]
    ctx = multiprocessing.get_context("spawn")   # reference fad_batch.py:46-48
    with ctx.Pool(len(chunks)) as pool:
        counts = pool.map(_worker, [(model_name, checkpoint_dir, device, c) for c in chunks])
    return sum(counts)
