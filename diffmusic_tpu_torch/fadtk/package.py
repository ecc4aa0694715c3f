"""Stats-bundle packager (port of `diffmusic_tpu/fadtk/package.py`;
reference fadtk/package.py:29-42): mu / Sigma of a directory of audio under
one or more embedding models, written as .npz bundles that serve as FAD
baselines.

    python -m diffmusic_tpu_torch.fadtk.package -m MODEL [MODEL...] -d DIR -o OUTDIR
        [-w WORKERS] [--checkpoint_dir DIR] [--device cuda|cpu]
"""

import argparse
from pathlib import Path

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="diffmusic_tpu_torch.fadtk.package")
    p.add_argument("-m", "--models", nargs="+", required=True)
    p.add_argument("-d", "--dir", required=True, help="directory of baseline audio files")
    p.add_argument("-o", "--out", required=True, help="output directory for .npz")
    p.add_argument("-w", "--workers", type=int, default=1)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--device", default="cuda", help="where the embedders run (default: the card)")
    args = p.parse_args(argv)

    from .fad_batch import cache_embedding_files
    from .utils import stats_from_npy_dir

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    for model in args.models:
        cache_embedding_files(args.dir, model, workers=args.workers,
                              checkpoint_dir=args.checkpoint_dir, device=args.device)
        mu, cov = stats_from_npy_dir(Path(args.dir) / "embeddings" / model)
        out = out_dir / f"{model}.npz"
        np.savez(out, mu=mu, cov=cov)
        print(f"{model}: stats bundle -> {out}")


if __name__ == "__main__":
    main()
