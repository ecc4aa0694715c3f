"""Multi-model embedding cacher (port of `diffmusic_tpu/fadtk/embeds.py`;
reference fadtk/embeds.py:5-27).

    python -m diffmusic_tpu_torch.fadtk.embeds -m MODEL [MODEL...] -d DIR [DIR...]
        [-w WORKERS] [--checkpoint_dir DIR] [--device cuda|cpu]
"""

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="diffmusic_tpu_torch.fadtk.embeds")
    p.add_argument("-m", "--models", nargs="+", required=True,
                   help="embedding model names (see model_loader.get_all_models)")
    p.add_argument("-d", "--dirs", nargs="+", required=True,
                   help="directories of audio files to cache embeddings for")
    p.add_argument("-w", "--workers", type=int, default=1)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--device", default="cuda", help="where the embedders run (default: the card)")
    args = p.parse_args(argv)

    from .fad_batch import cache_embedding_files
    for model in args.models:
        for d in args.dirs:
            n = cache_embedding_files(d, model, workers=args.workers,
                                      checkpoint_dir=args.checkpoint_dir, device=args.device)
            print(f"{model}: {d}: {n} new embeddings cached")


if __name__ == "__main__":
    main()
