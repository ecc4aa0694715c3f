"""Evaluation CLI on PyTorch, the twin of the JAX package's `eval.py`:

    python -m diffmusic_tpu_torch.eval -gt DIR -r DIR [--embedding mfcc-stack vggish]
        [--fad_inf] [--individual CSV] [--device cuda|cpu] [--checkpoint_dir DIR]

computes FAD (per embedding model, with fadtk-style per-file embedding caches
under each directory), KL (re-embedding every clip with the first model),
LSD and MSE between a ground-truth directory and a reconstruction directory,
and prints the score table (reference eval.py:150-163). It runs on the card
unless `--device cpu` is given. VGGish reads a torchvggish state dict from
`<checkpoint_dir>/vggish/` (or `$DIFFMUSIC_TPU_CHECKPOINTS/vggish/`).
"""

import contextlib
from argparse import ArgumentParser

import torch

from .fadtk import FADEngine, get_model
from .metrics import (KullbackLeiblerDivergence, LogSpectralDistance, MeanSquaredError,
                      get_embedding_model)
from .utils import load_audio_files


def parse_arguments(argv=None):
    p = ArgumentParser(description="FAD / KL / LSD / MSE between two directories of audio")
    p.add_argument("-gt", "--ground_truth_dir", type=str, required=True)
    p.add_argument("-r", "--recon_dir", type=str, required=True)
    p.add_argument("--embedding", type=str, nargs="+", default=["mfcc-stack"],
                   help="embedding model(s) for FAD/KL; ported: mfcc-stack (default, "
                        "no weights) and vggish")
    p.add_argument("--fad_inf", action="store_true",
                   help="also compute FAD-inf extrapolation")
    p.add_argument("--individual", type=str, default=None,
                   help="write per-song FAD CSV to this path")
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                   help="where the embedders run (default: the card)")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="local weights root (default: $DIFFMUSIC_TPU_CHECKPOINTS)")
    return p.parse_args(argv)


def load_dir(d):
    """The directory's WAVs, mono, resampled to 16 kHz (reference
    diffmusic/utils.py:45-75)."""
    waves, _names = load_audio_files(d, sample_rate=16000)
    return waves


@contextlib.contextmanager
def full_fp32():
    """The fp32 embedders in full fp32 (cuDNN's convolutions default to
    TF32); the caller's settings come back on exit."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def main(argv=None) -> dict:
    args = parse_arguments(argv)
    with full_fp32():
        scores = score_dirs(args)
    width = max(len(k) for k in scores)
    print("=" * (width + 20))
    for k, v in scores.items():
        print(f"| {k:<{width}} : {v:.6f}")
    print("=" * (width + 20))
    return scores


def score_dirs(args) -> dict:
    """Every score of `parse_arguments`'s namespace, in the table's order."""
    gt = load_dir(args.ground_truth_dir)
    recon = load_dir(args.recon_dir)
    if not gt or not recon:
        raise SystemExit("no .wav files found in one of the directories")

    if args.embedding == ["mfcc-stack"]:
        print("note: FAD/KL below use the offline 'mfcc-stack' embedder — "
              "values are NOT comparable to the reference's vggish/CLAP "
              "tables (eval.py:56-66). Pass --embedding vggish ... with "
              "--checkpoint_dir (or DIFFMUSIC_TPU_CHECKPOINTS) for "
              "reference-comparable numbers.")

    scores = {}
    first_model = None
    for name in args.embedding:  # per-model FAD loop (reference eval.py:56-73)
        # the JAX eval.py's choice of loader: mfcc-stack has no load_wav, so
        # the engine resamples with ops/resample.py; vggish with scipy's
        model = (get_embedding_model(name, device=args.device) if name == "mfcc-stack"
                 else get_model(name, args.checkpoint_dir, args.device))
        first_model = first_model or model
        engine = FADEngine(model=model)
        scores[f"FAD ({name})"] = engine.score(args.ground_truth_dir, args.recon_dir)
        if args.fad_inf:
            fad_inf, _slope = engine.score_inf(args.ground_truth_dir, args.recon_dir)
            scores[f"FAD-inf ({name})"] = fad_inf
        if args.individual:
            engine.score_individual(args.ground_truth_dir, args.recon_dir, args.individual)

    scores["KL"] = KullbackLeiblerDivergence(embed_fn=first_model).score(gt, recon)
    scores["LSD"] = LogSpectralDistance().score(gt, recon)
    scores["MSE"] = MeanSquaredError().score(gt, recon)
    return scores


if __name__ == "__main__":
    main()
