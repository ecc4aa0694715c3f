"""Evaluation CLI on PyTorch, the twin of the JAX package's `eval.py`:

    python -m diffmusic_tpu_torch.eval -gt DIR -r DIR [--embedding mfcc-stack vggish]
        [--fad_inf] [--individual CSV] [--device cuda|cpu] [--checkpoint_dir DIR]
        [--mesh dp=N]

computes FAD (per embedding model, with fadtk-style per-file embedding caches
under each directory), KL (re-embedding every clip with the first model),
LSD and MSE between a ground-truth directory and a reconstruction directory,
and prints the score table (reference eval.py:150-163). It runs on the card
unless `--device cpu` is given. VGGish reads a torchvggish state dict from
`<checkpoint_dir>/vggish/` (or `$DIFFMUSIC_TPU_CHECKPOINTS/vggish/`),
clap-laion-audio / clap-laion-music a CLAP model from `<checkpoint_dir>/clap/`.

`--mesh dp=N` (JAX's spec, `parallel/mesh.py`) runs the eval on N ranks, one
device each (spawned here; gloo processes with `--device cpu`, one GPU a
rank on the card; a mesh of one rank runs in this process): the batch-capable
mfcc-stack embeds each group of equal-length files in one call, dp-sharded
over the ranks (`fadtk/engine.py::cache_embedding_files`), every other
embedder file by file; rank 0 writes the caches and prints the table.
"""

import contextlib
from argparse import ArgumentParser

import torch

from .fadtk import make_engine
from .metrics import KullbackLeiblerDivergence, LogSpectralDistance, MeanSquaredError
from .parallel.mesh import launch, leads, parse_mesh
from .utils import load_audio_files


def parse_arguments(argv=None):
    p = ArgumentParser(description="FAD / KL / LSD / MSE between two directories of audio")
    p.add_argument("-gt", "--ground_truth_dir", type=str, required=True)
    p.add_argument("-r", "--recon_dir", type=str, required=True)
    p.add_argument("--embedding", type=str, nargs="+", default=["mfcc-stack"],
                   help="embedding model(s) for FAD/KL: mfcc-stack (default, no "
                        "weights) or any name of fadtk.get_all_models(), from "
                        "--checkpoint_dir")
    p.add_argument("--fad_inf", action="store_true",
                   help="also compute FAD-inf extrapolation")
    p.add_argument("--individual", type=str, default=None,
                   help="write per-song FAD CSV to this path")
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                   help="where the embedders run (default: the card)")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="local weights root (default: $DIFFMUSIC_TPU_CHECKPOINTS)")
    p.add_argument("--mesh", type=str, default=None,
                   help="device mesh spec e.g. 'dp=8': shards embedding batches over "
                        "one rank a device (batch-capable embedders only)")
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
    mesh = parse_mesh(args.mesh, args.device)
    if mesh is None:
        return evaluate(args)
    return launch(mesh, eval_rank, args)[0]


def eval_rank(mesh, args) -> dict:
    """One rank of a `--mesh` eval (`parallel.launch`), on the rank's device."""
    args.device = str(mesh.device)
    return evaluate(args, mesh)


def evaluate(args, mesh=None) -> dict:
    """The scores, and their table printed by rank 0 (or alone)."""
    with full_fp32():
        scores = score_dirs(args, mesh)
    if leads(mesh):
        width = max(len(k) for k in scores)
        print("=" * (width + 20))
        for k, v in scores.items():
            print(f"| {k:<{width}} : {v:.6f}")
        print("=" * (width + 20))
    return scores


def score_dirs(args, mesh=None) -> dict:
    """Every score of `parse_arguments`'s namespace, in the table's order,
    the embedding caches made over `mesh` if one is given."""
    gt = load_dir(args.ground_truth_dir)
    recon = load_dir(args.recon_dir)
    if not gt or not recon:
        raise SystemExit("no .wav files found in one of the directories")

    if args.embedding == ["mfcc-stack"] and leads(mesh):
        print("note: FAD/KL below use the offline 'mfcc-stack' embedder — "
              "values are NOT comparable to the reference's vggish/CLAP "
              "tables (eval.py:56-66). Pass --embedding vggish ... with "
              "--checkpoint_dir (or DIFFMUSIC_TPU_CHECKPOINTS) for "
              "reference-comparable numbers.")

    scores = {}
    first_model = None
    for name in args.embedding:  # per-model FAD loop (reference eval.py:56-73)
        engine = make_engine(name, args.checkpoint_dir, args.device, mesh)
        first_model = first_model or engine.model
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
