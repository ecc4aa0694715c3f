"""fadtk-compatible CLI (port of `diffmusic_tpu/fadtk/__main__.py`; reference
fadtk/__main__.py:9-74):

    python -m diffmusic_tpu_torch.fadtk MODEL BASELINE EVAL [CSV] [--inf | --indiv]
        [--device cuda|cpu]

BASELINE is a directory or an .npz stats bundle (`fadtk.package`).
"""

import argparse
import csv
from pathlib import Path


def main(argv=None) -> float:
    p = argparse.ArgumentParser(prog="diffmusic_tpu_torch.fadtk")
    p.add_argument("model", help="embedding model name (no weights: mfcc-stack)")
    p.add_argument("baseline", help="baseline dir or .npz stats bundle")
    p.add_argument("eval", help="evaluation dir")
    p.add_argument("csv", nargs="?", default=None, help="append the score to this CSV")
    p.add_argument("--inf", action="store_true", help="FAD-inf extrapolation")
    p.add_argument("--indiv", action="store_true", help="per-song FAD CSV")
    p.add_argument("--device", default="cuda", help="where the embedder runs (default: the card)")
    args = p.parse_args(argv)

    from .engine import make_engine
    engine = make_engine(args.model, device=args.device)

    if args.indiv:
        out = Path(args.csv or f"fad-individual-{args.model}.csv")
        engine.score_individual(args.baseline, args.eval, out)
        print(f"individual FAD scores -> {out}")
        return None

    if args.inf:
        score, _slope = engine.score_inf(args.baseline, args.eval)
        label = "FAD-inf"
    else:
        score = engine.score(args.baseline, args.eval)
        label = "FAD"

    print(f"{label} ({args.model}): {score:.6f}")
    if args.csv:
        with open(args.csv, "a", newline="") as fh:
            csv.writer(fh).writerow([args.model, args.baseline, args.eval, label, score])
    return score


if __name__ == "__main__":
    main()
