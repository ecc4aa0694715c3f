"""Golden-score regression gate (port of `diffmusic_tpu/fadtk/test/__main__.py`;
reference fadtk/test/__main__.py:12-104): FAD and FAD-inf of deterministic
synthetic fixtures under mfcc-stack, against the scores pinned in this
package's goldens.json, within 5 % of each.

    python -m diffmusic_tpu_torch.fadtk.test [--regen] [--device cuda|cpu]

Exit codes: 0 pass, 2 regression.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

TOLERANCE = 0.05   # fadtk/test/__main__.py:93
GOLDEN = Path(__file__).parent / "goldens.json"


def _fixtures(tmp: Path):
    from ...data import write_wav
    sr = 16000
    base, ev = tmp / "baseline", tmp / "eval"
    base.mkdir(parents=True, exist_ok=True)
    ev.mkdir(parents=True, exist_ok=True)
    for d, freqs, seed in ((base, (220, 330, 440), 10), (ev, (233, 349, 466), 20)):
        for i, f0 in enumerate(freqs):
            t = np.arange(sr * 2) / sr
            w = (0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * 2 * f0 * t)
                 + 0.02 * np.random.default_rng(seed + i).standard_normal(len(t)))
            write_wav(d / f"clip{i}.wav", w.astype(np.float32)[None], sr)
    return base, ev


def compute_scores(tmp: Path, device="cuda") -> dict:
    from ..engine import make_engine
    base, ev = _fixtures(tmp)
    engine = make_engine("mfcc-stack", device=device)
    return {"fad": float(engine.score(base, ev)),
            "fad_inf": float(engine.score_inf(base, ev, steps=5)[0])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="diffmusic_tpu_torch.fadtk.test")
    p.add_argument("--regen", action="store_true", help="rewrite goldens.json")
    p.add_argument("--device", default="cuda", help="where the embedder runs (default: the card)")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        scores = compute_scores(Path(tmp), args.device)
    if args.regen:
        GOLDEN.write_text(json.dumps(scores, indent=2))
        print(f"wrote {GOLDEN}: {scores}")
        return 0
    if not GOLDEN.exists():
        print("goldens.json missing; run with --regen first", file=sys.stderr)
        return 2
    failed = False
    for k, want in json.loads(GOLDEN.read_text()).items():
        got = scores[k]
        tol = TOLERANCE * abs(want) if want else 1e-6
        status = "OK" if abs(got - want) < tol else "FAIL"
        failed |= status == "FAIL"
        print(f"{k}: got {got:.6f}, golden {want:.6f} [tol {tol:.6f}] {status}")
    return 2 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
