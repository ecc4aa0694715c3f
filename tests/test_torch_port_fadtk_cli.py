"""CPU parity of the port's fadtk command lines with the JAX package's, on
the same files (each package on its own copy of the directories, so that
neither reads the other's caches), all with `--device cpu`:

- `python -m diffmusic_tpu_torch.fadtk MODEL BASELINE EVAL [CSV]` with and
  without `--inf`, `--indiv`, and an .npz baseline: the scores within 1e-3
  relative of JAX's `diffmusic_tpu.fadtk`, its output lines in JAX's form;
- `.fadtk.embeds`: the mfcc-stack caches within 1e-3 of max of JAX's, and
  its report lines equal;
- `.fadtk.package`: the stats bundle (mu, Sigma) within 1e-3 of max;
- `fad_batch.cache_embedding_files` with workers=1 and workers=2 (a spawn
  pool whose workers take the same device): the same caches;
- `.fadtk.test`, the golden gate: exits 0 against the port's goldens.json
  (and 2 against a planted golden), its scores within 1e-3 of the pinned
  ones; run once as `python -m`.
"""

import csv
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from diffmusic_tpu.fadtk import __main__ as jmain
from diffmusic_tpu.fadtk import embeds as jembeds
from diffmusic_tpu.fadtk import package as jpackage
from diffmusic_tpu_torch.data import write_wav
from diffmusic_tpu_torch.fadtk import __main__ as tmain
from diffmusic_tpu_torch.fadtk import embeds as tembeds
from diffmusic_tpu_torch.fadtk import fad_batch
from diffmusic_tpu_torch.fadtk import package as tpackage
from diffmusic_tpu_torch.fadtk.test import __main__ as tgate
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-3
SR = 16000


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """baseline/ and eval/, three 1-s clips each: harmonic stacks of seeded
    fundamentals, the eval clips with noise; one eval clip 44.1-kHz stereo."""
    root = tmp_path_factory.mktemp("fadtk")
    rng = np.random.default_rng(0)
    for d, noise in (("baseline", 0.0), ("eval", 0.05)):
        (root / d).mkdir()
        for i in range(3):
            sr = 44100 if (d, i) == ("eval", 2) else SR
            tt = np.arange(sr) / sr
            f0 = 110.0 * 2.0 ** rng.uniform(0.0, 3.0)
            x = sum(0.25 / (h + 1) * np.sin(2 * np.pi * f0 * (h + 1) * tt) for h in range(4))
            x = (x + noise * rng.standard_normal(tt.size)).astype(np.float32)
            write_wav(root / d / f"clip{i}.wav", np.stack([x, 0.8 * x]) if sr != SR else x, sr)
    return root


def fresh(dirs, tmp_path, name):
    """A copy of the fixture's directories without caches."""
    out = tmp_path / name
    for d in ("baseline", "eval"):
        shutil.copytree(dirs / d, out / d, ignore=shutil.ignore_patterns("embeddings"))
    return out


def run_jax(monkeypatch, capsys, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    module.main()
    return capsys.readouterr().out


def run_port(capsys, module, argv):
    module.main(argv + ["--device", "cpu"])
    return capsys.readouterr().out


def score_of(line: str) -> float:
    return float(line.strip().rsplit(" ", 1)[1])


@pytest.mark.parametrize("flags", [[], ["--inf"], ["csv"], ["npz"]])
def test_main_matches_jax(dirs, tmp_path, monkeypatch, capsys, flags):
    outs = {}
    for side, run in (("jax", lambda a: run_jax(monkeypatch, capsys, jmain, a)),
                      ("port", lambda a: run_port(capsys, tmain, a))):
        d = fresh(dirs, tmp_path, side)
        base = str(d / "baseline")
        extra = [f for f in flags if f.startswith("--")]
        if "npz" in flags:
            (run_jax(monkeypatch, capsys, jpackage, ["-m", "mfcc-stack", "-d", base, "-o",
                                                     str(d / "bundles")]) if side == "jax"
             else run_port(capsys, tpackage, ["-m", "mfcc-stack", "-d", base, "-o",
                                              str(d / "bundles")]))
            base = str(d / "bundles" / "mfcc-stack.npz")
        if "csv" in flags:
            extra.append(str(d / "scores.csv"))
        outs[side] = (run(["mfcc-stack", base, str(d / "eval")] + extra).strip(), d)
    (jline, jd), (tline, td) = outs["jax"], outs["port"]
    label = "FAD-inf" if "--inf" in flags else "FAD"
    assert tline.startswith(f"{label} (mfcc-stack): ") and jline.startswith(f"{label} (")
    assert abs(score_of(tline) - score_of(jline)) <= TOL * abs(score_of(jline))
    if "csv" in flags:
        (jrow,), (trow,) = (list(csv.reader(open(d / "scores.csv"))) for d in (jd, td))
        assert trow[0] == "mfcc-stack" and trow[3] == label == jrow[3]
        assert abs(float(trow[4]) - float(jrow[4])) <= TOL * abs(float(jrow[4]))


def test_main_individual_matches_jax(dirs, tmp_path, monkeypatch, capsys):
    rows = {}
    for side in ("jax", "port"):
        d = fresh(dirs, tmp_path, side)
        argv = ["mfcc-stack", str(d / "baseline"), str(d / "eval"), str(d / "songs.csv"),
                "--indiv"]
        out = (run_jax(monkeypatch, capsys, jmain, argv) if side == "jax"
               else run_port(capsys, tmain, argv))
        assert out.strip() == f"individual FAD scores -> {d / 'songs.csv'}"
        rows[side] = list(csv.reader(open(d / "songs.csv")))
    assert [r[0] for r in rows["port"]] == [r[0] for r in rows["jax"]] == [
        "clip0", "clip1", "clip2"]
    assert rel([float(r[1]) for r in rows["port"]], [float(r[1]) for r in rows["jax"]]) <= TOL


def caches(d: Path, model: str = "mfcc-stack") -> dict:
    return {p.stem: np.load(p) for p in sorted((d / "embeddings" / model).glob("*.npy"))}


def test_embeds_cli_matches_jax(dirs, tmp_path, monkeypatch, capsys):
    outs, got = {}, {}
    for side in ("jax", "port"):
        d = fresh(dirs, tmp_path, side)
        argv = ["-m", "mfcc-stack", "-d", str(d / "baseline"), str(d / "eval")]
        outs[side] = (run_jax(monkeypatch, capsys, jembeds, argv) if side == "jax"
                      else run_port(capsys, tembeds, argv))
        outs[side] = outs[side].replace(str(d), "ROOT")
        got[side] = {sub: caches(d / sub) for sub in ("baseline", "eval")}
    assert outs["port"] == outs["jax"] == (
        "mfcc-stack: ROOT/baseline: 3 new embeddings cached\n"
        "mfcc-stack: ROOT/eval: 3 new embeddings cached\n")
    for sub in ("baseline", "eval"):
        assert sorted(got["port"][sub]) == sorted(got["jax"][sub])
        for k, v in got["jax"][sub].items():
            assert got["port"][sub][k].shape == v.shape and rel(got["port"][sub][k], v) <= TOL
    # idempotent: nothing new the second time
    assert run_port(capsys, tembeds, ["-m", "mfcc-stack", "-d", str(
        tmp_path / "port" / "eval")]).endswith(": 0 new embeddings cached\n")


def test_package_cli_matches_jax(dirs, tmp_path, monkeypatch, capsys):
    bundles = {}
    for side in ("jax", "port"):
        d = fresh(dirs, tmp_path, side)
        argv = ["-m", "mfcc-stack", "-d", str(d / "eval"), "-o", str(d / "out")]
        out = (run_jax(monkeypatch, capsys, jpackage, argv) if side == "jax"
               else run_port(capsys, tpackage, argv))
        assert out.strip() == f"mfcc-stack: stats bundle -> {d / 'out' / 'mfcc-stack.npz'}"
        bundles[side] = np.load(d / "out" / "mfcc-stack.npz")
    for k in ("mu", "cov"):
        assert bundles["port"][k].shape == bundles["jax"][k].shape
        assert rel(bundles["port"][k], bundles["jax"][k]) <= TOL


def test_fad_batch_workers_give_the_same_caches(dirs, tmp_path):
    got = {}
    for workers in (1, 2):
        d = fresh(dirs, tmp_path, f"w{workers}")
        n = fad_batch.cache_embedding_files(d / "eval", "mfcc-stack", workers=workers,
                                            device="cpu")
        assert n == 3
        assert fad_batch.cache_embedding_files(d / "eval", "mfcc-stack", workers=workers,
                                               device="cpu") == 0
        got[workers] = caches(d / "eval")
    assert sorted(got[1]) == sorted(got[2]) == ["clip0", "clip1", "clip2"]
    for k in got[1]:
        assert rel(got[2][k], got[1][k]) <= 1e-6


def test_golden_gate(tmp_path, monkeypatch, capsys):
    torch_threads = torch.get_num_threads()
    assert tgate.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count(" OK") == 2 and "FAIL" not in out
    with __import__("tempfile").TemporaryDirectory() as tmp:
        scores = tgate.compute_scores(Path(tmp), "cpu")
    pinned = __import__("json").loads(tgate.GOLDEN.read_text())
    assert sorted(scores) == sorted(pinned) == ["fad", "fad_inf"]
    for k, v in pinned.items():
        assert abs(scores[k] - v) <= TOL * abs(v), (k, scores[k], v)
    planted = tmp_path / "goldens.json"
    planted.write_text(__import__("json").dumps({k: 1.2 * v for k, v in pinned.items()}))
    monkeypatch.setattr(tgate, "GOLDEN", planted)
    assert tgate.main(["--device", "cpu"]) == 2
    assert capsys.readouterr().out.count("FAIL") == 2
    assert torch.get_num_threads() == torch_threads


def test_command_lines_run_with_python_m(dirs, tmp_path):
    d = fresh(dirs, tmp_path, "m")
    runs = [[sys.executable, "-m", "diffmusic_tpu_torch.fadtk", "mfcc-stack",
             str(d / "baseline"), str(d / "eval"), "--device", "cpu"],
            [sys.executable, "-m", "diffmusic_tpu_torch.fadtk.test", "--device", "cpu"]]
    fad = subprocess.run(runs[0], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert fad.returncode == 0 and fad.stdout.startswith("FAD (mfcc-stack): "), fad.stderr
    gate = subprocess.run(runs[1], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert gate.returncode == 0 and gate.stdout.count(" OK") == 2, gate.stdout + gate.stderr
