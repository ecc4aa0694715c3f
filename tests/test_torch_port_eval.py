"""CPU parity of the port's eval path with the JAX package's: WAV I/O,
resampling, the MFCC-stack and VGGish embedders, the numpy metrics, and the
whole `eval.py` (FAD, FAD-inf, per-song CSV, KL, LSD, MSE) against the port's
`diffmusic_tpu_torch.eval` run with `--device cpu`.

Inputs come from a numpy seed, fp32. Bounds: 1e-5 of max for the resampler,
1e-4 of max for the embeddings (the mel and DCT sums run in other orders),
pre-PCA VGGish 1e-4 of max and post-PCA within one quantisation level, and
1e-3 relative for every eval score. VGGish runs at its one published width
with seeded random weights in torchvggish's layout, written once per module.
"""

import csv
import importlib.util
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from diffmusic_tpu.data import read_wav as jread_wav
from diffmusic_tpu.fadtk.utils import merge_stats as jmerge_stats
from diffmusic_tpu.metrics import embeddings as jemb
from diffmusic_tpu.metrics import frechet as jfrechet
from diffmusic_tpu.metrics import kl as jkl
from diffmusic_tpu.metrics import lsd as jlsd
from diffmusic_tpu.metrics import mse as jmse
from diffmusic_tpu.metrics import vggish as jvggish
from diffmusic_tpu.ops.resample import resample as jresample
import diffmusic_tpu_torch.eval as teval
from diffmusic_tpu_torch import kernels
from diffmusic_tpu_torch.data import read_wav, write_wav
from diffmusic_tpu_torch.fadtk import get_model, merge_stats
from diffmusic_tpu_torch.kernels import mel as tmel
from diffmusic_tpu_torch.metrics import embeddings as temb
from diffmusic_tpu_torch.metrics import frechet as tfrechet
from diffmusic_tpu_torch.metrics import kl as tkl
from diffmusic_tpu_torch.metrics import lsd as tlsd
from diffmusic_tpu_torch.metrics import mse as tmse
from diffmusic_tpu_torch.metrics import vggish as tvggish
from diffmusic_tpu_torch.ops.resample import resample as tresample
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
SR = 16000


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def harmonic(rng, seconds: float) -> np.ndarray:
    """Four harmonics of a random fundamental with a slow AM, at 16 kHz."""
    tt = np.arange(int(seconds * SR)) / SR
    f0 = 110.0 * 2.0 ** rng.uniform(0.0, 3.0)
    x = sum(0.25 / (h + 1) * np.sin(2 * np.pi * f0 * (h + 1) * tt + rng.uniform(0, 6))
            for h in range(4))
    return (x * (0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.5, 4.0) * tt))).astype(np.float32)


@pytest.fixture(scope="module")
def vggish_ckpt(tmp_path_factory):
    """A checkpoint root holding one seeded random torchvggish-layout
    `vggish/vggish.npz` (72 M parameters), written once for the module."""
    root = tmp_path_factory.mktemp("ckpt")
    (root / "vggish").mkdir()
    np.savez(root / "vggish" / "vggish.npz", **tvggish.random_state_dict(0))
    return root


# ---------------------------------------------------------------- host I/O
@pytest.mark.parametrize("subtype", ["float32", "pcm16"])
def test_wav_round_trip_matches_jax_reader(tmp_path, subtype):
    x = np.random.default_rng(0).uniform(-0.9, 0.9, (2, 3001)).astype(np.float32)
    path = tmp_path / "a.wav"
    write_wav(path, x, 44100, subtype=subtype)
    (a, sr_a), (b, sr_b) = read_wav(path), jread_wav(path)
    assert sr_a == sr_b == 44100 and a.shape == b.shape == x.shape
    assert np.array_equal(a, b)
    # pcm16: written as trunc(x * 32767), read as / 32768
    assert np.abs(a - x).max() <= (0 if subtype == "float32" else 2.0 / 32767)


@pytest.mark.parametrize("orig,new", [(44100, 16000), (48000, 16000), (8000, 16000)])
def test_resample_matches_jax(orig, new):
    x = np.random.default_rng(1).standard_normal((2, 12345)).astype(np.float32)
    ref = np.asarray(jresample(jnp.asarray(x), orig, new))
    out = tresample(torch.from_numpy(x), orig, new)
    assert tuple(out.shape) == ref.shape
    assert rel(out, ref) <= 1e-5


# --------------------------------------------------------------- embedders
@pytest.mark.parametrize("seconds", [3.0, 0.5])
def test_mfcc_stack_matches_jax(seconds):
    """3 s gives 4 windows; 0.5 s (51 frames) takes the zero pad to 96."""
    wav = harmonic(np.random.default_rng(2), seconds)
    wav += 0.01 * np.random.default_rng(3).standard_normal(wav.size).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(jemb.MFCCStackEmbedding()(wav))
    out = temb.MFCCStackEmbedding("cpu")(wav)
    assert out.shape == ref.shape and out.dtype == np.float32
    assert rel(out, ref) <= 1e-4, f"port vs JAX: {rel(out, ref):.2e} of max"


def test_vggish_matches_jax(vggish_ckpt):
    """Both `load_vggish`s read the same .npz; a 3-s clip gives 3 examples."""
    path = vggish_ckpt / "vggish" / "vggish.npz"
    japply, jpca = jvggish.load_vggish(path)
    model, pca = tvggish.load_vggish(path, "cpu")
    wav = harmonic(np.random.default_rng(4), 3.0)
    ex = tvggish.log_mel_examples(wav)
    assert np.array_equal(ex, jvggish.log_mel_examples(wav)) and ex.shape == (3, 96, 64)
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(japply(jnp.asarray(ex[..., None])))
    with torch.no_grad():
        out = model(torch.from_numpy(ex[..., None])).numpy()
    assert rel(out, ref) <= 1e-4, f"pre-PCA port vs JAX: {rel(out, ref):.2e} of max"
    assert np.array_equal(pca.eigen_vectors, jpca.eigen_vectors)
    post, jpost = pca(out), jpca(ref)
    assert np.abs(post - jpost).max() <= 1.0
    assert np.array_equal(tvggish.vggish_embedding(model, pca, wav), post)


def test_vggish_from_flax_is_the_torchvggish_layout():
    """The flax tree converted from a torchvggish state dict converts back
    to it exactly (conv HWIO -> OIHW, dense (in, out) -> (out, in))."""
    sd = tvggish.random_state_dict(1)
    params, _ = jvggish.convert_torchvggish_state_dict(sd)
    back = tvggish.from_flax(params)
    assert set(back) == {k for k in sd if not k.startswith("pproc.")}
    assert all(np.array_equal(back[k].numpy(), sd[k]) for k in back)
    assert set(back) == set(tvggish.VGGish().state_dict())


def test_model_registry_raises_for_what_is_not_ported(tmp_path):
    """Every name resolves; what is not ported is MERT's own remote-code
    model type, which raises NotImplementedError at load (the JAX package's
    AutoModel cannot load it either)."""
    for name in ("vggish", "mfcc-stack", "clap-laion-audio", "clap-laion-music",
                 "w2v2-base", "MERT-v1-95M", "encodec-emb"):
        assert get_model(name, device="cpu").name == name
    (tmp_path / "MERT-v1-95M").mkdir()
    (tmp_path / "MERT-v1-95M" / "config.json").write_text('{"model_type": "mert_model"}')
    with pytest.raises(NotImplementedError, match="mert_model"):
        get_model("MERT-v1-95M", tmp_path, device="cpu").load_model()
    with pytest.raises(ValueError):
        get_model("no-such-model", device="cpu")
    with pytest.raises(FileNotFoundError):
        get_model("vggish", checkpoint_dir="/nonexistent", device="cpu").load_model()


def test_clap_laion_matches_jax(tmp_path, monkeypatch):
    """clap-laion-audio from a local CLAP directory (a tiny ClapModel of the
    snapshot writer, its audio tower narrow but taking the 48-kHz features
    at their full shape): the port's loader on the CPU against JAX's on
    the same files, 1e-4 of max; a ClapModel's text keys are named, an
    unknown key raises."""
    import test_torch_port_checkpoint as ckpt_test
    import test_torch_port_snapshot as snap
    from diffmusic_tpu.fadtk.model_loader import CLAPLaionModel as JCLAPLaion
    txt = snap.tiny_configs()[3]
    sd = {**snap._values(snap.clap_text_shapes(txt), 3),
          **snap.clap_audio_values(ckpt_test.AUDIO, 4)}
    snap.write_snapshot(tmp_path, {"clap": (snap.clap_json(txt, ckpt_test.AUDIO), sd)})
    jmodel, model = JCLAPLaion("audio", tmp_path), get_model("clap-laion-audio", tmp_path,
                                                              "cpu")
    for seconds, seed in ((2.5, 5), (0.7, 6)):
        wav = harmonic(np.random.default_rng(seed), seconds)
        ref, out = jmodel.get_embedding(wav), model.get_embedding(wav)
        assert out.shape == ref.shape == (int(np.ceil(seconds)), 32)
        assert rel(out, ref) <= 1e-4, f"port vs JAX: {rel(out, ref):.2e} of max"
    assert model.sr == 16000 and model.model.tower.bn_var.dtype == torch.float32
    snap.write_snapshot(tmp_path / "bad", {"clap": (snap.clap_json(txt, ckpt_test.AUDIO),
                                                    {**sd, "extra.weight": sd["logit_scale_a"]})})
    with pytest.raises(ValueError, match="NOT consumed"):
        get_model("clap-laion-audio", tmp_path / "bad", "cpu").load_model()


# ----------------------------------------------------------------- metrics
@pytest.mark.parametrize("name", ["frechet", "kl", "lsd", "mse", "merge_stats"])
def test_numpy_metrics_match_jax(name):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((300, 20)).astype(np.float32)
    b = (0.8 * rng.standard_normal((300, 20)) + 0.3).astype(np.float32)
    if name == "frechet":
        got = [mod.frechet_distance(*mod._stats(a), *mod._stats(b)) for mod in (tfrechet, jfrechet)]
    elif name == "kl":
        got = [mod.kl_from_embeddings(a, b) for mod in (tkl, jkl)]
    elif name in ("lsd", "mse"):
        wa, wb = [rng.standard_normal(8000).astype(np.float32) for _ in range(2)]
        cls = {"lsd": "LogSpectralDistance", "mse": "MeanSquaredError"}[name]
        got = [getattr(mod, cls)().score([wa, wa], [wb, wa[:7000]])
               for mod in ((tlsd, jlsd) if name == "lsd" else (tmse, jmse))]
    else:
        got = [np.concatenate([m.ravel() for m in fn([a[:100], a[100:], b])])
               for fn in (merge_stats, jmerge_stats)]
    assert np.array_equal(got[0], got[1])


# ------------------------------------------------------- the whole eval path
def write_pairs(root: Path, n_pairs: int, seconds: float, seed: int = 0):
    """gt/ and recon/ under root: seeded harmonic stacks, each recon its gt
    with the 40-60 % box zeroed plus noise; pair 0 as 44.1-kHz stereo float32,
    so that the resamplers run."""
    rng = np.random.default_rng(seed)
    for d in ("gt", "recon"):
        (root / d).mkdir(parents=True)
    for i in range(n_pairs):
        gt = harmonic(rng, seconds)
        rec = gt.copy()
        rec[int(0.4 * rec.size):int(0.6 * rec.size)] = 0.0
        rec += 0.05 * rng.standard_normal(rec.size).astype(np.float32)
        if i == 0:
            up = lambda a: tresample(torch.from_numpy(a[None]), SR, 44100).numpy()
            write_wav(root / "gt" / f"{i:03d}.wav", np.concatenate([up(gt), 0.9 * up(gt)]), 44100)
            write_wav(root / "recon" / f"{i:03d}.wav", np.concatenate([up(rec), up(rec)]), 44100)
        else:
            write_wav(root / "gt" / f"{i:03d}.wav", gt, SR)
            write_wav(root / "recon" / f"{i:03d}.wav", rec, SR)


def jax_eval_main(argv, monkeypatch, ckpt):
    """The JAX package's eval.py, loaded by path, with sys.argv set."""
    spec = importlib.util.spec_from_file_location("jax_eval_cli", REPO / "eval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["eval.py", *argv])
    monkeypatch.setenv("DIFFMUSIC_TPU_CHECKPOINTS", str(ckpt))
    with jax.default_matmul_precision("float32"):
        return mod.main()


def test_eval_matches_jax_eval(tmp_path, monkeypatch, vggish_ckpt):
    """Two pairs of 40-s clips: 164 MFCC windows a side, so the 160-d MFCC
    covariance has full rank (the JAX embedder compiles once per clip, for a
    time that grows with the clip's windows: two clips a side is the
    cheapest full-rank choice). Each side scores its own copy of the
    directories (the caches are written into them under the same model
    names)."""
    write_pairs(tmp_path / "jax", 2, 40.0)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    flags = ["--embedding", "mfcc-stack", "vggish", "--fad_inf", "--individual"]
    ref = jax_eval_main(["-gt", str(tmp_path / "jax/gt"), "-r", str(tmp_path / "jax/recon"),
                         *flags, str(tmp_path / "jax.csv")], monkeypatch, vggish_ckpt)
    monkeypatch.delenv("DIFFMUSIC_TPU_CHECKPOINTS")
    out = teval.main(["-gt", str(tmp_path / "port/gt"), "-r", str(tmp_path / "port/recon"),
                      *flags, str(tmp_path / "port.csv"), "--device", "cpu",
                      "--checkpoint_dir", str(vggish_ckpt)])
    assert list(out) == list(ref) == ["FAD (mfcc-stack)", "FAD-inf (mfcc-stack)", "FAD (vggish)",
                                      "FAD-inf (vggish)", "KL", "LSD", "MSE"]
    errs = {k: abs(out[k] - ref[k]) / abs(ref[k]) for k in ref}
    assert all(np.isfinite(v) for v in out.values())
    assert max(errs.values()) <= 1e-3, errs
    rows = [list(csv.reader(open(tmp_path / f"{side}.csv"))) for side in ("port", "jax")]
    assert [r[0] for r in rows[0]] == [r[0] for r in rows[1]] == ["000", "001"]
    for a, b in zip(*rows):
        assert abs(float(a[1]) - float(b[1])) <= 1e-3 * abs(float(b[1]))
    for name in ("mfcc-stack", "vggish"):
        cache = sorted((tmp_path / "port/recon/embeddings" / name).glob("*.npy"))
        assert [p.stem for p in cache] == ["000", "001"]


def test_eval_launches_the_mel_kernel_four_times_per_pair(tmp_path, monkeypatch, vggish_ckpt):
    """The eval's mel launches, counted by the real wrapper around a
    stand-in for the kernel that returns the plain result: the mfcc-stack
    FAD caches embed each gt and recon file once, KL re-embeds each with the
    first model, and --fad_inf, --individual and VGGish (its own numpy mel)
    launch none. This is the number chip_smoke.py checks its eval against."""
    n_pairs = 3
    write_pairs(tmp_path, n_pairs, 2.0, seed=1)
    monkeypatch.setattr(tmel, "use_plain", lambda x, name: False)
    monkeypatch.setattr(tmel, "_run_kernel", lambda xb, geom: tmel.fused_mel_plain(xb, *geom))
    kernels.reset_launch_counts()
    scores = teval.main(["-gt", str(tmp_path / "gt"), "-r", str(tmp_path / "recon"),
                         "--embedding", "mfcc-stack", "vggish", "--fad_inf", "--individual",
                         str(tmp_path / "songs.csv"), "--device", "cpu",
                         "--checkpoint_dir", str(vggish_ckpt)])
    counts = kernels.launch_counts()
    assert counts["fused_mel_spectrogram"] == chip_smoke.eval_mel_launches(n_pairs) == 4 * n_pairs
    assert sum(counts.values()) == counts["fused_mel_spectrogram"]
    assert len(scores) == 7 and all(np.isfinite(v) for v in scores.values())
    assert len(list(csv.reader(open(tmp_path / "songs.csv")))) == n_pairs


def test_eval_flags():
    args = teval.parse_arguments(["-gt", "a", "-r", "b"])
    assert (args.embedding, args.device, args.checkpoint_dir, args.fad_inf,
            args.individual, args.mesh) == (["mfcc-stack"], "cuda", None, False, None, None)
    assert teval.parse_arguments(["-gt", "a", "-r", "b", "--mesh", "dp=8"]).mesh == "dp=8"
    with pytest.raises(SystemExit):
        teval.parse_arguments(["-gt", "a", "-r", "b", "--no-such-flag"])
