"""CPU parity of the port's entry point against the JAX package's `run.py`
surface: the YAML reader, config composition, the datasets, operator
construction, the mel PNG, the refusals, and one whole CLI run.

- `config.load_yaml` equals `yaml.safe_load` on every file under `configs/`
  and on the scalar forms YAML 1.1 resolves; outside its subset it raises.
- `config.compose` equals the JAX `compose` for every scheduler x model,
  with group (`data=music_data`) and dotted overrides.
- The WAV/MP3/Opus dataset registry; `WAVDataset` equals the JAX one on
  written WAVs (mono mix, resampling from 44.1 and 8 kHz, the crop to
  [start_s, end_s), zero padding, names), to the bit.
- `build_operator` builds JAX's operator for every task (the same
  type and fields; the masks of the box and periodic modes equal; the
  random mask and the reverb impulse response are drawn from each package's
  own generator, so only their shapes are compared).
- `-m stable_audio -t music_generation --tiny` writes JAX's output tree
  and a stereo wav; any other task raises "music_generation only" before
  anything is written.
- Without matplotlib `save_mel_spectrogram` writes an 8-bit grey PNG of the
  dB mel clipped to [-80, 80].
- One `python -m diffmusic_tpu_torch.run --device cpu --tiny
  --num_inference_steps 2` run writes the output tree; a second run skips
  the file. (A JAX CLI run takes minutes on the CPU: it is not run here.)
- In-process --tiny runs whose UNet route calls equal
  `chip_smoke.cli_launches`: DITTO and DPS, and the CLAP and TTS paths
  (-t style_guidance, --prompt_type clap and --transcription with AudioLDM2,
  -nw 2 with its re-ranking logged best first).
"""

import dataclasses
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import run as jrun
from diffmusic_tpu.config import compose as jcompose
from diffmusic_tpu.data import dataloader as jdata
from diffmusic_tpu.inverse_problem import get_noiser as jget_noiser
from diffmusic_tpu_torch import config, run
from diffmusic_tpu_torch.data import dataloader as tdata
from diffmusic_tpu_torch.data import write_wav
from diffmusic_tpu_torch.inverse_problem import get_noiser
from diffmusic_tpu_torch.pipelines import base
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted((REPO / "configs").rglob("*.yaml"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: str(p.relative_to(REPO / "configs")))
def test_yaml_reader_matches_pyyaml_on_configs(path):
    text = path.read_text()
    got, want = config.load_yaml(text), yaml.safe_load(text)
    assert got == want and repr(got) == repr(want)


SCALARS = ["1e-4", "1.0e-4", "0.", ".5", "-3", "+7", "017", "0x1F", "0b101", "1_000", "0",
           "true", "False", "yes", "Off", "null", "~", "", "'quoted # not a comment'",
           '"x\\ty"', "./data/moises_subset", "cvssp/audioldm2-music", "scaled_linear",
           "+.inf", "-.Inf", "1.5e+3"]


def test_yaml_scalars_and_structure_match_pyyaml():
    for s in SCALARS:
        want = yaml.safe_load(f"a: {s}")["a"]
        got = config.parse_scalar(s)
        assert repr(got) == repr(want), s
    doc = ("# leading comment\nname: x\nlist:\n- a\n- b: 1\n  c: 2\n"
           + "nested:\n  deeper:\n    leaf: 0.25   # trailing\n  empty:\nseq_under_key:\n"
           + "  - 1\n  - - 2\n    - 3\n")
    assert config.load_yaml(doc) == yaml.safe_load(doc)
    assert config.load_yaml("") is None and config.load_yaml("# only\n") is None


@pytest.mark.parametrize("text", ["a: [1, 2]", "a: {b: 1}", "a: &x 1", "a: *x", "a: !!str 1",
                                  "a: |\n  text", "a: 12:30", "a:\n  b: 1\n c: 2",
                                  "- a\nb: 1"])
def test_yaml_outside_the_subset_raises(text):
    with pytest.raises(ValueError):
        config.load_yaml(text)


SCHEDULERS = ["ddim", "dps", "mpgd", "dsg", "ditto", "diffmusic"]


@pytest.mark.parametrize("model", ["musicldm", "audioldm2", "stable_audio"])
@pytest.mark.parametrize("name", SCHEDULERS)
def test_compose_matches_jax(name, model):
    overrides = [f"model={model}", "data=music_data", "model.pipe.audio_length_in_s=3",
                 "data.root=/elsewhere", "scheduler.eta=0.5", "scheduler.new_key=1e-4",
                 "inverse_problem.noise.sigma=0.01"]
    got = config.compose(name, overrides, str(REPO / "configs"))
    want = jcompose(name, overrides, str(REPO / "configs"))
    assert got == want and repr(got) == repr(want)
    assert got.model.name == model and got.data.name == "musiccaps"
    assert got.scheduler.new_key == "1e-4"    # YAML 1.1: a float needs a dot
    plain = config.compose(name, [f"model={model}"], str(REPO / "configs"))
    assert plain == jcompose(name, [f"model={model}"], str(REPO / "configs"))


def test_dataset_registry_matches_jax():
    assert sorted(tdata.__DATASET__) == sorted(jdata.__DATASET__) == ["mp3", "opus", "wav"]
    with pytest.raises(NameError):
        tdata.get_dataset("x", "flac", ".")
    with pytest.raises(NameError):
        tdata.register_dataset("wav")(object)


def write_clips(root: Path, rng):
    root.mkdir(parents=True)
    write_wav(root / "a_16k.wav", 0.3 * rng.standard_normal((1, 16000 * 3)).astype(np.float32),
              16000)
    write_wav(root / "b_44k_stereo.wav",
              0.3 * rng.standard_normal((2, 44100 * 2)).astype(np.float32), 44100)
    write_wav(root / "c_8k_short.wav", 0.3 * rng.standard_normal((1, 8000)).astype(np.float32),
              8000)
    (root / "notes.txt").write_text("not audio")


@pytest.mark.parametrize("start_s, end_s, length_s", [(0.0, None, 2.0), (0.5, 1.75, 2.0),
                                                      (1.0, 2.5, 1.0)])
def test_wav_dataset_matches_jax(tmp_path, rng, start_s, end_s, length_s):
    write_clips(tmp_path / "clips", rng)
    kw = dict(name="x", type="wav", root=str(tmp_path / "clips"), sample_rate=16000,
              audio_length_in_s=length_s, start_s=start_s, end_s=end_s, transforms=None)
    got, want = tdata.get_dataset(**kw), jdata.get_dataset(**kw)
    assert len(got) == len(want) == 3
    loader, jloader = tdata.get_dataloader(got), jdata.get_dataloader(want)
    assert len(loader) == 3
    for (wav, name), (jwav, jname) in zip(loader, jloader):
        assert name == jname and wav.dtype == jwav.dtype == np.float32
        assert wav.shape == jwav.shape == (1, int(round(length_s * 16000)))
        assert np.array_equal(wav, jwav), name


TASKS = ["music_generation", "music_inpainting", "super_resolution", "phase_retrieval",
         "music_dereverberation", "style_guidance"]


@pytest.mark.parametrize("task, mask_type", [(t, "box") for t in TASKS] + [
    ("music_inpainting", "random"), ("music_inpainting", "periodic")])
def test_build_operator_matches_jax(task, mask_type):
    argv = ["-t", task, "--mask_type", mask_type, "-m", "musicldm"]
    args = run.parse_arguments(argv)
    cfg = config.compose("dps", ["data=moises", "model=musicldm"], str(REPO / "configs"))
    op, scale = run.build_operator(args, cfg, get_noiser(**cfg.inverse_problem.noise))
    jop, jscale = jrun.build_operator(args, cfg, jget_noiser(**cfg.inverse_problem.noise))
    assert type(op).__name__ == type(jop).__name__ and scale == jscale
    drawn = {"mask_generator", "mask_key", "ir_generator", "ir_key"}
    fields = {f.name for f in dataclasses.fields(op)} - drawn
    assert fields == {f.name for f in dataclasses.fields(jop)} - drawn
    for name in sorted(fields):
        a, b = getattr(op, name), getattr(jop, name)
        if name == "noiser":
            assert type(a).__name__ == type(b).__name__ and a.sigma == b.sigma
        elif (name == "mask" and mask_type == "random") or name == "ir":
            assert np.shape(a) == np.shape(b)     # each package's own draw
        elif isinstance(a, np.ndarray) or hasattr(b, "shape"):
            assert np.array_equal(np.asarray(a), np.asarray(b)), name
        else:
            assert a == b, name


@pytest.mark.parametrize("task", ["music_inpainting", "super_resolution", "style_guidance"])
def test_unported_features_raise_before_loading(task, tmp_path, monkeypatch):
    """stable_audio generates music only: any other task raises JAX's
    "music_generation only" before anything is loaded or written."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="music_generation only"):
        run.main(["-m", "stable_audio", "-t", task, "--device", "cpu", "--tiny",
                  "-o", f"data.root={tmp_path}"])
    assert not (tmp_path / "outputs").exists()   # raised before anything was made


def test_cli_stable_audio_music_generation(tmp_path, monkeypatch, capsys):
    """`-m stable_audio -t music_generation --tiny` writes what the JAX
    `run.py` writes (tests/test_run_cli.py): the output tree, the mel PNG and
    a stereo wav of audio_end_in_s at the tiny Oobleck's 16 kHz; with -nw 2
    and no CLAP tower it keeps the generation order."""
    clips = tmp_path / "data_src"
    clips.mkdir()
    tt = np.arange(8000) / 16000
    write_wav(clips / "track.wav", (0.3 * np.sin(2 * np.pi * 440 * tt)).astype(np.float32),
              16000)
    monkeypatch.chdir(tmp_path)
    argv = ["-c", "ddim", "-t", "music_generation", "-m", "stable_audio", "--tiny",
            "--num_inference_steps", "2", "--device", "cpu", "-o", f"data.root={clips}",
            "-o", "data.start_s=0", "-o", "data.end_s=0.4",
            "-o", "model.pipe.audio_end_in_s=0.2"]
    run.main(argv + ["-o", "model.pipe.num_waveforms_per_prompt=1"])
    out = tmp_path / "outputs" / "stable_audio" / "moises" / "ddim" / "music_generation"
    for d in ["wav_input", "wav_recon", "wav_label", "mel_input", "mel_recon", "mel_label"]:
        assert (out / d).is_dir(), d
    assert (out / "mel_recon" / "track.png").stat().st_size > 0
    from diffmusic_tpu_torch.data import read_wav
    recon, sr = read_wav(out / "wav_recon" / "track.wav")
    assert sr == 16000 and recon.shape == (2, 3200) and np.isfinite(recon).all()
    assert "keeping generation order" not in capsys.readouterr().out
    (out / "wav_recon" / "track.wav").unlink()
    run.main(argv + ["-nw", "2"])
    assert "keeping generation order" in capsys.readouterr().out
    assert read_wav(out / "wav_recon" / "track.wav")[0].shape == (2, 3200)


def test_stable_audio_tiny_matches_jax_configs():
    from diffmusic_tpu.models import configs as jc
    from diffmusic_tpu_torch.pipelines import StableAudioPipeline
    p = StableAudioPipeline.tiny(device="cpu")
    for got, want in ((p.dit_cfg, jc.tiny_stable_audio_dit_config()),
                      (p.vae_cfg, jc.tiny_oobleck_config()), (p.text_cfg, jc.tiny_t5_config()),
                      (p.proj_cfg, jc.StableAudioProjectionConfig(32, 16, max_value=64.0))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert p.vae_cfg.hop_length == jc.tiny_oobleck_config().hop_length == 8
    assert p.tokenizer(["hi"])[0].shape == (1, 12) and p.device.type == "cpu"


def read_grey_png(path: Path) -> np.ndarray:
    raw = path.read_bytes()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, (w, h) = 8, b"", (0, 0)
    while pos < len(raw):
        (n,), tag = struct.unpack(">I", raw[pos:pos + 4]), raw[pos + 4:pos + 8]
        data = raw[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", raw[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(tag + data)
        if tag == b"IHDR":
            w, h, depth, colour = struct.unpack(">IIBB", data[:10])
            assert (depth, colour) == (8, 0)
        elif tag == b"IDAT":
            idat += data
        pos += 12 + n
    rows = zlib.decompress(idat)
    return np.frombuffer(rows, np.uint8).reshape(h, w + 1)[:, 1:]


def test_mel_png_without_matplotlib(tmp_path, rng, monkeypatch):
    monkeypatch.setattr(base, "have_matplotlib", lambda: False)
    mel = rng.uniform(-120, 120, (1, 50, 64)).astype(np.float32)   # (B, T, n_mels)
    base.save_mel_spectrogram(mel, tmp_path / "m.png", 16000)
    img = read_grey_png(tmp_path / "m.png")
    want = np.round((np.clip(mel[0].T[::-1], -80, 80) + 80) * 255 / 160).astype(np.uint8)
    assert img.shape == (64, 50) and np.array_equal(img, want)


def test_pipelines_tiny_match_jax_configs():
    """The port's `tiny` pipelines have the JAX tiny pipelines' configs and
    tokenizer lengths (the JAX `tiny()` runs flax's inits: not called here)."""
    from diffmusic_tpu.models import configs as jc
    from diffmusic_tpu_torch.pipelines import AudioLDM2Pipeline, MusicLDMPipeline
    m = MusicLDMPipeline.tiny("dps", device="cpu")
    a = AudioLDM2Pipeline.tiny("ditto", device="cpu")
    assert dataclasses.asdict(m.unet_cfg) == dataclasses.asdict(jc.tiny_unet_config())
    assert dataclasses.asdict(a.unet_cfg) == dataclasses.asdict(jc.tiny_unet_config((32, 32)))
    for p in (m, a):
        assert dataclasses.asdict(p.vae_cfg) == dataclasses.asdict(jc.tiny_vae_config())
        assert dataclasses.asdict(p.vocoder_cfg) == dataclasses.asdict(jc.tiny_hifigan_config())
        assert dataclasses.asdict(p.text_encoder.cfg) == dataclasses.asdict(
            jc.tiny_clap_text_config())
    assert m.tokenizer(["hi"])[0].shape == (1, 16) and a.tokenizer(["hi"])[0].shape == (1, 12)
    assert (m.scheduler_name, a.scheduler_name) == ("dps", "ditto")


def test_cli_run_writes_the_output_tree(tmp_path):
    clips = tmp_path / "data" / "moises_subset"
    clips.mkdir(parents=True)
    t = np.arange(16000 * 16) / 16000
    write_wav(clips / "track.wav", (0.3 * np.sin(2 * np.pi * 220 * t))[None].astype(np.float32),
              16000)
    # a 1-s clip (the box at 0.3-0.6 s of it) keeps the tiny UNet's attention small
    cmd = [sys.executable, "-m", "diffmusic_tpu_torch.run", "--device", "cpu", "--tiny",
           "--num_inference_steps", "2", "-c", "dps", "-m", "musicldm",
           "-o", "model.pipe.audio_length_in_s=1", "-o", "data.start_inpainting_s=10.3",
           "-o", "data.end_inpainting_s=10.6"]
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    proc = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = tmp_path / "outputs" / "musicldm" / "moises" / "dps" / "music_inpainting"
    for d, ext in (("wav", ".wav"), ("mel", ".png")):
        for part in ("input", "recon", "label"):
            assert (out / f"{d}_{part}" / f"track{ext}").stat().st_size > 0, (d, part)
    from diffmusic_tpu_torch.data import read_wav
    wav, sr = read_wav(out / "wav_recon" / "track.wav")
    assert sr == 16000 and wav.shape == (1, 16000) and np.isfinite(wav).all()
    again = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=600,
                           env=env)
    assert again.returncode == 0 and "already exists. Skipping." in again.stdout


def counted_unet_calls(monkeypatch) -> dict:
    """Counts of the UNet's kernel route calls (the block and flash
    attention), the plain versions taken on the CPU."""
    from diffmusic_tpu_torch.models import layers
    calls = dict.fromkeys(("fused_transformer_block", "flash_attention"), 0)
    for name in calls:
        fn = getattr(layers, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(layers, name, counted)
    return calls


def cli_clips(tmp_path) -> Path:
    clips = tmp_path / "clips"
    clips.mkdir()
    t = np.arange(16000 * 16) / 16000
    write_wav(clips / "track.wav", (0.3 * np.sin(2 * np.pi * 220 * t))[None].astype(np.float32),
              16000)
    return clips


@pytest.mark.parametrize("extra", [["-m", "musicldm", "-t", "style_guidance"],
                                   ["-m", "audioldm2", "--prompt_type", "clap"],
                                   ["-m", "musicldm", "-nw", "2"],
                                   ["-m", "audioldm2", "--transcription", "hello there"]],
                         ids=lambda a: " ".join(a[1:]))
def test_cli_clap_and_tts_runs(tmp_path, monkeypatch, capsys, extra):
    """The CLAP and TTS paths of the CLI on the tiny configs: style guidance
    with the tiny tower's frame features, AudioLDM2 conditioned on the
    measurement's CLAP embedding, two candidates re-ranked by CLAP (logged,
    best first), and AudioLDM2's TTS variant encoding a transcription; each
    writes its output tree and makes `chip_smoke.cli_launches`' UNet calls."""
    import chip_smoke
    calls = counted_unet_calls(monkeypatch)
    clips = cli_clips(tmp_path)
    monkeypatch.chdir(tmp_path)
    run.main(["--device", "cpu", "--tiny", "-c", "dps", "--num_inference_steps", "2",
              "-o", f"data.root={clips}", "-o", "model.pipe.audio_length_in_s=1",
              "-o", "data.start_inpainting_s=10.3", "-o", "data.end_inpainting_s=10.6",
              *extra])
    model = extra[1]
    task = "style_guidance" if "style_guidance" in extra else "music_inpainting"
    out = tmp_path / "outputs" / model / "moises" / "dps" / task
    assert sorted(str(p.relative_to(out)) for p in out.rglob("*.*")) == [
        "mel_input/track.png", "mel_label/track.png", "mel_recon/track.png",
        "wav_input/track.wav", "wav_label/track.wav", "wav_recon/track.wav"]
    assert {n: k for n, k in calls.items() if k} == chip_smoke.cli_launches(
        model, "dps", 2, 1, 1.0)
    logged = capsys.readouterr().out
    if "-nw" in extra:
        line = [ln for ln in logged.splitlines() if ln.startswith("CLAP re-ranking")][0]
        sims = [float(v) for v in line.split("[")[1].rstrip("]").split()]
        assert len(sims) == 2 and sims[0] >= sims[1]
    else:
        assert "CLAP re-ranking" not in logged


@pytest.mark.parametrize("model,sched,audio_s", [("musicldm", "ditto", 1.28),
                                                 ("audioldm2", "dps", 1.0)], ids=str)
def test_cli_unet_calls_match_chip_smoke(tmp_path, monkeypatch, model, sched, audio_s):
    """The UNet's kernel route calls of a --tiny CLI run on the CPU equal
    `chip_smoke.cli_launches`, which the card's CLI runs assert as launches:
    the block (MusicLDM) or flash attention (AudioLDM2, fuse_cross off) once
    per transformer block on a level of at least 512 tokens, per UNet
    forward; a DITTO step's forward runs twice under its checkpoint. At 1.28
    s both levels have 512 tokens or more, at 1 s only level 0."""
    import chip_smoke
    calls = counted_unet_calls(monkeypatch)
    clips = cli_clips(tmp_path)
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--tiny", "-m", model, "-c", sched, "--num_inference_steps",
            "2", "-o", f"data.root={clips}", "-o", f"model.pipe.audio_length_in_s={audio_s}",
            "-o", "data.start_inpainting_s=10.3", "-o", "data.end_inpainting_s=10.6",
            "-o", "scheduler.optim_outer_loop=2"]
    run.main(argv)
    want = chip_smoke.cli_launches(model, sched, 2, 2 if sched == "ditto" else 1, audio_s)
    assert {n: k for n, k in calls.items() if k} == want
