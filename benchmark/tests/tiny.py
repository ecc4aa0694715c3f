"""Tiny cells for the CPU tests, written as added files only: a benchmark
root with its own BENCHMARK.json, configuration, traffic and limits files,
the configurations being the real ones at tiny widths and float32."""

import copy
import json
from pathlib import Path

from benchmark.manifest import ROOT

SHRINK = {
    "unet": dict(block_out_channels=[16, 32], layers_per_block=1, norm_num_groups=8,
                 has_attention=[True, True]),
    "vae": dict(block_out_channels=[16, 32], layers_per_block=1, norm_num_groups=8,
                scaling_factor=0.5),
    "vocoder": dict(upsample_initial_channel=32, resblock_kernel_sizes=[3],
                    resblock_dilation_sizes=[[1, 3]]),
    "clap_text": dict(vocab_size=256, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                      intermediate_size=64, max_position_embeddings=64, projection_dim=32),
    "t5": dict(vocab_size=256, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4),
    "gpt2": dict(vocab_size=256, n_positions=64, n_embd=32, n_layer=2, n_head=4),
    "projection": dict(text_encoder_dim=32, text_encoder_1_dim=32, langauge_model_dim=32),
}
# (cell, configuration, traffic) of the real cells the tiny ones copy
CELLS = (("musicldm.inpaint-dps", "musicldm", "inpaint-dps"),
         ("audioldm2-music.generate-cfg", "audioldm2-music", "generate-cfg"),
         ("musicldm.dereverb-diffmusic", "musicldm", "dereverb-diffmusic"))


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def tiny_config(name: str) -> dict:
    cfg = copy.deepcopy(_read(ROOT / "benchmark" / "configs" / f"{name}.json"))
    cfg.update(audio_length_in_s=0.64, weight_dtype="float32")
    for group, kw in SHRINK.items():
        if group in cfg:
            cfg[group].update(kw)
    if cfg["pipeline"] == "musicldm":
        cfg["unet"]["projection_class_embeddings_input_dim"] = 32
    else:
        cfg["unet"]["cross_attention_dims"] = [32, 32]
    return cfg


def tiny_traffic(name: str) -> dict:
    tr = copy.deepcopy(_read(ROOT / "benchmark" / "traffic" / f"{name}.json"))
    # as in the real cells, a guided clip outlasts the window and a generated one ends in it
    tr.update(steps=4 if tr["sampler"]["name"] == "ddim" else 400, candidates=2, clips=2,
              min_steps=3, checks=1, span_steps=2)
    if "signal" in tr:
        tr["signal"]["notes"] = 4
    if tr["task"]["name"] == "music_dereverberation":
        tr["task"]["ir_length"] = 400
    return tr


def write_root(root: Path) -> dict:
    """A benchmark root under `root` holding the tiny cells, each limited as
    the real cell it copies; returns {tiny cell: real cell}."""
    manifest = copy.deepcopy(_read(ROOT / "BENCHMARK.json"))
    manifest["configs"], manifest["workloads"] = [], []
    for d in ("configs", "traffic", "limits"):
        (root / "benchmark" / d).mkdir(parents=True, exist_ok=True)
    out = {}
    for cell, config, traffic in CELLS:
        tc, tt = f"tiny-{config}", f"tiny-{traffic}"
        name = f"{tc}.{traffic}"
        if not any(c["name"] == tc for c in manifest["configs"]):
            (root / "benchmark" / "configs" / f"{tc}.json").write_text(
                json.dumps(tiny_config(config)))
            manifest["configs"].append({"name": tc, "source": "test", "reduced": [],
                                        "file": f"benchmark/configs/{tc}.json", "why": "test"})
        (root / "benchmark" / "traffic" / f"{tt}.json").write_text(
            json.dumps(tiny_traffic(traffic)))
        (root / "benchmark" / "limits" / f"{name}.json").write_text(
            (ROOT / "benchmark" / "limits" / f"{cell}.json").read_text())
        manifest["workloads"].append({"name": name, "config": tc, "traffic": tt, "chips": 1,
                                      "why": "test"})
        out[name] = cell
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return out
