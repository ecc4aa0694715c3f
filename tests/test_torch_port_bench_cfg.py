"""The benchmark's AudioLDM2-music cell under CFG (`audioldm2-music.generate-cfg-24`),
on the CPU:

- the port's AudioLDM2 pipeline at tiny widths under CFG 3.5, 3 candidates
  and a non-empty negative prompt, against the frozen reference
  (`benchmark/reference/` through `check.Reference`, its own text stack and
  conditioning): the raw UNet output of each of the 2 x 3 rows at steps 0
  and 1;
- the cell resolves by name to its own traffic and limits files, runs 24
  candidates (the UNet at batch 48) under guidance 3.5, and reads the three
  region metrics, which no other cell reads; the launches the roofline
  counts are flash #9's at 48 rows.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

from benchmark import check, harness, manifest, program, weights as W
from benchmark.manifest import ROOT
from benchmark.reference.precision import FP32
from benchmark.work import attention, calls as work_calls
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

sys.path.insert(0, str(ROOT / "benchmark" / "tests"))
from tiny import tiny_config, tiny_traffic  # noqa: E402

CELL = "audioldm2-music.generate-cfg-24"
REGION_METRICS = {"unet.self_attn.device_ms", "unet.cross_attn.device_ms",
                  "unet.cross_attn.idle_ms"}
TOL = 1e-5   # float32 on both sides, as `benchmark/tests/test_bench_reference.py`
PROMPT, NEGATIVE = "upbeat funk bass", "noisy lo-fi recording"


@pytest.fixture(scope="module")
def cfg_steps():
    """(reference, [(UNet input rows, timestep, raw output)] of 2 steps)."""
    cfg = tiny_config("audioldm2-music")
    tr = dict(tiny_traffic("generate-cfg-24"), candidates=3, negative_prompt=NEGATIVE)
    weights = W.make(program.model_shapes(cfg), 2_718_281_829, "cpu", torch.float32)
    pipe = program.build(cfg, tr, weights, 5)
    seen = []
    hook = pipe.unet.register_forward_hook(
        lambda _m, args, out: seen.append((args[0].clone(), int(args[1][0]), out.clone())))
    try:
        pipe(**program.call_kwargs(cfg, tr, pipe, PROMPT, None,
                                   torch.Generator().manual_seed(11), 2))
    finally:
        hook.remove()
    return check.Reference(cfg, tr, weights, FP32, "cpu", 5), seen


@pytest.mark.parametrize("step", [0, 1])
def test_cfg_rows_against_the_reference(cfg_steps, step):
    ref, seen = cfg_steps
    assert len(seen) == 2
    rows, t, out = seen[step]
    assert rows.shape[0] == out.shape[0] == 6
    x = rows[:3]
    assert torch.equal(rows[3:], x)          # [x; x]: the unconditional half first
    with FP32.mode(), torch.no_grad():
        want = ref.unet(x.float(), t, PROMPT)
    for r in range(6):
        assert check.rel(out[r], want[r]) < TOL, r
    # the halves differ, so the order [uncond * 3, cond * 3] is what is held
    assert check.rel(out[:3], out[3:]) > 1e-3


def test_cell_resolves_to_its_files():
    spec = manifest.load(CELL)
    read = lambda *p: json.loads((ROOT.joinpath(*p)).read_text())
    assert spec["traffic"] == read("benchmark", "traffic", "generate-cfg-24.json")
    assert spec["limits"] == read("benchmark", "limits", f"{CELL}.json")
    assert spec["config"] == read("benchmark", "configs", "audioldm2-music.json")
    assert set(spec["limits"]) == {"cond", "eps", "step", "decode"}
    assert spec["cell"]["chips"] == 1 and spec["run_seconds"] == 51
    kw = program.call_kwargs(spec["config"], spec["traffic"], None, PROMPT, None, None, 200)
    assert kw["num_waveforms_per_prompt"] == 24 and kw["guidance_scale"] == 3.5
    assert kw["negative_prompt"] == "" and kw["measurement"] is None
    assert harness.latent_shape(spec["config"], spec["traffic"]) == (24, 8, 250, 16)


def test_region_metrics_are_this_cells_alone():
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    unlisted = {p["name"] for p in m["per_layer"] if "workloads" not in p}
    names = {p["name"] for p in manifest.load(CELL)["per_layer"]}
    assert names == unlisted | REGION_METRICS
    for w in m["workloads"]:
        if w["name"] != CELL:
            assert not REGION_METRICS & {p["name"] for p in manifest.load(w["name"])["per_layer"]}
    for name in REGION_METRICS:
        assert callable(manifest.reader(name))


def test_roofline_counts_flash_at_48_rows():
    spec = manifest.load(CELL)
    c = work_calls(spec["config"], spec["traffic"])
    flash = [(k, w) for k, w in c["per_step"] if k == attention.COUNTER]
    # 5 blocks a level (2 down, 3 up) at T 4000 (16 heads) and T 1000 (32 heads)
    assert flash == ([(attention.COUNTER, attention.work(48, 4000, 16, 8))] * 5
                     + [(attention.COUNTER, attention.work(48, 1000, 32, 8))] * 5)
    assert len(c["per_step"]) == 10 and c["per_clip"]     # the final decode's vocoder
