"""The manifest against its format rules (names, units, bounds, budget), every cell found by name,
and the import checks (CPU)."""

import ast
import json
import re
import subprocess
import sys

import pytest

from benchmark import manifest
from benchmark.manifest import ROOT
from benchmark.run import FORBIDDEN, forbidden_modules

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def m():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_units(m):
    assert set(m) == KEYS
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    assert m["paths"] == ["benchmark"] and m["command"][:3] == ["python3", "-m", "benchmark.run"]
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] == 1 and one_line(w["why"])
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(set(names)) == len(names)
    assert {"step_ms", "step_ms_p90", "setup_s"} <= {e["name"] for e in m["end_to_end"]}
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert p["moves"] == "step_ms" and one_line(p["layer"]) and p["source"] in SOURCES
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
    for x in m["per_layer"]:
        if x["name"].endswith("_roofline") or "mfu" in x["name"]:
            assert x["unit"] == "%"
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_check_fits_the_budget_with_24_cells(m):
    total = (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_every_cell_resolves_by_name(m):
    for w in m["workloads"]:
        spec = manifest.load(w["name"])
        assert spec["config"]["source"] == next(c["source"] for c in m["configs"]
                                                if c["name"] == w["config"])
        assert spec["traffic"]["steps"] >= spec["traffic"]["min_steps"]
        assert set(spec["limits"]) <= {"cond", "eps", "guide", "step", "decode"}
        for metric in spec["per_layer"]:
            assert callable(manifest.reader(metric["name"]))


def test_import_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "diffmusic_tpu_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "jax_like.sub", sys)
    assert forbidden_modules() == sorted(set(forbidden_modules()) & set(FORBIDDEN))
    assert "diffmusic_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "diffmusic_tpu.models", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert {"diffmusic_tpu", "jaxlib"} <= set(forbidden_modules())


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("diffmusic_tpu_torch", "diffmusic_tpu", "jax"), path
    code = ("import sys, benchmark.reference.models, benchmark.reference.text, "
            "benchmark.reference.audio, benchmark.reference.sampler, benchmark.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'diffmusic_tpu_torch', 'diffmusic_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "[]"
