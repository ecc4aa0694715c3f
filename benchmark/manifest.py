"""Everything a cell needs, found by name from `BENCHMARK.json`: its
configuration file (the manifest's `file`), its traffic mix
(`benchmark/traffic/<traffic>.json`), its limits (`benchmark/limits/<cell>.json`)
and its metrics, each per-layer one a reader `benchmark/metrics/<name>.py`.
A later cell, mix or metric is added by adding files and entries.
"""

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(name: str, root: Path = ROOT) -> dict:
    """The cell `name` of `root/BENCHMARK.json`, resolved."""
    manifest = _json(root / "BENCHMARK.json")
    cell = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"cell": cell, "config": _json(root / entry["file"]),
            "traffic": _json(root / "benchmark" / "traffic" / f"{cell['traffic']}.json"),
            "limits": _json(root / "benchmark" / "limits" / f"{name}.json"),
            "end_to_end": mine(manifest["end_to_end"]), "per_layer": mine(manifest["per_layer"]),
            "run_seconds": manifest["run_seconds"]}


def reader(metric: str):
    """The `read(ctx)` function of `benchmark/metrics/<metric>.py`."""
    path = ROOT / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def data(name: str) -> dict:
    """A data file of the benchmark's own (`benchmark/<name>.json`)."""
    return _json(ROOT / "benchmark" / f"{name}.json")
