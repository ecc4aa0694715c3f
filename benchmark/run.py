"""The benchmark of `diffmusic_tpu_torch` on one card:

    python3 -m benchmark.run --workload musicldm.inpaint-dps --seed 7 --seconds 30 --trace 0

runs the cell named in `BENCHMARK.json` and prints, as the last line of its
standard output, one JSON object: `correct`, `attempted` (answers compared),
`failed` (answers over their limit), `metrics` (the cell's end-to-end
metrics with `--trace 0`, its per-layer metrics with `--trace 1`), `device`
and, traced, `breakdown`; its last key, `checks`, holds each compared
number with its limit, which the last lines of standard error repeat.

It exits non-zero with no result when no card is visible, when the port
cannot be imported, or when `jax`, `jaxlib`, `flax` or `diffmusic_tpu` is
loaded at the end of the run. Caches (the port's kernel build) stay inside
the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "diffmusic_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not load, each
    compared whole (`diffmusic_tpu_torch` is not `diffmusic_tpu`)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card() -> dict:
    """The card's name and power limit as nvidia-smi reads them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return {"nvidia_smi": out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from . import manifest
    spec = manifest.load(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    from . import harness, program
    result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda",
                              T_START, program)
    props = torch.cuda.get_device_properties(0)
    info = {"sms": props.multi_processor_count, "sm_clock_hz": harness.sm_clock_hz()}
    metrics = harness.metrics(spec, result, bool(args.trace), info)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": result["memory_peak_bytes"], **card()}
    out = {"correct": result["correct"], "attempted": result["attempted"],
           "failed": result["failed"], "metrics": metrics, "device": device}
    t = result["timing"]
    print(f"window: {t['steps']} steps in {t['window_s']:.3f} s, {t['clips']} clip(s); "
          f"set-up {result['setup_s']:.3f} s; peak {result['memory_peak_bytes']} B",
          file=sys.stderr)
    for name, where, value in result["details"]:
        print(f"compared {name} at {where}: {value:.6g}", file=sys.stderr)
    if args.trace:
        s = result["summary"]
        device.update(busy_s=s["busy_s"], window_s=s["window_s"])
        out["breakdown"] = result["breakdown"]
    out["checks"] = result["checks"]
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded {bad}, which the port's benchmark may not load",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']:.6g} limit {c['limit']:.6g}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
