"""Timings of the port's fused GroupNorm (#10), fused mel spectrogram (#15)
and head_dim 32-512 flash attention (#9) on one NVIDIA GPU, to compare two
checkouts in turns and to choose the GroupNorm's cluster size.

    python3 kernel_ab.py calls [--tree DIR]
        Through the public wrappers of the package in DIR (default: this
        checkout), under no_grad as the UNet route and the eval call them:
        the fused GroupNorm at the 20 geometries of the fused route (bf16)
        and the mel spectrogram at (1, 160000) and (64, 160000) with the
        MFCC geometry and at (1, 160000) with n_fft 1024; per call the
        device ms (torch.profiler's self CUDA time), the host ms (host clock,
        `chip_smoke.split_ms`) and the CUDA-event ms (`chip_smoke.time_ms`),
        and the sums per guided step (60 GroupNorms) and per 64-pair eval
        (256 mels). One JSON line.
    python3 kernel_ab.py turns --parent DIR
        `calls` on this checkout and on DIR in turns, new, old, old, new,
        each in a process of its own; each line as it comes, then a summary.
    python3 kernel_ab.py gn-plans
        The fused GroupNorm kernel of this checkout at the 20 geometries,
        through its C entry point, under every cluster size k in 1, 2, 4, 8
        and a thread's target of 1, 2 or 4 loads: device us a call, in turns.
        One JSON line.
    python3 kernel_ab.py flash-wide [--parent DIR]
        The bf16 head_dim 32-512 flash kernel (#9 at the VAE mid-block's
        (1, 4000, 1, 512)) of this checkout and, with --parent, of DIR's
        source (each csrc/flash_attention.cu built with nvcc into a library
        of its own and called through its C entry point); beside them SDPA,
        the plain attention and the route's two backward forms: CUDA-event
        ms a call, median of the rounds, all taking turns in each round
        (forward order, then reversed), each kernel checked against the
        plain attention. One JSON line.

Every line names the card (nvidia-smi name and power limit). No fallback:
without a CUDA device the script exits non-zero.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
MEL_PER_EVAL = 256   # mel launches of a 64-pair eval, at (1, 160000) with the MFCC geometry


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def device_us(fn, n: int = 20) -> float:
    """Self CUDA time a call of fn() in us, from torch.profiler over n calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    for _ in range(3):   # now and then a trace holds no device events: trace again
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
        if total > 0:
            return total / n
    return float("nan")


def calls(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch
    import chip_smoke as cs
    from diffmusic_tpu_torch.kernels import build
    from diffmusic_tpu_torch.kernels import group_norm as GN
    from diffmusic_tpu_torch.kernels import mel as M
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    build.library()
    out = {"tree": str(tree), "card": card(), "build_s": time.time() - t0, "gn": [], "mel": []}
    gen = torch.Generator().manual_seed(0)
    sums = {"events": 0.0, "device": 0.0, "host": 0.0}
    with torch.no_grad():
        for (shape, eps, silu), n in sorted(cs.route_calls()["fused_group_norm"].items()):
            c = shape[1]
            x = cs.randn(shape, gen, "cuda", torch.bfloat16, 2.0, 0.3)
            wt = cs.randn((c,), gen, "cuda", torch.bfloat16, 0.2, 1.0)
            bt = cs.randn((c,), gen, "cuda", torch.bfloat16, 0.1)
            fn = lambda: GN.fused_group_norm(x, wt, bt, 32, eps, silu)
            dev, host = cs.split_ms({"kernel": fn})["kernel"]
            ev = cs.time_ms(fn)
            out["gn"].append({"shape": shape, "eps": eps, "silu": silu, "per_step": n,
                              "events_ms": ev, "device_ms": dev, "host_ms": host})
            for key, v in (("events", ev), ("device", dev), ("host", host)):
                sums[key] += n * v
        out["gn_per_step"] = sums
        for shape, kw in (((1, 160000), cs.MEL_MFCC), ((64, 160000), cs.MEL_MFCC),
                          ((1, 160000), cs.MEL_DEFAULT)):
            x = cs.randn(shape, gen, "cuda", torch.float32, 0.3)
            fns = {"kernel": lambda: M.fused_mel_spectrogram(x, **kw),
                   "plain": lambda: M.fused_mel_plain(x, **kw),
                   "composition": lambda: cs.mel_composition(x, kw)}
            split = cs.split_ms(fns)
            row = {"shape": shape, "n_fft": kw["n_fft"]}
            for name, fn in fns.items():
                row[name] = {"events_ms": cs.time_ms(fn), "device_ms": split[name][0],
                             "host_ms": split[name][1]}
            out["mel"].append(row)
    return out


def gn_geometry(n: int, k: int, thread_loads: int):
    """(vec, k, threads, loads) of the bf16 kernel for groups of n elements
    with k blocks a group and about `thread_loads` loads a thread; None
    where a thread would need more than 8 loads."""
    vec = next(v for v in (8, 4, 2, 1) if n % v == 0)
    per = -(-(n // vec) // k)
    threads = 32
    while threads < 512 and threads * thread_loads < per:
        threads *= 2
    loads = -(-per // threads)
    return None if loads > 8 else (vec, k, threads, loads)


def gn_plans() -> dict:
    import torch
    import chip_smoke as cs
    from diffmusic_tpu_torch.kernels import build
    from diffmusic_tpu_torch.kernels import group_norm as GN
    lib = build.library()
    gen = torch.Generator().manual_seed(0)
    rows = []
    for (shape, eps, silu), n_calls in sorted(cs.route_calls()["fused_group_norm"].items()):
        b, c, h, w = shape
        x = cs.randn(shape, gen, "cuda", torch.bfloat16, 2.0, 0.3)
        wt = cs.randn((c,), gen, "cuda", torch.bfloat16, 0.2, 1.0)
        bt = cs.randn((c,), gen, "cuda", torch.bfloat16, 0.1)
        y = torch.empty_like(x)
        ref = GN.group_norm_plain(x, wt, bt, 32, eps, silu)
        n = c // 32 * h * w
        plans = {}
        for k in (1, 2, 4, 8):
            for tl in (1, 2, 4):
                geo = gn_geometry(n, k, tl)
                if geo is not None:
                    plans[f"k{k} t{geo[2]} l{geo[3]}"] = geo
        stream = build.stream_ptr(x.device)

        def launch(geo):
            rc = lib.dm_group_norm(1, x.data_ptr(), wt.data_ptr(), bt.data_ptr(), y.data_ptr(),
                                   b, c, h * w, 32, float(eps), int(silu), *geo, stream)
            build.check(rc, "fused_group_norm")

        times = {name: [] for name in plans}
        for _ in range(2):   # in turns: every plan once, then every plan again
            for name, geo in plans.items():
                launch(geo)
                torch.cuda.synchronize()
                err = float((y.float() - ref.float()).abs().max() / ref.float().abs().max())
                if not err <= cs.TOL_ROUTE_BF16:
                    raise AssertionError(f"{shape} {name}: rel err {err:.2e}")
                times[name].append(device_us(lambda: launch(geo)))
        chosen = GN.fused_plan(x.shape, x.stride(), x.dtype, x.device, 32,
                               (wt.shape, wt.stride(), wt.dtype, wt.device,
                                bt.shape, bt.stride(), bt.dtype, bt.device))[5:]
        rows.append({"shape": shape, "elements": n, "per_step": n_calls,
                     "plan": list(chosen),
                     "device_us": {name: min(t) for name, t in times.items()}})
        best = min(rows[-1]["device_us"], key=rows[-1]["device_us"].get)
        print(f"  {shape} n {n}: plan {tuple(chosen)}; best {best} "
              f"{rows[-1]['device_us'][best]:.2f} us; "
              + ", ".join(f"{k} {v:.2f}" for k, v in rows[-1]["device_us"].items()),
              file=sys.stderr, flush=True)
    return {"card": card(), "gn_plans": rows}


FLASH_SHAPE = (1, 4000, 1, 512)


def build_flash(csrc: Path, out_dir: Path):
    """Start nvcc on `csrc`/flash_attention.cu: one shared library holding
    that file's entry points. Returns (Popen, lib)."""
    from diffmusic_tpu_torch.kernels import build
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libflash.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib),
           str(csrc / "flash_attention.cu")]
    log = open(out_dir / "build.log", "w")
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), lib


def flash_wide(parent) -> dict:
    import ctypes
    import math
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from diffmusic_tpu_torch.kernels import attention as A
    from diffmusic_tpu_torch.kernels import build
    root = HERE / "diffmusic_tpu_torch" / "kernels" / "_build" / "flash_ab"
    trees = {"new": HERE / "diffmusic_tpu_torch" / "kernels" / "csrc"}
    if parent is not None:
        trees["parent"] = parent / "diffmusic_tpu_torch" / "kernels" / "csrc"
    t0 = time.time()
    jobs = {name: build_flash(csrc, root / name) for name, csrc in trees.items()}
    libs = {}
    for name, (proc, path) in jobs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n"
                               + (root / name / "build.log").read_text()[-3000:])
        lib = ctypes.CDLL(str(path))
        lib.dm_flash_attention_wide.argtypes, lib.dm_flash_attention_wide.restype = \
            build.SIGNATURES["dm_flash_attention_wide"]
        libs[name] = lib
    out = {"card": card(), "shape": FLASH_SHAPE, "build_s": time.time() - t0, "ptxas": {}}
    for name in libs:
        text = (root / name / "build.log").read_text()
        out["ptxas"][name] = [ln.strip() for ln in text.splitlines()
                              if "C75" in ln or "spill" in ln or "registers" in ln]
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    b, t, h, d = FLASH_SHAPE
    q, k, v, g = (cs.randn(FLASH_SHAPE, gen, "cuda", torch.bfloat16) for _ in range(4))
    o = torch.empty_like(q)
    stream = build.stream_ptr(q.device)
    scale = 1.4426950408889634 / math.sqrt(d)
    with torch.no_grad():
        ref = A.attention_plain(q, k, v).float()

    def kernel(lib):
        def fn():
            build.check(lib.dm_flash_attention_wide(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                   o.data_ptr(), b, t, h, d, scale, stream),
                        "flash_attention")
        return fn

    qkv = [a.clone().requires_grad_(True) for a in (q, k, v)]
    graphs = {form: A.flash_attention(*qkv, form) for form in A.FLASH_BWD}
    fns = {name: kernel(lib) for name, lib in libs.items()}
    fns["sdpa"] = lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                         v.transpose(1, 2))
    fns["plain"] = lambda: A.attention_plain(q, k, v)
    for form, y in graphs.items():
        fns[f"backward_{form}"] = (lambda y=y: torch.autograd.grad(y, qkv, g,
                                                                   retain_graph=True))
    out["err"] = {}
    for name in libs:
        fns[name]()
        torch.cuda.synchronize()
        out["err"][name] = float((o.float() - ref).abs().max() / ref.abs().max())
        if not out["err"][name] <= cs.TOL_FLASH_BF16:
            raise AssertionError(f"{name}: rel err {out['err'][name]:.2e}")
    times = {name: [] for name in fns}
    order = list(fns)
    for rnd in range(4):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            with torch.no_grad() if not name.startswith("backward") else torch.enable_grad():
                times[name].append(cs.time_ms(fns[name], reps=3, inner=10))
    import statistics
    out["ms"] = {name: statistics.median(ts) for name, ts in times.items()}
    out["ms_rounds"] = times
    useful = 4 * t * t * h * d
    out["useful_tflops"] = {name: useful / ms / 1e9 for name, ms in out["ms"].items()
                            if name in libs}
    plan = (ctypes.c_int * 6)()
    fn = libs["new"].dm_flash_attention_wide_plan
    fn.argtypes, fn.restype = build.SIGNATURES["dm_flash_attention_wide_plan"]
    build.check(fn(b, t, h, d, ctypes.addressof(plan)), "flash_attention")
    out["grid"] = list(plan[:3])   # (query tiles, batch x heads, key splits) of this checkout
    for name, ms in out["ms"].items():
        print(f"  {name:26s} {ms:.4f} ms", file=sys.stderr, flush=True)
    return out


def summary(tag: str, r: dict) -> str:
    gn = r["gn_per_step"]
    parts = [f"{tag}: gn per step events {gn['events']:.3f} device {gn['device']:.3f} "
             f"host {gn['host']:.3f} ms"]
    for row in r["mel"]:
        k = row["kernel"]
        if tuple(row["shape"]) == (1, 160000) and row["n_fft"] == 400:
            parts.append(f"mel per eval events {MEL_PER_EVAL * k['events_ms']:.3f} ms")
        parts.append(f"mel {tuple(row['shape'])} n_fft {row['n_fft']}: events "
                     f"{k['events_ms']:.4f} device {k['device_ms']:.4f} host "
                     f"{k['host_ms']:.4f} (plain {row['plain']['events_ms']:.4f}, composition "
                     f"{row['composition']['events_ms']:.4f})")
    return "; ".join(parts)


def turns(parent: Path) -> None:
    results = []
    for tag, tree in (("new", HERE), ("old", parent), ("old", parent), ("new", HERE)):
        proc = subprocess.run([sys.executable, str(HERE / "kernel_ab.py"), "calls", "--tree",
                               str(tree)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"calls on {tree} failed:\n{proc.stderr[-4000:]}")
        line = proc.stdout.strip().splitlines()[-1]
        print(f"{tag} {line}", flush=True)
        results.append((tag, json.loads(line)))
    for tag, r in results:
        print(summary(tag, r), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("calls", "turns", "gn-plans", "flash-wide"))
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--parent", type=Path)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.mode == "calls":
        print(json.dumps(calls(args.tree.resolve())), flush=True)
    elif args.mode == "gn-plans":
        sys.path.insert(0, str(HERE))
        print(json.dumps(gn_plans()), flush=True)
    elif args.mode == "flash-wide":
        sys.path.insert(0, str(HERE))
        print(json.dumps(flash_wide(None if args.parent is None else args.parent.resolve())),
              flush=True)
    else:
        if args.parent is None:
            ap.error("turns needs --parent")
        turns(args.parent.resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main())
