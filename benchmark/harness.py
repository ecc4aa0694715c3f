"""One run of one cell: set-up, the window, the traced span, the check.

`run_cell` is device-agnostic so that the tests can drive a whole run on the
CPU at a tiny size; `benchmark/run.py` is the entry that demands the card.
"""

import gc
import math
import subprocess
import time

import torch

from . import check, manifest, traffic as T, weights as W, window as WIN
from .work import calls as work_calls
from .reference.precision import FP32

SAMPLE_RATE = 16000
WARMUP_STEPS = 2
EVENTS_PER_SECOND = 200      # the most steps a second any cell can run


class HostEvent:
    """`torch.cuda.Event`'s interface on the host clock, for CPU runs."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


def latent_shape(config: dict, traffic: dict) -> tuple:
    """(candidates, channels, mel frames / s, mel bins / s), s the VAE's
    downsampling (100 mel frames a second at 16 kHz, hop 160)."""
    s = 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    return (traffic["candidates"], config["unet"]["in_channels"],
            int(config["audio_length_in_s"] * 100) // s, config["vocoder"]["model_in_dim"] // s)


def sm_clock_hz() -> float:
    """The card's top SM clock, read from nvidia-smi (the exp2 floor's rate)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.splitlines()[0]) * 1e6


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, program) -> dict:
    """The run's result: end-to-end or per-layer metrics, the compared
    numbers with their limits, the device readings. `program` is the module
    that builds the system under test (`benchmark/program.py`), passed in so
    that a test can plant a fault in it."""
    config, tr, limits = spec["config"], spec["traffic"], spec["limits"]
    w_seed, gen_seed, tr_seed, ir_seed, check_seed = T.streams(seed, 5)
    cuda = device == "cuda"
    dtype = getattr(torch, config["weight_dtype"])

    weights = W.make(program.model_shapes(config), w_seed, device, dtype)
    pipe = program.build(config, tr, weights, ir_seed)
    clips = T.clips(tr, config["audio_length_in_s"], SAMPLE_RATE, tr_seed, tr["clips"])
    generator = torch.Generator(device).manual_seed(gen_seed)

    def clip_kwargs(k, steps=tr["steps"]):
        prompt, gt = clips[k % len(clips)]
        return program.call_kwargs(config, tr, pipe, prompt, gt, generator, steps)

    pipe(**clip_kwargs(0, WARMUP_STEPS))             # every shape of the window, once
    span = None
    if trace:
        from .trace import Span
        span = Span(tr["span_steps"], tr["steps"],
                    (program.reset_launch_counts, program.launch_counts))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    checked = T.checked_steps(tr, check_seed)
    max_steps = int(seconds * EVENTS_PER_SECOND) + tr["span_steps"] + 1
    win = WIN.Window(pipe, clip_kwargs, tr["steps"], checked, generator, max_steps, span,
                     event=None if cuda else HostEvent, sync=torch.cuda.synchronize if cuda
                     else (lambda: None), taps=program.text_taps(pipe))
    setup_s = time.perf_counter() - t_start
    timing = win.run(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    result = {"timing": timing, "setup_s": setup_s, "memory_peak_bytes": peak}
    if trace:
        from .trace import breakdown, summarize
        result["summary"] = summarize(span, manifest.data("kernels")["names"])
        result["breakdown"] = breakdown(result["summary"])

    records, clip_starts, decoded, tapped = win.records, win.clip_starts, win.decoded, win.tapped
    program.free(pipe)
    del pipe, win, span
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref = check.Reference(config, tr, weights, FP32, device, ir_seed)
    with FP32.mode():
        numbers, details, flops = check.readings(ref, records, clips, clip_starts, decoded,
                                                 latent_shape(config, tr), count_flops=trace,
                                                 tapped=tapped)
    # a number the cell's limits do not name has no limit and fails
    lim = {k: limits.get(k, float("nan")) for k in numbers}
    result["checks"] = {k: {"value": v, "limit": lim[k]} for k, v in sorted(numbers.items())}
    result["details"] = details
    result["correct"] = bool(numbers) and all(
        math.isfinite(v) and v <= lim[k] for k, v in numbers.items())
    result["attempted"] = len(details)
    result["failed"] = sum(1 for k, _, v in details if not v <= lim[k])
    result["flops_step"] = flops
    return result


def metrics(spec: dict, result: dict, trace: bool, device_info: dict) -> dict:
    """The cell's end-to-end metrics (`trace` off) or per-layer ones (on)."""
    t = result["timing"]
    if not trace:
        values = {"step_ms": t["step_ms"], "step_ms_p90": t["step_ms_p90"],
                  "setup_s": result["setup_s"]}
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                for m in spec["end_to_end"]}
    ctx = {"summary": result["summary"], "window": t, "flops_step": result["flops_step"],
           "calls": work_calls(spec["config"], spec["traffic"]), "peaks": manifest.data("peaks"),
           **device_info}
    out = {}
    for m in spec["per_layer"]:
        v = manifest.reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
