"""Tracing, profiling and failure detection (port of `diffmusic_tpu/tracing.py`).

- `trace(logdir)`: `torch.profiler` over the host and the card, written as a
  Chrome trace (`chrome://tracing`, Perfetto) under `logdir`. The denoise
  loop marks each step's "unet_forward" and "guided_step"
  (`pipelines/base.py::run_denoise_loop`), as the JAX package does.
- `annotate(name)`: a named range, `record_function` in the profiler's trace
  and an NVTX range on the card.
- `debug_nans(enable)`: raise `FloatingPointError` at the first op whose
  floating output holds a NaN, as `jax_debug_nans` does (debug only).
- `device_memory_stats()`: the caching allocator's live and peak bytes per
  card.
- The per-step loss on the host: `show_progress=True` on a pipeline call.
"""

import contextlib
import time
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


@contextlib.contextmanager
def trace(logdir):
    """Profile the block (CPU, and CUDA where a card is present) and write
    its Chrome trace to `logdir/trace_<time>.json`; yields the profiler (its
    `key_averages()` are there after the block)."""
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(logdir / f"trace_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range: `with annotate("vae_decode"): ...`. It shows in a
    `trace` and, on the card, as an NVTX range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class _NaNCheck(TorchDispatchMode):
    """Checks the floating outputs of every dispatched op."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
                    and t.device.type != "meta" and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


_NAN_MODE = None


def debug_nans(enable: bool = True) -> None:
    """While enabled, the first op that yields a NaN raises
    `FloatingPointError` naming it (a `TorchDispatchMode` that checks every
    floating output; each check reads the result back to the host, so it
    synchronises with the card and is for debugging only).

    It sees the ops that pass through PyTorch's dispatcher, on this thread:
    the forward and autograd's backward ops, cuDNN and cuBLAS calls. It
    does not see inside a hand-written kernel (only the tensor the wrapper
    returns), work on other threads, or NaNs that an op creates and
    consumes internally without returning them. Production keeps the
    pipelines' NaN retry instead (`pipelines/base.py::denoise_with_nan_retry`)."""
    global _NAN_MODE
    if enable and _NAN_MODE is None:
        _NAN_MODE = _NaNCheck()
        _NAN_MODE.__enter__()
    elif not enable and _NAN_MODE is not None:
        _NAN_MODE.__exit__(None, None, None)
        _NAN_MODE = None


def device_memory_stats() -> dict:
    """{card: {"bytes_in_use", "peak_bytes_in_use"}} from the caching
    allocator (`torch.cuda.memory_stats`); {} without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0)}
    return out
