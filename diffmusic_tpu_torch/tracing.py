"""Tracing, profiling and failure detection (port of `diffmusic_tpu/tracing.py`).

- `trace(logdir)`: `torch.profiler` over the host and the card, written as a
  Chrome trace (`chrome://tracing`, Perfetto) under `logdir`. The denoise
  loop marks each step's "unet_forward" and "guided_step"
  (`pipelines/base.py::run_denoise_loop`), as the JAX package does.
- `annotate(name, step)`: a named range, an NVTX range on the card and,
  while a `torch.profiler` session records (a `trace`, or any other
  profiler), a `record_function` range in the profiler's trace and a span in
  the recorder. The spans: the denoise loop's "unet_forward" and
  "guided_step"; the guided loss's "guided.vae", "guided.vocoder",
  "guided.loss_head" and "guided.backward"; AudioLDM2's text stack,
  "text.clap", "text.t5", "text.projection", "text.gpt2", once a prompt
  (`pipelines/audioldm2.py::_encode_one`); a call's final "decode" (the
  VAE decoder and the vocoder, `pipelines/musicldm.py::__call__`).
- `region(name, what)`: a sub-stage marked inside a span, recorded in
  `spans()` as kind "region" while a profiler records, and nothing else: no
  NVTX range, no `record_function` range, no place on the span stack, so
  that it relabels nothing a reader of spans labels. With no profiler
  recording it costs one check of the flag and returns a shared no-op
  context. The UNet's transformer blocks mark "unet.self_attn",
  "unet.cross_attn" (`what` the stream's index), "unet.ff" and, where the
  block runs as one fused launch, "unet.fused_block"
  (`models/layers.py::BasicTransformerBlock`).
- The recorder: a bounded in-memory buffer that `spans()` returns, filled
  only while a profiler records (the flag the profiler itself sets). A span
  holds its name, start and end (`time.time_ns()`, the clock the profiler
  stamps its events with), thread, id, the id of the enclosing span and the
  denoise step it belongs to: (clip-local index, timestep), which the
  denoise loop passes to its ranges and the ranges inside them inherit.
  `count(name, what)` adds a point event; `mark_backward(tensor, name)`
  cuts the backward span open when autograd reaches `tensor` into one span
  a stage (`<name>.backward`). With no profiler recording a range costs
  that one check and its NVTX push and pop, and no hook is registered.
- `debug_nans(enable)`: raise `FloatingPointError` at the first op whose
  floating output holds a NaN, as `jax_debug_nans` does (debug only).
- `device_memory_stats()`: the caching allocator's live and peak bytes per
  card.
- The per-step loss on the host: `show_progress=True` on a pipeline call.

No span name starts with "cu": a reader of the profiler's host events may
take such names for CUDA runtime calls.
"""

import collections
import contextlib
import itertools
import threading
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


# the recorder's buffer (spans and counts, oldest first; the oldest fall out
# when it is full), the spans open on any thread in the order they opened,
# and each thread's own stack of open spans
_RECORDS = collections.deque(maxlen=1 << 16)
_OPEN = []
_LOCK = threading.Lock()
_IDS = itertools.count(1)
_LOCAL = threading.local()


def _recording() -> bool:
    """Whether a profiler session records: the flag `torch.profiler` sets."""
    return torch.autograd._profiler_enabled()


class _Span:
    __slots__ = ("id", "name", "start", "end", "thread", "parent", "step", "marks")

    def __init__(self, name, thread, parent, step):
        self.id, self.name, self.thread = next(_IDS), name, thread
        self.start = self.end = time.time_ns()
        self.parent, self.step, self.marks = parent, step, []


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def _enclosing():
    """The innermost span open on this thread, else the latest opened on
    any thread (autograd's device thread opens none of its own)."""
    stack = _stack()
    if stack:
        return stack[-1]
    with _LOCK:
        return _OPEN[-1] if _OPEN else None


def _record(kind, name, start, end, thread, parent, step, span_id=None, what=None) -> None:
    rec = {"kind": kind, "name": name, "start": start, "end": end, "thread": thread,
           "id": span_id, "parent": parent, "step": step, "what": what}
    with _LOCK:
        _RECORDS.append(rec)


def _open(name: str, step) -> _Span:
    parent = _enclosing()
    if step is None and parent is not None:
        step = parent.step
    span = _Span(name, threading.get_ident(), parent.id if parent is not None else None, step)
    _stack().append(span)
    with _LOCK:
        _OPEN.append(span)
    return span


def _close(span: _Span) -> None:
    _stack().pop()
    with _LOCK:
        _OPEN.remove(span)
        marks = list(span.marks)
    _record("span", span.name, span.start, span.end, span.thread, span.parent, span.step,
            span.id)
    for k, (name, t, thread) in enumerate(marks):
        stop = marks[k + 1][1] if k + 1 < len(marks) else span.end
        _record("span", f"{name}.backward", t, stop, thread, span.id, span.step, next(_IDS))


@contextlib.contextmanager
def annotate(name: str, step=None):
    """A named range: `with annotate("vae_decode"): ...`. It shows on the
    card as an NVTX range and, while a profiler records, in its trace as a
    `record_function` range and in `spans()` as a span; `step` (clip-local
    index, timestep) names the denoise step, which ranges opened inside it
    inherit."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        if not _recording():
            yield
            return
        # the bookkeeping lies outside the profiler's range and the stamps
        # just inside it, so that the span matches the range on its clock
        span = _open(name, step)
        try:
            with torch.profiler.record_function(name):
                span.start = time.time_ns()
                try:
                    yield
                finally:
                    span.end = time.time_ns()
        finally:
            _close(span)
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _mark(name: str) -> None:
    if _recording():
        t = time.time_ns()
        with _LOCK:
            if _OPEN:
                _OPEN[-1].marks.append((name, t, threading.get_ident()))


def mark_backward(tensor: torch.Tensor, name: str) -> torch.Tensor:
    """While a profiler records, a hook on `tensor`, the output of the
    forward stage `name`: when autograd's backward reaches it (on the thread
    that runs the backward, autograd's device thread on the card), the span
    latest opened and still open, on any thread, enters `name`'s backward,
    recorded when that span closes as the span `<name>.backward`, from the
    hook to the next such hook or the span's end (not a `record_function`
    range: it is cut after the fact). Registers nothing otherwise, or when
    `tensor` needs no gradient. Returns `tensor`."""
    if tensor.requires_grad and _recording():
        tensor.register_hook(lambda grad: _mark(name))
    return tensor


def count(name: str, what=None) -> None:
    """While a profiler records, a point event `name` in `spans()`, with
    `what` it counts (which cache missed, say), the enclosing span and its
    step."""
    if _recording():
        t = time.time_ns()
        parent = _enclosing()
        _record("count", name, t, t, threading.get_ident(),
                parent.id if parent is not None else None,
                parent.step if parent is not None else None, what=what)


class _Region:
    __slots__ = ("name", "what", "start")

    def __init__(self, name, what):
        self.name, self.what = name, what

    def __enter__(self):
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        parent = _enclosing()
        _record("region", self.name, self.start, end, threading.get_ident(),
                parent.id if parent is not None else None,
                parent.step if parent is not None else None, what=self.what)
        return False


_NO_REGION = contextlib.nullcontext()


def region(name: str, what=None):
    """A sub-stage inside a span: `with region("unet.ff"): ...`. While a
    profiler records, a record of kind "region" in `spans()` with `what`
    (a stream's index, say), the enclosing span and its step; it opens no
    span, NVTX or `record_function` range, so that readers of the spans see
    what they saw without it. Otherwise one check of the flag and a shared
    no-op context."""
    if not _recording():
        return _NO_REGION
    return _Region(name, what)


def spans() -> list:
    """The recorder's buffer, oldest first: dicts with `kind` ("span",
    "count" or "region"), `name`, `start` and `end` (ns, the profiler's
    clock; a count's are equal), `thread`, `id` (spans), `parent` (the
    enclosing span's id or None), `step` ((clip-local index, timestep) or
    None) and `what` (counts and regions)."""
    with _LOCK:
        return list(_RECORDS)


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
