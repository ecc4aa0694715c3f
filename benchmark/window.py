"""The measured window: the cell's pipeline `__call__` back to back, one clip
after another, for a fixed number of seconds.

Each call gets a `callback` that records a CUDA event at every step
boundary, with no synchronize, and ends the call with `StopWindow` once the
window's time is spent. `step_ms` is the window's wall time (its final
synchronize inside) over the steps completed; `step_ms_p90` the 90th
percentile of the steps' times between consecutive events.

At the steps the check compares, the callback keeps the latents entering
and leaving the step and the generator's state before it, and a forward
hook on the UNet keeps the step's raw output and its conditioning; at a
clip's last step it keeps the final latents, and the call's audio is kept
for the first clip that ends. At other steps neither does any work on the
device.

With a `span` (the traced run) the window closes as usual, and the same
sequence of calls goes on while the profiler records the next
`span.steps` steps.
"""

import statistics
import time

import torch


class StopWindow(Exception):
    """Raised from the callback: the window (or the traced span) is over."""


class Window:
    def __init__(self, pipe, clip_kwargs, steps_per_clip: int, checked: list,
                 generator: torch.Generator, max_steps: int, span=None, event=None,
                 sync=torch.cuda.synchronize, taps=None):
        """`event`: a class with `torch.cuda.Event`'s record / elapsed_time
        (default: CUDA events with timing); `sync`: waits for the device;
        `taps`: {name: module} whose calls in the first clip's prompt
        encoding are kept (inputs and outputs) for the check."""
        self.pipe, self.clip_kwargs, self.sync = pipe, clip_kwargs, sync
        self.steps_per_clip, self.generator, self.span = steps_per_clip, generator, span
        self.checked = set(checked)
        self.want_in = {j - 1 for j in self.checked if j > 0}
        make = event or (lambda: torch.cuda.Event(enable_timing=True))
        self.events = [make() for _ in range(max_steps + 1)]
        self.records = {}        # window step -> what the check compares
        self.clip_starts = {}    # clip -> generator state before its call
        self.decoded = None      # the first clip that ended: final latents, audio
        self.n = 0               # steps completed
        self.clip = 0
        self.timing = None
        self._last = None
        self.taps, self.tapped = taps or {}, []
        self._tap_hooks = []

    def _tap(self, name):
        def hook(module, args, out):
            self.tapped.append((name, detached(args), detached(out)))
        return hook

    def _unet_hook(self, module, args, kwargs, out):
        if self.n in self.checked and self.n not in self.records:
            cond = tuple(kwargs[k] for k in ("class_labels", "encoder_hidden_states",
                                             "encoder_hidden_states_1")
                         if kwargs.get(k) is not None)
            self.records[self.n] = {"eps": out.detach().clone(),
                                    "cond": tuple(c.detach().clone() for c in cond)}

    def _callback(self, i, t, x):
        n = self.n
        for h in self._tap_hooks:
            h.remove()
        self._tap_hooks = []
        if n + 1 >= len(self.events):
            raise StopWindow
        self.events[n + 1].record()
        if n in self.records:
            rec = self.records[n]
            rec.update(clip=self.clip, i=i, t=int(t), prev=x.detach().clone())
            if i > 0 and self._last is not None and self._last[0] == n - 1:
                rec.update(x_in=self._last[1], gen_state=self._last[2])
        if n in self.want_in:
            self._last = (n, x.detach().clone(), self.generator.get_state())
        if i == self.steps_per_clip - 1 and self.decoded is None:
            self.decoded = {"clip": self.clip, "latents": x.detach().clone()}
        self.n = n + 1
        if self.timing is None:
            if time.perf_counter() >= self.deadline:
                self.timing = self._close()
                if self.span is None:
                    raise StopWindow
                self.span.open()
        elif self.span.step(i):
            raise StopWindow

    def run(self, seconds: float) -> dict:
        """Runs the window (and the span); returns the window's timing."""
        hook = self.pipe.unet.register_forward_hook(self._unet_hook, with_kwargs=True)
        self._tap_hooks = [m.register_forward_hook(self._tap(k)) for k, m in self.taps.items()]
        self.events[0].record()
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + seconds
        try:
            while True:
                self.clip_starts[self.clip] = self.generator.get_state()
                out = self.pipe(**self.clip_kwargs(self.clip), callback=self._callback)
                if self.decoded is not None and "audio" not in self.decoded:
                    self.decoded["audio"] = out.audios
                self.clip += 1
        except StopWindow:
            pass
        finally:
            hook.remove()
            for h in self._tap_hooks:
                h.remove()
        if self.timing is None:
            self.timing = self._close()
        return self.timing

    def _close(self) -> dict:
        self.sync()
        wall = time.perf_counter() - self.t0
        n = self.n
        times = [self.events[k].elapsed_time(self.events[k + 1]) for k in range(n)]
        return {"steps": n, "window_s": wall, "step_ms": wall * 1e3 / n,
                "step_ms_p90": statistics.quantiles(times, n=10, method="inclusive")[-1],
                "step_times_ms": times, "clips": self.clip + 1}


def detached(v):
    """A detached copy of the tensors in a call's arguments or output."""
    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    if isinstance(v, (tuple, list)):
        return type(v)(detached(a) for a in v)
    return v
