"""Kernel-layout copies of frozen weights, made once per weight tensor.

The bf16 tensor-core kernels read their weights as a tap-major, K-major copy
(each tap's (Cout, Cin) matrix contiguous, input channels innermost): the
'same' conv2d (`conv2d.py`), the upsampler (`upsampler.py`) and the conv1d
kernel's forward passes, single and pair (`conv1d.py`, which keeps each
copy's TMA tensor map beside it). The conv1d adjoint reads the weight tensor
as it lies and keeps only a tensor map over it ("conv1d_adjoint"); the
conv2d adjoint keeps its flipped, channel-swapped weight with that weight's
tap-major copy ("conv2d_adjoint"). The modules keep their parameters in
their own layouts; `cached(name, w, make)` makes `make(w)` once per (kernel,
weight tensor) and keeps it until the tensor is written in place (its
`_version` moves) or has died. `REPACKS` counts what was made per name
(copies, or the adjoint's maps; not launches), and each make is a
"kernels.cache_miss" count in the tracing recorder (`tracing.count`).
"""

import weakref

import torch

from ..tracing import count

# copies made since the last reset, per kernel
REPACKS = {"conv2d_same": 0, "phase_convtranspose": 0, "conv1d_pair": 0,
           "conv1d_adjoint": 0, "conv2d_adjoint": 0}

# (kernel, data_ptr, shape, stride, dtype, device) -> (weakref to the tensor,
# _version, copy). The weakref keeps the entry honest: while the tensor lives,
# no other tensor can hold its address; views and the detached copies a
# state_dict hands out share its storage and version counter, so modules
# rebuilt on the same weights hit the same entry.
_CACHE = {}


def cached(name: str, w, make):
    """`make(w)` for kernel `name`, made once per weight tensor and remade
    when the tensor is written in place or has died."""
    key = (name, w.data_ptr(), tuple(w.shape), w.stride(), w.dtype, w.device)
    hit = _CACHE.get(key)
    if hit is not None and hit[0]() is not None and hit[1] == w._version:
        return hit[2]
    count("kernels.cache_miss", f"repack.{name}")
    with torch.no_grad():
        copy = make(w)
    for k in [k for k, (ref, _, _) in _CACHE.items() if ref() is None]:
        del _CACHE[k]
    _CACHE[key] = (weakref.ref(w), w._version, copy)
    REPACKS[name] += 1
    return copy
