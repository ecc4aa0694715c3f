"""Leaky-ReLU backward masks of the vocoder's adjoint convs: `leaky_mask` and
`leaky_mask_add`.

Replace `diffmusic_tpu/pallas/mask_kernel.py::leaky_mask` and
`::leaky_mask_add` with the CUDA kernel of `csrc/leaky_mask.cu`.

Bound on the H100: device memory (two or three reads and one write per
element). One grid-stride pass with 16-byte loads, the compare in fp32, the
result in g's dtype. They run inside the conv1d kernels' backward functions
only (`kernels/conv1d.py`), so they have no autograd of their own. On a CPU
tensor the wrappers run the plain versions; on a CUDA tensor they launch the
kernel or raise.
"""

import torch

from .device import use_plain

# launches of each kernel since the last reset (see kernels.launch_counts)
LAUNCHES = {"leaky_mask": 0, "leaky_mask_add": 0}


def mask_ok(h) -> bool:
    """The JAX routing rule (`mask_kernel.mask_ok`) on (B, T, C): C % 128 == 0
    and T >= max(512, 2**19 / C)."""
    c = h.shape[-1]
    return c % 128 == 0 and h.shape[1] >= max(512, 2 ** 19 // c)


def leaky_mask_plain(h, g, slope, r=None):
    """where(h >= 0, g, slope * g) [+ r]."""
    out = torch.where(h >= 0, g, slope * g)
    return out if r is None else out + r


def _launch(name, h, g, r, slope):
    from . import build
    ops = [h, g] + ([r] if r is not None else [])
    build.check_tensors(name, *ops)
    if any(t.shape != h.shape for t in ops):
        raise ValueError(f"{name}: shapes differ: {[tuple(t.shape) for t in ops]}")
    out = torch.empty_like(g)
    rc = build.library().dm_leaky_mask(
        build.dtype_code(g.dtype), h.data_ptr(), g.data_ptr(),
        r.data_ptr() if r is not None else None, out.data_ptr(), g.numel(), float(slope),
        build.stream_ptr(g.device))
    build.check(rc, name)
    LAUNCHES[name] += 1
    return out


def leaky_mask(h, g, slope):
    """where(h >= 0, g, slope * g): the VJP of leaky_relu at pre-activation h
    applied to the cotangent g."""
    if use_plain(h, "leaky_mask"):
        return leaky_mask_plain(h, g, slope)
    return _launch("leaky_mask", h, g, None, slope)


def leaky_mask_add(h, g, r, slope):
    """where(h >= 0, g, slope * g) + r: the mask fused with the residual
    path's cotangent."""
    if use_plain(h, "leaky_mask_add"):
        return leaky_mask_plain(h, g, slope, r)
    return _launch("leaky_mask_add", h, g, r, slope)
