"""Leaky-ReLU backward masks of the vocoder's adjoint convs: `leaky_mask` and
`leaky_mask_add`.

Replace `diffmusic_tpu/pallas/mask_kernel.py::leaky_mask` and
`::leaky_mask_add` with the CUDA kernels of `csrc/leaky_mask.cu`.

Bound on the H100: device memory, a few microseconds a call at the 10-s
slice's stages. What held the mask route back lay around the kernel:
  - the host's time to launch it, more than the kernel's own;
  - a copy of g before each mask, because the kernel read g only as
    (B, T, C) while the adjoint conv leaves it as the transposed view of a
    contiguous (B, C, T) tensor.
So g comes in either layout, as h or as that transposed view, which the
kernel transposes through shared-memory tiles on its way in. And the launch
path resolves once per operand geometry (shapes, strides, dtypes, devices)
what the launch needs, checking it there (`launch_plan`); per call it reads
the addresses, checks their alignment, allocates the output and launches on
the current stream's raw handle.

h and r (B, T, C) contiguous, g either layout, out (B, T, C) contiguous. They
run inside the conv1d kernels' backward functions only (`kernels/conv1d.py`),
so they have no autograd of their own. On a CPU tensor the wrappers run the
plain versions, which take g in any layout; on a CUDA tensor they launch the
kernel or raise.
"""

import functools

import torch

from ..tracing import count
from . import build
from .device import use_plain

# launches of each kernel since the last reset (see kernels.launch_counts)
LAUNCHES = {"leaky_mask": 0, "leaky_mask_add": 0}

G_AS_H, G_TRANSPOSED = 0, 1   # the kernel's g layouts (csrc/leaky_mask.cu)


def mask_ok(h) -> bool:
    """The JAX routing rule (`mask_kernel.mask_ok`) on (B, T, C): C % 128 == 0
    and T >= max(512, 2**19 / C)."""
    c = h.shape[-1]
    return c % 128 == 0 and h.shape[1] >= max(512, 2 ** 19 // c)


def leaky_mask_plain(h, g, slope, r=None):
    """where(h >= 0, g, slope * g) [+ r]."""
    out = torch.where(h >= 0, g, slope * g)
    return out if r is None else out + r


def _dense(shape, stride) -> bool:
    """Whether `stride` is the row-major contiguous stride of `shape`, dims of
    size 1 aside (as `Tensor.is_contiguous` reads it)."""
    expect = 1
    for n, s in zip(reversed(shape), reversed(stride)):
        if n != 1 and s != expect:
            return False
        expect *= n
    return True


@functools.lru_cache(maxsize=256)
def launch_plan(name: str, shapes: tuple, strides: tuple, dtypes: tuple, devices: tuple) -> tuple:
    """(dtype code, g layout) of a mask launch on h, g [, r], given in that
    order by their shapes, strides, dtypes and devices; raises for what the
    kernel does not take: shapes that differ, a device that is not one CUDA
    device, mixed or other dtypes, h or r not contiguous, g in neither
    layout (as h, or for (B, T, C) with C % 8 == 0 the transposed view of a
    contiguous (B, C, T) tensor)."""
    count("kernels.cache_miss", "mask.launch_plan")
    shape = shapes[0]
    if any(s != shape for s in shapes):
        raise ValueError(f"{name}: shapes differ: {[tuple(s) for s in shapes]}")
    if any(d.type != "cuda" or d != devices[0] for d in devices):
        raise ValueError(f"{name}: all tensors must be on one CUDA device, not {devices}")
    if any(t != dtypes[0] for t in dtypes):
        raise TypeError(f"{name}: mixed dtypes {dtypes}")
    code = build.dtype_code(dtypes[0])
    h_stride, g_stride, *r_stride = strides
    if not all(_dense(shape, s) for s in [h_stride] + r_stride):
        raise ValueError(f"{name}: h and r must be contiguous")
    if _dense(shape, g_stride):
        return code, G_AS_H
    if (len(shape) == 3 and shape[2] % 8 == 0
            and _dense((shape[0], shape[2], shape[1]), (g_stride[0], g_stride[2], g_stride[1]))):
        return code, G_TRANSPOSED
    raise ValueError(f"{name}: g of shape {tuple(shape)} and strides {g_stride} is neither "
                     f"contiguous nor the transposed view of a contiguous (B, C, T) tensor "
                     f"with C % 8 == 0")


def _launch(name, h, g, r, slope):
    if r is None:
        code, layout = launch_plan(name, (h.shape, g.shape), (h.stride(), g.stride()),
                                   (h.dtype, g.dtype), (h.device, g.device))
        rp = None
    else:
        code, layout = launch_plan(name, (h.shape, g.shape, r.shape),
                                   (h.stride(), g.stride(), r.stride()),
                                   (h.dtype, g.dtype, r.dtype), (h.device, g.device, r.device))
        rp = r.data_ptr()
    hp, gp = h.data_ptr(), g.data_ptr()
    if (hp | gp | (rp or 0)) % 16:
        raise ValueError(f"{name}: tensors must start 16-byte aligned")
    out = torch.empty_like(h)
    bsz, t, c = h.shape if layout == G_TRANSPOSED else (0, 0, 0)
    rc = build.library().dm_leaky_mask(code, layout, hp, gp, rp, out.data_ptr(),
                                       h.numel(), bsz, t, c, float(slope),
                                       build.stream_ptr(h.device))
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
