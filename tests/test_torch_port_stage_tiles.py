"""The bf16 stage backward's passes (`csrc/stage_bwd.cu` on the conv1d
kernel's TMA + wgmma core, `kernels/stage_bwd.py`), on the CPU, against the
plain version, the JAX package and a float64 oracle.

The passes cannot run here, so `emulate_stage_bwd` computes what they
compute from the same operands, in the wrapper's own schedule
(`stage_schedule`): the first operand round(g / n_branches) on the signal
rows; per pass, each slot's adjoint conv as #6's pass computes it
(`emulate_pass` of `test_torch_port_conv1d_tiles.py` with `flip`: per
128-row tile and (64-channel slice, tap), the input box at the tap's shift
with zeros outside, bf16 operands, fp32 sums) and then its epilogue in fp32:
MASK dh = leaky'(h_i) * acc rounded to bf16; MASK_ACC dcur = leaky'(x_i) *
acc + dcur (g / n_branches at a branch's first pair), kept fp32 and rounded
to bf16 as the next operand; every row outside the signal exactly 0; then
the branches' dcur summed in branch order and rounded once. At t 700 and at
a t under one row tile (100), on the canvas of the slice's ch128 stage (KS
(3, 7, 11), dilations (1, 3, 5) x 3), it must equal `stage_bwd_plain` on
bf16 values, the JAX `stage_resblocks_canvas` VJP on its CPU path and the
float64 oracle `_stage_grad_numpy_f64` within 2e-2 of the norm
(TOL_CONV_BF16: every conv operand is rounded to bf16), with exact zeros in
the margins. The saved x_i and h_i are the fp32 forward's, rounded to bf16:
rounding keeps their signs, so the masks are the references' own and the
comparison measures the backward (a bf16 forward's nine chained pairs flip
masks against the fp32 and float64 forwards: 6.7 % by norm at t 700).

The launch path's pure-Python part runs through a stand-in kernel library:
one adjoint tensor map per weight tensor, made once and shared with the
canvas conv's adjoint; the schedule handed to the library (the pass order,
each pass's epilogue and slots); the scratch and its shapes; the fp32 call;
what the wrapper rejects.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffmusic_tpu.pallas.conv1d_kernel as ck
import diffmusic_tpu.pallas.stage_bwd_kernel as sk
from diffmusic_tpu_torch import kernels
from diffmusic_tpu_torch.kernels import build, repack
from diffmusic_tpu_torch.kernels import canvas as tcanvas
from diffmusic_tpu_torch.kernels import conv1d as tconv
from diffmusic_tpu_torch.kernels import stage_bwd as tstage
from test_torch_port_canvas import _stage_grad_numpy_f64
from test_torch_port_conv1d_tiles import BF, emulate_pass
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

SLOPE = 0.1
TOL = 2e-2   # chip_smoke.TOL_CONV_BF16
C = 128
KS, DILS = (3, 7, 11), ((1, 3, 5),) * 3
TB = tcanvas.TIME_BLOCK


def norm_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def outside(a, t: int) -> float:
    a = torch.as_tensor(np.asarray(a, np.float32))
    return max(float(a[:, :TB].abs().max()), float(a[:, TB + t:].abs().max()))


def rbf(a):
    """Rounded to bf16, kept as fp32 values."""
    return a.to(BF).float()


def emulate_stage_bwd(g, xs, hs, w1s, w2s, t: int, kernel_sizes, dilation_sizes, slope):
    """The bf16 call's result from canvas g and the saved xs, hs (bf16) and
    weights, pass by pass in `stage_schedule`'s order: (B, T, C) fp32 values
    of the bf16 output."""
    sig0, sig1 = TB, TB + t
    rows = torch.arange(g.shape[1])
    rv = ((rows >= sig0) & (rows < sig1)).float()[None, :, None]
    inv = torch.tensor(1.0 / len(kernel_sizes), dtype=torch.float32)
    dils = [d for ds in dilation_sizes for d in ds]
    gf = g.float()
    op0 = rbf(gf * inv) * rv
    nb = len(kernel_sizes)
    op, dh, dcur = [None] * nb, [None] * nb, [None] * nb
    mask = lambda s, v: torch.where(s >= 0, v, slope * v)
    for epi, slots in tstage.stage_schedule(kernel_sizes, dilation_sizes):
        for b, i, flags in slots:
            if epi == tstage.MASK:
                src = op0 if flags & tstage.FIRST else op[b]
                acc = emulate_pass(src, w2s[i].float(), None, None, 1, sig0, sig1, None,
                                   flip=True, raw=True)
                dh[b] = rbf(mask(hs[i].float(), acc)) * rv
            else:
                acc = emulate_pass(dh[b], w1s[i].float(), None, None, dils[i], sig0, sig1, None,
                                   flip=True, raw=True)
                prev = gf * inv if flags & tstage.FIRST else dcur[b]
                dcur[b] = (mask(xs[i].float(), acc) + prev) * rv
                op[b] = rbf(dcur[b]) if flags & tstage.WRITE_OP else None
    total = dcur[0]
    for b in range(1, nb):
        total = total + dcur[b]
    return rbf(total * rv)


def stage_operands(rng, t):
    """(x, g, params) as fp32 numpy arrays of bf16 values: the signal (1, t,
    128), its cotangent and (w1, b1, w2, b2) per pair, branch-major."""
    bfv = lambda a: torch.from_numpy(a.astype(np.float32)).to(BF).float().numpy()
    x, g = bfv(rng.standard_normal((1, t, C))), bfv(rng.standard_normal((1, t, C)))
    params = [tuple(bfv(rng.standard_normal(s) * sc)
                    for s, sc in (((k, C, C), 0.05), ((C,), 0.1), ((k, C, C), 0.05),
                                  ((C,), 0.1)))
              for k, dils in zip(KS, DILS) for _ in dils]
    return x, g, params


@pytest.mark.parametrize("t", [700, 100])
def test_emulated_stage_backward_matches_plain_jax_and_f64(rng, t):
    x, g, params = stage_operands(rng, t)
    tp = [tuple(torch.from_numpy(a) for a in p) for p in params]
    with torch.no_grad():   # the references' own forward, its saved tensors rounded
        _, xs, hs = tstage.stage_forward(tcanvas.to_canvas(torch.from_numpy(x)), tp, t, KS,
                                         DILS, SLOPE)
    xs, hs = [a.to(BF) for a in xs], [a.to(BF) for a in hs]
    gc = tcanvas.to_canvas(torch.from_numpy(g)).to(BF)
    w1s, w2s = [p[0].to(BF) for p in tp], [p[2].to(BF) for p in tp]
    got = emulate_stage_bwd(gc, xs, hs, w1s, w2s, t, KS, DILS, SLOPE)
    assert torch.isfinite(got).all() and outside(got, t) == 0
    plain = tstage.stage_bwd_plain(gc, xs, hs, w1s, w2s, t, KS, DILS, SLOPE)
    assert plain.dtype == BF and outside(plain.float(), t) == 0

    jp = tuple(tuple(map(jnp.asarray, p)) for p in params)
    _, vjp = jax.vjp(lambda x_: ck.from_canvas(sk.stage_resblocks_canvas(
        ck.to_canvas(x_), jp, t, KS, DILS, SLOPE), t), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    oracle = _stage_grad_numpy_f64(x[0].astype(np.float64), params, g[0].astype(np.float64),
                                   SLOPE)
    sig = tcanvas.from_canvas(got, t)
    errs = {"plain": norm_rel(got, plain.float()), "jax": norm_rel(sig, jdx),
            "f64": norm_rel(sig[0], oracle)}
    assert max(errs.values()) <= TOL, errs


def test_schedule_runs_pair_steps_of_all_branches_largest_k_first():
    """The slice's stage: 3 steps of 2 launches (MASK, then MASK_ACC), each
    with one slot per branch, k 11 first; the first step reads op0 and g,
    every step but the last writes the next operand."""
    sched = tstage.stage_schedule(KS, DILS)
    assert [epi for epi, _ in sched] == [tstage.MASK, tstage.MASK_ACC] * 3
    for j in range(3):
        for epi, slots in sched[2 * j:2 * j + 2]:
            assert [b for b, _, _ in slots] == [2, 1, 0]
            assert [i for _, i, _ in slots] == [3 * b + 2 - j for b in (2, 1, 0)]
            first = tstage.FIRST if j == 0 else 0
            write = tstage.WRITE_OP if (epi == tstage.MASK_ACC and j < 2) else 0
            assert {f for _, _, f in slots} == {first | write}
    # unequal branches: a branch leaves the launches when its pairs are done
    sched = tstage.stage_schedule((3, 7), ((1, 3), (1, 3, 5)))
    assert [len(slots) for _, slots in sched] == [2, 2, 2, 2, 1, 1]
    assert sched[3][1] == ((1, 3, tstage.WRITE_OP), (0, 0, 0))


# ----------------------------------------------------------- the launch path
def _ints(addr: int, n: int) -> list:
    return list((ctypes.c_int * n).from_address(addr))


class _Library:
    """Stands in for the kernel library: decodes and records each stage call
    (its pointers and meta) and the tensor maps encoded; every call
    succeeds."""

    def __init__(self):
        self.calls, self.wmaps = [], []

    def dm_stage_bwd(self, code, g, ptrs, meta, out, bsz, rows, sig0, sig1, slope, inv, stream):
        n, nb = _ints(meta.value, 2)
        head = 2 + nb + 2 * n
        ints = _ints(meta.value, head + 1)
        sched = []
        if code == 1:
            pos = head + 1
            for _ in range(ints[head]):
                epi, nslots = _ints(meta.value + 4 * pos, 2)
                flat = _ints(meta.value + 4 * (pos + 2), 3 * nslots)
                sched.append((epi, tuple(tuple(flat[3 * s:3 * s + 3]) for s in range(nslots))))
                pos += 2 + 3 * nslots
        nptrs = 4 * n + (4 if code == 1 else 0)
        p = list((ctypes.c_void_p * nptrs).from_address(ptrs.value))
        self.calls.append(dict(code=code, g=g, ptrs=p, meta=ints[:head], sched=tuple(sched),
                               out=out, geometry=(bsz, rows, sig0, sig1), slope=slope, inv=inv))
        return 0

    def dm_conv1d_wmap(self, w, k, kdim, ndim, out):
        self.wmaps.append((w, k, kdim, ndim))
        return 0

    def __getattr__(self, name):
        return lambda *a: 0


@pytest.fixture
def stand_in(monkeypatch):
    """The launch path on CPU tensors: the library, the stream and the
    device check stand in; the scratch each call makes is recorded."""
    lib = _Library()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda device: 7)
    monkeypatch.setattr(build, "check_tensors", lambda name, *t: None)
    made = []
    real = tstage.stage_scratch
    monkeypatch.setattr(tstage, "stage_scratch", lambda g, nb: made.append(real(g, nb)) or made[-1])
    kernels.reset_launch_counts()
    repack.REPACKS["conv1d_adjoint"] = 0
    return lib, made


def saved(rng, t, dtype):
    rows = tcanvas.canvas_rows(t)
    n = sum(len(d) for d in DILS)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
    xs, hs = [mk(1, rows, C) for _ in range(n)], [mk(1, rows, C) for _ in range(n)]
    ws = [mk(k, C, C) for k, ds in zip(KS, DILS) for _ in ds]
    w2s = [mk(k, C, C) for k, ds in zip(KS, DILS) for _ in ds]
    return mk(1, rows, C), xs, hs, ws, w2s


def test_bf16_launch_path_maps_each_weight_once_and_hands_over_the_schedule(rng, stand_in):
    lib, made = stand_in
    t = 300
    g, xs, hs, w1s, w2s = saved(rng, t, BF)
    rows = tcanvas.canvas_rows(t)
    for _ in range(2):
        tstage._launch(g, xs, hs, w1s, w2s, t, KS, DILS, SLOPE)
    # one adjoint map per weight tensor, over the weight itself, made once
    assert repack.REPACKS["conv1d_adjoint"] == 18 and len(lib.wmaps) == 18
    assert [m[0] for m in lib.wmaps] == [w.data_ptr() for w in (*w1s, *w2s)]
    assert all(m[1:] == (w.shape[0], C, C) for m, w in zip(lib.wmaps, (*w1s, *w2s)))
    maps = [repack.cached(tconv.ADJOINT, w, None) for w in (*w1s, *w2s)]
    assert kernels.launch_counts()["stage_resblocks_canvas"] == 2
    for call, scratch in zip(lib.calls, made):
        n = 9
        assert call["code"] == 1 and call["g"] == g.data_ptr()
        assert call["ptrs"][:2 * n] == [a.data_ptr() for a in (*xs, *hs)]
        assert call["ptrs"][2 * n:4 * n] == [m.data_ptr() for m in maps]
        assert call["ptrs"][4 * n:] == [a.data_ptr() for a in scratch]
        assert call["meta"] == [9, 3, 3, 3, 3, 3, 3, 3, 7, 7, 7, 11, 11, 11] + [1, 3, 5] * 3
        assert call["sched"] == tstage.stage_schedule(KS, DILS)
        assert call["geometry"] == (1, rows, TB, TB + t)
        assert call["inv"] == pytest.approx(1 / 3) and call["slope"] == pytest.approx(SLOPE)
    # the scratch: the first operand, and per branch side by side dcur (fp32),
    # the operand and dh (bf16)
    op0, dcur, op, dh = made[0]
    assert tuple(op0.shape) == (1, rows, C) and op0.dtype == BF
    assert tuple(dcur.shape) == (3, 1, rows, C) and dcur.dtype == torch.float32
    assert tuple(op.shape) == tuple(dh.shape) == (3, 1, rows, C)
    assert op.dtype == dh.dtype == BF


def test_fp32_launch_path_passes_the_weights_and_no_scratch(rng, stand_in):
    lib, made = stand_in
    t = 300
    g, xs, hs, w1s, w2s = saved(rng, t, torch.float32)
    tstage._launch(g, xs, hs, w1s, w2s, t, KS, DILS, SLOPE)
    (call,) = lib.calls
    assert call["code"] == 0 and call["sched"] == () and not made and not lib.wmaps
    assert call["ptrs"] == [a.data_ptr() for a in (*xs, *hs, *w1s, *w2s)]


def test_launch_path_rejects_what_the_kernel_does_not_take(rng, stand_in):
    lib, _ = stand_in
    t = 300
    g, xs, hs, w1s, w2s = saved(rng, t, BF)
    with pytest.raises(ValueError):   # not the canvas of t
        tstage._launch(g, xs, hs, w1s, w2s, t + 600, KS, DILS, SLOPE)
    with pytest.raises(ValueError):   # a saved tensor of another shape
        tstage._launch(g, xs[:-1] + [xs[-1][:, :-1]], hs, w1s, w2s, t, KS, DILS, SLOPE)
    with pytest.raises(ValueError):   # a weight of another k
        tstage._launch(g, xs, hs, [w1s[0][:2]] + w1s[1:], w2s, t, KS, DILS, SLOPE)
    with pytest.raises(ValueError):   # 256 channels
        g2 = torch.zeros(1, g.shape[1], 256, dtype=BF)
        tstage._launch(g2, xs, hs, w1s, w2s, t, KS, DILS, SLOPE)
    with pytest.raises(TypeError):    # fp16
        tstage._launch(*(a.half() if isinstance(a, torch.Tensor) else [b.half() for b in a]
                         for a in (g, xs, hs, w1s, w2s)), t, KS, DILS, SLOPE)
    assert not lib.calls and kernels.launch_counts()["stage_resblocks_canvas"] == 0


def test_launch_path_rejects_cpu_tensors(rng, monkeypatch):
    """Without the stand-in's device check: a CPU tensor does not launch."""
    monkeypatch.setattr(build, "library", _Library)
    g, xs, hs, w1s, w2s = saved(rng, 300, BF)
    with pytest.raises(ValueError, match="CUDA"):
        tstage._launch(g, xs, hs, w1s, w2s, 300, KS, DILS, SLOPE)
