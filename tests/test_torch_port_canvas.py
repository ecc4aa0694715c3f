"""CPU parity of the vocoder's canvas routes against the JAX package: the
canvas helpers, `conv1d_fused_canvas` (both backwards), `conv1d_pair_canvas`
and `stage_resblocks_canvas`, a small vocoder under each route, and the
launches of each route at full width.

On the CPU the port's wrappers run their plain versions. The JAX canvas
kernels run in interpret mode (`_INTERPRET = True` on `conv1d_kernel`, on
`stage_bwd_kernel`, which holds its own copy of the flag, and on
`mask_kernel`), with every routing variable set explicitly: in interpret mode
the JAX canvas routes default on. The JAX default vocoder runs without
interpret mode. The stage's JAX side is its CPU path (the XLA composition of
its custom VJP), and its gradient is also held against a float64 numpy
oracle. Inputs come from a numpy seed, fp32. Tolerances, as a fraction of
max |reference|: 1e-5 for values, 1e-4 for gradients against JAX (sums in
other orders), 1e-6 against the float64 oracle. Outside the signal every
canvas output and gradient must be exactly zero.
"""

import contextlib
import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import diffmusic_tpu.pallas.conv1d_kernel as ck
import diffmusic_tpu.pallas.mask_kernel as mk
import diffmusic_tpu.pallas.stage_bwd_kernel as sk
from diffmusic_tpu.models import configs as jcfg
from diffmusic_tpu.models.hifigan import SpeechT5HifiGan as JHifiGan
from diffmusic_tpu_torch import kernels
from diffmusic_tpu_torch.kernels import canvas as tcanvas
from diffmusic_tpu_torch.kernels import conv1d as tconv
from diffmusic_tpu_torch.kernels import mask as tmask
from diffmusic_tpu_torch.kernels import stage_bwd as tstage
from diffmusic_tpu_torch.kernels import upsampler as tup
from diffmusic_tpu_torch.models import configs as tcfg
from diffmusic_tpu_torch.models import hifigan as thifigan
from diffmusic_tpu_torch.models.convert import from_flax
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

SLOPE = 0.1
C = 128
TB = tcanvas.TIME_BLOCK


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def outside(a, t: int):
    """max |a| over the rows of a canvas outside its signal [512, 512 + t)."""
    a = a.detach() if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return max(float(a[:, :TB].abs().max()), float(a[:, TB + t:].abs().max()))


def canvas_np(rng, t: int):
    """A canvas of a random (1, t, 128) signal, numpy."""
    return np.array(ck.to_canvas(jnp.asarray(arr(rng, 1, t, C))))


@pytest.fixture
def interpret(monkeypatch):
    """The JAX canvas kernels in interpret mode; restored after the test."""
    for module in (ck, sk, mk):
        monkeypatch.setattr(module, "_INTERPRET", True)


# -------------------------------------------------------------------- helpers
@pytest.mark.parametrize("t", [1, 511, 512, 700, 1100])
def test_canvas_helpers_match_jax(rng, t):
    x = arr(rng, 2, t, 16)
    xc = tcanvas.to_canvas(torch.from_numpy(x))
    jxc = ck.to_canvas(jnp.asarray(x))
    assert tcanvas.canvas_blocks(t) == ck.canvas_blocks(t)
    assert tuple(xc.shape) == jxc.shape == (2, tcanvas.canvas_rows(t), 16)
    assert np.array_equal(xc.numpy(), np.asarray(jxc))
    assert np.array_equal(tcanvas.from_canvas(xc, t).numpy(), np.asarray(ck.from_canvas(jxc, t)))
    mask = tcanvas.canvas_row_mask(xc.shape[1], t)
    assert np.array_equal(mask.numpy(), np.asarray(ck._canvas_row_mask(xc.shape[1], t)))
    assert tcanvas.canvas_ok(128, 256) and not tcanvas.canvas_ok(64, 128)


# --------------------------------------------------------- the canvas conv
@pytest.mark.parametrize("bwd", ["kernel", "plain"])
@pytest.mark.parametrize("t", [700, 1100])
@pytest.mark.parametrize("k,d", [(3, 1), (3, 3), (11, 1), (11, 3)])
def test_canvas_conv_matches_jax(interpret, rng, k, d, t, bwd):
    """conv1d_fused_canvas against the JAX Pallas canvas kernel: `bwd`
    "kernel" against `conv1d_fused_canvas` (whose backward is the kernel's
    adjoint mode), "plain" against `conv1d_canvas_xbwd`. The dilation-1
    cases carry a residual, as each iteration's second conv does."""
    xc, gc = canvas_np(rng, t), canvas_np(rng, t)
    rc = canvas_np(rng, t) if d == 1 else None
    w, b = arr(rng, k, C, C, scale=1 / np.sqrt(k * C)), arr(rng, C, scale=0.1)
    jfn = ck.conv1d_fused_canvas if bwd == "kernel" else ck.conv1d_canvas_xbwd
    jr = jnp.asarray(rc if rc is not None else np.zeros_like(xc))
    jy, vjp = jax.vjp(lambda x_, r_: jfn(x_, jnp.asarray(w), jnp.asarray(b), r_, t, d, SLOPE,
                                         rc is not None), jnp.asarray(xc), jr)
    jdx, jdr = vjp(jnp.asarray(gc))
    xt = torch.from_numpy(xc).requires_grad_(True)
    rt = torch.from_numpy(rc).requires_grad_(True) if rc is not None else None
    y = tconv.conv1d_fused_canvas(xt, torch.from_numpy(w), torch.from_numpy(b), rt, t, d,
                                  SLOPE, bwd)
    grads = torch.autograd.grad(y, [xt] + ([rt] if rt is not None else []), torch.from_numpy(gc))
    errs = {"y": rel(y.detach(), jy), "dx": rel(grads[0], jdx)}
    if rt is not None:
        errs["dres"] = rel(grads[1], jdr)
    assert errs["y"] <= 1e-5 and max(errs.values()) <= 1e-4, errs
    zeros = {n: outside(a, t) for n, a in (("y", y), ("dx", grads[0]), ("dres", grads[-1]))}
    assert not any(zeros.values()), zeros


def test_canvas_conv_rejects_a_bad_backward_and_counts_nothing_on_cpu(rng):
    xc = torch.from_numpy(canvas_np(rng, 300))
    w, b = torch.zeros(3, C, C), torch.zeros(C)
    with pytest.raises(ValueError, match="bwd"):
        tconv.conv1d_fused_canvas(xc, w, b, None, 300, 1, SLOPE, "xla")
    kernels.reset_launch_counts()
    tconv.conv1d_fused_canvas(xc, w, b, None, 300, 1, SLOPE, "kernel")
    assert not any(kernels.launch_counts().values())


# --------------------------------------------------------- the canvas pair
@pytest.mark.parametrize("t", [700, 1100])
@pytest.mark.parametrize("k,d", [(3, 1), (3, 3), (11, 1), (11, 3)])
def test_pair_canvas_matches_jax(interpret, rng, k, d, t):
    """conv1d_pair_canvas (y, the h it saves, the input gradient) against
    the JAX Pallas pair kernel and its XLA-adjoint backward."""
    xc, gc = canvas_np(rng, t), canvas_np(rng, t)
    w1, w2 = (arr(rng, k, C, C, scale=1 / np.sqrt(k * C)) for _ in range(2))
    b1, b2 = arr(rng, C, scale=0.1), arr(rng, C, scale=0.1)
    jw = tuple(map(jnp.asarray, (w1, b1, w2, b2)))
    jy, vjp = jax.vjp(lambda x_: ck.conv1d_pair_canvas(x_, *jw, t, d, SLOPE), jnp.asarray(xc))
    (jdx,) = vjp(jnp.asarray(gc))
    jh = ck._pair_canvas_pallas(jnp.asarray(xc), *jw, t, d, SLOPE)[1]
    tw = tuple(map(torch.from_numpy, (w1, b1, w2, b2)))
    xt = torch.from_numpy(xc).requires_grad_(True)
    y = tconv.conv1d_pair_canvas(xt, *tw, t, d, SLOPE)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(gc))
    h = tconv.pair_canvas_forward(torch.from_numpy(xc), *tw, t, d, SLOPE)[1]
    errs = {"y": rel(y.detach(), jy), "h": rel(h, jh), "dx": rel(dx, jdx)}
    assert max(errs["y"], errs["h"]) <= 1e-5 and errs["dx"] <= 1e-4, errs
    zeros = {n: outside(a, t) for n, a in (("y", y), ("h", h), ("dx", dx))}
    assert not any(zeros.values()), zeros


# --------------------------------------------------------------- the stage
KS = (3, 7, 11)
DILS = ((1, 3, 5),) * 3


def _conv_np(x, w, d):
    """'same' dilated conv, numpy float64: x (t, cin), w (k, cin, cout)."""
    k = w.shape[0]
    pad = (k - 1) * d // 2
    xp = np.pad(x, ((pad, pad), (0, 0)))
    return sum(xp[tap * d:tap * d + x.shape[0]] @ w[tap] for tap in range(k))


def _stage_grad_numpy_f64(x, params, g, slope):
    """Analytic float64 stage input gradient (`tests/test_stage_bwd.py`)."""
    params = [[np.asarray(a, np.float64) for a in p] for p in params]
    mask = lambda s, v: np.where(s >= 0, v, slope * v)
    adj = lambda w: np.flip(w, axis=0).swapaxes(1, 2)
    dx_total = np.zeros_like(x)
    pi = 0
    for k, dils in zip(KS, DILS):
        saved = []
        xb = x
        for d, (w1, b1, w2, b2) in zip(dils, params[pi:pi + len(dils)]):
            h = _conv_np(mask(xb, xb), w1, d) + b1
            y = _conv_np(mask(h, h), w2, 1) + b2 + xb
            saved.append((xb, h, w1, w2, d))
            xb = y
        dcur = g / len(KS)
        for xb_i, h, w1, w2, d in reversed(saved):
            dh = mask(h, _conv_np(dcur, adj(w2), 1))
            dcur = mask(xb_i, _conv_np(dh, adj(w1), d)) + dcur
        dx_total += dcur
        pi += len(dils)
    return dx_total


def test_stage_matches_jax_and_the_f64_oracle(rng):
    """The whole ch128 stage (KS (3, 7, 11), dilations (1, 3, 5) x 3, t 700):
    forward against JAX's CPU path and `_stage_ref`, input gradient against
    JAX's CPU path (its custom VJP's XLA composition) and the float64
    oracle; exact zeros outside the signal of the stage's output and of the
    gradient on the canvas."""
    t = 700
    x, g = arr(rng, 1, t, C), arr(rng, 1, t, C)
    params = [tuple(arr(rng, *s, scale=sc) for s, sc in (((k, C, C), 0.05), ((C,), 0.1),
                                                        ((k, C, C), 0.05), ((C,), 0.1)))
              for k, dils in zip(KS, DILS) for _ in dils]
    jp = tuple(tuple(map(jnp.asarray, p)) for p in params)
    jy, vjp = jax.vjp(lambda x_: ck.from_canvas(sk.stage_resblocks_canvas(
        ck.to_canvas(x_), jp, t, KS, DILS, SLOPE), t), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    tp = [tuple(map(torch.from_numpy, p)) for p in params]
    xc = tcanvas.to_canvas(torch.from_numpy(x)).requires_grad_(True)
    kernels.reset_launch_counts()
    yc = tstage.stage_resblocks_canvas(xc, tp, t, KS, DILS, SLOPE)
    (dxc,) = torch.autograd.grad(yc, xc, tcanvas.to_canvas(torch.from_numpy(g)))
    assert not any(kernels.launch_counts().values())          # CPU: plain versions
    y, dx = tcanvas.from_canvas(yc.detach(), t), tcanvas.from_canvas(dxc, t)
    oracle = _stage_grad_numpy_f64(x[0].astype(np.float64), params, g[0].astype(np.float64),
                                   SLOPE)
    errs = {"y": rel(y, jy), "y_ref": rel(y, sk._stage_ref(jnp.asarray(x), jp, KS, DILS, SLOPE)),
            "dx": rel(dx, jdx), "dx_f64": rel(dx[0], oracle)}
    assert max(errs["y"], errs["y_ref"]) <= 1e-5 and errs["dx"] <= 1e-4, errs
    assert errs["dx_f64"] <= 1e-6, errs
    assert outside(yc, t) == 0 and outside(dxc, t) == 0
    assert rel(y, tstage.stage_plain(torch.from_numpy(x), tp, KS, DILS, SLOPE)) <= 1e-5


def test_stage_rule_matches_jax():
    for ch, ks, dils in ((128, KS, DILS), (256, KS, DILS), (128, (3, 7), ((1, 3), (1, 3))),
                         (128, (13,), ((1, 3, 5),))):
        for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
            assert tstage.stage_ok(ch, ks, dils, dtype) == sk.stage_ok(ch, ks, dils, jdtype)


# ------------------------------------------------------- a vocoder per route
# the vocoder of `tests/test_stage_bwd.py`: stage 0 is ch128 at T = 4 * 41
VOC = jcfg.HiFiGANConfig(model_in_dim=64, upsample_initial_channel=256, upsample_rates=(4, 2),
                         upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3, 7),
                         resblock_dilation_sizes=((1, 3), (1, 3)))
# port flags -> (JAX variables, whether the JAX kernels run in interpret
# mode, the port wrapper that must run)
ROUTES = {
    "default": (dict(canvas="off"), {"DIFFMUSIC_TPU_CANVAS": "0", "DIFFMUSIC_TPU_STAGE_BWD": "0"},
                False, "conv1d_fused_pair"),
    "xbwd": (dict(canvas="xbwd"), {"DIFFMUSIC_TPU_CANVAS": "xbwd", "DIFFMUSIC_TPU_STAGE_BWD": "0"},
             True, "conv1d_pair_canvas"),
    "kernel": (dict(canvas="kernel"), {"DIFFMUSIC_TPU_CANVAS": "1", "DIFFMUSIC_TPU_STAGE_BWD": "0"},
               True, "conv1d_fused_canvas"),
    "stage": (dict(canvas="xbwd", stage_bwd=True),
              {"DIFFMUSIC_TPU_CANVAS": "xbwd", "DIFFMUSIC_TPU_STAGE_BWD": "1"}, True,
              "stage_resblocks_canvas"),
}


@pytest.fixture(scope="module")
def voc_params():
    return jax.jit(JHifiGan(VOC).init)(jax.random.key(0), jnp.zeros((1, 2, 64)))


@pytest.mark.parametrize("route", list(ROUTES))
def test_vocoder_routes_match_jax(rng, monkeypatch, voc_params, route):
    """The small vocoder's waveform and mel gradient under each route
    against the JAX vocoder under the matching variables."""
    flags, env, interpret, wrapper = ROUTES[route]
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    for module in (ck, sk, mk):
        monkeypatch.setattr(module, "_INTERPRET", interpret)
    mel, probe = arr(rng, 1, 41, 64), arr(rng, 1, 41 * 8)
    voc = JHifiGan(VOC)
    jy, vjp = jax.vjp(lambda m: voc.apply(voc_params, m), jnp.asarray(mel))
    (jdm,) = vjp(jnp.asarray(probe))

    calls = Counter()
    fn = getattr(thifigan, wrapper)
    monkeypatch.setattr(thifigan, wrapper, lambda *a, **k: calls.update([wrapper]) or fn(*a, **k))
    pcfg = tcfg.HiFiGANConfig(**dataclasses.asdict(VOC))
    model = thifigan.SpeechT5HifiGan(pcfg, mask_kernel=True, **flags)
    model.load_state_dict(from_flax(voc_params, pcfg), strict=True)
    m = torch.from_numpy(mel).requires_grad_(True)
    y = model(m)
    (dm,) = torch.autograd.grad(y, m, torch.from_numpy(probe))
    assert calls[wrapper] > 0, calls
    errs = {"y": rel(y.detach(), jy), "dmel": rel(dm, jdm)}
    assert errs["y"] <= 1e-5 and errs["dmel"] <= 1e-4, errs


def test_vocoder_rejects_an_unknown_canvas_mode():
    with pytest.raises(ValueError, match="canvas"):
        thifigan.SpeechT5HifiGan(tcfg.HiFiGANConfig(), canvas="xla")


# ------------------------------------------------- launches at full width
class _FakeLibrary:
    """Stands in for the kernel library on the meta device: every launch
    succeeds and needs no shared memory."""

    def __getattr__(self, name):
        return lambda *a: 0


@contextlib.contextmanager
def meta_launches(monkeypatch):
    """Kernel launches on meta tensors: the wrappers take their kernel path
    (shape checks, counts) and allocate meta outputs; nothing runs. The
    conv1d launch plans see the meta tensors as on one CUDA device."""
    from diffmusic_tpu_torch.kernels import build
    real_plan, real_fused_plan = tconv.pair_plan, tconv.fused_plan
    cuda = torch.device("cuda", 0)
    with monkeypatch.context() as mp:
        mp.setattr(build, "library", lambda: _FakeLibrary())
        mp.setattr(build, "check_tensors", lambda *a: None)
        mp.setattr(build, "stream_ptr", lambda device: 0)
        mp.setattr(tconv, "pair_plan", lambda name, sh, st, dt, dev, d, t: real_plan(
            name, sh, st, dt, (cuda,) * len(dev), d, t))
        mp.setattr(tconv, "fused_plan", lambda name, sh, st, dt, dev, *rest: real_fused_plan(
            name, sh, st, dt, (cuda,) * len(dev), *rest))
        for module in (tconv, tstage, tup, tmask):
            mp.setattr(module, "use_plain", lambda x, name: False)
        yield


def vocoder_launches(monkeypatch, dtype=torch.bfloat16, **flags) -> tuple:
    """(forward, backward) launches of the full-width vocoder with `flags`
    on the 10-s slice's mel (1, 1000, 64), from forwards and a backward on
    the meta device."""
    with torch.device("meta"):
        model = thifigan.SpeechT5HifiGan(tcfg.HiFiGANConfig(), **flags).to(dtype)
    mel = torch.empty(1, chip_smoke.LATENTS[2] * 4, 64, device="meta", dtype=dtype)
    with meta_launches(monkeypatch):
        kernels.reset_launch_counts()
        with torch.no_grad():
            y = model(mel)
        assert tuple(y.shape) == (1, 160032)        # 1000 frames x hop 160, + 32
        fwd = Counter(kernels.launch_counts())
        kernels.reset_launch_counts()
        m = mel.requires_grad_(True)
        torch.autograd.grad(model(m), m, torch.empty_like(y))
        both = Counter(kernels.launch_counts())
    return +fwd, +(both - fwd)


@pytest.mark.parametrize("setting", list(chip_smoke.VOCODER_LAUNCHES))
def test_vocoder_launches_at_full_width(monkeypatch, setting):
    """Each vocoder route's launches per forward and per backward of the
    10-s slice, derived from the model, equal the constants `chip_smoke.py`
    checks its runs against."""
    fwd, bwd = vocoder_launches(monkeypatch, **chip_smoke.VOCODER_ROUTES[setting])
    want_fwd, want_bwd = chip_smoke.VOCODER_LAUNCHES[setting]
    assert (dict(fwd), dict(bwd)) == (want_fwd, want_bwd)


def test_full_width_stage_geometry():
    """At full width in bf16 only stage 2 (ch128, T 40008) meets the stage
    rule, and all its pairs meet pair_ok; in fp32 its 8.3 MB of weights
    exceed the rule's 6 MB."""
    cfg = tcfg.HiFiGANConfig()
    stages = [shape for shape, _, _ in chip_smoke.mask_geometries()]
    for dt, want in ((torch.bfloat16, [False, False, True, False, False]),
                     (torch.float32, [False] * 5)):
        ok = [tstage.stage_ok(c, cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes, dt)
              and all(tconv.pair_ok(k, c, c, dt) for k in cfg.resblock_kernel_sizes)
              for _, _, c in stages]
        assert ok == want, dt
    assert stages[2] == (1, 40008, 128)
    assert sk.stage_ok(128, cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes,
                       jnp.bfloat16)
    assert ck.canvas_blocks(40008) == 79 and tcanvas.canvas_rows(40008) == 41472
