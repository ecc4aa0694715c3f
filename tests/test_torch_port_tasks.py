"""CPU parity of the port's inverse problems against the JAX package (fp32,
inputs from a numpy seed): the DSP they need, the masks and noise, the
operators and the phase-aware output. The tiny MusicLDM under the DiffMusic
sampler on each task is in `test_torch_port_tasks_pipelines.py`.

Tolerances, relative to max |reference|: the STFT, its inverse, the mel
scales and the filter within 1e-5; each operator's forward, transform and
the gradient of its guided loss within 1e-4 (dB of near-silent bins and
long fp32 reductions); the phase-aware waveform within 1e-4. The STFT's
phase is held against a float64 oracle (`phase_within`). Where an operator
draws (the random mask, the reverb impulse response), the port's operator is
given the JAX operator's array. The filter's gradients (the input's as a
correlation with the reversed response) are held against autograd through
the plain `F.conv1d` within 1e-5.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_samplers as samplers_test
from diffmusic_tpu.inverse_problem import (MusicDereverberationOperator as JDereverb,
                                           MusicInpaintingOperator as JInpaint,
                                           PhaseRetrievalOperator as JPhase,
                                           PoissonNoise as JPoisson,
                                           SuperResolutionOperator as JSuperRes,
                                           get_noiser as jget_noiser)
from diffmusic_tpu.ops.filters import convolve1d as jconvolve1d
from diffmusic_tpu.ops.masks import periodic_mask as jperiodic_mask
from diffmusic_tpu.ops.masks import random_mask as jrandom_mask
from diffmusic_tpu.pipelines.base import (
    mel_spectrogram_to_waveform_with_phase as jmel_to_wav_with_phase)
from diffmusic_tpu_torch.inverse_problem import (GaussianNoise, MusicDereverberationOperator,
                                                 MusicInpaintingOperator,
                                                 PhaseRetrievalOperator, PoissonNoise,
                                                 SuperResolutionOperator, get_noiser)
from diffmusic_tpu_torch.ops.filters import convolve1d, generate_impulse_response
from diffmusic_tpu_torch.ops.masks import periodic_mask, random_mask
from diffmusic_tpu_torch.ops.mel import InverseMelScale, MelScale
from diffmusic_tpu_torch.ops.stft import istft, magphase_spectrogram, spectrogram, stft
from diffmusic_tpu_torch.pipelines.base import mel_spectrogram_to_waveform_with_phase
from diffmusic_tpu_torch.pipelines.musicldm import per_clip_loss
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

# the JAX ops package re-exports functions named `stft` and `mel` over its modules
jstft = importlib.import_module("diffmusic_tpu.ops.stft")
jmel = importlib.import_module("diffmusic_tpu.ops.mel")
rel = samplers_test.rel
AUDIO_S = samplers_test.AUDIO_S
OWL = int(AUDIO_S * 16000)


def wave(rng, n, batch=2):
    return rng.standard_normal((batch, n)).astype(np.float32) * 0.3


def fp32(fn, *args, **kw):
    """A JAX function with fp32 matmuls, finished, as numpy."""
    with jax.default_matmul_precision("float32"):
        out = fn(*args, **kw)
    return jax.tree.map(lambda a: np.array(jax.block_until_ready(a)), out)


# ------------------------------------------------------------------- DSP
STFT_CASES = [(1024, 160, 1024), (256, 64, 256), (256, 64, 200)]


@pytest.mark.parametrize("length", [4000, 4321])
@pytest.mark.parametrize("n_fft, hop, win", STFT_CASES)
def test_stft_and_magphase_match_jax(rng, length, n_fft, hop, win):
    x = wave(rng, length)
    for use_hann in (False, True):
        jre, jim = fp32(jstft.stft, jnp.asarray(x), n_fft, hop, win, True, use_hann)
        tre, tim = stft(torch.from_numpy(x), n_fft, hop, win, True, use_hann)
        assert tre.shape == jre.shape == (2, n_fft // 2 + 1, 1 + length // hop)
        scale = max(np.abs(jre).max(), np.abs(jim).max())
        assert np.abs(tre.numpy() - jre).max() <= 1e-5 * scale
        assert np.abs(tim.numpy() - jim).max() <= 1e-5 * scale
    jmag, jphase = fp32(jstft.magphase_spectrogram, jnp.asarray(x), n_fft, hop, win)
    tmag, tphase = magphase_spectrogram(torch.from_numpy(x), n_fft, hop, win)
    assert rel(tmag, jmag) <= 1e-5
    # the phase where the magnitude is not near zero (atan2's cut elsewhere),
    # each side against a float64 oracle of the same frames
    omag, ophase = stft_oracle(x, n_fft, hop)
    ok, msg = phase_within(tphase.numpy(), jphase, omag, ophase, n_fft)
    assert ok, msg
    # the bound still catches a one-sample frame offset and a flipped imaginary part
    _, shifted = magphase_spectrogram(torch.from_numpy(np.roll(x, 1, axis=-1)), n_fft, hop,
                                      win)
    for planted in (shifted.numpy(), -tphase.numpy()):
        assert not phase_within(planted, jphase, omag, ophase, n_fft)[0]


# The phase error of a bin is about its absolute error over |X|, and a fp32
# matmul DFT of n_fft terms carries an absolute error of about eps32 * sqrt(n_fft)
# * max|X|. Against the float64 oracle both sides read at most 0.20 of that
# per-bin unit at every case here, at torch thread counts 1-6 (0.07-0.10 for
# JAX, 0.08-0.20 for the port); the constant leaves a 10x margin.
PHASE_UNITS = 2.0


def stft_oracle(x, n_fft, hop):
    """|X| and angle(X) of the rectangular-window, centred, reflect-padded
    STFT in float64: (..., n_freqs, frames)."""
    xp = np.pad(x.astype(np.float64), ((0, 0), (n_fft // 2, n_fft // 2)), mode="reflect")
    starts = np.arange(1 + x.shape[-1] // hop) * hop
    spec = np.fft.rfft(xp[:, starts[:, None] + np.arange(n_fft)], axis=-1).transpose(0, 2, 1)
    return np.abs(spec), np.angle(spec)


def phase_within(tphase, jphase, omag, ophase, n_fft):
    """(ok, message): on the bins above 1e-3 of the largest |X|, the port's
    phase error against the oracle is at most twice JAX's plus PHASE_UNITS
    per-bin fp32 units eps32 * sqrt(n_fft) * max|X| / |X|."""
    big = omag > 1e-3 * omag.max()
    unit = (np.finfo(np.float32).eps * np.sqrt(n_fft) * omag.max() / omag)[big]
    terr, jerr = (np.abs(np.angle(np.exp(1j * (p - ophase))))[big] for p in (tphase, jphase))
    msg = (f"phase error against the float64 oracle, in units of eps32 sqrt(n_fft) "
           f"max|X| / |X|: port {(terr / unit).max():.3g}, JAX {(jerr / unit).max():.3g} "
           f"(bound: 2 x JAX + {PHASE_UNITS})")
    return bool(np.all(terr <= 2.0 * jerr + PHASE_UNITS * unit)), msg


@pytest.mark.parametrize("n_fft, hop, win", STFT_CASES)
@pytest.mark.parametrize("use_hann", [False, True])
def test_istft_matches_jax_and_inverts_stft(rng, n_fft, hop, win, use_hann):
    x = wave(rng, 4000)
    re, im = (rng.standard_normal((2, n_fft // 2 + 1, 26)).astype(np.float32)
              for _ in range(2))
    for length in (None, 3000):
        ref = fp32(jstft.istft, jnp.asarray(re), jnp.asarray(im), n_fft, hop, win,
                   True, use_hann, length)
        out = istft(torch.from_numpy(re), torch.from_numpy(im), n_fft, hop, win, True,
                    use_hann, length)
        assert out.shape == ref.shape
        assert rel(out, ref) <= 1e-5
    # the round trip: istft(stft(x)) == x, away from the reflect-padded ends
    tre, tim = stft(torch.from_numpy(x), n_fft, hop, win, True, use_hann)
    back = istft(tre, tim, n_fft, hop, win, True, use_hann, length=4000).numpy()
    inner = slice(n_fft, 4000 - n_fft)
    assert np.abs(back[:, inner] - x[:, inner]).max() <= 1e-5 * np.abs(x).max()
    jback = fp32(jstft.istft, *fp32(jstft.stft, jnp.asarray(x), n_fft, hop, win, True,
                                    use_hann), n_fft, hop, win, True, use_hann, 4000)
    assert rel(back, jback) <= 1e-5


def test_mel_scales_match_jax(rng):
    spec = np.abs(rng.standard_normal((2, 513, 30))).astype(np.float32)
    for kw in ({}, dict(n_mels=32, f_min=30.0, f_max=7000.0, norm="slaney")):
        jscale = jmel.MelScale(**kw)
        tscale = MelScale(**kw)
        mel = fp32(jscale, jnp.asarray(spec))
        tm = tscale(torch.from_numpy(spec))
        assert tm.shape == mel.shape and rel(tm, mel) <= 1e-5
        jinv = fp32(jmel.InverseMelScale(**kw), jnp.asarray(mel))
        tinv = InverseMelScale(**kw)(torch.from_numpy(mel))
        assert tinv.shape == jinv.shape == spec.shape and rel(tinv, jinv) <= 1e-5
        assert float(tinv.min()) >= 0.0
    assert np.array_equal(InverseMelScale().pinv(), jmel.InverseMelScale().pinv())


@pytest.mark.parametrize("taps", [64, 63])
def test_convolve1d_matches_jax(rng, taps):
    x = wave(rng, 3000)
    ir = rng.standard_normal(taps).astype(np.float32)
    ref = fp32(jconvolve1d, jnp.asarray(x), jnp.asarray(ir))
    out = convolve1d(torch.from_numpy(x), torch.from_numpy(ir))
    assert out.shape == ref.shape == (2, 3000 + 2 * (taps // 2) - taps + 1)
    assert rel(out, ref) <= 1e-5


def plain_convolve1d(x, ir):
    """The filter as one `F.conv1d`, differentiated by autograd (cuDNN's
    data gradient on a card)."""
    taps = ir.shape[-1]
    y = torch.nn.functional.conv1d(x.reshape(-1, 1, x.shape[-1]), ir.reshape(1, 1, taps),
                                   padding=taps // 2)
    return y.reshape(*x.shape[:-1], y.shape[-1])


@pytest.mark.parametrize("shape", [(1200,), (3, 1200), (2, 3, 1200)])
@pytest.mark.parametrize("taps", [1, 2, 7, 800, 801])
def test_convolve1d_gradients_match_autograd(rng, taps, shape):
    """The input gradient as the output gradient correlated with the
    reversed response, and the response's gradient, against autograd through
    the plain call, for odd and even lengths; the forward is the same call."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    ir = torch.from_numpy(rng.standard_normal(taps).astype(np.float32))
    grads = []
    for fn in (convolve1d, plain_convolve1d):
        xx, kk = x.clone().requires_grad_(True), ir.clone().requires_grad_(True)
        y = fn(xx, kk)
        g = torch.from_numpy(np.random.default_rng(1).standard_normal(y.shape).astype(np.float32))
        grads.append((y.detach(), *torch.autograd.grad(y, (xx, kk), g)))
    (y, dx, dk), (y0, dx0, dk0) = grads
    assert y.shape == y0.shape == (*shape[:-1], 1200 + 2 * (taps // 2) - taps + 1)
    assert torch.equal(y, y0)
    assert dx.shape == x.shape and rel(dx, dx0) <= 1e-5
    assert dk.shape == ir.shape and rel(dk, dk0) <= 1e-5


@pytest.mark.parametrize("response_grad", [False, True])
@pytest.mark.parametrize("taps", [7, 5000])
def test_convolve1d_backward_runs_forward_correlations(taps, response_grad):
    """The backward runs one forward convolution per gradient asked for and
    never the library's convolution backward (cuDNN's data gradient on a
    card)."""
    gen = torch.Generator().manual_seed(taps)
    x = torch.randn(3, 6000, generator=gen, requires_grad=True)
    ir = torch.randn(taps, generator=gen, requires_grad=response_grad)
    y = convolve1d(x, ir)
    wrt = (x, ir) if response_grad else (x,)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.autograd.grad(y, wrt, torch.ones_like(y))
    ops = {e.key: e.count for e in prof.key_averages()}
    assert not [k for k in ops if "convolution_backward" in k]
    assert ops.get("aten::convolution") == len(wrt)


@pytest.mark.parametrize("allow_tf32", [True, False])
def test_convolve1d_backward_turns_tf32_off(monkeypatch, allow_tf32):
    """Each correlation of the backward runs with cuDNN's TF32 off, and the
    caller's setting comes back after it."""
    from diffmusic_tpu_torch.ops import filters
    seen = []
    conv1d = filters.F.conv1d

    def recording(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv1d(*args, **kwargs)

    x = torch.randn(2, 500, requires_grad=True)
    ir = torch.randn(64, requires_grad=True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", allow_tf32)
    y = convolve1d(x, ir)
    monkeypatch.setattr(filters.F, "conv1d", recording)
    torch.autograd.grad(y, (x, ir), torch.ones_like(y))
    assert seen == [False, False]
    assert torch.backends.cudnn.allow_tf32 is allow_tf32


@pytest.mark.parametrize("taps", [6, 9])
def test_convolve1d_gradcheck(taps):
    gen = torch.Generator().manual_seed(taps)
    x = torch.randn(2, 40, dtype=torch.float64, generator=gen, requires_grad=True)
    ir = torch.randn(taps, dtype=torch.float64, generator=gen, requires_grad=True)
    assert torch.autograd.gradcheck(convolve1d, (x, ir))


def test_impulse_response_rule():
    ir = generate_impulse_response(torch.Generator().manual_seed(4), 5000, 0.99)
    noise = torch.randn(5000, generator=torch.Generator().manual_seed(4))
    want = torch.cumsum(noise, 0) * 0.99
    assert torch.equal(ir, want / want.abs().max())
    assert float(ir.abs().max()) == 1.0 and ir.shape == (5000,)
    same = generate_impulse_response(torch.Generator().manual_seed(4), 5000, 0.99)
    assert torch.equal(ir, same)


# ----------------------------------------------------------- masks, noise
def zero_runs(mask: np.ndarray) -> list:
    """(start, length) of each run of zeros of a (1, n) 0/1 mask."""
    m = np.concatenate([[1.0], mask[0], [1.0]])
    edges = np.flatnonzero(np.diff(m))
    return [(int(a), int(b - a)) for a, b in zip(edges[::2], edges[1::2])]


@pytest.mark.parametrize("total, sr, pct, dur_s", [(160000, 16000, 0.3, 0.1),
                                                  (8000, 16000, 0.3, 0.1),
                                                  (5120, 16000, 0.05, 0.1),
                                                  (44100, 44100, 0.5, 0.05)])
def test_random_mask_rule(total, sr, pct, dur_s):
    dur = int(dur_s * sr)
    count = max(1, int(pct * total) // dur)
    mask = random_mask(torch.Generator().manual_seed(1), total, sr, pct, dur_s)
    starts = torch.randint(0, total - dur, (count,), generator=torch.Generator().manual_seed(1))
    want = np.ones((1, total), np.float32)
    for s in starts.tolist():
        want[:, s:s + dur] = 0.0
    assert mask.dtype == np.float32 and np.array_equal(mask, want)
    jmask = np.asarray(jrandom_mask(jax.random.key(1), total, sr, pct, dur_s))
    for m in (mask, jmask):   # both rules: count spans of dur, inside the clip
        runs = zero_runs(m)
        assert set(np.unique(m)) <= {0.0, 1.0} and 1 <= len(runs) <= count
        assert all(length >= dur for _, length in runs)
        assert dur <= int((m == 0).sum()) <= count * dur
        assert all(s + length <= total - 1 for s, length in runs)


@pytest.mark.parametrize("total, sr, interval_s, dur_s", [(160000, 16000, 1.0, 0.1),
                                                         (5120, 16000, 0.1, 0.02),
                                                         (7000, 16000, 0.2, 0.3)])
def test_periodic_mask_matches_jax(total, sr, interval_s, dur_s):
    mask = periodic_mask(total, sr, interval_s, dur_s)
    assert np.array_equal(mask, np.asarray(jperiodic_mask(total, sr, interval_s, dur_s)))
    interval, dur = int(interval_s * sr), int(dur_s * sr)
    runs = zero_runs(mask)
    if dur < interval:
        assert [s for s, _ in runs] == list(range(0, total, interval))
        assert all(length == min(dur, total - s) for s, length in runs)


def test_inpainting_operator_builds_each_mask():
    kw = dict(audio_length_in_s=0.5, sample_rate=16000, mask_percentage=0.3,
              mask_duration_s=0.05, interval_s=0.1)
    rnd = MusicInpaintingOperator(mask_type="random",
                                  mask_generator=torch.Generator().manual_seed(2), **kw)
    assert np.array_equal(rnd.mask, random_mask(torch.Generator().manual_seed(2), 8000,
                                                16000, 0.3, 0.05))
    default = MusicInpaintingOperator(mask_type="random", **kw)
    assert np.array_equal(default.mask, random_mask(torch.Generator().manual_seed(0), 8000,
                                                    16000, 0.3, 0.05))
    per = MusicInpaintingOperator(mask_type="periodic", **kw)
    assert np.array_equal(per.mask, np.asarray(JInpaint(mask_type="periodic", **kw).mask))
    with pytest.raises(ValueError, match="Unknown mask type"):
        MusicInpaintingOperator(mask_type="triangle")


def test_poisson_noise():
    data = torch.linspace(-1.2, 1.2, 4001)[None].repeat(2, 1).requires_grad_(True)
    noiser = PoissonNoise(rate=2.0)
    assert noiser(data) is data            # no generator: the identity
    noisy = noiser(data, torch.Generator().manual_seed(0))
    again = noiser(data, torch.Generator().manual_seed(0))
    assert torch.equal(noisy, again) and not torch.equal(noisy, data)
    # the lattice of counts / (255 rate) mapped to [-1, 1]
    counts = (noisy.detach() + 1.0) / 2.0 * 255.0 * 2.0
    inside = noisy.detach().abs() < 1.0
    assert torch.allclose(counts[inside], counts[inside].round(), atol=1e-3)
    assert float(noisy.detach().abs().max()) <= 1.0
    # straight through: the gradient is the identity
    g = torch.randn(data.shape, generator=torch.Generator().manual_seed(1))
    (grad,) = torch.autograd.grad((noisy * g).sum(), data)
    assert torch.equal(grad, g)
    # unbiased where no clip acts: mean of many draws near the input
    x = torch.full((200000,), 0.2)
    draws = PoissonNoise(rate=1.0)(x, torch.Generator().manual_seed(5))
    assert abs(float(draws.mean()) - 0.2) < 2e-3
    # the JAX noiser's gradient is the identity too, and both factories agree
    jg = jax.grad(lambda d: jnp.sum(JPoisson(rate=2.0)(d, jax.random.key(0)) * g.numpy()))(
        jnp.asarray(data.detach().numpy()))
    assert np.array_equal(np.asarray(jg), g.numpy())
    for name, kw in (("gaussian", dict(sigma=0.1)), ("poisson", dict(rate=3.0)),
                     ("gaussian", {})):
        assert dataclasses.asdict(get_noiser(name, **kw)) == dataclasses.asdict(
            jget_noiser(name, **kw))
    assert isinstance(get_noiser("gaussian"), GaussianNoise)
    with pytest.raises(ValueError, match="Unknown noiser"):
        get_noiser("laplace")


# -------------------------------------------------------------- operators
def operator_pairs():
    """(name, JAX operator, port operator), the port's drawn arrays set to
    the JAX operator's."""
    jrand = JInpaint(audio_length_in_s=AUDIO_S, mask_type="random", mask_percentage=0.3,
                     mask_duration_s=0.05, mask_key=jax.random.key(3))
    trand = MusicInpaintingOperator(audio_length_in_s=AUDIO_S, mask_type="random",
                                    mask_percentage=0.3, mask_duration_s=0.05)
    object.__setattr__(trand, "mask", np.array(jrand.mask))
    jrev = JDereverb(ir_length=500, decay_factor=0.99, ir_key=jax.random.key(4))
    trev = MusicDereverberationOperator(ir_length=500, decay_factor=0.99)
    assert trev.ir.shape == jrev.ir.shape == (500,)
    object.__setattr__(trev, "ir", np.array(jrev.ir))
    per = dict(audio_length_in_s=AUDIO_S, mask_type="periodic", interval_s=0.1,
               mask_duration_s=0.02)
    phase = dict(n_fft=256, hop_length=64, win_length=256)
    return [("random", jrand, trand), ("periodic", JInpaint(**per), MusicInpaintingOperator(**per)),
            ("phase_retrieval", JPhase(**phase), PhaseRetrievalOperator(**phase)),
            ("super_resolution", JSuperRes(scale=2), SuperResolutionOperator(scale=2)),
            ("dereverberation", jrev, trev)]


@pytest.mark.parametrize("case", range(5))
def test_operators_match_jax(rng, case):
    name, jop, top = operator_pairs()[case]
    gt = wave(rng, OWL, batch=1)
    audio = wave(rng, OWL, batch=1)
    jy = fp32(jop.forward, jnp.asarray(gt))
    ty = top.forward(torch.from_numpy(gt))
    assert ty.shape == jy.shape and rel(ty, jy) <= 1e-4, name
    jt = fp32(jop.transform, jnp.asarray(jy))
    tt = top.transform(torch.from_numpy(jy))
    assert tt.shape == jt.shape and rel(tt, jt) <= 1e-4, name

    # the guided loss's gradient with respect to the audio, in both spaces
    for space in ("mel_spectrogram", "wav_form"):
        target = jt if space == "mel_spectrogram" else jy

        def jloss(a):
            pred = jop.forward(a)
            diff = jnp.asarray(target) - (jop.transform(pred) if space == "mel_spectrogram"
                                          else pred)
            return jnp.sum(jnp.sqrt(jnp.sum(jnp.square(diff.reshape(diff.shape[0], -1)), 1)))

        jl, jg = fp32(jax.value_and_grad(jloss), jnp.asarray(audio))
        a = torch.from_numpy(audio).requires_grad_(True)
        tl = per_clip_loss(torch.from_numpy(target), top, a, space)
        (tg,) = torch.autograd.grad(tl, a)
        assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-4), (name, space)
        assert rel(tg, jg) <= 1e-4, (name, space, rel(tg, jg))


def test_operator_fields_match_jax():
    """The port's operators take the JAX constructors' fields, with the
    generators in place of the keys."""
    for jcls, tcls, keyed in ((JInpaint, MusicInpaintingOperator, "mask"),
                              (JPhase, PhaseRetrievalOperator, None),
                              (JSuperRes, SuperResolutionOperator, None),
                              (JDereverb, MusicDereverberationOperator, "ir")):
        jf = {f.name: f.default for f in dataclasses.fields(jcls)}
        tf = {f.name: f.default for f in dataclasses.fields(tcls)}
        if keyed:
            assert jf.pop(f"{keyed}_key") is None and tf.pop(f"{keyed}_generator") is None
        assert jf.keys() == tf.keys(), jcls.__name__
        assert {k: v for k, v in jf.items() if k != "noiser"} == \
            {k: v for k, v in tf.items() if k != "noiser"}
    ir = MusicDereverberationOperator(ir_length=5000, decay_factor=0.99,
                                      ir_generator=torch.Generator().manual_seed(9)).ir
    assert np.array_equal(ir, generate_impulse_response(torch.Generator().manual_seed(9),
                                                        5000, 0.99).numpy())
    # drawn once: every forward applies the same response
    op = MusicDereverberationOperator(ir_length=64)
    x = torch.randn(1, 1000, generator=torch.Generator().manual_seed(0))
    assert torch.equal(op.forward(x), op.forward(x)) and op.forward(x).shape == (1, 1001)


def test_dereverberation_keeps_one_response_per_device(monkeypatch):
    """Two forwards on one device apply one response tensor, made once: no
    copy from host memory a call. A response set after construction (as
    `operator_pairs` sets the JAX one) is picked up."""
    op = MusicDereverberationOperator(ir_length=64)
    x = torch.randn(2, 1000, generator=torch.Generator().manual_seed(0))
    made = []
    as_tensor = torch.as_tensor
    monkeypatch.setattr(torch, "as_tensor", lambda a, **kw: made.append(a) or as_tensor(a, **kw))
    y1, held1 = op.forward(x), op.response(x.device, x.dtype)
    y2, held2 = op.forward(x), op.response(x.device, x.dtype)
    assert len(made) == 1 and made[0] is op.ir
    assert held1 is held2 and torch.equal(held1, torch.from_numpy(op.ir))
    assert torch.equal(y1, y2) and torch.equal(y1, convolve1d(x, torch.from_numpy(op.ir)))
    ir = np.ascontiguousarray(op.ir[::-1])
    object.__setattr__(op, "ir", ir)
    assert torch.equal(op.forward(x), convolve1d(x, torch.from_numpy(ir)))
    assert len(made) == 2 and made[1] is ir


@pytest.mark.parametrize("given", [True, False])
def test_phase_aware_waveform_matches_jax(rng, given):
    n_fft, hop = 256, 64
    x = wave(rng, OWL, batch=1)
    mag, phase = fp32(jstft.magphase_spectrogram, jnp.asarray(x), n_fft, hop, n_fft)
    mel = np.abs(rng.standard_normal((1, 1, 90, 64))).astype(np.float32)
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=n_fft, sample_rate=16000)
    for owl in (OWL, OWL + 300, OWL - 200):
        ref = fp32(jmel_to_wav_with_phase, jnp.asarray(mel), jnp.asarray(phase),
                   original_waveform_length=owl,
                   linear_magnitude=jnp.asarray(mag) if given else None, **kw)
        out = mel_spectrogram_to_waveform_with_phase(
            torch.from_numpy(mel), torch.from_numpy(phase), original_waveform_length=owl,
            linear_magnitude=torch.from_numpy(mag) if given else None, **kw)
        assert out.shape == ref.shape == (1, owl)
        assert rel(out, ref) <= 1e-4
    if given:   # the true magnitude and phase give the signal back
        inner = slice(n_fft, OWL - n_fft)
        assert rel(out[:, inner], x[:, inner]) <= 1e-4
