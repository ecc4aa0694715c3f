"""CPU parity of the PyTorch port's DSP ops, operators and sampler steps
against the JAX package (fp32, inputs from a numpy seed).

Tolerance: 1e-5 of max |reference| for values, 1e-4 for the mel gradient
(the JAX package's hand-written scatter-free VJP sums in another order than
autograd's unfold adjoint).
"""

import importlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmusic_tpu.inverse_problem import (IdentityOperator as JIdentity,
                                           MusicInpaintingOperator as JInpaint)
from diffmusic_tpu.samplers import (DiffusionSchedule as JSchedule,
                                    SamplerConfig as JSamplerConfig,
                                    make_step_fn as jmake_step_fn)
from diffmusic_tpu_torch.inverse_problem import (GaussianNoise, IdentityOperator,
                                                 MusicInpaintingOperator)
from diffmusic_tpu_torch.ops import mel as tmel
from diffmusic_tpu_torch.ops import stft as tstft
from diffmusic_tpu_torch.ops.masks import box_mask
from diffmusic_tpu_torch.samplers import (DiffusionSchedule, SamplerConfig,
                                          make_step_fn)

REPO = Path(__file__).resolve().parents[1]
# the JAX ops package re-exports a function named `stft` over its module
jmel = importlib.import_module("diffmusic_tpu.ops.mel")
jstft = importlib.import_module("diffmusic_tpu.ops.stft")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def wave(rng, n, batch=2):
    return rng.standard_normal((batch, n)).astype(np.float32) * 0.3


def spectrogram_oracle(x, power):
    """np.fft.rfft of reflect-padded, Hann-windowed frames in float64."""
    xp = np.pad(x.astype(np.float64), ((0, 0), (512, 512)), mode="reflect")
    n_frames = 1 + x.shape[-1] // 160
    idx = np.arange(n_frames)[:, None] * 160 + np.arange(1024)[None, :]
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(1024) / 1024)
    return np.abs(np.fft.rfft(xp[:, idx] * hann, axis=-1)).swapaxes(-1, -2) ** power


def jax_spectrogram(x, power):
    """The JAX reference on its own copy of x, with fp32 matmuls, finished
    before the port's side starts."""
    with jax.default_matmul_precision("float32"):
        ref = jstft.spectrogram(jnp.array(x), 1024, 160, 1024, power=power)
    return np.asarray(jax.block_until_ready(ref))


@pytest.fixture(scope="module", autouse=True)
def warm_spectrograms():
    """Compile and run both spectrograms once before any test of the file:
    its first test is a worker's first JAX and first BLAS computation, and
    the one place the port-vs-JAX check has failed."""
    x = wave(np.random.default_rng(1), 4000)
    for power in (1.0, 2.0):
        jax_spectrogram(x, power)
        tstft.spectrogram(torch.from_numpy(x.copy()), 1024, 160, 1024, power=power)


@pytest.mark.parametrize("length", [4000, 4321])
@pytest.mark.parametrize("power", [1.0, 2.0])
def test_spectrogram_matches_jax(rng, length, power):
    x = wave(rng, length)
    ref = jax_spectrogram(x, power)
    out = tstft.spectrogram(torch.from_numpy(x.copy()), 1024, 160, 1024, power=power)
    assert out.shape == ref.shape
    # two fp32 matmul-DFTs: each bin is a 1024-term dot whose rounding the
    # BLAS orders as it likes, up to ~1024 * 2^-24 = 6e-5 of its scale
    err = rel(out, ref)
    oracle = spectrogram_oracle(x, power)
    assert err <= 1e-4, (f"port vs JAX: {err:.2e} of max (against float64: port "
                         f"{rel(out, oracle):.2e}, JAX {rel(ref, oracle):.2e})")


@pytest.mark.parametrize("length", [4000, 4321])
@pytest.mark.parametrize("power", [1.0, 2.0])
def test_spectrogram_matches_float64_oracle(rng, length, power):
    """np.fft.rfft of reflect-padded, Hann-windowed frames in float64."""
    x = wave(rng, length)
    ref = spectrogram_oracle(x, power)
    out = tstft.spectrogram(torch.from_numpy(x), 1024, 160, 1024, power=power)
    assert out.shape == ref.shape
    err = rel(out, ref)
    assert err <= 1e-5, f"port vs float64 oracle: {err:.2e} of max"


def test_frame_signal_matches_jax(rng):
    x = wave(rng, 3001)
    ref = jstft.frame_signal(jnp.asarray(x), 1024, 160)
    assert rel(tstft.frame_signal(torch.from_numpy(x), 1024, 160), ref) == 0.0
    assert np.array_equal(tstft.hann_window(1024).numpy(), np.asarray(jstft.hann_window(1024)))


def test_mel_filterbank_is_the_same():
    assert np.array_equal(tmel.mel_filterbank(513, 64, 16000),
                          jmel.mel_filterbank(513, 64, 16000))


@pytest.mark.parametrize("length", [3200, 5000])
def test_mel_and_wav2mel_match_jax(rng, length):
    x = wave(rng, length)
    assert rel(tmel.MelSpectrogram()(torch.from_numpy(x)),
               jmel.MelSpectrogram()(jnp.asarray(x))) <= 1e-5
    jdb = jmel.amplitude_to_db(jmel.MelSpectrogram()(jnp.asarray(x)), "power")
    assert rel(tmel.Wav2Mel()(torch.from_numpy(x)), jdb) <= 1e-5
    assert rel(tmel.amplitude_to_db(torch.tensor([0.0, 1e-12, 3.0]), "power", top_db=80.0),
               jmel.amplitude_to_db(jnp.asarray([0.0, 1e-12, 3.0]), "power", top_db=80.0)) <= 1e-6


def test_mel_gradient_matches_jax_grad(rng):
    x = wave(rng, 4000)
    r = rng.standard_normal((2, 64, 26)).astype(np.float32)
    jg = jax.grad(lambda s: jnp.sum(jmel.MelSpectrogram()(s) * r))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tg,) = torch.autograd.grad((tmel.MelSpectrogram()(xt) * torch.from_numpy(r)).sum(), xt)
    assert rel(tg, jg) <= 1e-4


def test_box_mask_and_inpainting_operator_match_jax(rng):
    assert np.array_equal(box_mask(16000, 16000, 0.4, 0.6),
                          np.asarray(JInpaint(audio_length_in_s=1.0, start_inpainting_s=0.4,
                                              end_inpainting_s=0.6).mask))
    x = wave(rng, 8000, batch=1)
    jop = JInpaint(audio_length_in_s=0.5, start_inpainting_s=0.2, end_inpainting_s=0.3)
    top = MusicInpaintingOperator(audio_length_in_s=0.5, start_inpainting_s=0.2,
                                  end_inpainting_s=0.3)
    jy = jop.forward(jnp.asarray(x))
    ty = top.forward(torch.from_numpy(x))
    assert rel(ty, jy) == 0.0
    assert rel(top.transform(ty), jop.transform(jy)) <= 1e-5
    with pytest.raises(ValueError):
        MusicInpaintingOperator(mask_type="triangle")


def test_identity_operator_matches_jax(rng):
    x = wave(rng, 4000)
    assert rel(IdentityOperator().transform(torch.from_numpy(x)),
               JIdentity().transform(jnp.asarray(x))) <= 1e-5
    assert torch.equal(IdentityOperator().forward(torch.from_numpy(x)), torch.from_numpy(x))


def test_gaussian_noise_draws_from_the_generator():
    x = torch.zeros(4, 20000)
    assert GaussianNoise(sigma=0.0)(x, torch.Generator().manual_seed(0)) is x
    assert GaussianNoise(sigma=0.5)(x) is x
    a = GaussianNoise(sigma=0.5)(x, torch.Generator().manual_seed(3))
    b = GaussianNoise(sigma=0.5)(x, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert abs(a.std().item() - 0.5) < 0.01


def test_schedule_tables_match_jax():
    j, t = JSchedule(), DiffusionSchedule()
    assert np.array_equal(j.alphas_cumprod, t.alphas_cumprod)
    assert np.array_equal(j.timesteps(20), t.timesteps(20))
    for tt, tp in ((981, 931), (1, -49)):
        assert float(j.alpha_prod_prev(tp)) == float(t.alpha_prod_prev(tp))
        assert float(j.variance(tt, tp)) == pytest.approx(float(t.variance(tt, tp)), rel=1e-6)


@pytest.mark.parametrize("name", ["ddim", "dps", "mpgd", "dsg", "diffmusic"])
def test_steps_match_jax(rng, name):
    """Each sampler at eta 0 (the draws of DSG and DiffMusic are then scaled
    by 0), and the loss slot: the guided loss, or ddim's timestep."""
    eps = rng.standard_normal((1, 8, 6, 4)).astype(np.float32)
    x = rng.standard_normal((1, 8, 6, 4)).astype(np.float32)
    target = rng.standard_normal((1, 8, 6, 4)).astype(np.float32)
    jloss = lambda x0: jnp.sqrt(jnp.sum(jnp.square(jnp.sin(x0) - target)))
    tloss = lambda x0: (torch.sin(x0) - torch.from_numpy(target)).square().sum().sqrt()
    kw = dict(name=name, eta=0.0, ip_guidance_rate=0.3, num_inference_steps=20)
    guided = name != "ddim"
    jstep = jmake_step_fn(JSchedule(), JSamplerConfig(**kw), jloss if guided else None)
    tstep = make_step_fn(DiffusionSchedule(), SamplerConfig(**kw), tloss if guided else None)
    for t in (951, 501, 1):
        jprev, jx0, jl = jstep(jnp.asarray(eps), jnp.int32(t), jnp.asarray(x),
                               jax.random.key(0))
        tprev, tx0, tl = tstep(torch.from_numpy(eps), t, torch.from_numpy(x))
        assert rel(tprev, jprev) <= 1e-5
        assert rel(tx0, jx0) <= 1e-5
        assert tl.dtype == torch.float32 and tl.shape == ()
        assert float(tl) == pytest.approx(float(jl), rel=1e-5)
        if not guided:
            assert float(tl) == float(t)


def test_port_imports_no_jax():
    """The port package, chip_smoke's imports and the snapshot writer leave
    jax and the JAX package out of sys.modules."""
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import chip_smoke, diffmusic_tpu_torch.pipelines, "
            "diffmusic_tpu_torch.pipelines.audioldm2, diffmusic_tpu_torch.kernels.build, "
            "diffmusic_tpu_torch.kernels.attention, diffmusic_tpu_torch.models.convert, "
            "diffmusic_tpu_torch.models.clap, diffmusic_tpu_torch.models.t5, "
            "diffmusic_tpu_torch.models.gpt2, diffmusic_tpu_torch.models.projection, "
            "diffmusic_tpu_torch.eval, diffmusic_tpu_torch.metrics, "
            "diffmusic_tpu_torch.metrics.vggish, diffmusic_tpu_torch.fadtk, "
            "diffmusic_tpu_torch.data, diffmusic_tpu_torch.utils, "
            "diffmusic_tpu_torch.kernels.mel, diffmusic_tpu_torch.samplers, "
            "diffmusic_tpu_torch.inverse_problem, diffmusic_tpu_torch.ops, "
            "diffmusic_tpu_torch.ops.filters, diffmusic_tpu_torch.ops.masks, "
            "diffmusic_tpu_torch.pipelines.base, diffmusic_tpu_torch.run, "
            "diffmusic_tpu_torch.config, diffmusic_tpu_torch.constants, "
            "diffmusic_tpu_torch.data.dataloader, diffmusic_tpu_torch.models.checkpoint, "
            "diffmusic_tpu_torch.models.vae, diffmusic_tpu_torch.models.hifigan, "
            "diffmusic_tpu_torch.pipelines.musicldm, test_torch_port_snapshot; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'diffmusic_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
