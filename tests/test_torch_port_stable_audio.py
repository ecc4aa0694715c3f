"""CPU parity of the port's StableAudio against the JAX package's.

Weights: the JAX `StableAudioPipeline.tiny(seed=0)`'s own `init`, with
Snake's alpha and beta moved off zero by seeded normals, through `from_flax`
into the port's modules. Inputs are seeded numpy draws fed to both.

- Oobleck: encode (mean and std), decode, and decode's input gradient.
- The DiT forward at the tiny config (4 query heads over 2 KV heads), the
  projection model, encode_prompt with the byte tokenizer.
- EDM: the sigma and timestep tables equal to the float32 bit; the
  preconditioning under both prediction types; one sample of a fixed linear
  model_fn.
- The tiny pipeline end to end with the same latents (2 waveforms) and
  prompt_embeds: final latents and stereo audio with CFG (3.0), without
  (1.0), and output_type "latent". Two JAX pipeline compiles in the file.
- The converters (every Oobleck weight-norm form) and `load_stable_audio`
  from a tiny safetensors snapshot equal to JAX's to the bit, every key
  read, an extra key raising.
- Each trap as a planted fault that its bound must catch: `Tensor.repeat` for
  the KV heads and for the CFG conditioning, rope on every channel, rope on
  interleaved pairs, a second-order first step, sigma fed in place of
  c_noise.

Bounds (fp32, max |err| / max |JAX|): modules 1e-5; the decode's gradient
and the pipeline's latents and audio 1e-4 (a few steps through the whole
chain); the converters and the load exact.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_snapshot as snap
from diffmusic_tpu.models import checkpoint as jckpt
from diffmusic_tpu.models import convert as jconvert
from diffmusic_tpu.models.oobleck import AutoencoderOobleck as JOobleck
from diffmusic_tpu.models.stable_audio_dit import StableAudioDiTModel as JDiT
from diffmusic_tpu.pipelines.stable_audio import StableAudioPipeline as JPipeline
from diffmusic_tpu.samplers import edm as jedm
from diffmusic_tpu_torch.models import checkpoint as ckpt
from diffmusic_tpu_torch.models import configs as tcfg
from diffmusic_tpu_torch.models import convert
from diffmusic_tpu_torch.models import stable_audio_dit as sad
from diffmusic_tpu_torch.models.convert import from_flax
from diffmusic_tpu_torch.models.oobleck import AutoencoderOobleck
from diffmusic_tpu_torch.models.stable_audio_dit import (StableAudioDiTModel,
                                                         StableAudioProjectionModel)
from diffmusic_tpu_torch.models.t5 import T5EncoderModel
from diffmusic_tpu_torch.pipelines import StableAudioPipeline
from diffmusic_tpu_torch.pipelines import stable_audio as tsa
from diffmusic_tpu_torch.samplers import edm
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
MODULE_TOL = 1e-5
CHAIN_TOL = 1e-4
STEPS = 4
WAVES = 2


def relerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def port_cfg(cfg):
    return getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


def port_module(cls, params, jax_cfg):
    cfg = port_cfg(jax_cfg)
    m = cls(cfg)
    m.load_state_dict(from_flax(params, cfg), strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def pipes():
    """(the JAX tiny pipeline, the port's with its weights)."""
    jp = JPipeline.tiny(seed=0)
    rng = np.random.default_rng(5)
    jp.vae_params = jax.tree_util.tree_map_with_path(
        lambda p, a: (a + 0.3 * rng.standard_normal(a.shape).astype(np.float32)
                      if p[-1].key in ("alpha", "beta") else a), jp.vae_params)
    tp = StableAudioPipeline(port_module(StableAudioDiTModel, jp.dit_params, jp.dit_cfg),
                             port_module(AutoencoderOobleck, jp.vae_params, jp.vae_cfg),
                             port_module(T5EncoderModel, jp.text_params, jp.text_cfg),
                             port_module(StableAudioProjectionModel, jp.proj_params,
                                         jp.proj_cfg),
                             tokenizer=tsa.stable_audio_byte_tokenizer)
    return jp, tp


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    return {"wav": rng.standard_normal((2, 2, 8 * 8)).astype(np.float32),
            "z": rng.standard_normal((2, 4, 8)).astype(np.float32),
            "x": rng.standard_normal((2, 4, 16)).astype(np.float32),
            "t": np.asarray([0.5, -1.25], np.float32),
            "ctx": rng.standard_normal((2, 5, 16)).astype(np.float32),
            "glob": rng.standard_normal((2, 32)).astype(np.float32),
            "latents": rng.standard_normal((WAVES, 4, 6)).astype(np.float32),
            "embeds": rng.standard_normal((2, 7, 32)).astype(np.float32)}


def t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ Oobleck
def test_oobleck_encode_matches_jax(pipes, inputs):
    jp, tp = pipes
    mean, std = jp.vae.apply(jp.vae_params, inputs["wav"], method=JOobleck.encode)
    with torch.no_grad():
        tmean, tstd = tp.vae.encode(t(inputs["wav"]))
    assert tmean.shape == mean.shape == (2, 4, 8)
    assert relerr(tmean, mean) <= MODULE_TOL and relerr(tstd, std) <= MODULE_TOL
    assert float(tstd.min()) > 0


def test_oobleck_decode_matches_jax(pipes, inputs):
    jp, tp = pipes
    out = jp.vae.apply(jp.vae_params, inputs["z"], method=JOobleck.decode)
    with torch.no_grad():
        got = tp.vae.decode(t(inputs["z"]))
    assert got.shape == out.shape == (2, 2, 64)
    assert relerr(got, out) <= MODULE_TOL


def test_oobleck_decode_input_gradient_matches_jax(pipes, inputs):
    jp, tp = pipes
    g = jax.grad(lambda z: jnp.sum(jp.vae.apply(jp.vae_params, z,
                                                method=JOobleck.decode) ** 2))(inputs["z"])
    z = t(inputs["z"]).requires_grad_(True)
    (tg,) = torch.autograd.grad(tp.vae.decode(z).square().sum(), z)
    assert float(np.abs(np.asarray(g)).max()) > 0
    assert relerr(tg, g) <= CHAIN_TOL


# --------------------------------------------------------------------- DiT
def dit_args(inputs):
    return inputs["x"], inputs["t"], inputs["ctx"], inputs["glob"]


def dit_err(pipes, inputs) -> float:
    jp, tp = pipes
    want = jp.dit.apply(jp.dit_params, *dit_args(inputs))
    with torch.no_grad():
        got = tp.dit(*map(t, dit_args(inputs)))
    assert got.shape == want.shape == (2, 4, 16)
    return relerr(got, want)


def test_dit_forward_matches_jax(pipes, inputs):
    cfg = pipes[1].dit_cfg
    assert cfg.num_key_value_attention_heads < cfg.num_attention_heads   # GQA
    assert cfg.rotary_dim == cfg.attention_head_dim // 2
    assert dit_err(pipes, inputs) <= MODULE_TOL


def test_projection_matches_jax(pipes, inputs):
    jp, tp = pipes
    start, total = np.asarray([0.0, 3.5], np.float32), np.asarray([10.0, 80.0], np.float32)
    text, glob = jp.projection.apply(jp.proj_params, inputs["embeds"], start, total)
    with torch.no_grad():
        ttext, tglob = tp.projection(t(inputs["embeds"]), t(start), t(total))
    assert relerr(ttext, text) <= MODULE_TOL and relerr(tglob, glob) <= MODULE_TOL


def test_encode_prompt_matches_jax(pipes):
    jp, tp = pipes
    want = jp.encode_prompt("warm analog synth", "noise", True)
    with torch.no_grad():
        got = tp.encode_prompt("warm analog synth", "noise", True)
    assert got.shape == want.shape and relerr(got, want) <= MODULE_TOL
    ids, mask = tsa.stable_audio_byte_tokenizer(["ab"])
    assert ids[0, :3].tolist() == [2 + 97, 2 + 98, 1] and mask[0].sum() == 3
    # "noise" is 5 bytes and </s>: the uncond row's padding is zeroed
    assert np.abs(got.numpy()[0, 6:]).max() == 0 and np.abs(got.numpy()[0, :6]).min() > 0
    with pytest.raises(ValueError, match="tokenizer"):
        dataclasses.replace(tp, tokenizer=None).encode_prompt("x")


# --------------------------------------------------------------------- EDM
@pytest.mark.parametrize("n", [1, 2, 10, 100, 200])
def test_edm_tables_equal_to_the_bit(n):
    ours, theirs = edm.EDMDPMSolverMultistepSchedule(), jedm.EDMDPMSolverMultistepSchedule()
    for a, b in ((ours.sigmas(n), theirs.sigmas(n)), (ours.timesteps(n), theirs.timesteps(n))):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    assert ours.sigmas(n)[-1] == 0 and ours.sigmas(n).shape == (n + 1,)


@pytest.mark.parametrize("prediction_type", ["v_prediction", "epsilon"])
def test_edm_preconditioning_matches_jax(prediction_type):
    ours = edm.EDMDPMSolverMultistepSchedule(prediction_type=prediction_type)
    theirs = jedm.EDMDPMSolverMultistepSchedule(prediction_type=prediction_type)
    rng = np.random.default_rng(2)
    x, out = rng.standard_normal((2, 3, 5), np.float32), rng.standard_normal((2, 3, 5), np.float32)
    for sigma in np.float32([0.3, 5.0, 500.0]):
        assert relerr(ours.scale_input(t(x), t(sigma)),
                      theirs.scale_input(x, sigma)) <= MODULE_TOL
        assert relerr(ours.precondition_outputs(t(x), t(out), t(sigma)),
                      theirs.precondition_outputs(x, out, sigma)) <= MODULE_TOL
    c_out = ours.precondition_coefficients(torch.tensor(2.0))[1]
    assert (float(c_out) < 0) == (prediction_type == "v_prediction")
    with pytest.raises(ValueError):
        dataclasses.replace(ours, prediction_type="sample").precondition_outputs(
            t(x), t(out), 1.0)


def linear_model(lib):
    """A fixed linear model_fn of (scaled sample, c_noise)."""
    return lambda x, c: 0.7 * x - 0.2 * c


def edm_sample_err(steps: int = 12) -> float:
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((2, 3, 8)).astype(np.float32)
    want = jedm.make_edm_sampler(jedm.EDMDPMSolverMultistepSchedule(), steps,
                                 linear_model(jnp))(jnp.asarray(lat))
    got = edm.make_edm_sampler(edm.EDMDPMSolverMultistepSchedule(), steps,
                               linear_model(torch))(t(lat))
    assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
    return relerr(got, want)


def test_edm_sample_matches_jax():
    assert edm_sample_err() <= MODULE_TOL


def test_edm_sampler_recovers_a_fixed_x0():
    """The JAX package's own check: a model that always denoises to x0
    carries the sampler to x0."""
    sched = edm.EDMDPMSolverMultistepSchedule()
    x0 = torch.full((1, 2, 8), 0.7)

    def model_fn(x_scaled, c_noise):
        sigma = torch.exp(torch.tensor(4.0 * c_noise))
        x = x_scaled * torch.sqrt(sigma ** 2 + 1.0)
        c_skip, c_out = sched.precondition_coefficients(sigma)
        return (x0 - c_skip * x) / c_out

    final = edm.make_edm_sampler(sched, 30, model_fn)(torch.randn(1, 2, 8))
    assert torch.allclose(final, x0, atol=2e-2)


# ---------------------------------------------------------------- pipeline
@pytest.fixture(scope="module")
def jax_runs(pipes, inputs):
    """The JAX pipeline's outputs: CFG 3.0 (audio and latents, one compile)
    and CFG off (one more)."""
    jp = pipes[0]
    out = {}
    length_s = 6 * jp.vae_cfg.hop_length / jp.vae_cfg.sampling_rate
    for scale, embeds in ((3.0, inputs["embeds"]), (1.0, inputs["embeds"][1:])):
        kw = dict(audio_end_in_s=length_s, num_inference_steps=STEPS, guidance_scale=scale,
                  num_waveforms_per_prompt=WAVES, latents=jnp.asarray(inputs["latents"]),
                  prompt_embeds=jnp.asarray(embeds))
        out[scale] = (jp(**kw).audios, jp(**kw, output_type="latent").audios, kw)
    return out


def port_run(tp, kw, output_type="np"):
    kw = dict(kw, latents=t(np.asarray(kw["latents"])),
              prompt_embeds=t(np.asarray(kw["prompt_embeds"])))
    return tp(**kw, output_type=output_type).audios


@pytest.mark.parametrize("scale", [3.0, 1.0])
def test_pipeline_matches_jax(pipes, jax_runs, scale):
    tp = pipes[1]
    audio, lat, kw = jax_runs[scale]
    got_lat = port_run(tp, kw, "latent")
    got = port_run(tp, kw)
    assert got_lat.shape == lat.shape == (WAVES, 4, 6)
    assert got.shape == audio.shape == (WAVES, 2, 6 * tp.vae_cfg.hop_length)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert relerr(got_lat, lat) <= CHAIN_TOL and relerr(got, audio) <= CHAIN_TOL


def test_pipeline_cuts_to_length_and_draws_latents(pipes):
    tp = pipes[1]
    hop, sr = tp.vae_cfg.hop_length, tp.vae_cfg.sampling_rate
    out = tp(prompt="x", audio_end_in_s=5.5 * hop / sr, num_inference_steps=2,
             guidance_scale=2.0, generator=torch.Generator().manual_seed(1)).audios
    again = tp(prompt="x", audio_end_in_s=5.5 * hop / sr, num_inference_steps=2,
               guidance_scale=2.0, generator=torch.Generator().manual_seed(1)).audios
    assert out.shape == (1, 2, int(5.5 * hop)) and np.array_equal(out, again)
    default = tp(prompt="x", num_inference_steps=1, output_type="latent").audios
    assert default.shape == (1, 4, tp.dit_cfg.sample_size)   # sample_size * hop / sr


def test_bf16_pipeline_runs(pipes):
    """bf16 weights: the fp32 time features must not promote the token
    stream, the solver stays fp32, attention's q, k and v agree."""
    tp = pipes[1]
    bf = StableAudioPipeline(*(getattr(tp, n).to(torch.bfloat16) if n != "text_encoder"
                               else getattr(tp, n)
                               for n in ("dit", "vae", "text_encoder", "projection")),
                             tokenizer=tp.tokenizer)
    hop, sr = tp.vae_cfg.hop_length, tp.vae_cfg.sampling_rate
    try:
        lat = bf(prompt="x", audio_end_in_s=4 * hop / sr, num_inference_steps=3,
                 guidance_scale=3.0, output_type="latent").audios
        audio = bf(prompt="x", audio_end_in_s=4 * hop / sr, num_inference_steps=3,
                   guidance_scale=3.0).audios
    finally:
        for n in ("dit", "vae", "projection"):
            getattr(tp, n).float()
    assert lat.dtype == np.float32 and np.isfinite(lat).all() and np.isfinite(audio).all()


# ---------------------------------------------------------- planted faults
def tiled_kv(kv, rep):
    return kv.repeat(1, 1, rep, 1)


def tiled_rows(a, batch):
    return a.repeat(batch, *([1] * (a.ndim - 1)))


REAL_ROTARY, REAL_SCALARS = sad.apply_partial_rotary, edm.solver_scalars


def rope_every_channel(x, cos, sin, rotary_dim):
    c, s = sad.rotary_tables(x.shape[-1], x.shape[1])
    return REAL_ROTARY(x, c, s, x.shape[-1])


def rope_interleaved(x, cos, sin, rotary_dim):
    rot, rest = x[..., :rotary_dim].float(), x[..., rotary_dim:]
    r1, r2 = rot[..., 0::2], rot[..., 1::2]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    out = torch.stack([r1 * c - r2 * s, r2 * c + r1 * s], dim=-1).flatten(-2)
    return torch.cat([out.to(x.dtype), rest], dim=-1)


def second_order_first_step(x0, x0_prev, r, first):
    return (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * x0_prev


def sigma_for_c_noise(schedule, n):
    sc = REAL_SCALARS(schedule, n)
    sc["c_noise"] = schedule.sigmas(n)[:-1].tolist()
    return sc


PLANTED = {"kv heads tiled (Tensor.repeat)": (sad, "expand_kv_heads", tiled_kv, "dit"),
           "rope on every channel": (sad, "apply_partial_rotary", rope_every_channel, "dit"),
           "rope on interleaved pairs": (sad, "apply_partial_rotary", rope_interleaved, "dit"),
           "CFG conditioning tiled (Tensor.repeat)": (tsa, "repeat_rows", tiled_rows,
                                                      "pipeline"),
           "second-order first step": (edm, "dpm_solver_d", second_order_first_step, "edm"),
           "sigma fed in place of c_noise": (edm, "solver_scalars", sigma_for_c_noise, "edm")}


@pytest.mark.parametrize("name", list(PLANTED))
def test_planted_fault_fails_its_bound(name, pipes, inputs, jax_runs, monkeypatch):
    owner, attr, fault, where = PLANTED[name]
    monkeypatch.setattr(owner, attr, fault)
    if where == "dit":
        reading, tol = dit_err(pipes, inputs), MODULE_TOL
    elif where == "edm":
        reading, tol = edm_sample_err(), MODULE_TOL
    else:
        audio, lat, kw = jax_runs[3.0]
        reading, tol = relerr(port_run(pipes[1], kw, "latent"), lat), CHAIN_TOL
    assert reading > tol, f"{name}: {reading:.3e} within {tol:.0e}"


# --------------------------------------------------------- converters, load
def tiny_stable_audio_configs(gated: bool = False):
    """The tiny DiT and Oobleck, a t5-base-style (ReLU) tiny T5 and the
    projection between them (port configs)."""
    t5 = dataclasses.replace(tcfg.tiny_t5_config(), is_gated_act=gated)
    dit = tcfg.tiny_stable_audio_dit_config()
    return (dit, tcfg.tiny_oobleck_config(), t5,
            tcfg.StableAudioProjectionConfig(t5.d_model, dit.cross_attention_input_dim,
                                             max_value=64.0))


def trees_equal(a, b) -> bool:
    fa = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
          jax.tree_util.tree_flatten_with_path(a)[0]}
    fb = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
          jax.tree_util.tree_flatten_with_path(b)[0]}
    return sorted(fa) == sorted(fb) and all(
        fa[k].shape == fb[k].shape and np.array_equal(fa[k].astype(np.float32), fb[k]) for k in fa)


@pytest.mark.parametrize("which", ["oobleck fused", "oobleck weight_g",
                                   "oobleck parametrizations", "dit", "projection"])
def test_converters_match_jax(which):
    dit, vae, t5, proj = tiny_stable_audio_configs()
    if which.startswith("oobleck"):
        sd = snap._values(snap.oobleck_shapes(vae, which.split()[1]), 3)
        ours, theirs = convert.convert_oobleck(sd, vae), jconvert.convert_oobleck(sd, vae)
    elif which == "dit":
        sd = snap._values(snap.stable_audio_dit_shapes(dit), 4)
        ours, theirs = (convert.convert_stable_audio_dit(sd, dit),
                        jconvert.convert_stable_audio_dit(sd, dit))
    else:
        sd = snap._values(snap.stable_audio_projection_shapes(proj), 5)
        ours, theirs = (convert.convert_stable_audio_projection(sd),
                        jconvert.convert_stable_audio_projection(sd))
    assert trees_equal(ours, theirs)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    root = tmp_path_factory.mktemp("stable_audio")
    return snap.write_stable_audio_snapshot(
        root, snap.stable_audio_modules(*tiny_stable_audio_configs(), seed=9),
        dict(snap.EDM_SCHEDULER_JSON, sigma_min=0.25, rho=6.0))


def test_load_stable_audio_matches_jax(snapshot):
    jp = jckpt.load_stable_audio(str(snapshot))
    tp = ckpt.load_stable_audio(snapshot, device="cpu")
    assert not tp.text_cfg.is_gated_act and tp.text_cfg == port_cfg(jp.text_cfg)
    for name, params, jcfg in (("dit", jp.dit_params, jp.dit_cfg),
                               ("vae", jp.vae_params, jp.vae_cfg),
                               ("text_encoder", jp.text_params, jp.text_cfg),
                               ("projection", jp.proj_params, jp.proj_cfg)):
        cfg = port_cfg(jcfg)
        module = getattr(tp, name)
        assert module.cfg == cfg
        want, got = from_flax(params, cfg), module.state_dict()
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want), name
    assert dataclasses.asdict(tp.schedule) == dataclasses.asdict(jp.schedule)
    assert tp.schedule.sigma_min == 0.25 and tp.tokenizer is None
    assert tp.device.type == "cpu"


@pytest.mark.parametrize("module", ["transformer", "vae", "text_encoder", "projection_model"])
def test_load_stable_audio_unread_key_raises(snapshot, tmp_path, module):
    modules = snap.stable_audio_modules(*tiny_stable_audio_configs(), seed=9)
    cfg_json, sd = modules[module]
    modules[module] = (cfg_json, dict(sd, **{"extra.weight": np.zeros(3, np.float32)}))
    root = snap.write_stable_audio_snapshot(tmp_path / "bad", modules)
    with pytest.raises(ValueError, match="NOT consumed"):
        ckpt.load_stable_audio(root, device="cpu")


def test_random_weights_follow_flax_init():
    dit, vae, t5, proj = tiny_stable_audio_configs()
    a = StableAudioPipeline.random(dit, vae, t5, proj, seed=3, device="cpu")
    b = StableAudioPipeline.random(dit, vae, t5, proj, seed=3, device="cpu", draw_on_device=True)
    for name in ("dit", "vae", "text_encoder", "projection"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)   # CPU draws either way
    assert float(a.vae.decoder.snake1.alpha.abs().max()) == 0
    w = a.dit.time_proj.weight
    assert 0.5 < float(w.std()) < 1.6 and float(a.dit.timestep_proj_1.bias.abs().max()) == 0
    assert a.vae.decoder.block_0.conv_t1.weight.shape[:2] == (16, 8)


def test_new_modules_import_no_jax():
    code = ("import sys; "
            "import diffmusic_tpu_torch.pipelines.stable_audio, diffmusic_tpu_torch.tracing, "
            "diffmusic_tpu_torch.models.oobleck, diffmusic_tpu_torch.samplers.edm, "
            "diffmusic_tpu_torch.fadtk.fad_batch, diffmusic_tpu_torch.fadtk.embeds, "
            "diffmusic_tpu_torch.fadtk.package, diffmusic_tpu_torch.fadtk.__main__, "
            "diffmusic_tpu_torch.fadtk.test.__main__; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'diffmusic_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
