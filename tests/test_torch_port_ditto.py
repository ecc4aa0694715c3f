"""CPU parity of DITTO against the JAX package: the path that differentiates
the whole DDIM chain, UNet included, with respect to the initial latents.

- DITTO on the tiny MusicLDM (fp32, box inpainting, 3 steps, eta 1, 3 outer
  iterations at rate 0.01), the JAX scan's normal draws handed to the port
  (`samplers.steps.randn`): the gradient of the loss with respect to the
  initial latents against JAX's `value_and_grad` of its `loss_of_init`
  and against the port's own float64 run, within 1e-4 of its norm; the
  per-outer losses within 1e-4 relative; the final latents within 1e-4 of
  their max; the loss with the per-step checkpoint equal to the loss
  without it, to the bit. The rate sets how far fp32 rounding travels: at
  ditto.yaml's 0.5 the outer loop is chaotic on this tiny model (each SGD
  step moves the latents by a fifth of their norm; JAX's own third
  gradient is 14 % from a float64 run); at 0.05 the final latents still
  move with the summation order (the port's lie 4e-7 to 2.1e-4 of their
  max from its float64 run with 4, 8 or 1 CPU threads, JAX's 4.9e-5: a
  leaky-ReLU mask of the vocoder's backward flips, as in
  `test_torch_port_models.py`); at 0.01 every one of them is within 8e-6.
  Latents from seed 1: at seed 0 the port's first fp32 gradient is 3.5e-4
  from its float64 run (JAX's 5e-5), all of it from the vocoder's backward
  (3.6e-5 with the vocoder in float64).
- Under the checkpoint every route wrapper of the UNet (fused block, flash,
  fused GroupNorm, moments, conv2d) is called with grad on an input that
  needs it, twice a step; the block route is JAX's on the card too, the
  tiny configs' narrow blocks launching the kernel padded to one slice.
  `optim_prompt` is in `test_torch_port_optim_prompt.py`.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_samplers as samplers_test
import test_torch_port_slice as slice_test
from diffmusic_tpu_torch import kernels
from diffmusic_tpu_torch.models.unet import UNet2DConditionModel
from diffmusic_tpu_torch.samplers import SamplerConfig
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

rel = slice_test.rel
AUDIO_S = slice_test.AUDIO_S
OWL = int(AUDIO_S * 16000)
STEPS, OUTER, RATE = 3, 3, 0.01


def norm_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def musicldm():
    jop, top = slice_test.operators()
    return samplers_test.tiny_pipelines(jop, top, "ditto")


def ditto_keys(key, n: int):
    """The keys of the n eta draws of the JAX DITTO chain from `key`
    (`pipelines/musicldm.py`: split(key, 3), then one split of the scan key
    a step, the same in every outer iteration)."""
    _, _, k = jax.random.split(key, 3)
    subs = []
    for _ in range(n):
        k, sub = jax.random.split(k)
        subs.append(sub)
    return subs


def test_ditto_matches_jax(monkeypatch, musicldm):
    jpipe, tpipe = musicldm
    measurement = np.array(jpipe.operator.forward(
        jnp.asarray(samplers_test.harmonic(OWL), jnp.float32)))
    latents = np.random.default_rng(1).standard_normal((1, 8, 16, 32)).astype(np.float32)
    key = jax.random.key(8)
    kw = dict(audio_length_in_s=AUDIO_S, num_inference_steps=STEPS, guidance_scale=2.0,
              eta=1.0, ip_guidance_rate=RATE, optim_outer_loop=OUTER)
    embeds = np.zeros((2, 32), np.float32)   # empty prompt: degenerate CFG
    jout = jpipe(prompt_embeds=jnp.asarray(embeds), measurement=jnp.asarray(measurement),
                 latents=jnp.asarray(latents), key=key, output_type="latent", **kw)
    # JAX returns no losses with the latents: its outer loop again, on the
    # compiled value_and_grad of loss_of_init it cached (the one entry), the
    # degenerate CFG's cond half as the embeds
    (grad_fn,) = [v for k, v in jpipe._denoise_cache.items() if k != "decode"]
    _, _, scan_key = jax.random.split(key, 3)
    jargs = (jnp.asarray(measurement), jnp.zeros((1, 32)))
    lat, jlosses = jnp.asarray(latents), []
    for _ in range(OUTER):
        (loss, _), grad = grad_fn(jpipe._denoise_params(), lat, scan_key, *jargs)
        jlosses.append(float(loss))
        lat = lat - RATE * grad
    keys = ditto_keys(key, STEPS)
    drawn = samplers_test.feed_draws(monkeypatch, keys)
    kernels.reset_launch_counts()
    tout, tlosses = tpipe(prompt_embeds=torch.from_numpy(embeds),
                          measurement=torch.from_numpy(measurement),
                          latents=torch.from_numpy(latents), output_type="latent",
                          return_losses=True, **kw)
    assert all(v == 0 for v in kernels.launch_counts().values())   # CPU: plain versions
    assert drawn == [latents.shape] * STEPS    # once a call, reused by every iteration
    assert tlosses.shape == (OUTER,) and tlosses[-1] < tlosses[0]
    np.testing.assert_allclose(tlosses, np.asarray(jlosses), rtol=1e-4)
    assert rel(tout.audios, jout.audios) <= 1e-4
    assert not np.allclose(tout.audios, latents)

    # the gradient at the initial latents: JAX's, and the port's objective
    (jloss, _), jgrad = grad_fn(jpipe._denoise_params(), jnp.asarray(latents), scan_key,
                                *jargs)
    cfg = SamplerConfig(name="ditto", eta=1.0, ip_guidance_rate=RATE,
                        num_inference_steps=STEPS)
    draws = [samplers_test.jax_normal(k, latents.shape) for k in keys]
    loss_fn = tpipe.make_loss_fn(torch.from_numpy(measurement), OWL)
    timesteps = tpipe.schedule.timesteps(STEPS)
    out = {}
    for remat in (True, False):
        objective = tpipe.ditto_objective(torch.zeros(1, 32), 1.0, loss_fn, cfg, timesteps,
                                          draws, remat=remat)
        x = torch.from_numpy(latents).requires_grad_(True)
        loss, final = objective(x)
        (grad,) = torch.autograd.grad(loss, x)
        out[remat] = (loss.detach(), grad, final.detach())
    # the port's float64 run as the gradient's oracle
    f64 = dataclasses.replace(tpipe, dtype=torch.float64,
                              **{m: copy.deepcopy(getattr(tpipe, m)).double()
                                 for m in ("unet", "vae", "vocoder")})
    objective = f64.ditto_objective(torch.zeros(1, 32, dtype=torch.float64), 1.0,
                                    f64.make_loss_fn(torch.from_numpy(measurement).double(),
                                                     OWL),
                                    cfg, timesteps, [d.double() for d in draws])
    x = torch.from_numpy(latents).double().requires_grad_(True)
    (grad64,) = torch.autograd.grad(objective(x)[0], x)
    assert float(out[True][0]) == pytest.approx(float(jloss), rel=1e-4)
    assert float(out[True][0]) == pytest.approx(float(tlosses[0]), rel=1e-6)
    assert norm_rel(out[True][1], jgrad) <= 1e-4
    assert norm_rel(out[True][1], grad64) <= 1e-4 and norm_rel(jgrad, grad64) <= 1e-4
    # the checkpoint recomputes the same chain: the same loss to the bit
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][2], out[False][2])
    assert norm_rel(out[True][1], out[False][1]) <= 1e-6


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_ditto_step_matches_jax(rng, eta):
    """The inner step alone against JAX's, its draw handed over; the loss on
    prev where a loss_fn is given."""
    from diffmusic_tpu.samplers import (DiffusionSchedule as JSchedule,
                                        SamplerConfig as JSamplerConfig,
                                        make_step_fn as jmake_step_fn)
    from diffmusic_tpu_torch.samplers import DiffusionSchedule, make_step_fn
    eps, x, target = (rng.standard_normal((1, 8, 6, 4)).astype(np.float32) for _ in range(3))
    kw = dict(name="ditto", eta=eta, ip_guidance_rate=0.5, num_inference_steps=20)
    jloss = lambda p: jnp.sqrt(jnp.sum(jnp.square(jnp.sin(p) - target)))
    tloss = lambda p: (torch.sin(p) - torch.from_numpy(target)).square().sum().sqrt()
    for jl_fn, tl_fn in ((None, None), (jloss, tloss)):
        jstep = jmake_step_fn(JSchedule(), JSamplerConfig(**kw), jl_fn)
        tstep = make_step_fn(DiffusionSchedule(), SamplerConfig(**kw), tl_fn)
        for i, t in enumerate((951, 501, 1)):
            key = jax.random.key(i)
            jprev, jx0, jl = jstep(jnp.asarray(eps), jnp.int32(t), jnp.asarray(x), key)
            noise = samplers_test.jax_normal(key, x.shape)
            sample = torch.from_numpy(x).requires_grad_(True)
            tprev, tx0, tl = tstep(torch.from_numpy(eps), t, sample, noise)
            assert tprev.requires_grad     # nothing is detached
            assert rel(tprev.detach(), jprev) <= 1e-5 and rel(tx0.detach(), jx0) <= 1e-5
            assert float(tl) == pytest.approx(float(jl), rel=1e-5, abs=1e-6)


def test_ditto_remat_needs_its_draws(musicldm):
    """A checkpointed chain must not draw inside a step: the loop refuses a
    generator there."""
    from diffmusic_tpu_torch.pipelines.base import run_denoise_loop
    _, tpipe = musicldm
    x = torch.zeros(1, 8, 16, 32)
    with pytest.raises(ValueError, match="draws"):
        run_denoise_loop(lambda *a: a, lambda x, t: x, x, [1], torch.Generator(), grad=True,
                         remat=True)
    with pytest.raises(ValueError, match="grad=True"):
        run_denoise_loop(lambda *a: a, lambda x, t: x, x, [1], remat=True)


ROUTE_UNETS = {
    # one 128-wide level at latent (1, 8, 16, 32): T = 512 tokens, the fused
    # GroupNorm, moments and conv2d rules all hold
    "musicldm-fused": (dict(), dict(gn_mode="fused", conv2d_kernel=True),
                       ("fused_group_norm", "conv2d_same", "fused_transformer_block")),
    "musicldm-stats": (dict(), dict(gn_mode="stats", conv2d_kernel=True),
                       ("channel_moments", "conv2d_same", "fused_transformer_block")),
    "audioldm2-flash": (dict(cross_attention_dims=(32, 32), class_embed_type=None,
                             projection_class_embeddings_input_dim=None,
                             class_embeddings_concat=False), dict(),
                        ("flash_attention",)),
    "audioldm2-fused": (dict(cross_attention_dims=(32, 32), class_embed_type=None,
                             projection_class_embeddings_input_dim=None,
                             class_embeddings_concat=False), dict(fuse_cross=True),
                        ("fused_transformer_block",)),
}


@pytest.mark.parametrize("case", sorted(ROUTE_UNETS))
def test_checkpointed_unet_keeps_every_kernel_on_its_autograd_path(rng, monkeypatch, case):
    """Under DITTO's checkpoint every kernel wrapper of the UNet's routes is
    called with grad enabled on an input that requires it, so none takes its
    no-autograd fast path (which on the card would launch the kernel and
    return no gradient): twice a step, in the forward and in the recompute;
    and the gradient equals the one without the checkpoint."""
    from torch.utils.checkpoint import checkpoint
    from diffmusic_tpu_torch.kernels import group_norm as kgn
    from diffmusic_tpu_torch.models import configs as tc
    from diffmusic_tpu_torch.models import layers as tlayers
    from diffmusic_tpu_torch.models.convert import init_flax_style
    widths, routes, wrappers = ROUTE_UNETS[case]
    cfg = tc.UNetConfig(block_out_channels=(128,), layers_per_block=1, norm_num_groups=32,
                        has_attention=(True,), **widths)
    unet = init_flax_style(UNet2DConditionModel(cfg, **routes), 3).requires_grad_(False)
    calls = {}

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(x, *a, **k):
            calls.setdefault(name, []).append(torch.is_grad_enabled() and x.requires_grad)
            return fn(x, *a, **k)
        monkeypatch.setattr(module, name, wrapped)

    for name in wrappers:
        spy(kgn if name == "channel_moments" else tlayers, name)
    x0 = torch.from_numpy(rng.standard_normal((1, 8, 16, 32)).astype(np.float32))
    ts = torch.tensor([501])
    cond = (dict(class_labels=torch.ones(1, 512)) if "musicldm" in case else
            dict(encoder_hidden_states=torch.ones(1, 8, 32),
                 encoder_hidden_states_1=torch.ones(1, 5, 32)))
    grads = {}
    for remat in (False, True):
        calls.clear()
        x = x0.clone().requires_grad_(True)
        fwd = (lambda y: unet(y, ts, **cond))
        out = checkpoint(fwd, x, use_reentrant=False) if remat else fwd(x)
        (grads[remat],) = torch.autograd.grad(out.square().sum(), x)
        counts = {n: len(v) for n, v in calls.items()}
        assert all(all(v) for v in calls.values()), calls
        assert sorted(counts) == sorted(wrappers)
        if remat:
            assert counts == {n: 2 * c for n, c in plain.items()}
        plain = counts
    assert torch.equal(grads[True], grads[False])


def test_block_route_on_the_card_follows_the_kernel_contract(monkeypatch):
    """The block route is JAX's on either device (T >= 512, heads * head_dim
    == C): the tiny configs' 16- and 32-channel blocks take the fused block,
    which on a card tensor launches the kernel padded to one 64-channel slice
    (through the stand-in library of `test_torch_port_block_tiles.py`) and
    equals the block's plain run; below 512 tokens nothing launches."""
    import test_torch_port_block_tiles as block_tiles
    from diffmusic_tpu_torch.models.convert import init_flax_style
    from diffmusic_tpu_torch.models.layers import BasicTransformerBlock
    gen = torch.Generator().manual_seed(3)
    for c, cross in ((16, ()), (32, (24, 40))):
        block = init_flax_style(BasicTransformerBlock(c, c // 8, 8, cross, fuse_cross=True),
                                4).requires_grad_(False)
        contexts = tuple(torch.randn(1, 5, d, generator=gen) for d in cross)
        for t, launches in ((512, 1), (511, 0)):
            x = torch.randn(1, t, c, generator=gen)
            want = block(x, contexts)
            lib = block_tiles.stand_in(monkeypatch)
            got = block(x, contexts)
            monkeypatch.undo()
            assert sum(kernels.launch_counts().values()) == launches
            assert [a[3:5] for a in lib.launches] == [(64, c)] * launches
            assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
