"""CPU parity of the port's UNet, VAE decoder and HiFi-GAN against the JAX
package, with the weights carried over by `models/convert.py::from_flax`.

The small configs are chosen so that every kernel wrapper's route is taken
(on the CPU the wrappers run their plain versions):
  - UNet latent (1, 8, 64, 16): level 0 has T = 1024 >= 512 tokens with
    inner == C, so its blocks go through `fused_transformer_block`;
  - HiFi-GAN at full width (upsample_initial_channel 1024) with resblock
    kernels (3, 7), in fp32: stage 0 (ch512) runs k=3 through
    `conv1d_fused_pair` and k=7 (14.7 MB of fp32 pair weights, over pair_ok's
    9 MB) through `conv1d_fused` -- the route the bf16 slice takes for k=11;
    stages 1-2 (ch256, ch128) run pairs only; upsamplers 0-2 run
    `phase_convtranspose`; the ch64/32 stages are plain.
Tolerance: 1e-4 of max |reference| (fp32), 1e-5 against the port's own
float64 run for the vocoder gradient.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from diffmusic_tpu.models import configs as jcfg
from diffmusic_tpu.models.hifigan import SpeechT5HifiGan as JHifiGan
from diffmusic_tpu.models.unet import UNet2DConditionModel as JUNet
from diffmusic_tpu.models.vae import AutoencoderKL as JVAE
from diffmusic_tpu_torch.models import configs as tcfg
from diffmusic_tpu_torch.models import hifigan as thifigan
from diffmusic_tpu_torch.models import layers as tlayers
from diffmusic_tpu_torch.models.convert import from_flax, init_flax_style
from diffmusic_tpu_torch.models.hifigan import SpeechT5HifiGan
from diffmusic_tpu_torch.models.unet import UNet2DConditionModel
from diffmusic_tpu_torch.models.vae import AutoencoderKL
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

UNET = jcfg.tiny_unet_config()
VAE = jcfg.tiny_vae_config()
VOC = jcfg.HiFiGANConfig(resblock_kernel_sizes=(3, 7),
                         resblock_dilation_sizes=((1, 3), (1, 3)))


def port_cfg(cfg):
    return getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def load(model, params, cfg):
    model.load_state_dict(from_flax(params, port_cfg(cfg)), strict=True)
    return model.requires_grad_(False)


# parameters do not depend on the spatial size: init on small inputs
@pytest.fixture(scope="module")
def unet():
    params = jax.jit(JUNet(UNET).init)(jax.random.key(1), jnp.zeros((1, 8, 8, 8)),
                                       jnp.asarray([0]), class_labels=jnp.zeros((1, 32)))
    return params, load(UNet2DConditionModel(port_cfg(UNET)), params, UNET)


@pytest.fixture(scope="module")
def vae():
    params = jax.jit(JVAE(VAE).init)(jax.random.key(2), jnp.zeros((1, 1, 8, 8)))
    return params, load(AutoencoderKL(port_cfg(VAE)), params, VAE)


@pytest.fixture(scope="module")
def vocoder():
    params = jax.jit(JHifiGan(VOC).init)(jax.random.key(3), jnp.zeros((1, 2, 64)))
    return params, load(SpeechT5HifiGan(port_cfg(VOC)), params, VOC)


def spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def wrapped(*a, **k):
        calls[name] = calls.get(name, 0) + 1
        return fn(*a, **k)
    monkeypatch.setattr(module, name, wrapped)


def test_unet_matches_jax(rng, unet, monkeypatch):
    params, model = unet
    x = rng.standard_normal((1, 8, 64, 16)).astype(np.float32)
    cls = rng.standard_normal((1, 32)).astype(np.float32)
    ref = jax.jit(JUNet(UNET).apply)(params, jnp.asarray(x), jnp.asarray([417]),
                                     class_labels=jnp.asarray(cls))
    calls = {}
    spy(monkeypatch, tlayers, "fused_transformer_block", calls)
    out = model(torch.from_numpy(x), torch.tensor([417]), class_labels=torch.from_numpy(cls))
    assert calls == {"fused_transformer_block": 3}   # level 0: down_0 x1, up_1 x2
    assert out.shape == ref.shape
    assert rel(out, ref) <= 1e-4


def test_vae_decode_and_gradient_match_jax(rng, vae):
    params, model = vae
    z = rng.standard_normal((1, 8, 16, 8)).astype(np.float32)
    g = rng.standard_normal((1, 1, 32, 16)).astype(np.float32)
    ref, vjp = jax.vjp(jax.jit(lambda z_: JVAE(VAE).apply(params, z_, method=JVAE.decode)),
                       jnp.asarray(z))
    (jdz,) = vjp(jnp.asarray(g))
    zt = torch.from_numpy(z).requires_grad_(True)
    out = model.decode(zt)
    (dz,) = torch.autograd.grad(out, zt, torch.from_numpy(g))
    assert out.shape == ref.shape
    assert rel(out.detach(), ref) <= 1e-4
    assert rel(dz, jdz) <= 1e-4


def test_hifigan_routes_and_matches_jax(vocoder, monkeypatch):
    params, model = vocoder
    # a leaky-ReLU mask flips wherever an activation lies within fp32 rounding
    # of zero, moving the input gradient by ~1e-3: measured against a float64
    # run, seeds 0, 1 and 3 flip one mask in the port's or in JAX's fp32
    # gradient; seed 2 keeps every activation clear of zero on both sides
    rng = np.random.default_rng(2)
    mel = rng.standard_normal((1, 6, 64)).astype(np.float32)
    ref, vjp = jax.vjp(jax.jit(lambda m: JHifiGan(VOC).apply(params, m)), jnp.asarray(mel))
    g = rng.standard_normal(ref.shape).astype(np.float32)
    (jdm,) = vjp(jnp.asarray(g))
    calls = {}
    for name in ("conv1d_fused", "conv1d_fused_pair", "phase_convtranspose"):
        spy(monkeypatch, thifigan, name, calls)
    mt = torch.from_numpy(mel).requires_grad_(True)
    out = model(mt)
    (dm,) = torch.autograd.grad(out, mt, torch.from_numpy(g))
    # stage 0 (ch512): k=3 pairs x2, k=7 single convs x4; ch256, ch128: pairs x4 each
    assert calls == {"conv1d_fused_pair": 10, "conv1d_fused": 4, "phase_convtranspose": 3}
    assert out.shape == ref.shape == (1, 992)   # torch ConvTranspose geometry
    assert rel(out.detach(), ref) <= 1e-4
    assert rel(dm, jdm) <= 1e-4
    # float64 run of the same port model as the gradient oracle
    m64 = SpeechT5HifiGan(port_cfg(VOC)).double()
    m64.load_state_dict({k: v.double() for k, v in model.state_dict().items()})
    x64 = torch.from_numpy(mel).double().requires_grad_(True)
    (dm64,) = torch.autograd.grad(m64(x64), x64, torch.from_numpy(g).double())
    assert rel(dm, dm64) <= 1e-5


def _to_flax_layout(key, value, flax_leaf, hifigan):
    """The inverse of from_flax's layout change for one leaf."""
    v = value.numpy()
    if flax_leaf != "kernel":
        return v
    if hifigan:
        return v.swapaxes(1, 2) if key.split(".")[-2].startswith("upsampler_") else v
    return v if v.ndim == 2 else v.transpose(2, 3, 1, 0)


@pytest.mark.parametrize("which", ["unet", "vae", "vocoder"])
def test_weight_carry_round_trip(which, request):
    params, model = request.getfixturevalue(which)
    cfg = {"unet": UNET, "vae": VAE, "vocoder": VOC}[which]
    state = model.state_dict()
    leaves = flatten_dict(params["params"])   # the VAE's encoder too
    assert len(leaves) == len(state)
    for path, leaf in leaves.items():
        key = ".".join(path[:-1]) + (".bias" if path[-1] == "bias" else ".weight")
        back = _to_flax_layout(key, state[key], path[-1], which == "vocoder")
        assert np.array_equal(back, np.asarray(leaf)), "/".join(path)


def test_flax_style_init_statistics():
    model = init_flax_style(SpeechT5HifiGan(port_cfg(VOC)), seed=0)
    w = model.resblocks_0.convs1_0.weight          # (3, 512, 512): fan-in 1536
    assert abs(w.std().item() * math.sqrt(3 * 512) - 1.0) < 0.02
    assert w.abs().max().item() <= 2.0 / 0.87962566103423978 / math.sqrt(3 * 512) + 1e-6
    up = model.upsampler_0.weight                  # flax (k, Cout, Cin): fan-in k * Cout
    assert abs(up.std().item() * math.sqrt(16 * 512) - 1.0) < 0.02
    assert torch.count_nonzero(model.resblocks_0.convs1_0.bias) == 0
    unet = init_flax_style(UNet2DConditionModel(port_cfg(UNET)), seed=0)
    assert torch.equal(unet.down_0.resnet_0.norm1.weight, torch.ones(16))
    assert torch.equal(unet.down_0.attn_0.block_0.norm1.weight, torch.ones(16))
    again = init_flax_style(UNet2DConditionModel(port_cfg(UNET)), seed=0)
    assert all(torch.equal(a, b) for a, b in zip(unet.state_dict().values(),
                                                 again.state_dict().values()))
