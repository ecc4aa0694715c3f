"""CPU parity of the port's cross-attention path against the JAX package: the
flash attention kernel's plain version, the dual-cross transformer block on
both routes (`fuse_cross` off: plain with flash self-attention; on: the fused
block's dual-cross mode), its gradients to x and to the contexts, and the
cross-attention UNet.

On the JAX side the Pallas kernels run in interpret mode (`_INTERPRET`, as
the JAX package's own tests run them on the CPU), with
`DIFFMUSIC_TPU_FUSED_CROSS=1` for the fused route; on the port's side the
wrappers run their plain versions, because the tensors lie on the CPU.
Inputs come from a numpy seed, in fp32. Tolerances, as a fraction of max
|reference|: 1e-5 for the attention, 1e-4 for the blocks, the UNet and every
gradient (sums over more terms in other orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffmusic_tpu.pallas.attention_kernel as jak
import diffmusic_tpu.pallas.transformer_kernel as jtk
from diffmusic_tpu.models import configs as jcfg
from diffmusic_tpu.models.layers import BasicTransformerBlock as JBlock
from diffmusic_tpu.models.unet import UNet2DConditionModel as JUNet
from diffmusic_tpu_torch import kernels
from diffmusic_tpu_torch.kernels import attention as tattn
from diffmusic_tpu_torch.models import configs as tcfg
from diffmusic_tpu_torch.models import layers as tlayers
from diffmusic_tpu_torch.models.convert import from_flax
from diffmusic_tpu_torch.models.layers import BasicTransformerBlock
from diffmusic_tpu_torch.models.unet import UNet2DConditionModel
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

HEADS, T, CROSS = 2, 520, (24, 40)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def wrapped(*a, **k):
        calls[name] = calls.get(name, 0) + 1
        return fn(*a, **k)
    monkeypatch.setattr(module, name, wrapped)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode."""
    monkeypatch.setattr(jak, "_INTERPRET", True)
    monkeypatch.setattr(jtk, "_INTERPRET", True)


@pytest.mark.parametrize("t", [512, 600])
def test_flash_attention_matches_jax_kernel(rng, interpret, t):
    q, k, v = (rng.standard_normal((2, t, 4, 8)).astype(np.float32) for _ in range(3))
    ref = jak.flash_attention(*map(jnp.asarray, (q, k, v)))
    kernels.reset_launch_counts()
    out = tattn.flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert kernels.launch_counts()["flash_attention"] == 0   # CPU: the plain version
    assert out.shape == ref.shape
    assert rel(out, ref) <= 1e-5


def test_flash_attention_gradients_match_jax(rng):
    q, k, v = (rng.standard_normal((1, 512, 2, 8)).astype(np.float32) for _ in range(3))
    g = rng.standard_normal(q.shape).astype(np.float32)
    _, vjp = jax.vjp(jak.flash_attention, *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(g))
    qkv = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    grads = torch.autograd.grad(tattn.flash_attention(*qkv), qkv, torch.from_numpy(g))
    for got, want in zip(grads, ref):
        assert rel(got, want) <= 1e-4


def block_inputs(rng, batch=2):
    x = (rng.standard_normal((batch, T, HEADS * 8)) * 0.5).astype(np.float32)
    c0 = (rng.standard_normal((batch, 8, CROSS[0])) * 0.5).astype(np.float32)
    c1 = (rng.standard_normal((batch, 12, CROSS[1])) * 0.5).astype(np.float32)
    m1 = np.array([[1] * 9 + [0] * 3, [1] * 12][:batch], np.int32)
    return x, c0, c1, m1


def port_block(params, fuse_cross):
    blk = BasicTransformerBlock(HEADS * 8, HEADS, 8, CROSS, fuse_cross)
    # a block's leaves follow the UNet's conversion rules
    blk.load_state_dict(from_flax(params, tcfg.UNetConfig()), strict=True)
    return blk.requires_grad_(False)


@pytest.mark.parametrize("fuse_cross", [False, True])
def test_cross_block_matches_jax(rng, interpret, monkeypatch, fuse_cross):
    x, c0, c1, m1 = block_inputs(rng)
    jblk = JBlock(HEADS, 8, cross_dims=CROSS)
    params = jblk.init(jax.random.key(0), jnp.asarray(x), (jnp.asarray(c0), jnp.asarray(c1)),
                       (None, jnp.asarray(m1)))
    monkeypatch.setenv("DIFFMUSIC_TPU_FUSED_CROSS", "1" if fuse_cross else "0")
    ref = jblk.apply(params, jnp.asarray(x), (jnp.asarray(c0), jnp.asarray(c1)),
                     (None, jnp.asarray(m1)))
    calls = {}
    spy(monkeypatch, tlayers, "fused_transformer_block", calls)
    spy(monkeypatch, tlayers, "flash_attention", calls)
    out = port_block(params, fuse_cross)(
        torch.from_numpy(x), (torch.from_numpy(c0), torch.from_numpy(c1)),
        (None, torch.from_numpy(m1)))
    assert calls == ({"fused_transformer_block": 1} if fuse_cross else {"flash_attention": 1})
    assert rel(out, ref) <= 1e-4


@pytest.mark.parametrize("fuse_cross", [False, True])
def test_cross_block_gradients_match_jax(rng, monkeypatch, fuse_cross):
    """Gradients to x and to both contexts (what DITTO and optim_prompt take
    through the UNet), against JAX's custom VJP of the fused block."""
    x, c0, c1, m1 = block_inputs(rng, batch=1)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jblk = JBlock(HEADS, 8, cross_dims=CROSS)
    params = jblk.init(jax.random.key(1), jnp.asarray(x), (jnp.asarray(c0), jnp.asarray(c1)),
                       (None, jnp.asarray(m1)))
    monkeypatch.setenv("DIFFMUSIC_TPU_FUSED_CROSS", "1")
    _, vjp = jax.vjp(lambda x_, a, b: jblk.apply(params, x_, (a, b), (None, jnp.asarray(m1))),
                     jnp.asarray(x), jnp.asarray(c0), jnp.asarray(c1))
    ref = vjp(jnp.asarray(g))
    inputs = [torch.from_numpy(a).requires_grad_(True) for a in (x, c0, c1)]
    out = port_block(params, fuse_cross)(inputs[0], tuple(inputs[1:]),
                                         (None, torch.from_numpy(m1)))
    grads = torch.autograd.grad(out, inputs, torch.from_numpy(g))
    for got, want in zip(grads, ref):
        assert got.shape == want.shape
        assert rel(got, want) <= 1e-4


UNET = jcfg.tiny_unet_config(cross_attention_dims=(32, 32))


@pytest.fixture(scope="module")
def unet_params():
    return jax.jit(JUNet(UNET).init)(
        jax.random.key(2), jnp.zeros((1, 8, 8, 8)), jnp.asarray([0]),
        encoder_hidden_states=jnp.zeros((1, 8, 32)),
        encoder_hidden_states_1=jnp.zeros((1, 4, 32)))


@pytest.mark.parametrize("fuse_cross", [False, True])
def test_cross_unet_routes_and_matches_jax(rng, unet_params, monkeypatch, fuse_cross):
    """Latent (1, 8, 16, 32): level 0 has T = 512 tokens, so its 3 blocks
    (down_0 x1, up_1 x2) take flash attention (fuse_cross off) or the fused
    dual-cross block (on); JAX runs its default (unfused) route."""
    x = rng.standard_normal((1, 8, 16, 32)).astype(np.float32)
    gen = (rng.standard_normal((1, 8, 32)) * 0.5).astype(np.float32)
    seq = (rng.standard_normal((1, 12, 32)) * 0.5).astype(np.float32)
    mask = np.array([[1] * 7 + [0] * 5], np.int32)
    ref = jax.jit(JUNet(UNET).apply)(unet_params, jnp.asarray(x), jnp.asarray([417]),
                                     encoder_hidden_states=jnp.asarray(gen),
                                     encoder_hidden_states_1=jnp.asarray(seq),
                                     encoder_attention_mask_1=jnp.asarray(mask))
    pcfg = tcfg.UNetConfig(**dataclasses.asdict(UNET))
    model = UNet2DConditionModel(pcfg, fuse_cross=fuse_cross)
    model.load_state_dict(from_flax(unet_params, pcfg), strict=True)
    calls = {}
    spy(monkeypatch, tlayers, "fused_transformer_block", calls)
    spy(monkeypatch, tlayers, "flash_attention", calls)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.tensor([417]),
                    encoder_hidden_states=torch.from_numpy(gen),
                    encoder_hidden_states_1=torch.from_numpy(seq),
                    encoder_attention_mask_1=torch.from_numpy(mask))
    assert calls == {"fused_transformer_block" if fuse_cross else "flash_attention": 3}
    assert rel(out, ref) <= 1e-4
