"""CPU parity of the port's AudioLDM2 text stack against the JAX package: the
CLAP text tower, the T5 encoder, the projection model and GPT-2's
embedding-space generation of 8 hidden states, with the weights carried over
by `models/convert.py::from_flax` (fp32, tiny configs, inputs from a numpy
seed).

Tolerances, as a fraction of max |reference|: 1e-5 for one forward, 1e-4
after the 8 generation steps (each feeds its output back as an input).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from diffmusic_tpu.models import configs as jcfg
from diffmusic_tpu.models.clap import ClapTextModelWithProjection as JClap
from diffmusic_tpu.models.gpt2 import GPT2Model as JGPT2
from diffmusic_tpu.models.gpt2 import generate_hidden_states as jgenerate
from diffmusic_tpu.models.projection import AudioLDM2ProjectionModel as JProjection
from diffmusic_tpu.models.t5 import T5EncoderModel as JT5
from diffmusic_tpu_torch.models import configs as tcfg
from diffmusic_tpu_torch.models.clap import ClapTextModelWithProjection
from diffmusic_tpu_torch.models.convert import from_flax, init_flax_style
from diffmusic_tpu_torch.models.gpt2 import GPT2Model, generate_hidden_states
from diffmusic_tpu_torch.models.projection import AudioLDM2ProjectionModel
from diffmusic_tpu_torch.models.t5 import T5EncoderModel

CLAP = jcfg.tiny_clap_text_config()
T5 = jcfg.tiny_t5_config()
GPT2 = jcfg.tiny_gpt2_config()
PROJ = jcfg.tiny_projection_config()


def port_cfg(cfg):
    return getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def load(model, params, cfg):
    model.load_state_dict(from_flax(params, port_cfg(cfg)), strict=True)
    return model.requires_grad_(False)


def tokens(rng, vocab, lengths, maxlen=12):
    """Random ids after a BOS of 0, padded with 1 past each row's length."""
    ids = np.ones((len(lengths), maxlen), np.int32)
    mask = np.zeros((len(lengths), maxlen), np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = np.concatenate([[0], rng.integers(2, vocab, n - 1)])
        mask[i, :n] = 1
    return ids, mask


@pytest.fixture(scope="module")
def clap():
    params = JClap(CLAP).init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))
    return params, load(ClapTextModelWithProjection(port_cfg(CLAP)), params, CLAP)


@pytest.fixture(scope="module")
def t5():
    params = JT5(T5).init(jax.random.key(2), jnp.zeros((1, 8), jnp.int32))
    return params, load(T5EncoderModel(port_cfg(T5)), params, T5)


@pytest.fixture(scope="module")
def projection():
    params = JProjection(PROJ).init(
        jax.random.key(3), jnp.zeros((1, 1, PROJ.text_encoder_dim)),
        jnp.zeros((1, 4, PROJ.text_encoder_1_dim)), jnp.ones((1, 1), jnp.int32),
        jnp.ones((1, 4), jnp.int32))
    return params, load(AudioLDM2ProjectionModel(port_cfg(PROJ)), params, PROJ)


@pytest.fixture(scope="module")
def gpt2():
    params = JGPT2(GPT2).init(jax.random.key(4), jnp.zeros((1, 8, GPT2.n_embd)))
    return params, load(GPT2Model(port_cfg(GPT2)), params, GPT2)


def test_clap_text_tower_matches_jax(rng, clap):
    params, model = clap
    ids, mask = tokens(rng, CLAP.vocab_size, [12, 5])
    ref = JClap(CLAP).apply(params, jnp.asarray(ids), jnp.asarray(mask))
    out = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    assert out.shape == ref.shape == (2, CLAP.projection_dim)
    assert rel(out, ref) <= 1e-5


def test_t5_encoder_matches_jax(rng, t5):
    params, model = t5
    ids, mask = tokens(rng, T5.vocab_size, [12, 7])
    ref = JT5(T5).apply(params, jnp.asarray(ids), jnp.asarray(mask))
    out = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    assert out.shape == ref.shape == (2, 12, T5.d_model)
    assert rel(out, ref) <= 1e-5


def test_projection_matches_jax(rng, projection):
    params, model = projection
    h0 = rng.standard_normal((2, 1, PROJ.text_encoder_dim)).astype(np.float32)
    h1 = rng.standard_normal((2, 6, PROJ.text_encoder_1_dim)).astype(np.float32)
    m0 = np.ones((2, 1), np.int32)
    m1 = np.array([[1] * 6, [1] * 4 + [0] * 2], np.int32)
    ref, ref_mask = JProjection(PROJ).apply(params, *map(jnp.asarray, (h0, h1, m0, m1)))
    out, mask = model(*map(torch.from_numpy, (h0, h1, m0, m1)))
    assert out.shape == ref.shape == (2, 11, PROJ.langauge_model_dim)
    assert rel(out, ref) <= 1e-5
    assert np.array_equal(mask.numpy(), np.asarray(ref_mask))


def test_gpt2_generation_matches_jax(rng, gpt2):
    params, model = gpt2
    embeds = rng.standard_normal((2, 10, GPT2.n_embd)).astype(np.float32)
    mask = np.array([[1] * 10, [1] * 3 + [0] * 2 + [1] * 5], np.int32)   # a padded T5 part
    hidden = JGPT2(GPT2).apply(params, jnp.asarray(embeds), jnp.asarray(mask))
    assert rel(model(torch.from_numpy(embeds), torch.from_numpy(mask)), hidden) <= 1e-5
    ref = jgenerate(JGPT2(GPT2), params, jnp.asarray(embeds), jnp.asarray(mask), 8)
    out = generate_hidden_states(model, torch.from_numpy(embeds), torch.from_numpy(mask), 8)
    assert out.shape == ref.shape == (2, 8, GPT2.n_embd)
    assert rel(out, ref) <= 1e-4


@pytest.mark.parametrize("which", ["clap", "t5", "projection", "gpt2"])
def test_text_weight_carry_round_trip(which, request):
    """Every flax leaf lands on one port parameter, unchanged (the text models
    have no layout change: Dense kernels stay (in, out), Embed tables
    (num, dim))."""
    params, model = request.getfixturevalue(which)
    state = model.state_dict()
    leaves = flatten_dict(params["params"])
    assert len(leaves) == len(state)
    for path, leaf in leaves.items():
        name = {"bias": "bias", "scale": "weight", "kernel": "weight",
                "embedding": "weight"}.get(path[-1], path[-1])
        key = ".".join(path[:-1] + (name,))
        assert np.array_equal(state[key].numpy(), np.asarray(leaf)), "/".join(path)


def test_text_models_flax_style_init():
    t5 = init_flax_style(T5EncoderModel(tcfg.T5Config(num_layers=2)), seed=0)
    emb = t5.shared.weight                         # (32128, 1024): std 1/sqrt(1024)
    assert abs(emb.std().item() * 32.0 - 1.0) < 0.01
    assert torch.equal(t5.block_0.ln_attn.weight, torch.ones(1024))
    proj = init_flax_style(AudioLDM2ProjectionModel(tcfg.ProjectionConfig()), seed=0)
    assert abs(proj.sos_embed.std().item() / 0.02 - 1.0) < 0.2
    assert not torch.equal(proj.sos_embed, proj.eos_embed)
