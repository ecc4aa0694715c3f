"""CPU parity of the port's VITS text encoder (AudioLDM2's TTS stream) against
the JAX package: `VitsTextEncoder` on padded batches, the relative-position
helpers, and the HF -> flax converter from a tiny transformers `VitsModel`
(fp32, weights carried over by `from_flax`, inputs from a numpy seed).

Tolerances, as a fraction of max |reference|: 1e-5 for the encoder, exact
for the index shuffles, the converter to the bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmusic_tpu.models import convert as jconvert
from diffmusic_tpu.models import vits as jvits
from diffmusic_tpu_torch.models import convert, vits
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

TINY = jvits.tiny_vits_config()


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def port_cfg(cfg):
    return vits.VitsConfig(**dataclasses.asdict(cfg))


def port_encoder(cfg, params):
    model = vits.VitsTextEncoder(port_cfg(cfg))
    model.load_state_dict(convert.from_flax(params, port_cfg(cfg)), strict=True)
    return model.requires_grad_(False)


def ids_and_mask(rng, vocab, lengths, maxlen):
    ids = np.zeros((len(lengths), maxlen), np.int32)
    mask = np.zeros((len(lengths), maxlen), np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(1, vocab, n)
        mask[i, :n] = 1
    return ids, mask


@pytest.mark.parametrize("t", [1, 3, 9])
def test_relative_shuffles_match_jax(rng, t):
    x = rng.standard_normal((2, 2, t, 2 * t - 1)).astype(np.float32)
    a = rng.standard_normal((2, 2, t, t)).astype(np.float32)
    assert np.array_equal(vits._relative_to_absolute(torch.from_numpy(x)).numpy(),
                          np.asarray(jvits._relative_to_absolute(jnp.asarray(x))))
    assert np.array_equal(vits._absolute_to_relative(torch.from_numpy(a)).numpy(),
                          np.asarray(jvits._absolute_to_relative(jnp.asarray(a))))


@pytest.mark.parametrize("lengths, maxlen", [((7, 3), 7), ((12, 1, 5), 12)])
def test_text_encoder_matches_jax(rng, lengths, maxlen):
    """Padded rows, and sequences longer than twice the window (12 > 9): the
    relative tables' zeros outside the window matter."""
    model = jvits.VitsTextEncoder(TINY)
    params = model.init(jax.random.key(3), jnp.zeros((1, 4), jnp.int32))
    # random norm scales and biases, so that every leaf matters
    params = jax.tree.map(lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape),
                                                          jnp.float32), params)
    ids, mask = ids_and_mask(rng, TINY.vocab_size, lengths, maxlen)
    ref = np.asarray(model.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        out = port_encoder(TINY, params)(torch.from_numpy(ids).long(),
                                         torch.from_numpy(mask).long()).numpy()
    assert out.shape == ref.shape == (len(lengths), maxlen, TINY.hidden_size)
    assert rel(out, ref) <= 1e-5
    assert np.all(out[mask == 0] == 0)
    # without its relative-position terms the encoder is another function
    no_rel = port_encoder(TINY, params)
    for i in range(TINY.num_hidden_layers):
        getattr(no_rel, f"layers_{i}_attention").emb_rel_k.data.zero_()
        getattr(no_rel, f"layers_{i}_attention").emb_rel_v.data.zero_()
    with torch.no_grad():
        planted = no_rel(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()).numpy()
    assert rel(planted, ref) > 1e-3


def vits_sd(seed=4):
    """A tiny transformers VitsModel's whole state dict (the text encoder
    beside the flow, decoder, duration predictor and posterior encoder)."""
    import transformers as tf
    cfg = tf.VitsConfig(
        vocab_size=TINY.vocab_size, hidden_size=TINY.hidden_size,
        num_hidden_layers=TINY.num_hidden_layers, num_attention_heads=TINY.num_attention_heads,
        ffn_dim=TINY.ffn_dim, flow_size=16, spectrogram_bins=33, upsample_initial_channel=16,
        upsample_rates=[2, 2], upsample_kernel_sizes=[4, 4], resblock_kernel_sizes=[3],
        resblock_dilation_sizes=[[1, 3]], posterior_encoder_num_wavenet_layers=2,
        prior_encoder_num_wavenet_layers=2, duration_predictor_filter_channels=16,
        depth_separable_num_layers=2, prior_encoder_num_flows=2,
        duration_predictor_num_flows=2)
    torch.manual_seed(seed)
    return {k: v.detach().numpy() for k, v in tf.VitsModel(cfg).state_dict().items()}


@pytest.mark.parametrize("prefixed", [True, False])
def test_convert_vits_text_encoder_matches_jax(prefixed):
    sd = vits_sd()
    if not prefixed:
        sd = {k.removeprefix("text_encoder."): v for k, v in sd.items()
              if k.startswith("text_encoder.")}
    tree = convert.convert_vits_text_encoder(sd, port_cfg(TINY))
    jtree = jconvert.convert_vits_text_encoder(sd, TINY)
    assert jax.tree.structure(tree) == jax.tree.structure(jtree)
    assert jax.tree.all(jax.tree.map(np.array_equal, tree, jtree))
    port_encoder(TINY, jtree)   # every leaf lands on a parameter
