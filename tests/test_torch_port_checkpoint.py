"""CPU parity of the port's checkpoint loading against the JAX package's.

- Tiny diffusers-layout MusicLDM, AudioLDM2 and AudioLDM2-TTS snapshots
  (`test_torch_port_snapshot.py`, each CLAP model with its audio tower)
  loaded by the JAX `load_musicldm` / `load_audioldm2` and by the port's
  `from_pretrained(..., device="cpu")`: the configs are equal and every
  state dict, the HTSAT tower's and VITS's included, equals `from_flax` of
  the JAX parameters to the bit.
- A key no converter reads raises; the CLAP audio tower's keys load into
  the tower (its weightless buffers named); the config parsers equal JAX's
  on the same dicts.
- The full-width key manifests are all loaded or named: the UNets and the
  VAE from the meta-device modules of `torch_ref_diffusers.py`, the
  vocoder, CLAP (text and audio towers), T5, GPT-2 and VITS from the
  transformers models on the meta device.
- The VAE encoder and a `normalize_before` vocoder against JAX, 1e-4 of
  max |reference|.
"""

import dataclasses
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_real_checkpoint_contact as contact
import test_torch_port_snapshot as snap
from diffmusic_tpu.models import checkpoint as jckpt
from diffmusic_tpu.models import convert as jconvert
from diffmusic_tpu.models.hifigan import SpeechT5HifiGan as JHifiGan
from diffmusic_tpu.models.vae import AutoencoderKL as JVAE
from diffmusic_tpu_torch.models import checkpoint as ckpt
from diffmusic_tpu_torch.models import configs as tcfg
from diffmusic_tpu_torch.models import htsat, vits
from diffmusic_tpu_torch.models.convert import from_flax
from diffmusic_tpu_torch.models.hifigan import SpeechT5HifiGan
from diffmusic_tpu_torch.models.vae import AutoencoderKL
from diffmusic_tpu_torch.pipelines import AudioLDM2Pipeline, MusicLDMPipeline
from test_torch_port_samplers import flax_style_params


def relerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def port_cfg(cfg):
    for mod in (tcfg, htsat, vits):
        if hasattr(mod, type(cfg).__name__):
            return getattr(mod, type(cfg).__name__)(**dataclasses.asdict(cfg))


def text_cfgs():
    t5, gpt2, txt = tcfg.tiny_t5_config(), tcfg.tiny_gpt2_config(), tcfg.tiny_clap_text_config()
    return txt, t5, gpt2, tcfg.ProjectionConfig(txt.projection_dim, t5.d_model, gpt2.n_embd)


# a narrow tower that takes the 48-kHz CLAP features (64 mel bins, 1001
# frames) as the full one does
AUDIO = htsat.ClapAudioConfig(depths=(1, 1), num_attention_heads=(2, 2),
                              patch_embeds_hidden_size=8, projection_dim=32)
VITS = vits.VitsConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                       num_attention_heads=2, ffn_dim=32)   # T5's width


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    root = tmp_path_factory.mktemp("snapshots")
    unet, vae, voc, txt = snap.tiny_configs()
    _, t5, gpt2, proj = text_cfgs()
    snap.write_snapshot(root / "musicldm", snap.musicldm_modules(unet, vae, voc, txt, seed=1,
                                                                 audio_cfg=AUDIO))
    for name, seed, vits_cfg in (("audioldm2", 11, None), ("audioldm2_tts", 21, VITS)):
        snap.write_snapshot(root / name, snap.audioldm2_modules(
            tcfg.tiny_unet_config((gpt2.n_embd, t5.d_model)), vae, voc, txt, t5, gpt2, proj,
            seed=seed, audio_cfg=AUDIO, vits_cfg=vits_cfg))
    return root


def jax_tower(jembed):
    """(variables, config) of a JAX CLAP embed closure."""
    cells = inspect.getclosurevars(jembed).nonlocals
    return cells["htsat_params"], cells["htsat_model"].cfg


def assert_same_load(module, jparams, jcfg):
    want = from_flax(jparams, port_cfg(jcfg))
    got = module.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v), k


@pytest.mark.parametrize("model", ["musicldm", "audioldm2", "audioldm2_tts"])
def test_snapshot_loads_as_jax_does(snapshots, model):
    d = snapshots / model
    if model == "musicldm":
        j, t = jckpt.load_musicldm(d), MusicLDMPipeline.from_pretrained(d, device="cpu")
    else:
        j, t = jckpt.load_audioldm2(d), AudioLDM2Pipeline.from_pretrained(d, device="cpu")
    pairs = [(t.unet, j.unet_params, j.unet_cfg), (t.vae, j.vae_params, j.vae_cfg),
             (t.vocoder, j.vocoder_params, j.vocoder_cfg),
             (t.text_encoder, j.text_params, j.text_cfg),
             (t.clap_audio_embed.tower, *jax_tower(j.clap_audio_embed))]
    assert t.clap_frame_embed.tower is t.clap_audio_embed.tower
    if model.startswith("audioldm2"):
        pairs += [(t.gpt2, j.gpt2_params, j.gpt2_cfg), (t.projection, j.proj_params, j.proj_cfg)]
        assert t.max_new_tokens == j.max_new_tokens == 8
    if model == "audioldm2":
        pairs.append((t.t5, j.t5_params, j.t5_cfg))
        assert t.vits is None
    elif model == "audioldm2_tts":
        pairs.append((t.vits, j.vits_params, j.vits_cfg))
        assert t.t5 is None and t.vits_tokenizer is None
    for module, jparams, jcfg in pairs:
        if hasattr(module, "cfg"):   # the projection model keeps no config
            assert dataclasses.asdict(module.cfg) == dataclasses.asdict(jcfg)
        assert_same_load(module, jparams, jcfg)
        assert not any(p.requires_grad for p in module.parameters())
    assert t.tokenizer is None and j.tokenizer is None   # no tokenizer/ directory
    assert t.scheduler_name == "ddim" and t.device.type == "cpu"


def tiny_module(name):
    """(state dict, the port's tree function) of one tiny snapshot module."""
    unet, vae, voc, txt = snap.tiny_configs()
    _, t5, gpt2, proj = text_cfgs()
    return {
        "unet": (snap._values(snap.unet_shapes(unet), 0), lambda sd: ckpt.convert_unet(sd, unet)),
        "vae": (snap._values(snap.vae_shapes(vae), 0), lambda sd: ckpt.convert_vae(sd, vae)),
        "vocoder": (snap._values(snap.vocoder_shapes(voc), 0),
                    lambda sd: ckpt.vocoder_tree(sd, voc)),
        "text_encoder": (snap._values(snap.clap_text_shapes(txt), 0),
                         lambda sd: ckpt.clap_trees(sd, txt)[0]),
        "text_encoder_2": (snap._values(snap.t5_shapes(t5), 0),
                           lambda sd: ckpt.t5_tree(sd, t5)),
        "language_model": (snap._values(snap.gpt2_shapes(gpt2), 0),
                           lambda sd: ckpt.gpt2_tree(sd, gpt2)),
        "projection_model": (snap._values(snap.projection_shapes(proj), 0),
                             ckpt.projection_tree),
    }[name]


@pytest.mark.parametrize("name", ["unet", "vae", "vocoder", "text_encoder", "text_encoder_2",
                                  "language_model", "projection_model"])
def test_unmapped_key_raises(name):
    sd, tree = tiny_module(name)
    tree(dict(sd))   # the snapshot's own keys load
    with pytest.raises(ValueError, match="NOT consumed"):
        tree({**sd, "some_new_weight": np.zeros((4, 4), np.float32)})


def test_clap_audio_tower_keys_are_consumed_not_loaded():
    """Since the tower is ported the audio keys are no longer consumed
    unread: they load into the tower (equal to the JAX converter's
    variables), its weightless buffers are named, and the text tree is the
    same with or without the tower."""
    sd, tree = tiny_module("text_encoder")
    txt = snap.tiny_configs()[3]
    tower = snap.clap_audio_values(AUDIO, 5)
    extra = {"text_model.embeddings.token_type_ids": np.zeros((1, 16), np.int64)}
    text, audio = ckpt.clap_trees({**sd, **tower, **extra}, txt, AUDIO)
    assert jax.tree.all(jax.tree.map(np.array_equal, text, tree(dict(sd))))
    assert ckpt.clap_trees(dict(sd), txt)[1] is None
    jtree = jconvert.convert_clap_text(sd, txt)
    assert jax.tree.all(jax.tree.map(np.array_equal, text, jtree))
    from diffmusic_tpu.models import htsat as jhtsat
    jaudio = jconvert.convert_clap_audio(tower, jhtsat.ClapAudioConfig(
        **dataclasses.asdict(AUDIO)))
    assert jax.tree.all(jax.tree.map(np.array_equal, audio, jaudio))
    with pytest.raises(ValueError, match="NOT consumed"):   # an audio key nothing reads
        ckpt.clap_trees({**sd, **tower, "audio_model.extra.weight": np.ones(3, np.float32)},
                        txt, AUDIO)


PARSER_CASES = [
    ("unet", contact.MUSICLDM_UNET_JSON), ("unet", contact.AUDIOLDM2_UNET_JSON),
    ("unet", dict(contact.AUDIOLDM2_UNET_JSON, cross_attention_dim=[None, 768, None, 1024])),
    ("unet", dict(contact.AUDIOLDM2_UNET_JSON, cross_attention_dim=768)),
    ("unet", dict(contact.MUSICLDM_UNET_JSON, attention_head_dim=[8, 8, 8, 8])),
    ("unet", {"block_out_channels": [128, 256], "cross_attention_dim": [768, 1024]}),
    ("unet", snap.unet_json(tcfg.tiny_unet_config())),
    ("vae", contact.VAE_JSON), ("vae", {"block_out_channels": [128, 256, 512],
                                        "scaling_factor": 0.9227}),
    ("vae", snap.vae_json(tcfg.tiny_vae_config())),
    ("hifigan", contact.VOCODER_JSON), ("hifigan", {"upsample_rates": [5, 4, 2, 2, 2]}),
    ("hifigan", dict(contact.VOCODER_JSON, normalize_before=True, model_in_dim=80)),
]


@pytest.mark.parametrize("which, cfg_json", PARSER_CASES)
def test_config_parsers_match_jax(which, cfg_json):
    name = f"{which}_config_from_json"
    got, want = getattr(ckpt, name)(cfg_json), getattr(jckpt, name)(cfg_json)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _zeros(shapes: dict) -> dict:
    """Shape-only arrays (no memory) for a full-width manifest."""
    return {k: np.broadcast_to(np.float32(0), tuple(s)) for k, s in shapes.items()}


def _hf_manifest(name):
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    import transformers as tf
    with torch.device("meta"):
        model = {
            "vocoder": lambda: tf.SpeechT5HifiGan(tf.SpeechT5HifiGanConfig(
                **{k: v for k, v in contact.VOCODER_JSON.items() if k != "_class_name"})),
            "clap": lambda: tf.ClapModel(tf.ClapConfig()),
            "t5": lambda: tf.T5EncoderModel(tf.T5Config(
                d_model=1024, d_kv=64, d_ff=2816, num_layers=24, num_heads=16,
                feed_forward_proj="gated-gelu")),
            "gpt2": lambda: tf.GPT2Model(tf.GPT2Config()),
            "vits": lambda: tf.VitsModel(tf.VitsConfig()),
        }[name]()
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name", ["unet_musicldm", "unet_audioldm2", "vae", "vocoder", "clap",
                                  "t5", "gpt2", "vits"])
def test_full_width_manifests_are_consumed(name):
    """Every key of a full-width state dict of the real module grammar is
    read by the port's converter or named (each raises on a key left
    unread); a ClapModel's audio keys load into the tower."""
    if name.startswith("unet"):
        cfg = ckpt.unet_config_from_json(contact.MUSICLDM_UNET_JSON if name == "unet_musicldm"
                                          else contact.AUDIOLDM2_UNET_JSON)
        sd = _zeros(snap.unet_shapes(cfg))
        assert len(sd) > 400
        tree = ckpt.convert_unet(sd, cfg)
    elif name == "vae":
        cfg = ckpt.vae_config_from_json(contact.VAE_JSON)
        sd = _zeros(snap.vae_shapes(cfg))
        tree = ckpt.convert_vae(sd, cfg)
        assert "encoder" in tree["params"]
    else:
        sd = _zeros(_hf_manifest(name))
        tree = {"vocoder": lambda: ckpt.vocoder_tree(
                    sd, ckpt.hifigan_config_from_json(contact.VOCODER_JSON)),
                "clap": lambda: ckpt.clap_trees(sd, tcfg.ClapTextConfig(),
                                                htsat.ClapAudioConfig()),
                "t5": lambda: ckpt.t5_tree(sd, tcfg.T5Config()),
                "gpt2": lambda: ckpt.gpt2_tree(sd, tcfg.GPT2Config()),
                "vits": lambda: ckpt.vits_tree(sd, vits.VitsConfig())}[name]()
        if name == "clap":
            assert tree[1] is not None
            # one leaf per audio key but the index buffers and the batch count
            weights = [k for k in sd if k.startswith(("audio_model.", "audio_projection."))
                       and not k.endswith(("relative_position_index", "num_batches_tracked"))]
            assert len(jax.tree.leaves(tree[1])) == len(weights) == 227
        if name != "vits":   # the writer names one key of each VITS part it does not load
            # the hand-written tiny manifests of the snapshot writer name the same keys
            tiny = {"vocoder": snap.vocoder_shapes(tcfg.HiFiGANConfig()),
                    "clap": {**snap.clap_text_shapes(tcfg.ClapTextConfig()),
                             **snap.clap_audio_shapes(htsat.ClapAudioConfig())},
                    "t5": snap.t5_shapes(tcfg.T5Config()),
                    "gpt2": snap.gpt2_shapes(tcfg.GPT2Config())}[name]
            real = {k: s for k, s in _hf_manifest(name).items()
                    if k not in ("text_model.embeddings.position_ids",
                                 "text_model.embeddings.token_type_ids")}
            assert tiny == real
    assert len(jax.tree.leaves(tree)) > 10


def test_unported_snapshots_raise(snapshots, tmp_path):
    """The TTS variant is ported: a snapshot whose text_encoder_2 says VITS
    but holds T5's weights raises on the first VITS key it lacks, rather
    than loading anything."""
    import shutil
    d = tmp_path / "tts"
    shutil.copytree(snapshots / "audioldm2", d)
    (d / "text_encoder_2" / "config.json").write_text('{"model_type": "vits"}')
    with pytest.raises(KeyError, match="embed_tokens"):
        AudioLDM2Pipeline.from_pretrained(d, device="cpu")


def test_vae_encoder_matches_jax(rng, monkeypatch):
    cfg = tcfg.tiny_vae_config()
    from diffmusic_tpu.models import configs as jc
    jvae_cfg = jc.VAEConfig(**dataclasses.asdict(cfg))
    params = flax_style_params(JVAE(jvae_cfg).init, jnp.zeros((1, 1, 8, 8)), seed=4)
    # random norm scales and biases, so that every leaf matters
    params = jax.tree.map(lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape),
                                                          jnp.float32), params)
    model = AutoencoderKL(cfg)
    model.load_state_dict(from_flax(params, cfg), strict=True)
    x = rng.standard_normal((2, 1, 32, 16)).astype(np.float32)
    ref = np.asarray(JVAE(jvae_cfg).apply(params, jnp.asarray(x), method=JVAE.encode))
    with torch.no_grad():
        out = model.encode(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 8, 16, 8)
    assert relerr(out, ref) <= 1e-4
    # the posterior sample, with JAX's draw handed to the port
    key = jax.random.key(5)
    ref_s = np.asarray(JVAE(jvae_cfg).apply(params, jnp.asarray(x), key, method=JVAE.encode))
    draw = np.asarray(jax.random.normal(key, (2, 16, 8, 8), jnp.float32)).transpose(0, 3, 1, 2)
    from diffmusic_tpu_torch.models import vae as tvae
    monkeypatch.setattr(tvae, "randn", lambda shape, g, dtype, device: torch.from_numpy(
        np.ascontiguousarray(draw)))
    with torch.no_grad():
        out_s = model.encode(torch.from_numpy(x), torch.Generator()).numpy()
    assert relerr(out_s, ref_s) <= 1e-4 and not np.allclose(out_s, out)


def test_normalize_before_vocoder_matches_jax(rng):
    """A vocoder with `normalize_before`: the HF state dict through the JAX
    converter and the port's, then both forwards."""
    cfg = dataclasses.replace(tcfg.tiny_hifigan_config(), normalize_before=True)
    from diffmusic_tpu.models import configs as jc
    jcfg_ = jc.HiFiGANConfig(**dataclasses.asdict(cfg))
    sd = snap._values(snap.vocoder_shapes(cfg), 3)
    tree = ckpt.vocoder_tree(sd, cfg)
    jtree = jconvert.convert_hifigan(sd, jcfg_)
    assert jax.tree.all(jax.tree.map(np.array_equal, tree, jtree))
    assert not np.allclose(sd["mean"], 0) and not np.allclose(sd["scale"], 1)
    model = SpeechT5HifiGan(cfg)
    model.load_state_dict(from_flax(tree, cfg), strict=True)
    mel = rng.standard_normal((1, 6, 64)).astype(np.float32)
    ref = np.asarray(JHifiGan(jcfg_).apply(jax.tree.map(jnp.asarray, jtree), jnp.asarray(mel)))
    with torch.no_grad():
        out = model(torch.from_numpy(mel)).numpy()
        plain = SpeechT5HifiGan(dataclasses.replace(cfg, normalize_before=False))
        plain.load_state_dict({k: v for k, v in model.state_dict().items()
                               if k not in ("mean", "scale")})
        unnormalized = plain(torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape
    assert relerr(out, ref) <= 1e-4
    assert not np.allclose(out, unnormalized)
