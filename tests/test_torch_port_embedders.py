"""The eval's transformers-family embedders, written natively in the port
(`models/wav2vec2.py`, `models/whisper.py`, `models/encodec.py`, loaded by
`models/checkpoint.py`), against the JAX package's loaders, which run
transformers' torch models on the same snapshot:

- tiny snapshots built here with transformers (`save_pretrained`), as
  `tests/test_fadtk.py` builds them, in each weight-norm spelling
  (`parametrizations.weight.original0/1` as saved, `weight_g/v` renamed,
  `pytorch_model.bin`);
- w2v2 (post-LN with the group-norm extractor, pre-LN with the layer-norm
  one), HuBERT (with and without `feat_proj_layer_norm`), WavLM (post- and pre-LN, small buckets so that the
  logarithmic ones are reached), MERT as the HuBERT the JAX tests build,
  Whisper (WhisperModel and WhisperForConditionalGeneration), EnCodec 24k
  (causal weight-normed, and non-causal with time_group_norm), each at its
  first and final layer, within 1e-5 of max;
- Whisper's features alone against `WhisperFeatureExtractor` (80 and 128
  mels, a short and a long clip);
- the divergences kept from the JAX package: MERT's 'mert_model' type and
  EnCodec-48k's two channels;
- the registry against JAX's (names, order, sr, num_features, subdir);
- strict loading: a key left over or missing raises; nothing of
  transformers is imported by the port's path.
"""

import sys

import numpy as np
import pytest
import torch

import test_torch_port_snapshot as snap
from diffmusic_tpu.fadtk import model_loader as jml
from diffmusic_tpu_torch.fadtk import model_loader as ml
from diffmusic_tpu_torch.models.checkpoint import read_safetensors
from diffmusic_tpu_torch.models.whisper import WhisperFeatureConfig, log_mel_features
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

TOL = 1e-5   # fp32, relative to max


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def save(model, path, spelling: str = "parametrizations"):
    """save_pretrained, then the weight-norm keys renamed to the old
    weight_g / weight_v (`spelling` "weight_g"), or the weights written as
    pytorch_model.bin ("bin")."""
    model.eval().save_pretrained(str(path), safe_serialization=spelling != "bin")
    if spelling == "weight_g":
        f = path / "model.safetensors"
        sd = {k.replace("parametrizations.weight.original0", "weight_g")
               .replace("parametrizations.weight.original1", "weight_v"): v
              for k, v in read_safetensors(f).items()}
        assert any(k.endswith("weight_g") for k in sd)
        snap.write_safetensors(f, {k: v.clone() for k, v in sd.items()})
    return path


def tiny_speech(kind: str, **kw):
    import transformers as tf
    cls = {"wav2vec2": (tf.Wav2Vec2Config, tf.Wav2Vec2Model),
           "hubert": (tf.HubertConfig, tf.HubertModel),
           "wavlm": (tf.WavLMConfig, tf.WavLMModel)}[kind]
    torch.manual_seed(kw.pop("seed", 0))
    cfg = cls[0](hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=64, conv_dim=(16,) * 7, **kw)
    return cls[1](cfg)


# case -> (registry name of the final layer, subdir, model constructor)
SPEECH = {
    "w2v2": ("w2v2-base", "wav2vec2-base-960h",
             lambda: tiny_speech("wav2vec2", do_stable_layer_norm=False)),
    "w2v2_stable": ("w2v2-large", "wav2vec2-large-960h",
                    lambda: tiny_speech("wav2vec2", do_stable_layer_norm=True,
                                        feat_extract_norm="layer", conv_bias=True)),
    "hubert": ("hubert-base", "hubert-base-ls960",
               lambda: tiny_speech("hubert", do_stable_layer_norm=False)),
    "hubert_no_proj_norm": ("hubert-large", "hubert-large-ls960",
                            lambda: tiny_speech("hubert", feat_proj_layer_norm=False, seed=3)),
    "wavlm": ("wavlm-base", "wavlm-base",
              lambda: tiny_speech("wavlm", num_buckets=16, max_bucket_distance=40)),
    "wavlm_stable": ("wavlm-large", "wavlm-large",
                     lambda: tiny_speech("wavlm", do_stable_layer_norm=True,
                                         feat_extract_norm="layer", num_buckets=16,
                                         max_bucket_distance=40, seed=2)),
    "mert": ("MERT-v1-95M", "MERT-v1-95M", lambda: tiny_speech("hubert", seed=1)),
}


def layer_names(base: str):
    """(first layer's name, final layer's name) of a registry family."""
    return (("MERT-v1-95M-1" if base == "MERT-v1-95M" else f"{base}-1"), base)


def compare(name, root, audio, device="cpu"):
    ref = jml.get_model(name, root).get_embedding(audio)
    out = ml.get_model(name, root, device).get_embedding(audio)
    assert out.dtype == np.float32
    return rel(out, ref), out.shape


# every family in the spelling save_pretrained writes; the old spelling and
# pytorch_model.bin on three of them
SPELLINGS = ([(case, "parametrizations") for case in SPEECH]
             + [(case, s) for case in ("w2v2", "hubert", "wavlm_stable")
                for s in ("weight_g", "bin")])


@pytest.mark.parametrize("case,spelling", SPELLINGS)
def test_speech_encoders_match_jax(tmp_path, rng, case, spelling):
    base, subdir, build = SPEECH[case]
    save(build(), tmp_path / subdir, spelling)
    sr = 24000 if base.startswith("MERT") else 16000
    audio = (0.1 * rng.standard_normal(sr)).astype(np.float32)
    for name in layer_names(base):
        err, shape = compare(name, tmp_path, audio)
        assert shape == (49 if sr == 16000 else 74, 32) and err <= TOL, (name, err)


def test_final_layer_is_the_loaded_depth(tmp_path, rng):
    save(tiny_speech("wav2vec2"), tmp_path / "wav2vec2-base-960h")
    m = ml.get_model("w2v2-base", tmp_path, "cpu")
    m.get_embedding((0.1 * rng.standard_normal(8000)).astype(np.float32))
    assert m.layer == 2 and ml.get_model("w2v2-base-5", tmp_path, "cpu").layer == 5


def tiny_whisper(conditional: bool):
    import transformers as tf
    torch.manual_seed(0)
    cfg = tf.WhisperConfig(d_model=32, encoder_layers=2, encoder_attention_heads=2,
                           decoder_layers=1, decoder_attention_heads=2, encoder_ffn_dim=64,
                           decoder_ffn_dim=64)
    return (tf.WhisperForConditionalGeneration if conditional else tf.WhisperModel)(cfg)


@pytest.mark.parametrize("conditional", [False, True])
def test_whisper_matches_jax(tmp_path, rng, conditional):
    from transformers import WhisperFeatureExtractor
    path = save(tiny_whisper(conditional), tmp_path / "whisper-tiny")
    WhisperFeatureExtractor().save_pretrained(str(path))
    audio = (0.1 * rng.standard_normal(24000)).astype(np.float32)
    err, shape = compare("whisper-tiny", tmp_path, audio)
    assert shape == (1500, 32) and err <= TOL


@pytest.mark.parametrize("mels,seconds", [(80, 1.5), (128, 31.0)])
def test_whisper_features_match_the_extractor(rng, mels, seconds):
    from transformers import WhisperFeatureExtractor
    fe = WhisperFeatureExtractor(feature_size=mels)
    audio = (0.2 * rng.standard_normal(int(16000 * seconds))).astype(np.float32)
    ref = fe(audio, sampling_rate=16000, return_tensors="np").input_features
    cfg = WhisperFeatureConfig.from_json(fe.to_dict())
    out = log_mel_features(torch.from_numpy(audio)[None], cfg).numpy()
    assert out.shape == ref.shape == (1, mels, 3000)
    assert rel(out, ref) <= TOL


def tiny_encodec(**kw):
    import transformers as tf
    torch.manual_seed(kw.pop("seed", 0))
    cfg = tf.EncodecConfig(hidden_size=16, num_filters=4, num_residual_layers=1,
                           upsampling_ratios=[8, 5, 4, 2], codebook_size=64, codebook_dim=16,
                           **kw)
    return tf.EncodecModel(cfg)


@pytest.mark.parametrize("variant", ["causal_weight_norm", "weight_g", "time_group_norm"])
def test_encodec_matches_jax(tmp_path, rng, variant):
    kw = ({"norm_type": "time_group_norm", "use_causal_conv": False, "seed": 4}
          if variant == "time_group_norm" else {})
    save(tiny_encodec(sampling_rate=24000, **kw), tmp_path / "encodec_24k",
         "weight_g" if variant == "weight_g" else "parametrizations")
    audio = (0.1 * rng.standard_normal(12007)).astype(np.float32)
    err, shape = compare("encodec-emb", tmp_path, audio)
    assert shape == (38, 16) and err <= TOL


def test_encodec_48k_two_channels_raise_as_jax_fails(tmp_path, rng):
    """facebook/encodec_48khz has audio_channels 2; both loaders feed one
    channel. JAX's fails in the first conv, the port's names the cause."""
    save(tiny_encodec(sampling_rate=48000, audio_channels=2, norm_type="time_group_norm",
                      use_causal_conv=False), tmp_path / "encodec_48k")
    audio = (0.1 * rng.standard_normal(4800)).astype(np.float32)
    with pytest.raises(RuntimeError):
        jml.get_model("encodec-emb-48k", tmp_path).get_embedding(audio)
    with pytest.raises(ValueError, match="audio_channels"):
        ml.get_model("encodec-emb-48k", tmp_path, "cpu").get_embedding(audio)


def test_mert_model_type_raises_as_jax_cannot_load(tmp_path, rng):
    """A real MERT-v1-95M snapshot's config has model_type 'mert_model' and
    an auto_map; JAX's AutoModel (no trust_remote_code) refuses it, the port
    raises NotImplementedError naming the type."""
    path = save(tiny_speech("hubert", seed=1), tmp_path / "MERT-v1-95M")
    cfg = (path / "config.json").read_text().replace('"model_type": "hubert"',
                                                     '"model_type": "mert_model"')
    (path / "config.json").write_text(cfg)
    audio = (0.1 * rng.standard_normal(24000)).astype(np.float32)
    with pytest.raises(ValueError):
        jml.get_model("MERT-v1-95M", tmp_path).get_embedding(audio)
    with pytest.raises(NotImplementedError, match="mert_model"):
        ml.get_model("MERT-v1-95M", tmp_path, "cpu").get_embedding(audio)


def test_registry_matches_jax():
    ours, theirs = ml.get_all_models(device="cpu"), jml.get_all_models()
    assert len(ours) == len(theirs) == 147
    for a, b in zip(ours, theirs):
        assert (a.name, a.sr, a.num_features, getattr(a, "subdir", None)) == (
            b.name, b.sr, b.num_features, getattr(b, "subdir", None))
        assert getattr(a, "layer", None) == getattr(b, "layer", None)
        assert getattr(a, "final_layer", None) == getattr(b, "final_layer", None)
    with pytest.raises(ValueError, match="Unknown embedding model 'w2v2-tiny'"):
        ml.get_model("w2v2-tiny", device="cpu")


@pytest.mark.parametrize("name,package", [("dac-44kHz", "dac"), ("cdpam-acoustic", "cdpam"),
                                          ("clap-2023", "msclap")])
def test_gated_loaders_raise_as_jax(monkeypatch, name, package):
    monkeypatch.setitem(sys.modules, package, None)
    with pytest.raises(ImportError) as jerr:
        jml.get_model(name, "/nonexistent").load_model()
    with pytest.raises(ImportError) as err:
        ml.get_model(name, "/nonexistent", "cpu").load_model()
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("fault", ["extra", "missing"])
def test_a_key_left_over_or_missing_raises(tmp_path, fault):
    path = save(tiny_encodec(sampling_rate=24000), tmp_path / "encodec_24k")
    sd = {k: v.clone() for k, v in read_safetensors(path / "model.safetensors").items()}
    if fault == "extra":
        sd["encoder.layers.0.extra.weight"] = torch.zeros(3)
    else:
        del sd["encoder.layers.13.lstm.weight_hh_l1"]
    snap.write_safetensors(path / "model.safetensors", sd)
    with pytest.raises(ValueError, match="NOT consumed" if fault == "extra" else "missing"):
        ml.get_model("encodec-emb", tmp_path, "cpu").load_model()


def test_the_port_path_imports_no_transformers(tmp_path, rng, monkeypatch):
    save(tiny_speech("wavlm", num_buckets=16, max_bucket_distance=40), tmp_path / "wavlm-base")
    save(tiny_encodec(sampling_rate=24000), tmp_path / "encodec_24k")
    path = save(tiny_whisper(False), tmp_path / "whisper-tiny")
    from transformers import WhisperFeatureExtractor
    WhisperFeatureExtractor().save_pretrained(str(path))
    monkeypatch.setitem(sys.modules, "transformers", None)
    audio = (0.1 * rng.standard_normal(16000)).astype(np.float32)
    for name in ("wavlm-base", "encodec-emb", "whisper-tiny"):
        assert np.isfinite(ml.get_model(name, tmp_path, "cpu").get_embedding(audio)).all()
