"""Weights from a local checkpoint directory (port of
`diffmusic_tpu/models/checkpoint.py`).

A checkpoint is a directory in the HF snapshot layout:

  <dir>/unet/{config.json, diffusion_pytorch_model.safetensors}
  <dir>/vae/{config.json, diffusion_pytorch_model.safetensors}
  <dir>/vocoder/{config.json, model.safetensors}
  <dir>/text_encoder/{config.json, model.safetensors}      (a CLAP model)
  + text_encoder_2/ (T5), language_model/ (GPT-2) and projection_model/ for
  AudioLDM2; tokenizer/ and tokenizer_2/ where present.

StableAudio's snapshot (stabilityai/stable-audio-open-1.0) is another layout:
transformer/ (the DiT), vae/ (Oobleck), text_encoder/ (T5), projection_model/,
scheduler/scheduler_config.json and tokenizer/ (`load_stable_audio`).

Each module's state dict goes through its converter to the JAX package's
flax tree, then through `from_flax` to the port's state dict, so the port
loads exactly what the JAX package loads. Every key of a state dict is
consumed or the load raises (`TrackingStateDict`); the keys that a
converter reads nothing from are named here: a CLAP model's token-type-id
buffer and its BatchNorm's `num_batches_tracked`, T5's
`encoder.embed_tokens.weight` (tied to `shared.weight`), GPT-2's
`wte.weight` (the pipeline generates in embedding space), the vocoder's
`mean` / `scale` when `normalize_before` is off, and the parts of a VITS
model other than its text encoder (AudioLDM2-TTS conditions on the text
encoder's hidden states only). A CLAP model's audio tower (`audio_model.*`,
`audio_projection.*`) loads into the HTSAT tower, kept in fp32 whatever
`weight_dtype` is (it sits in the guided loss head, as JAX's does), and
gives the pipeline its `clap_audio_embed` and `clap_frame_embed`.

Safetensors files are read here (`read_safetensors`), and tokenizers by the
port's own readers (`models/tokenizers.py`), so loading needs neither the
`safetensors` package nor `transformers`; a snapshot without a tokenizer
directory has no tokenizer, and a text prompt then raises (pass
`prompt_embeds`).

The eval's embedders read transformers' torch snapshots (`config.json` and
`model.safetensors` or `pytorch_model.bin`): `load_wav2vec2`,
`load_whisper_encoder`, `load_encodec_encoder`, each weight-normed weight
folded at load (`fold_weight_norm`, both spellings), every key loaded or
named.
"""

import json
import struct
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from . import convert
from .configs import (ClapTextConfig, GPT2Config, HiFiGANConfig, ProjectionConfig,
                      T5Config, UNetConfig, VAEConfig)
from .htsat import ClapAudioConfig
from .vits import VitsConfig

# safetensors dtype tags -> torch dtypes
_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
           "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """A .safetensors file as CPU tensors: an 8-byte little-endian header
    length, a JSON header {name: {dtype, shape, data_offsets}} (and an
    optional "__metadata__"), then the raw little-endian buffers. The
    tensors share one buffer read from the file."""
    path = Path(path)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = bytearray(path.stat().st_size - 8 - n)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path}: truncated safetensors file")
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
        dtype = _DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - start != count * dtype.itemsize or end > len(buf):
            raise ValueError(f"{path}: tensor {name} has inconsistent offsets")
        t = (torch.frombuffer(buf, dtype=dtype, count=count, offset=start) if count
             else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(shape)
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    # numpy has no bfloat16: widen it (exactly) to float32
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _load_module_sd(module_dir: Path) -> Dict[str, np.ndarray]:
    """A module's state dict as numpy arrays: its one weights file, or the
    union of its shards."""
    module_dir = Path(module_dir)
    for name in ("diffusion_pytorch_model.safetensors", "model.safetensors",
                 "pytorch_model.safetensors"):
        p = module_dir / name
        if p.exists():
            return {k: _numpy(v) for k, v in read_safetensors(p).items()}
    shards = sorted(module_dir.glob("*.safetensors"))
    if not shards:
        raise FileNotFoundError(f"no safetensors found under {module_dir}")
    merged: Dict[str, np.ndarray] = {}
    for shard in shards:
        merged.update({k: _numpy(v) for k, v in read_safetensors(shard).items()})
    return merged


def _cfg(module_dir: Path) -> Dict:
    with open(Path(module_dir) / "config.json") as f:
        return json.load(f)


class TrackingStateDict(dict):
    """A state dict that records the keys a converter reads; a load fails
    if a key is left unread (a weight would be silently dropped)."""

    def __init__(self, sd):
        super().__init__(sd)
        self.consumed = set()

    def __getitem__(self, k):
        self.consumed.add(k)
        return super().__getitem__(k)

    def consume(self, *keys, prefixes=()) -> None:
        """Mark keys that are deliberately not loaded as consumed."""
        self.consumed.update(k for k in self if k in keys or k.startswith(tuple(prefixes)))

    # torch artifacts that carry no convertible weight
    IGNORE_SUBSTRINGS = ("num_batches_tracked", "position_ids", "rotary_emb.inv_freq",
                         "attn.masked_bias", "attn.bias", "logit_scale")

    def assert_all_consumed(self, what: str, extra_ignore=()):
        ignore = self.IGNORE_SUBSTRINGS + tuple(extra_ignore)
        leftover = sorted(k for k in self if k not in self.consumed
                          and not any(s in k for s in ignore))
        if leftover:
            raise ValueError(
                f"{what}: {len(leftover)} checkpoint keys were NOT consumed by the "
                f"converter (weights would be silently dropped): "
                f"{leftover[:12]}{' ...' if len(leftover) > 12 else ''}")


# ------------------------------------------------- transformers' torch models

def load_hf_torch_state_dict(module_dir) -> Dict[str, torch.Tensor]:
    """A transformers torch model's state dict as CPU tensors:
    `model.safetensors` (or its shards) through `read_safetensors`, else
    `pytorch_model.bin` through `torch.load(weights_only=True)`."""
    module_dir = Path(module_dir)
    shards = ([module_dir / "model.safetensors"] if (module_dir / "model.safetensors").exists()
              else sorted(module_dir.glob("*.safetensors")))
    if shards:
        sd: Dict[str, torch.Tensor] = {}
        for shard in shards:
            sd.update(read_safetensors(shard))
        return sd
    if (module_dir / "pytorch_model.bin").exists():
        return torch.load(module_dir / "pytorch_model.bin", map_location="cpu",
                          weights_only=True)
    raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin under {module_dir}")


# the two spellings of a weight-normed weight: the old weight_g / weight_v and
# torch.nn.utils.parametrizations' original0 / original1
WEIGHT_NORM = ((".weight_g", ".weight_v"),
               (".parametrizations.weight.original0", ".parametrizations.weight.original1"))


def fold_weight_norm(sd: Dict[str, torch.Tensor], dim_of) -> Dict[str, torch.Tensor]:
    """The state dict with each weight-normed weight, in either spelling,
    folded into `<prefix>.weight` = g v / |v| (torch's `_weight_norm`: the
    norm over every dim but `dim_of(prefix)`); g's shape must be that of a
    norm over that dim."""
    out = dict(sd)
    for g_suffix, v_suffix in WEIGHT_NORM:
        for key in [k for k in sd if k.endswith(g_suffix)]:
            prefix = key[:-len(g_suffix)]
            g, v = out.pop(key), out.pop(prefix + v_suffix)
            dim = dim_of(prefix)
            want = [n if i == dim else 1 for i, n in enumerate(v.shape)]
            if list(g.shape) != want:
                raise ValueError(f"{key}: shape {tuple(g.shape)} is not a weight norm over "
                                 f"dim {dim} of a weight {tuple(v.shape)}")
            out[prefix + ".weight"] = torch._weight_norm(v.float(), g.float(), dim)
    return out


def load_hf_module(module: torch.nn.Module, sd: Dict[str, torch.Tensor], what: str, device,
                   unused_prefixes=()) -> torch.nn.Module:
    """`module` (built on the meta device) with the state dict's weights in
    fp32 on `device`, frozen and in eval mode. The keys under
    `unused_prefixes` are named and not loaded; a key of the module missing
    from the state dict, or one left over, raises."""
    sd = TrackingStateDict(sd)
    sd.consume(prefixes=unused_prefixes)
    want = module.state_dict()
    missing = sorted(k for k in want if k not in sd)
    if missing:
        raise ValueError(f"{what}: {len(missing)} weights missing from the checkpoint: "
                         f"{missing[:12]}{' ...' if len(missing) > 12 else ''}")
    state = {k: sd[k].float() if sd[k].is_floating_point() else sd[k] for k in want}
    sd.assert_all_consumed(what)
    module.load_state_dict(state, strict=True, assign=True)
    return module.to(device).requires_grad_(False).eval()


def load_wav2vec2(path, device="cuda"):
    """A wav2vec2 / HuBERT / WavLM snapshot (`config.json` and weights, the
    bare model or under a task head's `wav2vec2.` / `hubert.` / `wavlm.`
    prefix) as the port's `Wav2Vec2Model` on `device`. The positional conv's
    weight norm is over dim 2; `masked_spec_embed` (training-time masking),
    a CTC head's and a pre-training model's projections and quantizer are
    named and not loaded."""
    from .wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
    path = Path(path)
    c = _cfg(path)
    if c.get("model_type") == "mert_model":
        raise NotImplementedError(
            f"{path}: model_type 'mert_model' (MERT's own remote-code model) is not "
            f"supported; the JAX package's AutoModel cannot load it either. A MERT "
            f"checkpoint saved as model_type 'hubert' loads.")
    cfg = Wav2Vec2Config.from_json(c)
    sd = load_hf_torch_state_dict(path)
    base = f"{cfg.model_type}."
    sd = {k[len(base):] if k.startswith(base) else k: v for k, v in sd.items()}
    sd = fold_weight_norm(sd, lambda prefix: 2)
    with torch.device("meta"):
        model = Wav2Vec2Model(cfg)
    return load_hf_module(model, sd, f"{cfg.model_type} encoder", device, unused_prefixes=(
        "masked_spec_embed", "lm_head.", "project_q.", "project_hid.", "quantizer."))


def load_whisper_encoder(path, device="cuda"):
    """(encoder, feature config) of a Whisper snapshot: `config.json`,
    `preprocessor_config.json` and the weights of a WhisperModel (or, under
    `model.`, a WhisperForConditionalGeneration). The decoder and the output
    projection are named and not loaded."""
    from .whisper import WhisperEncoder, WhisperEncoderConfig, WhisperFeatureConfig
    path = Path(path)
    cfg = WhisperEncoderConfig.from_json(_cfg(path))
    fcfg = WhisperFeatureConfig.from_json(
        json.loads((path / "preprocessor_config.json").read_text()))
    if fcfg.feature_size != cfg.num_mel_bins:
        raise ValueError(f"{path}: {fcfg.feature_size} mel features for a "
                         f"{cfg.num_mel_bins}-bin encoder")
    sd = {k[len("model."):] if k.startswith("model.") else k: v
          for k, v in load_hf_torch_state_dict(path).items()}
    sd = {k[len("encoder."):] if k.startswith("encoder.") else k: v for k, v in sd.items()}
    with torch.device("meta"):
        model = WhisperEncoder(cfg)
    return load_hf_module(model, sd, "whisper encoder", device,
                          unused_prefixes=("decoder.", "proj_out.")), fcfg


def load_encodec_encoder(path, device="cuda"):
    """An EncodecModel snapshot's encoder (`encoder.*`; its convs'
    weight norm over dim 0); the decoder and the quantizer's codebooks are
    named and not loaded."""
    from .encodec import EncodecConfig, EncodecEncoder
    path = Path(path)
    cfg = EncodecConfig.from_json(_cfg(path))
    sd = fold_weight_norm(load_hf_torch_state_dict(path), lambda prefix: 0)
    sd = {k[len("encoder."):] if k.startswith("encoder.") else k: v for k, v in sd.items()}
    with torch.device("meta"):
        model = EncodecEncoder(cfg)
    return load_hf_module(model, sd, "encodec encoder", device,
                          unused_prefixes=("decoder.", "quantizer."))


# --------------------------------------------------------------------- configs

def unet_config_from_json(c: Dict) -> UNetConfig:
    cad = c.get("cross_attention_dim")
    if cad is None:
        cross_dims = ()
    elif isinstance(cad, (list, tuple)):
        cross_dims = tuple(d for d in cad if d is not None)
    else:
        cross_dims = (cad,)
    blocks = tuple(c["block_out_channels"])
    down_types = c.get("down_block_types",
                       ["CrossAttnDownBlock2D"] * (len(blocks) - 1) + ["DownBlock2D"])
    ahd = c.get("attention_head_dim", 8)
    if isinstance(ahd, (list, tuple)):
        ahd = ahd[0]
    return UNetConfig(
        sample_size=c.get("sample_size", 128),
        in_channels=c.get("in_channels", 8),
        out_channels=c.get("out_channels", 8),
        block_out_channels=blocks,
        layers_per_block=c.get("layers_per_block", 2),
        attention_head_dim=ahd,
        norm_num_groups=c.get("norm_num_groups", 32),
        cross_attention_dims=cross_dims,
        class_embed_type=c.get("class_embed_type"),
        projection_class_embeddings_input_dim=c.get("projection_class_embeddings_input_dim"),
        class_embeddings_concat=c.get("class_embeddings_concat", False),
        has_attention=tuple("CrossAttn" in t or "Attn" in t for t in down_types),
    )


def vae_config_from_json(c: Dict) -> VAEConfig:
    return VAEConfig(
        in_channels=c.get("in_channels", 1),
        out_channels=c.get("out_channels", 1),
        latent_channels=c.get("latent_channels", 8),
        block_out_channels=tuple(c["block_out_channels"]),
        layers_per_block=c.get("layers_per_block", 2),
        norm_num_groups=c.get("norm_num_groups", 32),
        scaling_factor=c.get("scaling_factor", 0.18215),
    )


def hifigan_config_from_json(c: Dict) -> HiFiGANConfig:
    return HiFiGANConfig(
        model_in_dim=c.get("model_in_dim", 64),
        sampling_rate=c.get("sampling_rate", 16000),
        upsample_initial_channel=c.get("upsample_initial_channel", 1024),
        upsample_rates=tuple(c.get("upsample_rates", (5, 4, 2, 2, 2))),
        upsample_kernel_sizes=tuple(c.get("upsample_kernel_sizes", (16, 16, 8, 4, 4))),
        resblock_kernel_sizes=tuple(c.get("resblock_kernel_sizes", (3, 7, 11))),
        resblock_dilation_sizes=tuple(
            tuple(d) for d in c.get("resblock_dilation_sizes", ((1, 3, 5),) * 3)),
        leaky_relu_slope=c.get("leaky_relu_slope", 0.1),
        normalize_before=c.get("normalize_before", False),
    )


def clap_text_config_from_json(c: Dict) -> ClapTextConfig:
    t = c.get("text_config", c)
    return ClapTextConfig(
        vocab_size=t.get("vocab_size", 50265),
        hidden_size=t.get("hidden_size", 768),
        num_hidden_layers=t.get("num_hidden_layers", 12),
        num_attention_heads=t.get("num_attention_heads", 12),
        intermediate_size=t.get("intermediate_size", 3072),
        max_position_embeddings=t.get("max_position_embeddings", 514),
        projection_dim=c.get("projection_dim", 512))


def clap_audio_config_from_json(c: Dict) -> ClapAudioConfig:
    a = c.get("audio_config", {})
    return ClapAudioConfig(
        spec_size=a.get("spec_size", 256), patch_size=a.get("patch_size", 4),
        patch_stride=tuple(a.get("patch_stride", (4, 4))),
        num_mel_bins=a.get("num_mel_bins", 64), window_size=a.get("window_size", 8),
        depths=tuple(a.get("depths", (2, 2, 6, 2))),
        num_attention_heads=tuple(a.get("num_attention_heads", (4, 8, 16, 32))),
        patch_embeds_hidden_size=a.get("patch_embeds_hidden_size", 96),
        projection_dim=c.get("projection_dim", 512))


def vits_config_from_json(c: Dict) -> VitsConfig:
    return VitsConfig(
        vocab_size=c.get("vocab_size", 38), hidden_size=c.get("hidden_size", 192),
        num_hidden_layers=c.get("num_hidden_layers", 6),
        num_attention_heads=c.get("num_attention_heads", 2), ffn_dim=c.get("ffn_dim", 768),
        ffn_kernel_size=c.get("ffn_kernel_size", 3), window_size=c.get("window_size", 4))


# ------------------------------------------------------------- UNet state dict

def _conv(sd, p):
    return {"kernel": convert.conv2d(sd[f"{p}.weight"]), "bias": sd[f"{p}.bias"]}


def _norm(sd, p):
    return {"scale": sd[f"{p}.weight"], "bias": sd[f"{p}.bias"]}


def _resnet(sd, p):
    out = {"norm1": _norm(sd, f"{p}.norm1"), "conv1": _conv(sd, f"{p}.conv1"),
           "norm2": _norm(sd, f"{p}.norm2"), "conv2": _conv(sd, f"{p}.conv2")}
    if f"{p}.time_emb_proj.weight" in sd:
        out["time_emb_proj"] = {"kernel": convert.linear(sd[f"{p}.time_emb_proj.weight"]),
                                "bias": sd[f"{p}.time_emb_proj.bias"]}
    if f"{p}.conv_shortcut.weight" in sd:
        out["conv_shortcut"] = _conv(sd, f"{p}.conv_shortcut")
    return out


def _attention(sd, p):
    """One Attention module: to_q/k/v (+ to_out.0)."""
    return {"to_q": {"kernel": convert.linear(sd[f"{p}.to_q.weight"])},
            "to_k": {"kernel": convert.linear(sd[f"{p}.to_k.weight"])},
            "to_v": {"kernel": convert.linear(sd[f"{p}.to_v.weight"])},
            "to_out": {"kernel": convert.linear(sd[f"{p}.to_out.0.weight"]),
                       "bias": sd[f"{p}.to_out.0.bias"]}}


def _transformer2d(sd, p, depth, n_cross):
    """diffusers Transformer2DModel -> the flax Transformer2DModel tree."""
    def proj(w):   # conv 1x1 (O, I, 1, 1) or linear (O, I) -> Dense (I, O)
        w = np.asarray(w)
        return convert.linear(w[:, :, 0, 0] if w.ndim == 4 else w)

    out = {"norm": _norm(sd, f"{p}.norm"),
           "proj_in": {"kernel": proj(sd[f"{p}.proj_in.weight"]),
                       "bias": sd[f"{p}.proj_in.bias"]},
           "proj_out": {"kernel": proj(sd[f"{p}.proj_out.weight"]),
                        "bias": sd[f"{p}.proj_out.bias"]}}
    for d in range(depth):
        b = f"{p}.transformer_blocks.{d}"
        blk = {"norm1": _norm(sd, f"{b}.norm1"), "attn1": _attention(sd, f"{b}.attn1"),
               "norm3": _norm(sd, f"{b}.norm3"),
               "ff": {"proj_in": {"kernel": convert.linear(sd[f"{b}.ff.net.0.proj.weight"]),
                                  "bias": sd[f"{b}.ff.net.0.proj.bias"]},
                      "proj_out": {"kernel": convert.linear(sd[f"{b}.ff.net.2.weight"]),
                                   "bias": sd[f"{b}.ff.net.2.bias"]}}}
        # cross-attention streams: diffusers attn2 (and attn2_1 / norm2_1 for
        # AudioLDM2's second stream, when present)
        for i in range(n_cross):
            suffix = "" if i == 0 else f"_{i}"
            if f"{b}.attn2{suffix}.to_q.weight" not in sd:
                continue
            blk[f"norm2_{i}"] = _norm(sd, f"{b}.norm2{suffix}")
            blk[f"attn2_{i}"] = _attention(sd, f"{b}.attn2{suffix}")
        out[f"block_{d}"] = blk
    return out


def convert_unet(sd: Dict[str, np.ndarray], cfg: UNetConfig, strict: bool = True) -> Dict:
    """diffusers UNet2DConditionModel / AudioLDM2UNet2DConditionModel state
    dict -> the JAX package's UNet flax tree."""
    sd = TrackingStateDict(sd)
    n_cross = len(cfg.cross_attention_dims)
    p: Dict = {
        "conv_in": _conv(sd, "conv_in"),
        "time_embedding": {
            "linear_1": {"kernel": convert.linear(sd["time_embedding.linear_1.weight"]),
                         "bias": sd["time_embedding.linear_1.bias"]},
            "linear_2": {"kernel": convert.linear(sd["time_embedding.linear_2.weight"]),
                         "bias": sd["time_embedding.linear_2.bias"]}},
        "conv_norm_out": _norm(sd, "conv_norm_out"),
        "conv_out": _conv(sd, "conv_out"),
    }
    if cfg.class_embed_type == "simple_projection":
        p["class_embedding"] = {"kernel": convert.linear(sd["class_embedding.weight"]),
                                "bias": sd["class_embedding.bias"]}
    n_blocks = len(cfg.block_out_channels)
    for i in range(n_blocks):
        blk: Dict = {}
        for j in range(cfg.layers_per_block):
            blk[f"resnet_{j}"] = _resnet(sd, f"down_blocks.{i}.resnets.{j}")
            if cfg.has_attention[i]:
                blk[f"attn_{j}"] = _transformer2d(sd, f"down_blocks.{i}.attentions.{j}", 1,
                                                  n_cross)
        if i != n_blocks - 1:
            blk["downsample"] = {"conv": _conv(sd, f"down_blocks.{i}.downsamplers.0.conv")}
        p[f"down_{i}"] = blk
    p["mid"] = {"resnet_0": _resnet(sd, "mid_block.resnets.0"),
                "attn": _transformer2d(sd, "mid_block.attentions.0", 1, n_cross),
                "resnet_1": _resnet(sd, "mid_block.resnets.1")}
    for i in range(n_blocks):
        rev_i = n_blocks - 1 - i
        blk = {}
        for j in range(cfg.layers_per_block + 1):
            blk[f"resnet_{j}"] = _resnet(sd, f"up_blocks.{i}.resnets.{j}")
            if cfg.has_attention[rev_i]:
                blk[f"attn_{j}"] = _transformer2d(sd, f"up_blocks.{i}.attentions.{j}", 1,
                                                  n_cross)
        if i != n_blocks - 1:
            blk["upsample"] = {"conv": _conv(sd, f"up_blocks.{i}.upsamplers.0.conv")}
        p[f"up_{i}"] = blk
    if strict:
        sd.assert_all_consumed("convert_unet")
    return {"params": p}


def convert_vae(sd: Dict[str, np.ndarray], cfg: VAEConfig, strict: bool = True) -> Dict:
    """diffusers AutoencoderKL state dict -> the JAX package's VAE flax tree
    (encoder and decoder)."""
    sd = TrackingStateDict(sd)

    def vae_attn(pfx):
        # newer diffusers: to_q/to_k/to_v/to_out.0; older: query/key/value/proj_attn
        if f"{pfx}.to_q.weight" in sd:
            attn = _attention(sd, pfx)
        else:
            attn = {"to_q": {"kernel": convert.linear(sd[f"{pfx}.query.weight"])},
                    "to_k": {"kernel": convert.linear(sd[f"{pfx}.key.weight"])},
                    "to_v": {"kernel": convert.linear(sd[f"{pfx}.value.weight"])},
                    "to_out": {"kernel": convert.linear(sd[f"{pfx}.proj_attn.weight"]),
                               "bias": sd[f"{pfx}.proj_attn.bias"]}}
        return {"group_norm": _norm(sd, f"{pfx}.group_norm"), "attention": attn}

    n = len(cfg.block_out_channels)
    enc: Dict = {"conv_in": _conv(sd, "encoder.conv_in"),
                 "conv_norm_out": _norm(sd, "encoder.conv_norm_out"),
                 "conv_out": _conv(sd, "encoder.conv_out"),
                 "quant_conv": _conv(sd, "quant_conv"),
                 "mid_resnet_0": _resnet(sd, "encoder.mid_block.resnets.0"),
                 "mid_attn": vae_attn("encoder.mid_block.attentions.0"),
                 "mid_resnet_1": _resnet(sd, "encoder.mid_block.resnets.1")}
    for i in range(n):
        for j in range(cfg.layers_per_block):
            enc[f"down_{i}_resnet_{j}"] = _resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}")
        if i != n - 1:
            enc[f"down_{i}_downsample"] = {
                "conv": _conv(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv")}
    dec: Dict = {"post_quant_conv": _conv(sd, "post_quant_conv"),
                 "conv_in": _conv(sd, "decoder.conv_in"),
                 "conv_norm_out": _norm(sd, "decoder.conv_norm_out"),
                 "conv_out": _conv(sd, "decoder.conv_out"),
                 "mid_resnet_0": _resnet(sd, "decoder.mid_block.resnets.0"),
                 "mid_attn": vae_attn("decoder.mid_block.attentions.0"),
                 "mid_resnet_1": _resnet(sd, "decoder.mid_block.resnets.1")}
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            dec[f"up_{i}_resnet_{j}"] = _resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}")
        if i != n - 1:
            dec[f"up_{i}_upsample"] = {
                "conv": _conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv")}
    if strict:
        sd.assert_all_consumed("convert_vae")
    return {"params": {"encoder": enc, "decoder": dec}}


# ----------------------------------------------------------------- the models

def _strict(convert_fn, sd, what, *args, consume=(), prefixes=()):
    """Run an HF converter on a tracked state dict; the named keys are
    consumed without being read, and any other key left unread raises."""
    sd = TrackingStateDict(sd)
    sd.consume(*consume, prefixes=prefixes)
    tree = convert_fn(sd, *args)
    sd.assert_all_consumed(what)
    return tree


def vocoder_tree(sd, cfg: HiFiGANConfig):
    # transformers keeps the input statistics whether or not they are used
    unused = () if cfg.normalize_before else ("mean", "scale")
    return _strict(convert.convert_hifigan, sd, "convert_hifigan", cfg, consume=unused)


def _audio_buffers(sd):
    """The audio tower's keys that carry no weight: each block's
    relative-position index (the tower builds its own) and the BatchNorm's
    batch count."""
    return [k for k in sd if k.endswith((".attention.self.relative_position_index",
                                         "batch_norm.num_batches_tracked"))]


def clap_trees(sd, cfg: ClapTextConfig, audio_cfg: Optional[ClapAudioConfig] = None):
    """(text tree, audio variables or None) of a ClapModel (or
    ClapTextModelWithProjection) state dict: the text tower, and the audio
    tower where the state dict carries one. The token-type-id buffer (zeros)
    and `_audio_buffers` carry no weight."""
    sd = TrackingStateDict(sd)
    sd.consume("text_model.embeddings.token_type_ids", *_audio_buffers(sd))
    text = convert.convert_clap_text(sd, cfg)
    audio = None
    if any(k.startswith("audio_model.") for k in sd):
        audio = convert.convert_clap_audio(sd, audio_cfg or ClapAudioConfig())
    sd.assert_all_consumed("convert_clap_text / convert_clap_audio")
    return text, audio


def clap_audio_tree(sd, cfg: ClapAudioConfig):
    """The HTSAT tower's variables of a ClapAudioModelWithProjection or
    ClapModel state dict (keys with or without 'audio_model.'), as a local
    CLAP directory holds it for the clap-laion embedder: a ClapModel's text
    tower is named and not loaded (the embedder is the audio tower's)."""
    return _strict(convert.convert_clap_audio, sd, "convert_clap_audio", cfg,
                   consume=_audio_buffers(sd), prefixes=("text_model.", "text_projection."))


# the parts of a transformers VitsModel that AudioLDM2-TTS does not run
VITS_UNUSED = ("text_encoder.project.", "flow.", "decoder.", "duration_predictor.",
               "posterior_encoder.")


def vits_tree(sd, cfg: VitsConfig):
    """The VITS text encoder's tree of a VitsModel state dict; its prior
    projection, flow, decoder, duration predictor and posterior encoder
    (speech synthesis, not conditioning) are named and not loaded."""
    return _strict(convert.convert_vits_text_encoder, sd, "convert_vits_text_encoder", cfg,
                   prefixes=VITS_UNUSED)


def t5_tree(sd, cfg: T5Config):
    # T5's input embedding is tied to `shared`
    return _strict(convert.convert_t5_encoder, sd, "convert_t5_encoder", cfg,
                   consume=("encoder.embed_tokens.weight",))


def gpt2_tree(sd, cfg: GPT2Config):
    """GPT-2's tree; the pipeline generates in embedding space and never reads
    the token embedding. AudioLDM2 wraps GPT2Model under 'model.' in some
    snapshots."""
    sd = {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}
    return _strict(convert.convert_gpt2, sd, "convert_gpt2", cfg, consume=("wte.weight",))


def projection_tree(sd):
    return _strict(convert.convert_projection, sd, "convert_projection")


def _build(module, tree, cfg, device, weight_dtype):
    """The port's module (built on the meta device) with the flax tree's
    weights, cast to `weight_dtype` on `device`, frozen and in eval mode."""
    module.load_state_dict(convert.from_flax(tree, cfg), strict=True, assign=True)
    return module.to(device=device, dtype=weight_dtype).requires_grad_(False).eval()


def _make_hf_tokenizer(tok_dir, max_length: Optional[int] = 512):
    """The snapshot's tokenizer, read by the port's own readers
    (`tokenizers.load_tokenizer`: the ids and masks of the JAX package's
    transformers tokenizer), as a callable texts -> numpy (ids, mask), padded
    to the model's maximum length (capped at `max_length`); None where the
    directory is missing. A directory of a kind the readers do not know
    raises, naming its tokenizer class."""
    if not Path(tok_dir).exists():
        return None
    from .tokenizers import load_tokenizer
    return load_tokenizer(tok_dir, max_length)


def _core_models(d: Path, device, weight_dtype, gn_mode: str = "plain",
                 conv2d_kernel: bool = False, bsoft: bool = False, fuse_cross: bool = False,
                 conv2d_bwd: str = "plain", vae_mid_attn: str = "plain", **vocoder_routes):
    """UNet, VAE and vocoder of a snapshot, with the route flags of
    `MusicLDMPipeline.random`."""
    from .hifigan import SpeechT5HifiGan
    from .unet import UNet2DConditionModel
    from .vae import AutoencoderKL
    unet_cfg = unet_config_from_json(_cfg(d / "unet"))
    vae_cfg = vae_config_from_json(_cfg(d / "vae"))
    voc_cfg = hifigan_config_from_json(_cfg(d / "vocoder"))
    gn = dict(gn_mode=gn_mode, conv2d_kernel=conv2d_kernel, conv2d_bwd=conv2d_bwd)
    with torch.device("meta"):
        unet = UNet2DConditionModel(unet_cfg, bsoft=bsoft, fuse_cross=fuse_cross, **gn)
        vae = AutoencoderKL(vae_cfg, vae_mid_attn=vae_mid_attn, **gn)
        vocoder = SpeechT5HifiGan(voc_cfg, **vocoder_routes)
    return (_build(unet, convert_unet(_load_module_sd(d / "unet"), unet_cfg), unet_cfg,
                   device, weight_dtype),
            _build(vae, convert_vae(_load_module_sd(d / "vae"), vae_cfg), vae_cfg, device,
                   weight_dtype),
            _build(vocoder, vocoder_tree(_load_module_sd(d / "vocoder"), voc_cfg), voc_cfg,
                   device, weight_dtype))


def _clap(d: Path, device, weight_dtype):
    """(CLAP text tower, pooled audio embed, frame embed) of a snapshot's
    text_encoder; the embeds are None without an audio tower. The tower
    stays fp32."""
    from .clap import ClapTextModelWithProjection
    from .clap_features import make_clap_audio_embed, make_clap_frame_embed
    from .htsat import ClapAudioModelWithProjection
    c = _cfg(d / "text_encoder")
    cfg, audio_cfg = clap_text_config_from_json(c), clap_audio_config_from_json(c)
    text_tree, audio_tree = clap_trees(_load_module_sd(d / "text_encoder"), cfg, audio_cfg)
    with torch.device("meta"):
        model = ClapTextModelWithProjection(cfg)
        tower = ClapAudioModelWithProjection(audio_cfg) if audio_tree is not None else None
    text = _build(model, text_tree, cfg, device, weight_dtype)
    if tower is None:
        return text, None, None
    tower = _build(tower, audio_tree, audio_cfg, device, torch.float32)
    return text, make_clap_audio_embed(tower), make_clap_frame_embed(tower)


def load_musicldm(checkpoint_dir, scheduler_name: str = "ddim", operator=None,
                  schedule=None, device="cuda", weight_dtype=torch.float32, **routes):
    """A MusicLDMPipeline from a local HF-snapshot directory, its weights cast
    to `weight_dtype` on `device` (the card unless the caller asks for the
    CPU); `routes` are `MusicLDMPipeline.random`'s route flags."""
    from ..inverse_problem.operator import IdentityOperator
    from ..pipelines.musicldm import MusicLDMPipeline
    from ..samplers import DiffusionSchedule
    d = Path(checkpoint_dir)
    unet, vae, vocoder = _core_models(d, device, weight_dtype, **routes)
    text, audio_embed, frame_embed = _clap(d, device, weight_dtype)
    return MusicLDMPipeline(
        unet, vae, vocoder, schedule=schedule if schedule is not None else DiffusionSchedule(),
        scheduler_name=scheduler_name,
        operator=operator if operator is not None else IdentityOperator(),
        text_encoder=text, tokenizer=_make_hf_tokenizer(d / "tokenizer", max_length=None),
        clap_audio_embed=audio_embed, clap_frame_embed=frame_embed)


def load_audioldm2(checkpoint_dir, scheduler_name: str = "ddim", operator=None,
                   schedule=None, device="cuda", weight_dtype=torch.float32,
                   fuse_cross: bool = False, **routes):
    """An AudioLDM2Pipeline from a local HF-snapshot directory: text_encoder
    (CLAP, with its audio tower where present), text_encoder_2 (T5, or the
    TTS variant's VITS, which then encodes the transcription),
    projection_model, language_model (GPT-2), unet (two cross streams), vae,
    vocoder."""
    from ..inverse_problem.operator import IdentityOperator
    from ..pipelines.audioldm2 import AudioLDM2Pipeline
    from ..samplers import DiffusionSchedule
    from .gpt2 import GPT2Model
    from .projection import AudioLDM2ProjectionModel
    from .t5 import T5EncoderModel
    from .vits import VitsTextEncoder
    d = Path(checkpoint_dir)
    t5_json = _cfg(d / "text_encoder_2")
    gpt2_json = _cfg(d / "language_model")
    gpt2_cfg = GPT2Config(
        vocab_size=gpt2_json.get("vocab_size", 50257),
        n_positions=gpt2_json.get("n_positions", 1024), n_embd=gpt2_json.get("n_embd", 768),
        n_layer=gpt2_json.get("n_layer", 12), n_head=gpt2_json.get("n_head", 12))
    proj_json = _cfg(d / "projection_model")
    proj_cfg = ProjectionConfig(
        text_encoder_dim=proj_json.get("text_encoder_dim", 512),
        text_encoder_1_dim=proj_json.get("text_encoder_1_dim", 1024),
        langauge_model_dim=proj_json.get("langauge_model_dim", 768))

    unet, vae, vocoder = _core_models(d, device, weight_dtype, fuse_cross=fuse_cross,
                                      **routes)
    text, audio_embed, frame_embed = _clap(d, device, weight_dtype)
    second = {}
    if t5_json.get("model_type") == "vits":
        # the TTS variant: VITS encodes the transcription into the second stream
        vits_cfg = vits_config_from_json(t5_json)
        with torch.device("meta"):
            vits = VitsTextEncoder(vits_cfg)
        second["vits"] = _build(vits, vits_tree(_load_module_sd(d / "text_encoder_2"), vits_cfg),
                                vits_cfg, device, weight_dtype)
        second["vits_tokenizer"] = _make_hf_tokenizer(d / "tokenizer_2")
    else:
        t5_cfg = T5Config(
            vocab_size=t5_json.get("vocab_size", 32128), d_model=t5_json.get("d_model", 1024),
            d_kv=t5_json.get("d_kv", 64), d_ff=t5_json.get("d_ff", 2816),
            num_layers=t5_json.get("num_layers", 24), num_heads=t5_json.get("num_heads", 16),
            is_gated_act="gated" in t5_json.get("feed_forward_proj", "gated-gelu"))
        with torch.device("meta"):
            t5 = T5EncoderModel(t5_cfg)
        second["t5"] = _build(t5, t5_tree(_load_module_sd(d / "text_encoder_2"), t5_cfg),
                              t5_cfg, device, weight_dtype)
    with torch.device("meta"):
        gpt2, proj = GPT2Model(gpt2_cfg), AudioLDM2ProjectionModel(proj_cfg)
    return AudioLDM2Pipeline(
        unet, vae, vocoder, schedule=schedule if schedule is not None else DiffusionSchedule(),
        scheduler_name=scheduler_name,
        operator=operator if operator is not None else IdentityOperator(),
        text_encoder=text, tokenizer=_make_hf_tokenizer(d / "tokenizer"),
        clap_audio_embed=audio_embed, clap_frame_embed=frame_embed, **second,
        gpt2=_build(gpt2, gpt2_tree(_load_module_sd(d / "language_model"), gpt2_cfg),
                    gpt2_cfg, device, weight_dtype),
        projection=_build(proj, projection_tree(_load_module_sd(d / "projection_model")),
                          proj_cfg, device, weight_dtype),
        t5_tokenizer=_make_hf_tokenizer(d / "tokenizer_2"),
        max_new_tokens=gpt2_json.get("max_new_tokens", 8))


def stable_audio_configs(d: Path):
    """(DiT, Oobleck, T5, projection) configs of a StableAudio snapshot, with
    the JAX package's defaults for missing keys."""
    from .configs import OobleckConfig, StableAudioDiTConfig, StableAudioProjectionConfig
    c = _cfg(d / "transformer")
    dit = StableAudioDiTConfig(
        sample_size=c.get("sample_size", 1024), in_channels=c.get("in_channels", 64),
        num_layers=c.get("num_layers", 24), attention_head_dim=c.get("attention_head_dim", 64),
        num_attention_heads=c.get("num_attention_heads", 24),
        num_key_value_attention_heads=c.get("num_key_value_attention_heads", 12),
        out_channels=c.get("out_channels", 64),
        cross_attention_dim=c.get("cross_attention_dim", 768),
        time_proj_dim=c.get("time_proj_dim", 256),
        global_states_input_dim=c.get("global_states_input_dim", 1536),
        cross_attention_input_dim=c.get("cross_attention_input_dim", 768))
    c = _cfg(d / "vae")
    vae = OobleckConfig(
        encoder_hidden_size=c.get("encoder_hidden_size", 128),
        downsampling_ratios=tuple(c.get("downsampling_ratios", (2, 4, 4, 8, 8))),
        channel_multiples=tuple(c.get("channel_multiples", (1, 2, 4, 8, 16))),
        decoder_channels=c.get("decoder_channels", 128),
        decoder_input_channels=c.get("decoder_input_channels", 64),
        audio_channels=c.get("audio_channels", 2), sampling_rate=c.get("sampling_rate", 44100))
    c = _cfg(d / "text_encoder")
    t5 = T5Config(
        vocab_size=c.get("vocab_size", 32128), d_model=c.get("d_model", 768),
        d_kv=c.get("d_kv", 64), d_ff=c.get("d_ff", 2048), num_layers=c.get("num_layers", 12),
        num_heads=c.get("num_heads", 12),
        is_gated_act="gated" in c.get("feed_forward_proj", "gated-gelu"))
    c = _cfg(d / "projection_model")
    proj = StableAudioProjectionConfig(
        text_encoder_dim=c.get("text_encoder_dim", 768),
        conditioning_dim=c.get("conditioning_dim", 768), min_value=c.get("min_value", 0.0),
        max_value=c.get("max_value", 512.0))
    return dit, vae, t5, proj


def edm_schedule_from_snapshot(d: Path):
    """The EDM schedule of scheduler/scheduler_config.json, JAX's defaults
    for missing keys (or for a missing file)."""
    from ..samplers.edm import EDMDPMSolverMultistepSchedule
    f = d / "scheduler" / "scheduler_config.json"
    c = json.loads(f.read_text()) if f.exists() else {}
    return EDMDPMSolverMultistepSchedule(
        sigma_min=c.get("sigma_min", 0.3), sigma_max=c.get("sigma_max", 500.0),
        sigma_data=c.get("sigma_data", 1.0), rho=c.get("rho", 7.0),
        solver_order=c.get("solver_order", 2),
        prediction_type=c.get("prediction_type", "v_prediction"))


def load_stable_audio(checkpoint_dir, schedule=None, device="cuda",
                      weight_dtype=torch.float32, **_):
    """A StableAudioPipeline from a local HF-snapshot directory: transformer/
    (the DiT), vae/ (Oobleck, weight-normed convs fused), text_encoder/ (T5;
    t5-base's ReLU feed-forward when its feed_forward_proj is not gated),
    projection_model/, scheduler/ (the EDM schedule unless `schedule` is
    given) and tokenizer/. Weights cast to `weight_dtype` on `device` (the
    card unless the caller asks for the CPU); every key of every state dict
    is read or the load raises."""
    from ..pipelines.stable_audio import StableAudioPipeline
    from .oobleck import AutoencoderOobleck
    from .stable_audio_dit import StableAudioDiTModel, StableAudioProjectionModel
    from .t5 import T5EncoderModel
    d = Path(checkpoint_dir)
    dit_cfg, vae_cfg, t5_cfg, proj_cfg = stable_audio_configs(d)
    with torch.device("meta"):
        dit, vae = StableAudioDiTModel(dit_cfg), AutoencoderOobleck(vae_cfg)
        t5, proj = T5EncoderModel(t5_cfg), StableAudioProjectionModel(proj_cfg)
    trees = (_strict(convert.convert_stable_audio_dit, _load_module_sd(d / "transformer"),
                     "convert_stable_audio_dit", dit_cfg),
             _strict(convert.convert_oobleck, _load_module_sd(d / "vae"), "convert_oobleck",
                     vae_cfg),
             t5_tree(_load_module_sd(d / "text_encoder"), t5_cfg),
             _strict(convert.convert_stable_audio_projection,
                     _load_module_sd(d / "projection_model"),
                     "convert_stable_audio_projection"))
    models = [_build(m, tree, cfg, device, weight_dtype) for m, tree, cfg in
              zip((dit, vae, t5, proj), trees, (dit_cfg, vae_cfg, t5_cfg, proj_cfg))]
    return StableAudioPipeline(
        *models, schedule=schedule if schedule is not None else edm_schedule_from_snapshot(d),
        tokenizer=_make_hf_tokenizer(d / "tokenizer"))
