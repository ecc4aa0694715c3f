"""Weight carry from the JAX package and from HF checkpoints, and flax-style
random init.

`from_flax(params, cfg)` turns a flax parameter tree of the JAX package's
UNet, VAE, HiFi-GAN, CLAP text tower, CLAP audio tower (HTSAT, with its
BatchNorm's `batch_stats`), T5 encoder, VITS text encoder, AudioLDM2
projection model, GPT-2, Oobleck VAE, StableAudio DiT or StableAudio
projection model (arrays of any kind numpy can read) into the matching port
module's `state_dict`. The port's module and parameter names follow the flax tree, so
only the leaf names and the layouts change:
  - norm `scale` -> `weight`; Embed `embedding` (num, dim) -> `weight`;
  - Dense `kernel` (in, out) stays (in, out): the port's `Dense` keeps it so;
  - Conv `kernel` (kh, kw, in, out) -> Conv2d `weight` (out, in, kh, kw),
    and (k, in, out) -> Conv1d `weight` (out, in, k);
  - HiFi-GAN conv kernels stay in their (k, in, out) math layout, except the
    ConvTranspose upsamplers, whose (k, out, in) kernels swap to (k, in, out).
    Oobleck's convs are `nn.Conv1d` / `nn.ConvTranspose1d`: its ConvTranspose
    kernel, (k, out, in) under `transpose_kernel=True`, goes by the same rule
    as a conv's to torch's (in, out, k); Snake's alpha and beta, (1, 1, C) in
    flax, become (1, C, 1).
  - leaves of other names (T5's RMSNorm `weight`, the projection model's
    SOS/EOS embeds, the vocoder's `normalize_before` mean and scale, HTSAT's
    `bn_*` and bias tables, VITS's relative embeddings) keep their names.

`convert_hifigan`, `convert_clap_text`, `convert_clap_audio`,
`convert_t5_encoder`, `convert_vits_text_encoder`, `convert_gpt2`,
`convert_projection`, `convert_oobleck`, `convert_stable_audio_dit` and
`convert_stable_audio_projection` are numpy copies of the JAX package's HF -> flax
converters (`diffmusic_tpu/models/convert.py`): a transformers / diffusers
state dict becomes the flax tree, which `from_flax` then turns into the
port's state dict. `models/checkpoint.py` holds the UNet's and the VAE's.

`init_flax_style(model, seed)` draws random weights the way flax initialises
them (lecun-normal kernels, zero biases, unit norm scales, embeddings normal
with variance 1/dim, SOS/EOS embeds normal with std 0.02, the Fourier and
number-conditioner weights normal(1.0), Snake's alpha and beta zeros), so
bf16 activations of a random full-width model behave as in the JAX package.
"""

import numpy as np
import torch
import torch.nn as nn

from .configs import (ClapTextConfig, GPT2Config, HiFiGANConfig, OobleckConfig,
                      ProjectionConfig, StableAudioDiTConfig, StableAudioProjectionConfig,
                      T5Config, UNetConfig, VAEConfig)
from .hifigan import Conv1dParams
from .htsat import ClapAudioConfig
from .layers import Dense, GroupNorm
from .oobleck import Snake1d
from .projection import AudioLDM2ProjectionModel
from .stable_audio_dit import GaussianFourierProjection, NumberConditioner
from .t5 import RMSNorm
from .vits import VitsAttention, VitsConfig

CONFIGS = (UNetConfig, VAEConfig, HiFiGANConfig, ClapTextConfig, ClapAudioConfig, T5Config,
           VitsConfig, ProjectionConfig, GPT2Config, OobleckConfig, StableAudioDiTConfig,
           StableAudioProjectionConfig)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, dtype=np.float32)


def _layout(path, ndim: int, hifigan: bool, oobleck: bool = False):
    """(port key, axes) of one flax leaf: the port's array is the flax one
    transposed by `axes` (port axis i is flax axis axes[i])."""
    *mods, name = path
    same = tuple(range(ndim))
    if oobleck and name in ("alpha", "beta"):
        return ".".join(path), (0, 2, 1)   # Snake: (1, 1, C) -> (1, C, 1)
    if name == "bias":
        return ".".join(mods) + ".bias", same
    if name in ("scale", "embedding") and mods:
        return ".".join(mods) + ".weight", same
    if name != "kernel":
        return ".".join(path), same
    key = ".".join(mods) + ".weight"
    if hifigan:
        return key, (0, 2, 1) if mods[-1].startswith("upsampler_") else same
    if ndim in (2, 3, 4):
        return key, {2: same, 3: (2, 1, 0), 4: (3, 2, 0, 1)}[ndim]
    raise ValueError(f"unexpected kernel rank {ndim} at {'/'.join(path)}")


def _leaf(path, arr, hifigan: bool, oobleck: bool = False):
    """(port key, array in the port's layout) for one flax leaf."""
    key, axes = _layout(path, arr.ndim, hifigan, oobleck)
    return key, arr.transpose(axes)


def flax_axes(key: str, ndim: int, cfg) -> tuple:
    """The converter's axes for the port's state-dict entry `key` of rank
    `ndim` of the model of `cfg`: its axis i is axis axes[i] of the flax
    leaf. A `weight` of rank 1 is a norm's scale, of rank 2 a Dense kernel
    or an Embed table (both kept as they are), of higher rank a conv kernel."""
    *mods, name = key.split(".")
    if name == "weight":
        name = "kernel" if ndim > 1 else "scale"
    return _layout((*mods, name), ndim, isinstance(cfg, HiFiGANConfig),
                   isinstance(cfg, OobleckConfig))[1]


def from_flax(params, cfg) -> dict:
    """State dict of the port's model for `cfg` from the JAX package's
    variables (`{"params": ...}` or the bare tree; `batch_stats` leaves, the
    HTSAT BatchNorm's running statistics, become buffers of the same name)."""
    tree = params.get("params", params)
    hifigan = isinstance(cfg, HiFiGANConfig)
    if not isinstance(cfg, CONFIGS):
        raise TypeError(f"no port model for config {type(cfg).__name__}")
    out = {}
    leaves = list(_flatten(tree))
    if "params" in params:
        leaves += list(_flatten(params.get("batch_stats", {})))
    for path, arr in leaves:
        key, arr = _leaf(path, arr, hifigan, isinstance(cfg, OobleckConfig))
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    return out


# ----------------------------------------------- HF state dict -> flax tree
# torch layouts -> flax: Conv1d (O, I, K) -> (K, I, O); Conv2d (O, I, kh, kw)
# -> (kh, kw, I, O); ConvTranspose1d (I, O, K) -> (K, O, I); Linear (O, I) -> (I, O)

def conv1d(w):
    return np.transpose(np.asarray(w), (2, 1, 0))


def conv2d(w):
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def convtranspose1d(w):
    return np.transpose(np.asarray(w), (2, 1, 0))


def linear(w):
    return np.transpose(np.asarray(w), (1, 0))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def convert_hifigan(state_dict, cfg) -> dict:
    """transformers SpeechT5HifiGan state dict -> the vocoder's flax tree."""
    sd = state_dict
    p = {"conv_pre": {"kernel": conv1d(_np(sd["conv_pre.weight"])),
                      "bias": _np(sd["conv_pre.bias"])}}
    for i in range(len(cfg.upsample_rates)):
        p[f"upsampler_{i}"] = {"kernel": convtranspose1d(_np(sd[f"upsampler.{i}.weight"])),
                               "bias": _np(sd[f"upsampler.{i}.bias"])}
    nk = len(cfg.resblock_kernel_sizes)
    for r in range(len(cfg.upsample_rates) * nk):
        blk = {}
        for j in range(len(cfg.resblock_dilation_sizes[r % nk])):
            for conv in ("convs1", "convs2"):
                blk[f"{conv}_{j}"] = {
                    "kernel": conv1d(_np(sd[f"resblocks.{r}.{conv}.{j}.weight"])),
                    "bias": _np(sd[f"resblocks.{r}.{conv}.{j}.bias"])}
        p[f"resblocks_{r}"] = blk
    p["conv_post"] = {"kernel": conv1d(_np(sd["conv_post.weight"])),
                      "bias": _np(sd["conv_post.bias"])}
    if cfg.normalize_before:
        p["mean"] = _np(sd["mean"])
        p["scale"] = _np(sd["scale"])
    return {"params": p}


def _dense(sd, name, bias=True):
    out = {"kernel": linear(_np(sd[f"{name}.weight"]))}
    if bias:
        out["bias"] = _np(sd[f"{name}.bias"])
    return out


def _norm(sd, name):
    return {"scale": _np(sd[f"{name}.weight"]), "bias": _np(sd[f"{name}.bias"])}


def convert_clap_text(state_dict, cfg) -> dict:
    """transformers ClapTextModelWithProjection, or the text_model /
    text_projection part of a ClapModel -> the CLAP text tower's flax tree."""
    sd = state_dict
    emb = "text_model.embeddings"
    p = {
        "embeddings": {
            "word_embeddings": {"embedding": _np(sd[f"{emb}.word_embeddings.weight"])},
            "position_embeddings": {"embedding": _np(sd[f"{emb}.position_embeddings.weight"])},
            "token_type_embeddings": {
                "embedding": _np(sd[f"{emb}.token_type_embeddings.weight"])},
            "LayerNorm": _norm(sd, f"{emb}.LayerNorm"),
        },
        "pooler": _dense(sd, "text_model.pooler.dense"),
        "projection_linear1": _dense(sd, "text_projection.linear1"),
        "projection_linear2": _dense(sd, "text_projection.linear2"),
    }
    for i in range(cfg.num_hidden_layers):
        b = f"text_model.encoder.layer.{i}"
        p[f"layer_{i}"] = {
            "q": _dense(sd, f"{b}.attention.self.query"),
            "k": _dense(sd, f"{b}.attention.self.key"),
            "v": _dense(sd, f"{b}.attention.self.value"),
            "attn_out": _dense(sd, f"{b}.attention.output.dense"),
            "attn_ln": _norm(sd, f"{b}.attention.output.LayerNorm"),
            "ff_in": _dense(sd, f"{b}.intermediate.dense"),
            "ff_out": _dense(sd, f"{b}.output.dense"),
            "ff_ln": _norm(sd, f"{b}.output.LayerNorm"),
        }
    return {"params": p}


def convert_clap_audio(state_dict, cfg) -> dict:
    """transformers ClapAudioModelWithProjection, or the audio_model /
    audio_projection part of a ClapModel (keys with or without the
    'audio_model.' prefix) -> the HTSAT tower's flax variables."""
    sd = state_dict
    strip = {k[len("audio_model."):]: k for k in sd if k.startswith("audio_model.")}

    def get(name):
        return _np(sd[strip.get(name, name)])

    def dense(name, bias=True):
        out = {"kernel": linear(get(f"{name}.weight"))}
        if bias:
            out["bias"] = get(f"{name}.bias")
        return out

    def norm(name):
        return {"scale": get(f"{name}.weight"), "bias": get(f"{name}.bias")}

    enc = "audio_encoder"
    p = {"patch_embed_proj": {"kernel": conv2d(get(f"{enc}.patch_embed.proj.weight")),
                              "bias": get(f"{enc}.patch_embed.proj.bias")},
         "patch_embed_norm": norm(f"{enc}.patch_embed.norm"),
         "norm": norm(f"{enc}.norm"),
         "bn_scale": get(f"{enc}.batch_norm.weight"),
         "bn_bias": get(f"{enc}.batch_norm.bias"),
         "projection_linear1": dense("audio_projection.linear1"),
         "projection_linear2": dense("audio_projection.linear2")}
    for i, depth in enumerate(cfg.depths):
        for d in range(depth):
            b = f"{enc}.layers.{i}.blocks.{d}"
            attn = {n: dense(f"{b}.attention.self.{n}") for n in ("query", "key", "value")}
            attn["output_dense"] = dense(f"{b}.attention.output.dense")
            attn["relative_position_bias_table"] = get(
                f"{b}.attention.self.relative_position_bias_table")
            p[f"stage_{i}_block_{d}"] = {
                "layernorm_before": norm(f"{b}.layernorm_before"),
                "layernorm_after": norm(f"{b}.layernorm_after"),
                "attention": attn,
                "intermediate_dense": dense(f"{b}.intermediate.dense"),
                "output_dense": dense(f"{b}.output.dense")}
        if i < len(cfg.depths) - 1:
            p[f"stage_{i}_downsample"] = {
                "norm": norm(f"{enc}.layers.{i}.downsample.norm"),
                "reduction": dense(f"{enc}.layers.{i}.downsample.reduction", bias=False)}
    mean, var = f"{enc}.batch_norm.running_mean", f"{enc}.batch_norm.running_var"
    stats = {"bn_mean": get(mean) if strip.get(mean, mean) in sd
             else np.zeros(cfg.num_mel_bins, np.float32),
             "bn_var": get(var) if strip.get(var, var) in sd
             else np.ones(cfg.num_mel_bins, np.float32)}
    return {"params": p, "batch_stats": stats}


def convert_vits_text_encoder(state_dict, cfg) -> dict:
    """transformers VitsModel's text_encoder state dict (keys with or without
    the 'text_encoder.' prefix) -> the VITS text encoder's flax tree."""
    sd = state_dict
    pre = "text_encoder." if any(k.startswith("text_encoder.") for k in sd) else ""

    def get(name):
        return _np(sd[pre + name])

    def dense(name):
        return {"kernel": linear(get(f"{name}.weight")), "bias": get(f"{name}.bias")}

    def norm(name):
        return {"scale": get(f"{name}.weight"), "bias": get(f"{name}.bias")}

    p = {"embed_tokens": {"embedding": get("embed_tokens.weight")}}
    for i in range(cfg.num_hidden_layers):
        b = f"encoder.layers.{i}"
        attn = {n: dense(f"{b}.attention.{n}") for n in ("q_proj", "k_proj", "v_proj",
                                                          "out_proj")}
        attn["emb_rel_k"] = get(f"{b}.attention.emb_rel_k")
        attn["emb_rel_v"] = get(f"{b}.attention.emb_rel_v")
        p[f"layers_{i}_attention"] = attn
        p[f"layers_{i}_layer_norm"] = norm(f"{b}.layer_norm")
        p[f"layers_{i}_feed_forward"] = {
            n: {"kernel": conv1d(get(f"{b}.feed_forward.{n}.weight")),
                "bias": get(f"{b}.feed_forward.{n}.bias")} for n in ("conv_1", "conv_2")}
        p[f"layers_{i}_final_layer_norm"] = norm(f"{b}.final_layer_norm")
    return {"params": p}


def convert_t5_encoder(state_dict, cfg) -> dict:
    """transformers T5EncoderModel state dict -> the T5 encoder's flax tree."""
    sd = state_dict
    p = {"shared": {"embedding": _np(sd["shared.weight"])},
         "final_layer_norm": {"weight": _np(sd["encoder.final_layer_norm.weight"])}}
    for i in range(cfg.num_layers):
        b = f"encoder.block.{i}"
        attn = {n: _dense(sd, f"{b}.layer.0.SelfAttention.{n}", bias=False)
                for n in ("q", "k", "v", "o")}
        if i == 0:
            attn["relative_attention_bias"] = {"embedding": _np(
                sd[f"{b}.layer.0.SelfAttention.relative_attention_bias.weight"])}
        blk = {"attn": attn,
               "ln_attn": {"weight": _np(sd[f"{b}.layer.0.layer_norm.weight"])},
               "ln_ff": {"weight": _np(sd[f"{b}.layer.1.layer_norm.weight"])}}
        ff = f"{b}.layer.1.DenseReluDense"
        for n in (("wi_0", "wi_1") if cfg.is_gated_act else ("wi",)) + ("wo",):
            blk[n] = _dense(sd, f"{ff}.{n}", bias=False)
        p[f"block_{i}"] = blk
    return {"params": p}


def convert_gpt2(state_dict, cfg) -> dict:
    """transformers GPT2Model state dict -> GPT-2's flax tree. HF's Conv1D
    keeps its weight as (in, out), flax's layout, so nothing is transposed."""
    sd = state_dict

    def conv1d_dense(name):
        return {"kernel": _np(sd[f"{name}.weight"]), "bias": _np(sd[f"{name}.bias"])}

    p = {"wpe": {"embedding": _np(sd["wpe.weight"])}, "ln_f": _norm(sd, "ln_f")}
    for i in range(cfg.n_layer):
        b = f"h.{i}"
        p[f"h_{i}"] = {"ln_1": _norm(sd, f"{b}.ln_1"),
                       "c_attn": conv1d_dense(f"{b}.attn.c_attn"),
                       "attn_c_proj": conv1d_dense(f"{b}.attn.c_proj"),
                       "ln_2": _norm(sd, f"{b}.ln_2"),
                       "c_fc": conv1d_dense(f"{b}.mlp.c_fc"),
                       "mlp_c_proj": conv1d_dense(f"{b}.mlp.c_proj")}
    return {"params": p}


def convert_projection(state_dict) -> dict:
    """diffusers AudioLDM2ProjectionModel state dict -> its flax tree."""
    sd = state_dict
    p = {"projection": _dense(sd, "projection"), "projection_1": _dense(sd, "projection_1")}
    for n in ("sos_embed", "eos_embed", "sos_embed_1", "eos_embed_1"):
        p[n] = _np(sd[n])
    return {"params": p}


# --------------------------------------------------------------- StableAudio

def _wn_weight(sd, prefix: str):
    """A conv weight that may be weight-normed: the fused `weight`, the
    legacy `weight_g` / `weight_v`, or torch >= 2.1's
    `parametrizations.weight.original0` / `original1`."""
    if f"{prefix}.weight" in sd:
        return _np(sd[f"{prefix}.weight"])
    if f"{prefix}.weight_g" in sd:
        g, v = _np(sd[f"{prefix}.weight_g"]), _np(sd[f"{prefix}.weight_v"])
    else:
        g = _np(sd[f"{prefix}.parametrizations.weight.original0"])
        v = _np(sd[f"{prefix}.parametrizations.weight.original1"])
    norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def _snake(sd, prefix: str) -> dict:
    """diffusers Snake1d alpha / beta (1, C, 1) -> flax (1, 1, C)."""
    return {"alpha": np.transpose(_np(sd[f"{prefix}.alpha"]), (0, 2, 1)),
            "beta": np.transpose(_np(sd[f"{prefix}.beta"]), (0, 2, 1))}


def _wn_conv(sd, prefix: str, bias: bool = True) -> dict:
    # a ConvTranspose1d's (in, out, k) takes the same transpose as a conv's
    # (out, in, k), to flax's transpose_kernel layout (k, out, in)
    out = {"kernel": conv1d(_wn_weight(sd, prefix))}
    if bias:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _oobleck_res_unit(sd, p: str) -> dict:
    return {"snake1": _snake(sd, f"{p}.snake1"), "conv1": _wn_conv(sd, f"{p}.conv1"),
            "snake2": _snake(sd, f"{p}.snake2"), "conv2": _wn_conv(sd, f"{p}.conv2")}


def convert_oobleck(state_dict, cfg) -> dict:
    """diffusers AutoencoderOobleck state dict -> the Oobleck VAE's flax tree."""
    sd = state_dict
    enc = {"conv1": _wn_conv(sd, "encoder.conv1"), "snake1": _snake(sd, "encoder.snake1"),
           "conv2": _wn_conv(sd, "encoder.conv2")}
    for i in range(len(cfg.downsampling_ratios)):
        b = f"encoder.block.{i}"
        enc[f"block_{i}"] = {**{f"res_unit{r}": _oobleck_res_unit(sd, f"{b}.res_unit{r}")
                                for r in (1, 2, 3)},
                             "snake1": _snake(sd, f"{b}.snake1"),
                             "conv1": _wn_conv(sd, f"{b}.conv1")}
    dec = {"conv1": _wn_conv(sd, "decoder.conv1"), "snake1": _snake(sd, "decoder.snake1"),
           "conv2": _wn_conv(sd, "decoder.conv2", bias=False)}
    for i in range(len(cfg.downsampling_ratios)):
        b = f"decoder.block.{i}"
        dec[f"block_{i}"] = {"snake1": _snake(sd, f"{b}.snake1"),
                             "conv_t1": _wn_conv(sd, f"{b}.conv_t1"),
                             **{f"res_unit{r}": _oobleck_res_unit(sd, f"{b}.res_unit{r}")
                                for r in (1, 2, 3)}}
    return {"params": {"encoder": enc, "decoder": dec}}


def convert_stable_audio_dit(state_dict, cfg) -> dict:
    """diffusers StableAudioDiTModel state dict -> the DiT's flax tree (its
    1x1 pre/postprocess convs are token-wise Dense layers)."""
    sd = state_dict

    def dense(key, bias=True):
        out = {"kernel": linear(_np(sd[f"{key}.weight"]))}
        if bias and f"{key}.bias" in sd:
            out["bias"] = _np(sd[f"{key}.bias"])
        return out

    def conv1x1(key):
        return {"kernel": linear(_np(sd[f"{key}.weight"])[:, :, 0])}

    p = {"time_proj": {"weight": _np(sd["time_proj.weight"])},
         "timestep_proj_1": dense("timestep_proj.0"),
         "timestep_proj_2": dense("timestep_proj.2"),
         "global_proj_1": dense("global_proj.0", bias=False),
         "global_proj_2": dense("global_proj.2", bias=False),
         "cross_attention_proj_1": dense("cross_attention_proj.0", bias=False),
         "cross_attention_proj_2": dense("cross_attention_proj.2", bias=False),
         "preprocess_conv": conv1x1("preprocess_conv"),
         "proj_in": dense("proj_in", bias=False),
         "proj_out": dense("proj_out", bias=False),
         "postprocess_conv": conv1x1("postprocess_conv")}
    for i in range(cfg.num_layers):
        b = f"transformer_blocks.{i}"

        def attn(name):
            return {n: dense(f"{b}.{name}.{m}", bias=False)
                    for n, m in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"),
                                 ("to_out", "to_out.0"))}

        p[f"block_{i}"] = {
            **{n: {"scale": _np(sd[f"{b}.{n}.weight"]), "bias": _np(sd[f"{b}.{n}.bias"])}
               for n in ("norm1", "norm2", "norm3")},
            "attn1": attn("attn1"), "attn2": attn("attn2"),
            "ff": {"proj_in": dense(f"{b}.ff.net.0.proj"), "proj_out": dense(f"{b}.ff.net.2")}}
    return {"params": p}


def convert_stable_audio_projection(state_dict) -> dict:
    """diffusers StableAudioProjectionModel state dict -> its flax tree."""
    sd = state_dict

    def number_conditioner(p):
        return {"weight": _np(sd[f"{p}.time_positional_embedding.0.weights"]),
                "proj": {"kernel": linear(_np(sd[f"{p}.time_positional_embedding.1.weight"])),
                         "bias": _np(sd[f"{p}.time_positional_embedding.1.bias"])}}

    return {"params": {
        "text_projection": {"kernel": linear(_np(sd["text_projection.weight"])),
                            "bias": _np(sd["text_projection.bias"])},
        "start_number_conditioner": number_conditioner("start_number_conditioner"),
        "end_number_conditioner": number_conditioner("end_number_conditioner")}}


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator):
    # flax lecun_normal: truncated normal at +-2 std, rescaled to variance 1/fan_in
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_flax_style(model: nn.Module, seed: int, on_device: bool = False) -> nn.Module:
    """Random flax-style init in place, on the model's device, drawn on the
    CPU (a seed gives the same weights on every device) or, `on_device`, by
    a generator on the model's device (fast at full width)."""
    dev = next(model.parameters()).device if on_device else torch.device("cpu")
    g = torch.Generator(dev).manual_seed(seed)

    def normal(shape):
        return torch.randn(shape, generator=g, device=dev)

    for mod in model.modules():
        if isinstance(mod, (Dense, nn.Conv2d, nn.Conv1d, nn.ConvTranspose1d, Conv1dParams)):
            if isinstance(mod, Dense):
                fan_in = mod.weight.shape[0]
            elif isinstance(mod, nn.ConvTranspose1d):
                # flax's transpose_kernel layout (k, out, in): fan-in k * out
                fan_in = mod.out_channels * int(np.prod(mod.kernel_size))
            elif isinstance(mod, (nn.Conv2d, nn.Conv1d)):
                fan_in = mod.in_channels * int(np.prod(mod.kernel_size))
            else:
                fan_in = mod.fan_in
            w = torch.empty(mod.weight.shape, device=dev)
            _lecun_normal_(w, fan_in, g)
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (GroupNorm, nn.LayerNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, RMSNorm):
            mod.weight.fill_(1.0)
        elif isinstance(mod, nn.Embedding):
            # flax Embed: variance_scaling(1, fan_in, normal) over the feature axis
            mod.weight.copy_(normal(mod.weight.shape) / mod.weight.shape[1] ** 0.5)
        elif isinstance(mod, VitsAttention):
            # flax normal(head_dim ** -0.5) for the relative embeddings
            for p in (mod.emb_rel_k, mod.emb_rel_v):
                p.copy_(normal(p.shape) * p.shape[-1] ** -0.5)
        elif isinstance(mod, AudioLDM2ProjectionModel):
            for name in ("sos_embed", "eos_embed", "sos_embed_1", "eos_embed_1"):
                p = getattr(mod, name)
                p.copy_(0.02 * normal(p.shape))
        elif isinstance(mod, (GaussianFourierProjection, NumberConditioner)):
            mod.weight.copy_(normal(mod.weight.shape))   # flax normal(1.0)
        elif isinstance(mod, Snake1d):
            mod.alpha.zero_()
            mod.beta.zero_()
    return model
