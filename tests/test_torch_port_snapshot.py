"""Synthetic diffusers-layout checkpoints for the port's loader, and the
loader's own checks that need no JAX.

`write_snapshot(root, modules)` writes an HF-snapshot directory: per module a
`config.json` in the diffusers / transformers schema and the weights as
safetensors (`write_safetensors`, a writer of its own, so that this file
needs only torch and numpy and `chip_smoke.py` can import it). The state
dicts carry the real key grammar: the UNet's and the VAE's come from the
meta-device modules of `torch_ref_diffusers.py` (the keys of
`test_checkpoint.py::_synth_diffusers_unet_sd`), the vocoder's, CLAP's
(with its HTSAT audio tower where `audio_cfg` is given), T5's or VITS's,
GPT-2's and the projection model's from the transformers / diffusers names,
a StableAudio snapshot's DiT, Oobleck VAE (its convs weight-normed in
any of the three forms a snapshot holds), T5 and projection model from
diffusers' names, with the keys the converters leave unread (the vocoder's `mean` / `scale`,
T5's tied `encoder.embed_tokens.weight`, GPT-2's `wte.weight`, CLAP's
`logit_scale_a` / `_t`, the audio tower's `relative_position_index` buffers
and batch count, VITS's prior projection, flow, decoder, duration predictor
and posterior encoder). Values are seeded normals: weights over
sqrt(fan-in), norm scales near 1, biases near 0, the BatchNorm's running
variance above 1.

Checks here: the safetensors reader against the `safetensors` package
(F32, F16, BF16, I64; files written by either side; a sharded module), and
that a load imports neither `safetensors`, `yaml` nor `transformers`.
"""

import json
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent

_TAGS = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
         torch.int64: "I64", torch.int32: "I32", torch.float64: "F64"}


def write_safetensors(path, tensors: dict, metadata=None) -> None:
    """A .safetensors file of numpy arrays or CPU tensors: the 8-byte header
    length, the JSON header (padded with spaces to 8 bytes), the buffers in
    name order."""
    header, blobs, offset = {}, [], 0
    if metadata:
        header["__metadata__"] = metadata
    for name in sorted(tensors):
        t = torch.as_tensor(tensors[name]).contiguous()
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for data in blobs:
            f.write(data)


def _values(shapes: dict, seed: int) -> dict:
    """Seeded float32 values for {name: shape}."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        shape = tuple(shape)
        x = rng.standard_normal(shape, dtype=np.float32)
        leaf = name.rsplit(".", 1)[-1]
        if len(shape) >= 2:
            x *= np.float32(1.0 / np.sqrt(np.prod(shape[1:])))
        elif leaf in ("weight", "scale"):
            x = np.float32(1.0) + np.float32(0.1) * np.abs(x)
        else:
            x *= np.float32(0.1)
        out[name] = x
    return out


def _meta_shapes(module) -> dict:
    # diffusers' VAE attention keeps to_q/... under the block, not under .attn
    return {k.replace(".attn.to_", ".to_"): tuple(v.shape)
            for k, v in module.state_dict().items()}


def unet_json(cfg) -> dict:
    return {"_class_name": "UNet2DConditionModel", "sample_size": cfg.sample_size,
            "in_channels": cfg.in_channels, "out_channels": cfg.out_channels,
            "block_out_channels": list(cfg.block_out_channels),
            "down_block_types": ["CrossAttnDownBlock2D" if a else "DownBlock2D"
                                 for a in cfg.has_attention],
            "layers_per_block": cfg.layers_per_block,
            "attention_head_dim": cfg.attention_head_dim,
            "norm_num_groups": cfg.norm_num_groups,
            "cross_attention_dim": list(cfg.cross_attention_dims) or None,
            "class_embed_type": cfg.class_embed_type,
            "projection_class_embeddings_input_dim": cfg.projection_class_embeddings_input_dim,
            "class_embeddings_concat": cfg.class_embeddings_concat}


def unet_shapes(cfg) -> dict:
    sys.path.insert(0, str(TESTS))
    from torch_ref_diffusers import TorchUNet
    with torch.device("meta"):
        return _meta_shapes(TorchUNet(cfg))


def vae_json(cfg) -> dict:
    return {"_class_name": "AutoencoderKL", "in_channels": cfg.in_channels,
            "out_channels": cfg.out_channels, "latent_channels": cfg.latent_channels,
            "block_out_channels": list(cfg.block_out_channels),
            "layers_per_block": cfg.layers_per_block, "norm_num_groups": cfg.norm_num_groups,
            "scaling_factor": cfg.scaling_factor}


def vae_shapes(cfg) -> dict:
    sys.path.insert(0, str(TESTS))
    from torch_ref_diffusers import TorchVAE
    with torch.device("meta"):
        return _meta_shapes(TorchVAE(cfg))


def vocoder_json(cfg) -> dict:
    return {"_class_name": "SpeechT5HifiGan", "model_in_dim": cfg.model_in_dim,
            "sampling_rate": cfg.sampling_rate,
            "upsample_initial_channel": cfg.upsample_initial_channel,
            "upsample_rates": list(cfg.upsample_rates),
            "upsample_kernel_sizes": list(cfg.upsample_kernel_sizes),
            "resblock_kernel_sizes": list(cfg.resblock_kernel_sizes),
            "resblock_dilation_sizes": [list(d) for d in cfg.resblock_dilation_sizes],
            "leaky_relu_slope": cfg.leaky_relu_slope, "normalize_before": cfg.normalize_before}


def vocoder_shapes(cfg) -> dict:
    """transformers SpeechT5HifiGan's keys (its input statistics included)."""
    uic, nk = cfg.upsample_initial_channel, len(cfg.resblock_kernel_sizes)
    s = {"conv_pre.weight": (uic, cfg.model_in_dim, 7), "conv_pre.bias": (uic,),
         "mean": (cfg.model_in_dim,), "scale": (cfg.model_in_dim,)}
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        cin, ch = uic // 2 ** i, uic // 2 ** (i + 1)
        s[f"upsampler.{i}.weight"], s[f"upsampler.{i}.bias"] = (cin, ch, k), (ch,)
        for j, (rk, dil) in enumerate(zip(cfg.resblock_kernel_sizes,
                                          cfg.resblock_dilation_sizes)):
            for conv in ("convs1", "convs2"):
                for n in range(len(dil)):
                    p = f"resblocks.{i * nk + j}.{conv}.{n}"
                    s[f"{p}.weight"], s[f"{p}.bias"] = (ch, ch, rk), (ch,)
    last = uic // 2 ** len(cfg.upsample_rates)
    s["conv_post.weight"], s["conv_post.bias"] = (1, last, 7), (1,)
    return s


def clap_json(cfg, audio_cfg=None) -> dict:
    out = {"model_type": "clap", "projection_dim": cfg.projection_dim,
           "text_config": {"vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                           "num_hidden_layers": cfg.num_hidden_layers,
                           "num_attention_heads": cfg.num_attention_heads,
                           "intermediate_size": cfg.intermediate_size,
                           "max_position_embeddings": cfg.max_position_embeddings}}
    if audio_cfg is not None:
        a = audio_cfg
        out["audio_config"] = {
            "spec_size": a.spec_size, "patch_size": a.patch_size,
            "patch_stride": list(a.patch_stride), "num_mel_bins": a.num_mel_bins,
            "window_size": a.window_size, "depths": list(a.depths),
            "num_attention_heads": list(a.num_attention_heads),
            "patch_embeds_hidden_size": a.patch_embeds_hidden_size,
            "hidden_size": a.num_features, "enable_fusion": False}
    return out


def clap_audio_shapes(cfg) -> dict:
    """A ClapModel's audio tower and audio projection (transformers' names;
    every bias table sized by the config's window, as transformers sizes it)."""
    e, d, ws = "audio_model.audio_encoder", cfg.patch_embeds_hidden_size, cfg.window_size
    s = {f"{e}.patch_embed.proj.weight": (d, 1, cfg.patch_size, cfg.patch_size),
         f"{e}.patch_embed.proj.bias": (d,), f"{e}.patch_embed.norm.weight": (d,),
         f"{e}.patch_embed.norm.bias": (d,)}
    for i, depth in enumerate(cfg.depths):
        dim, heads = d * 2 ** i, cfg.num_attention_heads[i]
        for j in range(depth):
            b = f"{e}.layers.{i}.blocks.{j}"
            s[f"{b}.layernorm_before.weight"] = s[f"{b}.layernorm_before.bias"] = (dim,)
            s[f"{b}.attention.self.relative_position_bias_table"] = ((2 * ws - 1) ** 2, heads)
            s[f"{b}.attention.self.relative_position_index"] = (ws * ws, ws * ws)
            for n in ("self.query", "self.key", "self.value", "output.dense"):
                s[f"{b}.attention.{n}.weight"], s[f"{b}.attention.{n}.bias"] = (dim, dim), (dim,)
            s[f"{b}.layernorm_after.weight"] = s[f"{b}.layernorm_after.bias"] = (dim,)
            s[f"{b}.intermediate.dense.weight"] = (4 * dim, dim)
            s[f"{b}.intermediate.dense.bias"] = (4 * dim,)
            s[f"{b}.output.dense.weight"], s[f"{b}.output.dense.bias"] = (dim, 4 * dim), (dim,)
        if i < len(cfg.depths) - 1:
            s[f"{e}.layers.{i}.downsample.reduction.weight"] = (2 * dim, 4 * dim)
            s[f"{e}.layers.{i}.downsample.norm.weight"] = (4 * dim,)
            s[f"{e}.layers.{i}.downsample.norm.bias"] = (4 * dim,)
    m, n, p = cfg.num_mel_bins, cfg.num_features, cfg.projection_dim
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        s[f"{e}.batch_norm.{leaf}"] = (m,)
    s[f"{e}.batch_norm.num_batches_tracked"] = ()
    s[f"{e}.norm.weight"] = s[f"{e}.norm.bias"] = (n,)
    s.update({"audio_projection.linear1.weight": (p, n), "audio_projection.linear1.bias": (p,),
              "audio_projection.linear2.weight": (p, p), "audio_projection.linear2.bias": (p,)})
    return s


def clap_audio_values(cfg, seed: int) -> dict:
    """`_values` of `clap_audio_shapes`, with the integer buffers as
    transformers holds them and a positive running variance."""
    from diffmusic_tpu_torch.models.htsat import _relative_position_index
    out = _values(clap_audio_shapes(cfg), seed)
    for k in out:
        if k.endswith("relative_position_index"):
            out[k] = _relative_position_index(cfg.window_size).astype(np.int64)
        elif k.endswith("num_batches_tracked"):
            out[k] = np.array(1000, np.int64)
        elif k.endswith("running_var"):
            out[k] = np.float32(1.0) + np.abs(out[k])
    return out


def clap_text_shapes(cfg) -> dict:
    """A ClapModel's text tower, text projection and logit scales."""
    h, f, p = cfg.hidden_size, cfg.intermediate_size, cfg.projection_dim
    e = "text_model.embeddings"
    s = {f"{e}.word_embeddings.weight": (cfg.vocab_size, h),
         f"{e}.position_embeddings.weight": (cfg.max_position_embeddings, h),
         f"{e}.token_type_embeddings.weight": (cfg.type_vocab_size, h),
         f"{e}.LayerNorm.weight": (h,), f"{e}.LayerNorm.bias": (h,),
         "text_model.pooler.dense.weight": (h, h), "text_model.pooler.dense.bias": (h,),
         "text_projection.linear1.weight": (p, h), "text_projection.linear1.bias": (p,),
         "text_projection.linear2.weight": (p, p), "text_projection.linear2.bias": (p,),
         "logit_scale_a": (), "logit_scale_t": ()}
    for i in range(cfg.num_hidden_layers):
        b = f"text_model.encoder.layer.{i}"
        for name, shape in ((f"{b}.attention.self.query", (h, h)),
                            (f"{b}.attention.self.key", (h, h)),
                            (f"{b}.attention.self.value", (h, h)),
                            (f"{b}.attention.output.dense", (h, h)),
                            (f"{b}.intermediate.dense", (f, h)),
                            (f"{b}.output.dense", (h, f))):
            s[f"{name}.weight"], s[f"{name}.bias"] = shape, (shape[0],)
        for ln in (f"{b}.attention.output.LayerNorm", f"{b}.output.LayerNorm"):
            s[f"{ln}.weight"], s[f"{ln}.bias"] = (h,), (h,)
    return s


def t5_json(cfg) -> dict:
    return {"model_type": "t5", "vocab_size": cfg.vocab_size, "d_model": cfg.d_model,
            "d_kv": cfg.d_kv, "d_ff": cfg.d_ff, "num_layers": cfg.num_layers,
            "num_heads": cfg.num_heads,
            "feed_forward_proj": "gated-gelu" if cfg.is_gated_act else "relu"}


def t5_shapes(cfg) -> dict:
    d, inner = cfg.d_model, cfg.num_heads * cfg.d_kv
    s = {"shared.weight": (cfg.vocab_size, d), "encoder.embed_tokens.weight": (cfg.vocab_size, d),
         "encoder.final_layer_norm.weight": (d,)}
    for i in range(cfg.num_layers):
        b = f"encoder.block.{i}.layer"
        for n in ("q", "k", "v"):
            s[f"{b}.0.SelfAttention.{n}.weight"] = (inner, d)
        s[f"{b}.0.SelfAttention.o.weight"] = (d, inner)
        if i == 0:
            s[f"{b}.0.SelfAttention.relative_attention_bias.weight"] = (
                cfg.relative_attention_num_buckets, cfg.num_heads)
        s[f"{b}.0.layer_norm.weight"] = s[f"{b}.1.layer_norm.weight"] = (d,)
        for n in (("wi_0", "wi_1") if cfg.is_gated_act else ("wi",)):
            s[f"{b}.1.DenseReluDense.{n}.weight"] = (cfg.d_ff, d)
        s[f"{b}.1.DenseReluDense.wo.weight"] = (d, cfg.d_ff)
    return s


def gpt2_json(cfg) -> dict:
    return {"model_type": "gpt2", "vocab_size": cfg.vocab_size,
            "n_positions": cfg.n_positions, "n_embd": cfg.n_embd, "n_layer": cfg.n_layer,
            "n_head": cfg.n_head, "max_new_tokens": 8}


def gpt2_shapes(cfg) -> dict:
    """transformers GPT2Model (Conv1D weights are (in, out))."""
    n = cfg.n_embd
    s = {"wte.weight": (cfg.vocab_size, n), "wpe.weight": (cfg.n_positions, n),
         "ln_f.weight": (n,), "ln_f.bias": (n,)}
    for i in range(cfg.n_layer):
        b = f"h.{i}"
        for name, shape in ((f"{b}.attn.c_attn", (n, 3 * n)), (f"{b}.attn.c_proj", (n, n)),
                            (f"{b}.mlp.c_fc", (n, 4 * n)), (f"{b}.mlp.c_proj", (4 * n, n))):
            s[f"{name}.weight"], s[f"{name}.bias"] = shape, (shape[1],)
        for ln in ("ln_1", "ln_2"):
            s[f"{b}.{ln}.weight"], s[f"{b}.{ln}.bias"] = (n,), (n,)
    return s


def projection_json(cfg) -> dict:
    return {"_class_name": "AudioLDM2ProjectionModel", "text_encoder_dim": cfg.text_encoder_dim,
            "text_encoder_1_dim": cfg.text_encoder_1_dim,
            "langauge_model_dim": cfg.langauge_model_dim}


def projection_shapes(cfg) -> dict:
    lm = cfg.langauge_model_dim
    s = {"projection.weight": (lm, cfg.text_encoder_dim), "projection.bias": (lm,),
         "projection_1.weight": (lm, cfg.text_encoder_1_dim), "projection_1.bias": (lm,)}
    s.update({n: (lm,) for n in ("sos_embed", "eos_embed", "sos_embed_1", "eos_embed_1")})
    return s


def vits_json(cfg) -> dict:
    return {"model_type": "vits", "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_hidden_layers,
            "num_attention_heads": cfg.num_attention_heads, "ffn_dim": cfg.ffn_dim,
            "ffn_kernel_size": cfg.ffn_kernel_size, "window_size": cfg.window_size}


def vits_shapes(cfg) -> dict:
    """A transformers VitsModel's text encoder, and one key of each part
    AudioLDM2-TTS does not run (the loader names those parts)."""
    h, f, k = cfg.hidden_size, cfg.ffn_dim, cfg.ffn_kernel_size
    hd, w = h // cfg.num_attention_heads, cfg.window_size
    s = {"text_encoder.embed_tokens.weight": (cfg.vocab_size, h),
         "text_encoder.project.weight": (2 * h, h, 1), "text_encoder.project.bias": (2 * h,),
         "flow.flows.0.conv_pre.weight": (h, h // 2, 1),
         "decoder.conv_pre.weight": (h, h, 7),
         "duration_predictor.conv_pre.weight": (h, h, 1),
         "posterior_encoder.conv_pre.weight": (h, h, 1)}
    for i in range(cfg.num_hidden_layers):
        b = f"text_encoder.encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            s[f"{b}.attention.{n}.weight"], s[f"{b}.attention.{n}.bias"] = (h, h), (h,)
        s[f"{b}.attention.emb_rel_k"] = s[f"{b}.attention.emb_rel_v"] = (1, 2 * w + 1, hd)
        for ln in ("layer_norm", "final_layer_norm"):
            s[f"{b}.{ln}.weight"], s[f"{b}.{ln}.bias"] = (h,), (h,)
        s[f"{b}.feed_forward.conv_1.weight"] = (f, h, k)
        s[f"{b}.feed_forward.conv_1.bias"] = (f,)
        s[f"{b}.feed_forward.conv_2.weight"] = (h, f, k)
        s[f"{b}.feed_forward.conv_2.bias"] = (h,)
    return s


def musicldm_modules(unet_cfg, vae_cfg, voc_cfg, text_cfg, seed: int = 0,
                     audio_cfg=None) -> dict:
    """{module directory: (config.json dict, state dict of arrays)} of a
    MusicLDM snapshot; with `audio_cfg` its CLAP model carries the audio
    tower."""
    clap = _values(clap_text_shapes(text_cfg), seed + 3)
    if audio_cfg is not None:
        clap.update(clap_audio_values(audio_cfg, seed + 7))
    return {"unet": (unet_json(unet_cfg), _values(unet_shapes(unet_cfg), seed)),
            "vae": (vae_json(vae_cfg), _values(vae_shapes(vae_cfg), seed + 1)),
            "vocoder": (vocoder_json(voc_cfg), _values(vocoder_shapes(voc_cfg), seed + 2)),
            "text_encoder": (clap_json(text_cfg, audio_cfg), clap)}


def audioldm2_modules(unet_cfg, vae_cfg, voc_cfg, text_cfg, t5_cfg, gpt2_cfg, proj_cfg,
                      seed: int = 0, audio_cfg=None, vits_cfg=None) -> dict:
    """The same for an AudioLDM2 snapshot (GPT-2 under 'model.', as in
    some snapshots); with `vits_cfg` the TTS variant, a VITS model as
    text_encoder_2."""
    out = musicldm_modules(unet_cfg, vae_cfg, voc_cfg, text_cfg, seed, audio_cfg)
    gpt2 = _values(gpt2_shapes(gpt2_cfg), seed + 5)
    second = ((vits_json(vits_cfg), _values(vits_shapes(vits_cfg), seed + 4))
              if vits_cfg is not None else (t5_json(t5_cfg), _values(t5_shapes(t5_cfg), seed + 4)))
    out.update({"text_encoder_2": second,
                "language_model": (gpt2_json(gpt2_cfg),
                                   {f"model.{k}": v for k, v in gpt2.items()}),
                "projection_model": (projection_json(proj_cfg),
                                     _values(projection_shapes(proj_cfg), seed + 6))})
    return out


def stable_audio_dit_json(cfg) -> dict:
    keys = ("sample_size", "in_channels", "num_layers", "attention_head_dim",
            "num_attention_heads", "num_key_value_attention_heads", "out_channels",
            "cross_attention_dim", "time_proj_dim", "global_states_input_dim",
            "cross_attention_input_dim")
    return {"_class_name": "StableAudioDiTModel", **{k: getattr(cfg, k) for k in keys}}


def stable_audio_dit_shapes(cfg) -> dict:
    """diffusers StableAudioDiTModel (the 1x1 pre/postprocess convs are
    Conv1d weights (C, C, 1))."""
    inner = cfg.inner_dim
    kv = cfg.num_key_value_attention_heads * cfg.attention_head_dim
    s = {"time_proj.weight": (cfg.time_proj_dim // 2,),
         "timestep_proj.0.weight": (inner, cfg.time_proj_dim), "timestep_proj.0.bias": (inner,),
         "timestep_proj.2.weight": (inner, inner), "timestep_proj.2.bias": (inner,),
         "global_proj.0.weight": (inner, cfg.global_states_input_dim),
         "global_proj.2.weight": (inner, inner),
         "cross_attention_proj.0.weight": (cfg.cross_attention_dim,
                                           cfg.cross_attention_input_dim),
         "cross_attention_proj.2.weight": (cfg.cross_attention_dim, cfg.cross_attention_dim),
         "preprocess_conv.weight": (cfg.in_channels, cfg.in_channels, 1),
         "proj_in.weight": (inner, cfg.in_channels), "proj_out.weight": (cfg.out_channels, inner),
         "postprocess_conv.weight": (cfg.out_channels, cfg.out_channels, 1)}
    for i in range(cfg.num_layers):
        b = f"transformer_blocks.{i}"
        for n in ("norm1", "norm2", "norm3"):
            s[f"{b}.{n}.weight"] = s[f"{b}.{n}.bias"] = (inner,)
        for attn, ctx in (("attn1", inner), ("attn2", cfg.cross_attention_dim)):
            s[f"{b}.{attn}.to_q.weight"] = (inner, inner)
            s[f"{b}.{attn}.to_k.weight"] = s[f"{b}.{attn}.to_v.weight"] = (kv, ctx)
            s[f"{b}.{attn}.to_out.0.weight"] = (inner, inner)
        s[f"{b}.ff.net.0.proj.weight"], s[f"{b}.ff.net.0.proj.bias"] = (8 * inner, inner), (
            8 * inner,)
        s[f"{b}.ff.net.2.weight"], s[f"{b}.ff.net.2.bias"] = (inner, 4 * inner), (inner,)
    return s


def oobleck_json(cfg) -> dict:
    return {"_class_name": "AutoencoderOobleck", "encoder_hidden_size": cfg.encoder_hidden_size,
            "downsampling_ratios": list(cfg.downsampling_ratios),
            "channel_multiples": list(cfg.channel_multiples),
            "decoder_channels": cfg.decoder_channels,
            "decoder_input_channels": cfg.decoder_input_channels,
            "audio_channels": cfg.audio_channels, "sampling_rate": cfg.sampling_rate}


# the three forms of a weight-normed conv weight a diffusers Oobleck snapshot holds
WN_FORMS = {"fused": ("weight",), "weight_g": ("weight_g", "weight_v"),
            "parametrizations": ("parametrizations.weight.original0",
                                 "parametrizations.weight.original1")}


def oobleck_shapes(cfg, wn: str = "weight_g") -> dict:
    """diffusers AutoencoderOobleck with its convs weight-normed in the form
    `wn` (WN_FORMS; g has one norm per output channel of a conv, per input
    channel of a ConvTranspose: dim 0 of the weight)."""
    s = {}

    def conv(name, shape, bias=True):
        g_name, *v_name = WN_FORMS[wn]
        if v_name:
            s[f"{name}.{g_name}"] = (shape[0],) + (1,) * (len(shape) - 1)
            s[f"{name}.{v_name[0]}"] = shape
        else:
            s[f"{name}.{g_name}"] = shape
        if bias:
            s[f"{name}.bias"] = (shape[1],) if name.endswith("conv_t1") else (shape[0],)

    def snake(name, c):
        s[f"{name}.alpha"] = s[f"{name}.beta"] = (1, c, 1)

    def res_unit(p, c):
        snake(f"{p}.snake1", c)
        conv(f"{p}.conv1", (c, c, 7))
        snake(f"{p}.snake2", c)
        conv(f"{p}.conv2", (c, c, 1))

    hs, mults = cfg.encoder_hidden_size, (1,) + tuple(cfg.channel_multiples)
    conv("encoder.conv1", (hs, cfg.audio_channels, 7))
    for i, stride in enumerate(cfg.downsampling_ratios):
        cin, cout = hs * mults[i], hs * mults[i + 1]
        for r in (1, 2, 3):
            res_unit(f"encoder.block.{i}.res_unit{r}", cin)
        snake(f"encoder.block.{i}.snake1", cin)
        conv(f"encoder.block.{i}.conv1", (cout, cin, 2 * stride))
    snake("encoder.snake1", hs * mults[-1])
    conv("encoder.conv2", (2 * cfg.decoder_input_channels, hs * mults[-1], 3))
    dc, ratios = cfg.decoder_channels, tuple(reversed(cfg.downsampling_ratios))
    conv("decoder.conv1", (dc * mults[-1], cfg.decoder_input_channels, 7))
    for i, stride in enumerate(ratios):
        cin, cout = dc * mults[len(ratios) - i], dc * mults[len(ratios) - i - 1]
        snake(f"decoder.block.{i}.snake1", cin)
        conv(f"decoder.block.{i}.conv_t1", (cin, cout, 2 * stride))
        for r in (1, 2, 3):
            res_unit(f"decoder.block.{i}.res_unit{r}", cout)
    snake("decoder.snake1", dc)
    conv("decoder.conv2", (cfg.audio_channels, dc, 7), bias=False)
    return s


def stable_audio_projection_json(cfg) -> dict:
    return {"_class_name": "StableAudioProjectionModel",
            "text_encoder_dim": cfg.text_encoder_dim, "conditioning_dim": cfg.conditioning_dim,
            "min_value": cfg.min_value, "max_value": cfg.max_value}


def stable_audio_projection_shapes(cfg) -> dict:
    d = cfg.conditioning_dim
    s = {"text_projection.weight": (d, cfg.text_encoder_dim), "text_projection.bias": (d,)}
    for n in ("start_number_conditioner", "end_number_conditioner"):
        p = f"{n}.time_positional_embedding"
        s[f"{p}.0.weights"] = (d // 2,)
        s[f"{p}.1.weight"], s[f"{p}.1.bias"] = (d, 2 * (d // 2) + 1), (d,)
    return s


EDM_SCHEDULER_JSON = {"_class_name": "EDMDPMSolverMultistepScheduler", "sigma_min": 0.3,
                      "sigma_max": 500.0, "sigma_data": 1.0, "rho": 7.0, "solver_order": 2,
                      "prediction_type": "v_prediction"}


def stable_audio_modules(dit_cfg, vae_cfg, t5_cfg, proj_cfg, seed: int = 0,
                         wn: str = "weight_g") -> dict:
    """{module directory: (config.json dict, state dict of arrays)} of a
    stable-audio-open snapshot (the scheduler's config written apart by
    `write_stable_audio_snapshot`)."""
    return {"transformer": (stable_audio_dit_json(dit_cfg),
                            _values(stable_audio_dit_shapes(dit_cfg), seed)),
            "vae": (oobleck_json(vae_cfg), _values(oobleck_shapes(vae_cfg, wn), seed + 1)),
            "text_encoder": (t5_json(t5_cfg), _values(t5_shapes(t5_cfg), seed + 2)),
            "projection_model": (stable_audio_projection_json(proj_cfg),
                                 _values(stable_audio_projection_shapes(proj_cfg), seed + 3))}


def write_stable_audio_snapshot(root, modules: dict, scheduler: dict = EDM_SCHEDULER_JSON):
    root = write_snapshot(root, modules)
    (root / "scheduler").mkdir(exist_ok=True)
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps(scheduler))
    return root


WEIGHT_FILES = {"unet": "diffusion_pytorch_model.safetensors",
                "vae": "diffusion_pytorch_model.safetensors"}


def write_snapshot(root, modules: dict, shards: int = 1) -> Path:
    """Write `modules` as an HF snapshot under `root`; with `shards` > 1 each
    module's keys are split over that many files."""
    root = Path(root)
    for name, (cfg_json, sd) in modules.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "config.json").write_text(json.dumps(cfg_json))
        if shards == 1:
            write_safetensors(d / WEIGHT_FILES.get(name, "model.safetensors"), sd)
            continue
        keys = sorted(sd)
        for i in range(shards):
            write_safetensors(d / f"model-{i + 1:05d}-of-{shards:05d}.safetensors",
                              {k: sd[k] for k in keys[i::shards]})
    (root / "model_index.json").write_text(json.dumps({n: ["", ""] for n in modules}))
    return root


# ------------------------------------------------------------- tokenizers
# Small tokenizer directories of the kinds the snapshots carry, written with
# the standard library only (no transformers / tokenizers): a RoBERTa
# byte-level BPE, a T5 Unigram tokenizer.json whose normalizer holds a
# sentencepiece charsmap built here.

def double_array(keys: dict) -> list:
    """darts-clone units of a trie over {key bytes: value}: each node's unit
    holds its label (low byte), a leaf flag (bit 8) and the offset to its
    children (bits 10+), a child with label l sitting at pos ^ offset ^ l and
    the leaf's value unit (bit 31 set) at pos ^ offset; the array is whole
    256-unit blocks, so that a lookup of any byte stays inside it."""
    root: dict = {}
    for key, value in keys.items():
        node = root
        for b in key:
            node = node.setdefault(b, {})
        node[None] = value
    units, used = [0] * 256, {0}

    def place(node, pos):
        codes = sorted(0 if label is None else label for label in node)
        offset = 1
        while any(pos ^ offset ^ c in used for c in codes):
            offset += 1
        assert offset < 1 << 21
        for c in codes:
            used.add(pos ^ offset ^ c)
        need = -(-(max(used) + 1) // 256) * 256
        units.extend([0] * (need - len(units)))
        units[pos] |= (offset << 10) | ((1 << 8) if None in node else 0)
        for label, child in node.items():
            if label is None:
                units[pos ^ offset] = child | (1 << 31)
            else:
                units[pos ^ offset ^ label] |= label
                place(child, pos ^ offset ^ label)
    place(root, 0)
    return units


def charsmap(mapping: dict) -> bytes:
    """sentencepiece's precompiled_charsmap of {source: replacement}."""
    blob, keys = b"", {}
    for src, dst in mapping.items():
        keys[src.encode()] = len(blob)
        blob += dst.encode() + b"\0"
    units = double_array(keys)
    return struct.pack("<I", 4 * len(units)) + struct.pack(f"<{len(units)}I", *units) + blob


# what the tokenizer tests' charsmap normalises: fullwidth letters, a ligature,
# controls and odd spaces to a space, a decomposed accent composed, an ellipsis
NFKC_LIKE = {**{chr(0xFF21 + i): chr(0x41 + i) for i in range(26)},
             **{chr(0xFF41 + i): chr(0x61 + i) for i in range(26)},
             "\ufb01": "fi", "\t": " ", "\n": " ", "\r": " ", "\u00a0": " ", "\u3000": " ",
             "e\u0301": "\u00e9", "\u2026": "...", "\u00bd": "1/2"}

ROBERTA_WORDS = ("the", "piano", "calm", "music", "jazz", "drum", "beat", "soft", "guitar",
                 "an", "ing", "er", "in", "slow", "'s")


def roberta_vocab(words=ROBERTA_WORDS):
    """(vocab, merges) of a byte-level BPE: <s> <pad> </s> <unk>, the 256
    byte symbols, each word (and " word") merged left to right, <mask>."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("\u00a1"), ord("\u00ac") + 1)) \
        + list(range(ord("\u00ae"), ord("\u00ff") + 1))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    byte_map = dict(zip(bs, map(chr, cs)))
    vocab = {t: i for i, t in enumerate(["<s>", "<pad>", "</s>", "<unk>"])}
    for b in range(256):
        vocab[byte_map[b]] = len(vocab)
    merges = []
    for w in words:
        for word in (w, " " + w):
            sym = "".join(byte_map[b] for b in word.encode())
            cur = sym[0]
            for ch in sym[1:]:
                if (cur, ch) not in merges:
                    merges.append((cur, ch))
                vocab.setdefault(cur + ch, len(vocab))
                cur = cur + ch
    vocab["<mask>"] = len(vocab)
    return vocab, merges


def write_roberta_tokenizer(d, model_max_length: int = 77) -> Path:
    """vocab.json, merges.txt and the tokenizer config of a RoBERTa
    tokenizer (as RobertaTokenizer.save_pretrained writes them)."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    vocab, merges = roberta_vocab()
    (d / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    (d / "merges.txt").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges),
                                  encoding="utf-8")
    flag = dict(single_word=False, normalized=False, special=True)
    decoder = {str(vocab[t]): dict(content=t, lstrip=t == "<mask>", rstrip=False, **flag)
               for t in ("<s>", "<pad>", "</s>", "<unk>", "<mask>")}
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "RobertaTokenizer", "model_max_length": model_max_length,
        "add_prefix_space": False, "errors": "replace", "bos_token": "<s>",
        "eos_token": "</s>", "sep_token": "</s>", "cls_token": "<s>", "unk_token": "<unk>",
        "pad_token": "<pad>", "mask_token": "<mask>", "added_tokens_decoder": decoder}))
    return d


T5_PIECES = ("\u2581the", "\u2581a", "\u2581pi", "ano", "\u2581calm", "\u2581music",
             "\u2581jazz", "ing", "\u2581slow", "er", "\u2581be", "at", "\u2581soft",
             "\u2581guitar", "\u00e9", "fi", "...", "1/2")


def t5_pieces(seed: int = 0, extra_ids: int = 4):
    """Unigram pieces [(piece, score)]: <pad> </s> <unk>, "\u2581", the
    printable ASCII characters, some longer pieces, then the extra ids."""
    rng = np.random.default_rng(seed)
    chars = [chr(c) for c in range(33, 127)]
    body = ["\u2581"] + chars + list(T5_PIECES)
    pieces = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)]
    pieces += [(p, float(-rng.uniform(2.0, 12.0))) for p in body]
    return pieces + [(f"<extra_id_{i}>", 0.0) for i in range(extra_ids - 1, -1, -1)]


def write_t5_tokenizer_json(d, model_max_length: int = 64, extra_ids: int = 4) -> Path:
    """tokenizer.json (the Unigram, a normalizer of the NFKC_LIKE charsmap,
    right strip and runs of spaces to "\u2581", Metaspace, "$A </s>") and the
    config of a T5 tokenizer, in the layout transformers' converter writes."""
    import base64
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    pieces = t5_pieces(extra_ids=extra_ids)
    special = [(i, p) for i, (p, _) in enumerate(pieces) if p.startswith("<")]
    tok = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [dict(id=i, content=p, single_word=False, lstrip=False, rstrip=False,
                              normalized=False, special=True) for i, p in special],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Precompiled", "precompiled_charsmap":
                base64.b64encode(charsmap(NFKC_LIKE)).decode()},
            {"type": "Strip", "strip_left": False, "strip_right": True},
            {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": "\u2581"}]},
        "pre_tokenizer": {"type": "Metaspace", "replacement": "\u2581",
                          "prepend_scheme": "always", "split": True},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "special_tokens": {"</s>": {"id": "</s>", "ids": [1], "tokens": ["</s>"]}}},
        "decoder": {"type": "Metaspace", "replacement": "\u2581", "prepend_scheme": "always",
                    "split": True},
        "model": {"type": "Unigram", "unk_id": 2, "vocab": [list(p) for p in pieces],
                  "byte_fallback": False}}
    (d / "tokenizer.json").write_text(json.dumps(tok, ensure_ascii=False), encoding="utf-8")
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "T5Tokenizer", "model_max_length": model_max_length,
        "eos_token": "</s>", "unk_token": "<unk>", "pad_token": "<pad>", "extra_ids": extra_ids,
        "additional_special_tokens": [f"<extra_id_{i}>" for i in range(extra_ids)]}))
    return d


def tiny_configs():
    """The JAX package's tiny configs, from the port's copy."""
    from diffmusic_tpu_torch.models import configs as c
    return c.tiny_unet_config(), c.tiny_vae_config(), c.tiny_hifigan_config(), \
        c.tiny_clap_text_config()


# ------------------------------------------------------------------ checks
def _sample(dtype, rng):
    if dtype == torch.int64:
        return {"a": torch.from_numpy(rng.integers(-2**40, 2**40, (3, 5))),
                "b": torch.arange(7), "empty": torch.zeros((0, 4), dtype=torch.int64)}
    x = torch.from_numpy(rng.standard_normal((4, 3, 5)).astype(np.float32)).to(dtype)
    return {"a": x, "b": x[0, 0].clone(), "scalar": x[1, 1, 1].clone()}


def test_reader_matches_safetensors_package(tmp_path):
    import pytest
    st = pytest.importorskip("safetensors.torch")
    stn = pytest.importorskip("safetensors.numpy")
    from diffmusic_tpu_torch.models.checkpoint import read_safetensors
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.float16, torch.bfloat16, torch.int64):
        tensors = _sample(dtype, rng)
        theirs, ours = tmp_path / "theirs.safetensors", tmp_path / "ours.safetensors"
        st.save_file(tensors, str(theirs), metadata={"format": "pt"})
        write_safetensors(ours, tensors, metadata={"format": "pt"})
        for path in (theirs, ours):
            got, want = read_safetensors(path), st.load_file(str(path))
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
            if dtype != torch.bfloat16:   # numpy has no bfloat16
                for k, v in stn.load_file(str(path)).items():
                    assert np.array_equal(got[k].numpy(), v) and got[k].numpy().dtype == v.dtype


def test_sharded_module_is_the_union_of_its_shards(tmp_path):
    import pytest
    stn = pytest.importorskip("safetensors.numpy")
    from diffmusic_tpu_torch.models.checkpoint import _load_module_sd
    unet_cfg = tiny_configs()[0]
    modules = {"unet": (unet_json(unet_cfg), _values(unet_shapes(unet_cfg), 0))}
    write_snapshot(tmp_path, modules, shards=3)
    files = sorted((tmp_path / "unet").glob("*.safetensors"))
    assert len(files) == 3
    got = _load_module_sd(tmp_path / "unet")
    want = {}
    for f in files:
        want.update(stn.load_file(str(f)))
    assert sorted(got) == sorted(want) == sorted(modules["unet"][1])
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_load_needs_no_safetensors_yaml_or_transformers(tmp_path):
    """A snapshot loads (both pipelines, on the CPU) with none of the three
    packages imported: the reader, the config parsers and the converters
    are the port's own."""
    from diffmusic_tpu_torch.models import configs as c
    unet, vae, voc, txt = tiny_configs()
    write_snapshot(tmp_path / "musicldm", musicldm_modules(unet, vae, voc, txt))
    t5, gpt2 = c.tiny_t5_config(), c.tiny_gpt2_config()
    write_snapshot(tmp_path / "audioldm2", audioldm2_modules(
        c.tiny_unet_config((gpt2.n_embd, t5.d_model)), vae, voc, txt, t5, gpt2,
        c.ProjectionConfig(txt.projection_dim, t5.d_model, gpt2.n_embd)))
    code = (f"import sys\n"
            f"from diffmusic_tpu_torch.pipelines import AudioLDM2Pipeline, MusicLDMPipeline\n"
            f"m = MusicLDMPipeline.from_pretrained({str(tmp_path / 'musicldm')!r}, device='cpu')\n"
            f"a = AudioLDM2Pipeline.from_pretrained({str(tmp_path / 'audioldm2')!r}, "
            f"device='cpu')\n"
            f"assert m.tokenizer is None and a.tokenizer is None and a.t5_tokenizer is None\n"
            f"bad = [n for n in ('safetensors', 'yaml', 'transformers', 'jax') "
            f"if n in sys.modules]\n"
            f"print(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
