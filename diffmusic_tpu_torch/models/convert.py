"""Weight carry from the JAX package, and flax-style random init.

`from_flax(params, cfg)` turns a flax parameter tree of the JAX package's
UNet, VAE, HiFi-GAN, CLAP text tower, T5 encoder, AudioLDM2 projection model
or GPT-2 (arrays of any kind numpy can read) into the matching port module's
`state_dict`. The port's module and parameter names follow the flax tree, so
only the leaf names and the layouts change:
  - norm `scale` -> `weight`; Embed `embedding` (num, dim) -> `weight`;
  - Dense `kernel` (in, out) stays (in, out): the port's `Dense` keeps it so;
  - Conv `kernel` (kh, kw, in, out) -> Conv2d `weight` (out, in, kh, kw);
  - HiFi-GAN conv kernels stay in their (k, in, out) math layout, except the
    ConvTranspose upsamplers, whose (k, out, in) kernels swap to (k, in, out).
  - leaves of other names (T5's RMSNorm `weight`, the projection model's
    SOS/EOS embeds) keep their names.
The VAE encoder's leaves are skipped: only the decoder is ported.

`init_flax_style(model, seed)` draws random weights the way flax initialises
them (lecun-normal kernels, zero biases, unit norm scales, embeddings normal
with variance 1/dim, SOS/EOS embeds normal with std 0.02), so bf16
activations of a random full-width model behave as in the JAX package.
"""

import numpy as np
import torch
import torch.nn as nn

from .configs import (ClapTextConfig, GPT2Config, HiFiGANConfig, ProjectionConfig,
                      T5Config, UNetConfig, VAEConfig)
from .hifigan import Conv1dParams
from .layers import Dense, GroupNorm
from .projection import AudioLDM2ProjectionModel
from .t5 import RMSNorm

CONFIGS = (UNetConfig, VAEConfig, HiFiGANConfig, ClapTextConfig, T5Config, ProjectionConfig,
           GPT2Config)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, dtype=np.float32)


def _leaf(path, arr, hifigan: bool):
    """(port key, array in the port's layout) for one flax leaf."""
    *mods, name = path
    key = ".".join(mods)
    if name == "bias":
        return key + ".bias", arr
    if name in ("scale", "embedding"):
        return key + ".weight", arr
    if name != "kernel":
        return ".".join(path), arr
    if hifigan:
        return key + ".weight", arr.swapaxes(1, 2) if mods[-1].startswith("upsampler_") else arr
    if arr.ndim == 2:
        return key + ".weight", arr
    if arr.ndim == 4:
        return key + ".weight", arr.transpose(3, 2, 0, 1)
    raise ValueError(f"unexpected kernel rank {arr.ndim} at {'/'.join(path)}")


def from_flax(params, cfg) -> dict:
    """State dict of the port's model for `cfg` from the JAX package's
    variables (`{"params": ...}` or the bare tree)."""
    tree = params.get("params", params)
    hifigan = isinstance(cfg, HiFiGANConfig)
    if not isinstance(cfg, CONFIGS):
        raise TypeError(f"no port model for config {type(cfg).__name__}")
    out = {}
    for path, arr in _flatten(tree):
        if isinstance(cfg, VAEConfig) and path[0] == "encoder":
            continue
        key, arr = _leaf(path, arr, hifigan)
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    return out


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator):
    # flax lecun_normal: truncated normal at +-2 std, rescaled to variance 1/fan_in
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_flax_style(model: nn.Module, seed: int) -> nn.Module:
    """Random flax-style init in place (on the model's device, drawn on the CPU)."""
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (Dense, nn.Conv2d, Conv1dParams)):
            if isinstance(mod, Dense):
                fan_in = mod.weight.shape[0]
            elif isinstance(mod, nn.Conv2d):
                fan_in = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
            else:
                fan_in = mod.fan_in
            w = torch.empty(mod.weight.shape)
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
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=g)
                             / mod.weight.shape[1] ** 0.5)
        elif isinstance(mod, AudioLDM2ProjectionModel):
            for name in ("sos_embed", "eos_embed", "sos_embed_1", "eos_embed_1"):
                p = getattr(mod, name)
                p.copy_(0.02 * torch.randn(p.shape, generator=g))
    return model
