"""Seeded random weights, made on the device in a few large calls.

One normal draw of a `torch.Generator` on the device fills one flat buffer
in the serving dtype; each parameter is a view of it at an offset aligned
to 256 bytes (the kernels read 16-byte aligned rows and build TMA maps over
their weights), then scaled in place by flax's default initialisers, which
the port's `init_flax_style` follows: a kernel by 1 / sqrt(fan_in) (lecun
normal), an embedding by 1 / sqrt(width), biases 0, norm scales 1,
AudioLDM2's start and end embeddings by 0.02. The rule reads a parameter's
name and shape only, in the port's layouts: Dense (in, out), conv2d (out,
in, kh, kw), conv1d (k, in, out), the vocoder's transposed convs (k, in,
out) with flax's fan-in k * out.
"""

import math

import torch

ALIGN = 256   # bytes
EMBEDDINGS = ("word_embeddings.weight", "position_embeddings.weight",
              "token_type_embeddings.weight", "shared.weight", "wpe.weight",
              "relative_attention_bias.weight")
SPECIAL = ("sos_embed", "eos_embed", "sos_embed_1", "eos_embed_1")


def scale_of(name: str, shape) -> float:
    """The init rule: the factor a unit normal draw is multiplied by."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in SPECIAL:
        return 0.02
    if name.endswith(EMBEDDINGS):
        return 1.0 / math.sqrt(shape[1])
    if leaf == "bias":
        return 0.0
    if len(shape) == 1:
        return 1.0               # a norm's scale: filled with 1, not drawn
    if len(shape) == 4:
        fan_in = shape[1] * shape[2] * shape[3]
    elif len(shape) == 3:
        fan_in = shape[0] * (shape[2] if ".upsampler_" in f".{name}" else shape[1])
    else:
        fan_in = shape[0]
    return 1.0 / math.sqrt(fan_in)


def make(shapes: dict, seed: int, device, dtype) -> dict:
    """{model: {name: tensor}} for `shapes` {model: {name: shape}}: one flat
    buffer of `dtype` on `device`, drawn by one generator seeded with
    `seed`."""
    per = ALIGN // torch.empty((), dtype=dtype).element_size()
    layout, total = [], 0
    for model, named in shapes.items():
        for name, shape in named.items():
            n = math.prod(shape)
            layout.append((model, name, tuple(shape), total, n))
            total += -(-n // per) * per
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    out = {m: {} for m in shapes}
    for model, name, shape, off, n in layout:
        t = flat[off:off + n].view(shape)
        s = scale_of(name, shape)
        if s == 0.0:
            t.zero_()
        elif len(shape) == 1 and name.rsplit(".", 1)[-1] not in SPECIAL:
            t.fill_(1.0)
        else:
            t.mul_(s)
        out[model][name] = t
    return out
