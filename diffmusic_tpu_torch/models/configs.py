"""Model configs of the MusicLDM slice.

Field for field the dataclasses of `diffmusic_tpu/models/configs.py`, copied so
that this package never imports the JAX package; a JAX config converts with
`type(cfg)(**dataclasses.asdict(jax_cfg))`.
"""

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 128
    in_channels: int = 8
    out_channels: int = 8
    block_out_channels: Tuple[int, ...] = (128, 256, 384, 640)
    layers_per_block: int = 2
    attention_head_dim: int = 8           # dim per head (diffusers convention)
    norm_num_groups: int = 32
    # cross-attention streams: () = self-attention only (MusicLDM)
    cross_attention_dims: Tuple[int, ...] = ()
    # class conditioning (MusicLDM: CLAP 512-d pooled embedding)
    class_embed_type: Optional[str] = "simple_projection"
    projection_class_embeddings_input_dim: Optional[int] = 512
    class_embeddings_concat: bool = True
    has_attention: Tuple[bool, ...] = (True, True, True, False)

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 1
    out_channels: int = 1
    latent_channels: int = 8
    block_out_channels: Tuple[int, ...] = (128, 256, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215

    @property
    def scale_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


@dataclass(frozen=True)
class HiFiGANConfig:
    """transformers SpeechT5HifiGanConfig field names."""
    model_in_dim: int = 64
    sampling_rate: int = 16000
    upsample_initial_channel: int = 1024
    upsample_rates: Tuple[int, ...] = (5, 4, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 8, 4, 4)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    leaky_relu_slope: float = 0.1
    normalize_before: bool = False

    @property
    def hop_length(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out
