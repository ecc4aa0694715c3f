"""Model configs of the MusicLDM, AudioLDM2 and StableAudio slices.

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


def tiny_unet_config(cross_attention_dims: Tuple[int, ...] = ()) -> UNetConfig:
    return UNetConfig(
        sample_size=16, in_channels=8, out_channels=8,
        block_out_channels=(16, 32), layers_per_block=1,
        attention_head_dim=8, norm_num_groups=8,
        cross_attention_dims=cross_attention_dims,
        class_embed_type="simple_projection" if not cross_attention_dims else None,
        projection_class_embeddings_input_dim=32 if not cross_attention_dims else None,
        class_embeddings_concat=not cross_attention_dims,
        has_attention=(True, True),
    )


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


def tiny_vae_config() -> VAEConfig:
    return VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                     norm_num_groups=8, latent_channels=8, scaling_factor=0.5)


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


def tiny_hifigan_config() -> HiFiGANConfig:
    return HiFiGANConfig(model_in_dim=64, upsample_initial_channel=32,
                         upsample_rates=(5, 4, 2, 2, 2),
                         upsample_kernel_sizes=(16, 16, 8, 4, 4),
                         resblock_kernel_sizes=(3,),
                         resblock_dilation_sizes=((1, 3),))


@dataclass(frozen=True)
class ClapTextConfig:
    """CLAP text tower (RoBERTa encoder) + 2-layer MLP projection head."""
    vocab_size: int = 50265
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 1
    projection_dim: int = 512
    projection_hidden_act: str = "relu"


def tiny_clap_text_config() -> ClapTextConfig:
    return ClapTextConfig(vocab_size=256, hidden_size=32, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=64,
                          max_position_embeddings=64, projection_dim=32)


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 1024
    d_kv: int = 64
    d_ff: int = 2816
    num_layers: int = 24
    num_heads: int = 16
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    is_gated_act: bool = True  # flan-t5 uses gated-gelu


def tiny_t5_config() -> T5Config:
    return T5Config(vocab_size=256, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                    num_heads=4)


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5


def tiny_gpt2_config() -> GPT2Config:
    return GPT2Config(vocab_size=256, n_positions=64, n_embd=32, n_layer=2,
                      n_head=4)


@dataclass(frozen=True)
class OobleckConfig:
    """AutoencoderOobleck (stable-audio-open waveform VAE) config; field names
    mirror diffusers' autoencoder_oobleck.py config.json keys."""
    encoder_hidden_size: int = 128
    downsampling_ratios: Tuple[int, ...] = (2, 4, 4, 8, 8)
    channel_multiples: Tuple[int, ...] = (1, 2, 4, 8, 16)
    decoder_channels: int = 128
    decoder_input_channels: int = 64
    audio_channels: int = 2
    sampling_rate: int = 44100

    @property
    def hop_length(self) -> int:
        out = 1
        for r in self.downsampling_ratios:
            out *= r
        return out


def tiny_oobleck_config() -> OobleckConfig:
    return OobleckConfig(encoder_hidden_size=8, downsampling_ratios=(2, 4),
                         channel_multiples=(1, 2), decoder_channels=8,
                         decoder_input_channels=4, audio_channels=2,
                         sampling_rate=16000)


@dataclass(frozen=True)
class StableAudioDiTConfig:
    """StableAudioDiTModel config (diffusers stable_audio_transformer.py keys)."""
    sample_size: int = 1024
    in_channels: int = 64
    num_layers: int = 24
    attention_head_dim: int = 64
    num_attention_heads: int = 24
    num_key_value_attention_heads: int = 12
    out_channels: int = 64
    cross_attention_dim: int = 768
    time_proj_dim: int = 256
    global_states_input_dim: int = 1536
    cross_attention_input_dim: int = 768

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def rotary_dim(self) -> int:
        return self.attention_head_dim // 2


def tiny_stable_audio_dit_config() -> StableAudioDiTConfig:
    return StableAudioDiTConfig(
        sample_size=32, in_channels=4, num_layers=2, attention_head_dim=8,
        num_attention_heads=4, num_key_value_attention_heads=2, out_channels=4,
        cross_attention_dim=16, time_proj_dim=8, global_states_input_dim=32,
        cross_attention_input_dim=16)


@dataclass(frozen=True)
class StableAudioProjectionConfig:
    """StableAudioProjectionModel: T5 text projection + two learned
    number-conditioners for seconds_start / seconds_total."""
    text_encoder_dim: int = 768
    conditioning_dim: int = 768
    min_value: float = 0.0
    max_value: float = 512.0


def tiny_stable_audio_projection_config() -> StableAudioProjectionConfig:
    return StableAudioProjectionConfig(text_encoder_dim=16, conditioning_dim=16,
                                       max_value=64.0)


@dataclass(frozen=True)
class ProjectionConfig:
    """AudioLDM2ProjectionModel: per-stream linear + learned SOS/EOS embeds."""
    text_encoder_dim: int = 512       # CLAP pooled
    text_encoder_1_dim: int = 1024    # T5
    langauge_model_dim: int = 768     # GPT-2 (sic: diffusers spells it this way)


def tiny_projection_config() -> ProjectionConfig:
    return ProjectionConfig(text_encoder_dim=16, text_encoder_1_dim=32,
                            langauge_model_dim=32)
