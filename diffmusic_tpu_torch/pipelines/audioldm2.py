"""AudioLDM2 pipeline for music inverse problems (port of
`diffmusic_tpu/pipelines/audioldm2.py`).

The prompt goes through two text encoders, CLAP (pooled) and T5 (sequence);
the projection model maps both into GPT-2's width between learned SOS/EOS
tokens, and GPT-2 generates 8 hidden states from them in embedding space.
The UNet attends to the generated states and to the T5 sequence (two
cross-attention streams); the guided denoise loop is MusicLDM's.

Ported: text prompts through the whole text stack, `prompt_type="clap"`
(the measurement's pooled CLAP audio embedding, through the HTSAT tower, in
the CLAP text embedding's place), the TTS variant (the VITS encoding of the
transcription in T5's place: the second stream is always VITS's, the
transcription's for the prompt and the empty one's for the negative
prompt), `prompt_embeds`, the degenerate-CFG skip over the stream tuple,
`optim_prompt` over the GPT-2 states and the second stream (its mask is
carried as it is), DITTO, `score_waveforms` (MusicLDM's), `from_pretrained`
and `tiny`.
"""

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..inverse_problem.operator import IdentityOperator
from ..models.clap import ClapTextModelWithProjection
from ..models.clap_features import make_tiny_clap_audio_embeds
from ..models.configs import (ClapTextConfig, GPT2Config, HiFiGANConfig, ProjectionConfig,
                              T5Config, UNetConfig, VAEConfig, tiny_clap_text_config,
                              tiny_gpt2_config, tiny_hifigan_config, tiny_t5_config,
                              tiny_unet_config, tiny_vae_config)
from ..models.gpt2 import GPT2Model, generate_hidden_states
from ..models.hifigan import SpeechT5HifiGan
from ..models.projection import AudioLDM2ProjectionModel
from ..models.t5 import T5EncoderModel
from ..models.unet import UNet2DConditionModel
from ..models.vae import AutoencoderKL
from ..models.vits import VitsConfig, VitsTextEncoder
from ..tracing import annotate
from .base import byte_tokenizer
from .musicldm import MusicLDMPipeline, _dtype

GENERATED_STATES = 8   # GPT-2 generation steps, as the JAX package's max_new_tokens


@dataclass
class AudioLDM2Pipeline(MusicLDMPipeline):
    """MusicLDM's geometry, loss and guided loop; AudioLDM2's prompt encoding
    and UNet conditioning. `text_encoder` is the CLAP text tower; `vits`
    (the TTS variant) takes T5's place."""
    t5: Optional[T5EncoderModel] = None
    gpt2: Optional[GPT2Model] = None
    projection: Optional[AudioLDM2ProjectionModel] = None
    t5_tokenizer: Optional[Callable] = None
    max_new_tokens: int = GENERATED_STATES
    vits: Optional[VitsTextEncoder] = None
    vits_tokenizer: Optional[Callable] = None

    def _models(self):
        return super()._models() + [m for m in (self.t5, self.vits, self.gpt2, self.projection)
                                    if m is not None]

    @classmethod
    def random(cls, unet_cfg: UNetConfig, vae_cfg: VAEConfig, vocoder_cfg: HiFiGANConfig,
               seed: int = 0, device="cuda", weight_dtype=torch.float32,
               text_cfg: ClapTextConfig = ClapTextConfig(), t5_cfg: T5Config = T5Config(),
               gpt2_cfg: GPT2Config = GPT2Config(),
               proj_cfg: ProjectionConfig = ProjectionConfig(), fuse_cross: bool = False,
               gn_mode: str = "plain", conv2d_kernel: bool = False, mask_kernel: bool = False,
               bsoft: bool = False, canvas: str = "off", stage_bwd: bool = False,
               conv2d_bwd: str = "plain", vae_mid_attn: str = "plain",
               adjoint_kernel: bool = False, vits_cfg: Optional[VitsConfig] = None, **kwargs):
        """Seeded flax-style random weights for all seven models, cast to
        `weight_dtype` on `device` (the card unless the caller asks for the
        CPU), with the byte tokenizer for both text encoders unless
        `tokenizer` / `t5_tokenizer` are given. With `vits_cfg` the second
        text encoder is the TTS variant's VITS in T5's place. `fuse_cross`
        routes the UNet's long dual-cross blocks to the fused block kernel;
        `gn_mode`, `conv2d_kernel`, `conv2d_bwd`, `mask_kernel`, `bsoft`,
        `canvas`, `stage_bwd`, `vae_mid_attn` and `adjoint_kernel` are
        `MusicLDMPipeline.random`'s route flags."""
        routes = dict(gn_mode=gn_mode, conv2d_kernel=conv2d_kernel, conv2d_bwd=conv2d_bwd)
        second = VitsTextEncoder(vits_cfg) if vits_cfg is not None else T5EncoderModel(t5_cfg)
        models = cls._random_models(
            [UNet2DConditionModel(unet_cfg, fuse_cross=fuse_cross, bsoft=bsoft, **routes),
             AutoencoderKL(vae_cfg, vae_mid_attn=vae_mid_attn, **routes),
             SpeechT5HifiGan(vocoder_cfg, mask_kernel=mask_kernel, canvas=canvas,
                             stage_bwd=stage_bwd, adjoint_kernel=adjoint_kernel),
             ClapTextModelWithProjection(text_cfg),
             second, GPT2Model(gpt2_cfg), AudioLDM2ProjectionModel(proj_cfg)],
            seed, device, weight_dtype)
        kwargs.setdefault("tokenizer", byte_tokenizer)
        kwargs.setdefault("t5_tokenizer", byte_tokenizer)
        kwargs["vits" if vits_cfg is not None else "t5"] = models[4]
        return cls(*models[:3], text_encoder=models[3], gpt2=models[5],
                   projection=models[6], **kwargs)

    # ------------------------------------------------------------------ text
    def _encode_one(self, text: str, measurement: Optional[torch.Tensor] = None,
                    prompt_type: Optional[str] = None, transcription: str = ""):
        """One prompt -> (generated GPT-2 states (1, 8, 768), second stream
        (1, L, width), its mask (1, L)). The first stream is the prompt's
        normalised CLAP text embedding, or with prompt_type "clap" the
        measurement's CLAP audio embedding; the second is T5's encoding of
        the prompt, or VITS's of the transcription in the TTS variant. Each
        stage is a span: "text.clap", "text.t5" (VITS in the TTS variant),
        "text.projection", "text.gpt2"."""
        if prompt_type == "clap" and self.clap_audio_embed is None:
            raise ValueError("prompt_type='clap' requires a CLAP audio tower "
                             "(clap_audio_embed); load one via from_pretrained")
        if transcription and self.vits is None:
            raise ValueError("transcription (TTS) requires the AudioLDM2-TTS variant with a "
                             "VITS text encoder; load one via from_pretrained")
        with annotate("text.clap"):
            if prompt_type == "clap":
                clap = self.clap_audio_embed(measurement).float()
            else:
                clap = self._clap_text(text)
        proj_dt = _dtype(self.projection)
        clap = clap[:, None].to(proj_dt)                                 # (1, 1, 512)
        clap_mask = torch.ones(clap.shape[:2], dtype=torch.long, device=clap.device)
        with annotate("text.t5"):
            if self.vits is not None:
                ids, mask = self._tokens([transcription],
                                         self.vits_tokenizer or self.t5_tokenizer)
                seq = self.vits(ids, mask)
            else:
                ids, mask = self._tokens([text], self.t5_tokenizer)
                seq = self.t5(ids, mask)
        with annotate("text.projection"):
            projected, proj_mask = self.projection(clap, seq.to(proj_dt), clap_mask, mask)
        with annotate("text.gpt2"):
            generated = generate_hidden_states(self.gpt2, projected.to(_dtype(self.gpt2)),
                                               proj_mask, self.max_new_tokens)
        return generated, seq, mask

    def encode_prompt(self, prompt, negative_prompt=None, do_classifier_free_guidance=True,
                      measurement: Optional[torch.Tensor] = None,
                      prompt_type: Optional[str] = None, transcription: str = ""):
        """(generated, second stream, its mask), CFG-stacked [uncond; cond]
        with the second streams padded to a common length; the negative
        prompt is always text (and, in the TTS variant, the empty
        transcription)."""
        if (self.tokenizer is None and (prompt_type != "clap" or do_classifier_free_guidance)
                or (self.vits_tokenizer or self.t5_tokenizer) is None):
            raise ValueError("no tokenizers configured: pass prompt_embeds instead of a "
                             "text prompt")
        cond = self._encode_one(prompt or "", measurement, prompt_type, transcription)
        if not do_classifier_free_guidance:
            return cond
        uncond = self._encode_one(negative_prompt or "")
        length = max(cond[1].shape[1], uncond[1].shape[1])

        def pad(seq, mask):
            d = length - seq.shape[1]
            return F.pad(seq, (0, 0, 0, d)), F.pad(mask, (0, d))

        (nseq, nmask), (seq, mask) = pad(*uncond[1:]), pad(*cond[1:])
        return (torch.cat([uncond[0], cond[0]]), torch.cat([nseq, seq]),
                torch.cat([nmask, mask]))

    # --------------------------------------------------------------- denoise
    def _apply_unet(self, prompt_embeds, x_in, t: int):
        """Dual-stream conditioning: the GPT-2 generated states, then the T5
        sequence with its mask."""
        generated, t5_seq, t5_mask = prompt_embeds
        dt = _dtype(self.unet)
        ts = torch.full((x_in.shape[0],), t, device=x_in.device)
        return self.unet(x_in.to(dt), ts, encoder_hidden_states=generated.to(dt),
                         encoder_hidden_states_1=t5_seq.to(dt),
                         encoder_attention_mask_1=t5_mask).to(x_in.dtype)

    def _optim_prompt_split(self, prompt_embeds):
        """The GPT-2 states and the T5 sequence are optimized; the T5 mask is
        carried as it is."""
        generated, t5_seq, t5_mask = prompt_embeds
        return (generated, t5_seq), lambda d: (d[0], d[1], t5_mask)

    @torch.no_grad()
    def __call__(self, prompt: Optional[str] = None, measurement=None,
                 prompt_type: Optional[str] = None, guidance_scale: float = 3.5,
                 negative_prompt: Optional[str] = None, prompt_embeds=None,
                 transcription: str = "", **kwargs):
        if prompt_embeds is None:
            if measurement is not None:
                measurement = torch.as_tensor(measurement, dtype=torch.float32,
                                              device=self.device)
            prompt_embeds = self.encode_prompt(prompt, negative_prompt, guidance_scale > 1.0,
                                               measurement, prompt_type, transcription)
        return super().__call__(prompt=prompt, measurement=measurement,
                                guidance_scale=guidance_scale, negative_prompt=negative_prompt,
                                prompt_embeds=prompt_embeds, **kwargs)

    # ------------------------------------------------------------- factories
    @classmethod
    def from_pretrained(cls, checkpoint_dir, scheduler_name: str = "ddim", operator=None,
                        schedule=None, device="cuda", weight_dtype=torch.float32,
                        fuse_cross: bool = False, **routes):
        """Load from a local HF-snapshot directory (`models/checkpoint.py`),
        on the card unless the caller asks for the CPU."""
        from ..models.checkpoint import load_audioldm2
        return load_audioldm2(checkpoint_dir, scheduler_name=scheduler_name, operator=operator,
                              schedule=schedule, device=device, weight_dtype=weight_dtype,
                              fuse_cross=fuse_cross, **routes)

    @classmethod
    def tiny(cls, scheduler_name: str = "ddim", operator=None, seed: int = 0, device="cuda",
             weight_dtype=torch.float32, tts: bool = False, **routes):
        """Seeded random weights at the JAX package's tiny configs for all
        seven models and the tiny CLAP audio tower, with the byte tokenizer
        (12 tokens) for both text encoders. `tts` builds the TTS variant: a
        2-layer VITS of T5's width (its vocabulary the byte tokenizer's 256)
        in T5's place."""
        txt, t5, gpt2 = tiny_clap_text_config(), tiny_t5_config(), tiny_gpt2_config()
        audio_embed, frame_embed = make_tiny_clap_audio_embeds(seed + 99, txt.projection_dim,
                                                               device)
        vits_cfg = VitsConfig(vocab_size=256, hidden_size=t5.d_model, num_hidden_layers=2,
                              num_attention_heads=2, ffn_dim=32) if tts else None
        return cls.random(tiny_unet_config(cross_attention_dims=(gpt2.n_embd, t5.d_model)),
                          tiny_vae_config(), tiny_hifigan_config(), seed=seed, device=device,
                          weight_dtype=weight_dtype, text_cfg=txt, t5_cfg=t5, gpt2_cfg=gpt2,
                          proj_cfg=ProjectionConfig(txt.projection_dim, t5.d_model,
                                                    gpt2.n_embd),
                          vits_cfg=vits_cfg, scheduler_name=scheduler_name,
                          operator=operator if operator is not None else IdentityOperator(),
                          clap_audio_embed=audio_embed, clap_frame_embed=frame_embed, **routes)
