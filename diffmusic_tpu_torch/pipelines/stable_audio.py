"""StableAudio pipeline: a T5-conditioned DiT over Oobleck waveform latents
(port of `diffmusic_tpu/pipelines/stable_audio.py`).

T5 sequence features and the learned duration conditioners
(StableAudioProjectionModel) condition the StableAudioDiTModel; EDM
DPM-Solver++ (2M) samples its latents, under classifier-free guidance when
`guidance_scale > 1`; AutoencoderOobleck decodes them to stereo audio at the
VAE's rate. Text-to-music only: no operator and no guided loss (run.py
refuses the other tasks).

Under CFG the DiT's batch is [x; x] (each waveform's latents twice), so each
conditioning row is repeated in place, `repeat_interleave` as JAX's
`jnp.repeat`: [u, u, u, c, c, c] for 3 waveforms. `Tensor.repeat` would tile
[u, c, u, c, u, c] and guide each waveform with the wrong half.

The DiT and the VAE run in their weights' dtype; the latents, the solver and
the guidance combine are fp32. Latents come from a `torch.Generator` (on
the device unless the caller passes another), or are passed in.
"""

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..inverse_problem.noise import randn
from ..models.configs import (OobleckConfig, StableAudioDiTConfig, StableAudioProjectionConfig,
                              T5Config, tiny_oobleck_config, tiny_stable_audio_dit_config,
                              tiny_t5_config)
from ..models.convert import init_flax_style
from ..models.oobleck import AutoencoderOobleck
from ..models.stable_audio_dit import StableAudioDiTModel, StableAudioProjectionModel
from ..models.t5 import T5EncoderModel
from ..parallel.mesh import Mesh
from ..samplers.edm import EDMDPMSolverMultistepSchedule, make_edm_sampler
from .base import AudioPipelineOutput
from .musicldm import _dtype


def repeat_rows(a: torch.Tensor, batch: int) -> torch.Tensor:
    """Each row `batch` times in place, as `jnp.repeat(a, batch, axis=0)`:
    [u, c] -> [u, u, u, c, c, c], matching the DiT batch [x; x]."""
    return a.repeat_interleave(batch, dim=0)


def stable_audio_byte_tokenizer(texts, maxlen: int = 12):
    """The JAX tiny StableAudio pipeline's vocabulary-free tokenizer: the
    prompt's UTF-8 bytes mapped into [2, 252), then T5's </s> (1), then
    padding (0). Numpy (ids, attention_mask), (len(texts), maxlen) int32."""
    ids = np.zeros((len(texts), maxlen), np.int32)
    mask = np.zeros((len(texts), maxlen), np.int32)
    for i, t in enumerate(texts):
        row = [2 + (c % 250) for c in list(t.encode("utf-8"))[:maxlen - 1]] + [1]
        ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    return ids, mask


@dataclass
class StableAudioPipeline:
    dit: StableAudioDiTModel
    vae: AutoencoderOobleck
    text_encoder: T5EncoderModel
    projection: StableAudioProjectionModel
    schedule: EDMDPMSolverMultistepSchedule = field(
        default_factory=EDMDPMSolverMultistepSchedule)
    tokenizer: Optional[Callable] = None   # texts -> numpy (ids, attention_mask)
    dtype: torch.dtype = torch.float32     # latents and solver
    # a dp x tp mesh: every rank runs the whole batch (the JAX pipeline
    # shards nothing of its own either)
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        for m in (self.dit, self.vae, self.text_encoder, self.projection):
            m.requires_grad_(False)
            m.eval()
        self.dit_cfg = self.dit.cfg
        self.vae_cfg = self.vae.cfg
        self.text_cfg = self.text_encoder.cfg
        self.proj_cfg = self.projection.cfg

    @property
    def device(self) -> torch.device:
        return next(self.dit.parameters()).device

    # ------------------------------------------------------------------ text
    def encode_prompt(self, prompt, negative_prompt=None, do_classifier_free_guidance=True):
        """T5 sequence embeddings with padded positions zeroed, CFG-stacked
        [uncond; cond]."""
        if self.tokenizer is None:
            raise ValueError("No tokenizer configured; pass prompt_embeds instead")
        texts = ([negative_prompt or "", prompt or ""] if do_classifier_free_guidance
                 else [prompt or ""])
        ids, mask = self.tokenizer(texts)
        ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        mask = torch.as_tensor(mask, dtype=torch.long, device=self.device)
        emb = self.text_encoder(ids, mask)
        return emb * mask.to(emb.dtype)[..., None]

    def _conditioning(self, prompt_embeds, seconds_start, seconds_total):
        return self.projection(prompt_embeds, seconds_start, seconds_total)

    # --------------------------------------------------------------- denoise
    @torch.no_grad()
    def __call__(self,
                 prompt: Optional[str] = None,
                 negative_prompt: Optional[str] = None,
                 audio_end_in_s: Optional[float] = None,
                 audio_start_in_s: float = 0.0,
                 num_inference_steps: int = 100,
                 guidance_scale: float = 7.0,
                 num_waveforms_per_prompt: int = 1,
                 generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None,
                 prompt_embeds: Optional[torch.Tensor] = None,
                 output_type: str = "np",
                 **_ignored):
        """JAX's signature and defaults (`key` becomes `generator`; run.py's
        guidance arguments are ignored, as there). Returns the audio (B,
        audio_channels, length) as numpy fp32, or the final latents with
        output_type "latent"."""
        device = self.device
        sr, hop = self.vae_cfg.sampling_rate, self.vae_cfg.hop_length
        if audio_end_in_s is None:
            audio_end_in_s = self.dit_cfg.sample_size * hop / sr
        length = int(audio_end_in_s * sr)
        latent_t = int(np.ceil(length / hop))

        do_cfg = guidance_scale > 1.0
        if prompt_embeds is None:
            prompt_embeds = self.encode_prompt(prompt, negative_prompt, do_cfg)
        prompt_embeds = torch.as_tensor(prompt_embeds, device=device)
        batch = num_waveforms_per_prompt
        n_cond = prompt_embeds.shape[0]   # 2 with CFG, else 1
        seconds = (torch.full((n_cond,), float(audio_start_in_s), device=device),
                   torch.full((n_cond,), float(audio_end_in_s), device=device))
        text_ctx, global_states = self._conditioning(prompt_embeds, *seconds)

        if latents is None:
            if generator is None:
                generator = torch.Generator(device).manual_seed(0)
            latents = randn((batch, self.dit_cfg.in_channels, latent_t), generator,
                            self.dtype, device)
        latents = torch.as_tensor(latents, device=device)
        batch = latents.shape[0]

        # the network boundary is the DiT's dtype (a bf16 checkpoint must not
        # carry its 24-layer stream in fp32); the solver around it stays fp32
        dt = _dtype(self.dit)
        ctx, glob = repeat_rows(text_ctx.to(dt), batch), repeat_rows(global_states.to(dt), batch)

        def model_fn(x, t):
            x = x.to(dt)
            if do_cfg:
                tt = torch.full((2 * batch,), t, dtype=torch.float32, device=device)
                out = self.dit(torch.cat([x, x]), tt, ctx, glob).float()
                uncond, cond = out.chunk(2)
                return uncond + guidance_scale * (cond - uncond)
            tt = torch.full((batch,), t, dtype=torch.float32, device=device)
            return self.dit(x, tt, ctx, glob).float()

        final = make_edm_sampler(self.schedule, num_inference_steps, model_fn)(latents)
        if output_type == "latent":
            return AudioPipelineOutput(audios=final.cpu().numpy())
        audio = self.vae.decode(final.to(_dtype(self.vae)))
        return AudioPipelineOutput(audios=audio[:, :, :length].float().cpu().numpy())

    # ------------------------------------------------------------- factories
    @classmethod
    def random(cls, dit_cfg: StableAudioDiTConfig, vae_cfg: OobleckConfig, text_cfg: T5Config,
               proj_cfg: StableAudioProjectionConfig, seed: int = 0, device="cuda",
               weight_dtype=torch.float32, draw_on_device: bool = False, **kwargs):
        """Seeded flax-style random weights for the four models, model i from
        seed + i, cast to `weight_dtype` on `device` (the card unless the
        caller asks for the CPU). The draws are made on the CPU, so that a
        seed gives the same weights on every device, or with
        `draw_on_device` on the device itself (fast at full width)."""
        with torch.device(device) if draw_on_device else contextlib.nullcontext():
            models = [StableAudioDiTModel(dit_cfg), AutoencoderOobleck(vae_cfg),
                      T5EncoderModel(text_cfg), StableAudioProjectionModel(proj_cfg)]
        out = [init_flax_style(m, seed + i, on_device=draw_on_device).to(
            device=device, dtype=weight_dtype) for i, m in enumerate(models)]
        return cls(*out, **kwargs)

    @classmethod
    def from_pretrained(cls, checkpoint_dir, schedule=None, device="cuda",
                        weight_dtype=torch.float32, **_):
        """Load from a local HF-snapshot directory (`models/checkpoint.py`),
        on the card unless the caller asks for the CPU."""
        from ..models.checkpoint import load_stable_audio
        return load_stable_audio(checkpoint_dir, schedule=schedule, device=device,
                                 weight_dtype=weight_dtype)

    @classmethod
    def tiny(cls, seed: int = 0, device="cuda", weight_dtype=torch.float32):
        """Seeded random weights at the JAX package's tiny configs, with its
        byte tokenizer (12 tokens)."""
        dit_cfg, vae_cfg, txt_cfg = (tiny_stable_audio_dit_config(), tiny_oobleck_config(),
                                     tiny_t5_config())
        proj_cfg = StableAudioProjectionConfig(
            text_encoder_dim=txt_cfg.d_model,
            conditioning_dim=dit_cfg.cross_attention_input_dim, max_value=64.0)
        return cls.random(dit_cfg, vae_cfg, txt_cfg, proj_cfg, seed=seed, device=device,
                          weight_dtype=weight_dtype, tokenizer=stable_audio_byte_tokenizer)
