"""MusicLDM pipeline for music inverse problems (port of
`diffmusic_tpu/pipelines/musicldm.py`).

One guided step: the UNet forward under `torch.no_grad()`, the DDIM algebra,
then the guidance loss || y - mel(A(vocoder(VAE.decode(x0)))) || per clip and
its gradient with respect to x_t, through the mel transform, HiFi-GAN and the
VAE decoder. Weights are frozen (`requires_grad_(False)`): guidance
differentiates activations only.

Ported: the `ddim` and `dps` samplers with `prompt_embeds`, the degenerate-CFG
skip and the NaN retry. Still to be ported: the CLAP text tower (a text prompt
raises), the other samplers, DITTO and `optim_prompt`.
"""

from dataclasses import dataclass, field
from typing import Optional

import torch

from ..inverse_problem.operator import BaseOperator, IdentityOperator
from ..models.configs import HiFiGANConfig, UNetConfig, VAEConfig
from ..models.convert import init_flax_style
from ..models.hifigan import SpeechT5HifiGan
from ..models.unet import UNet2DConditionModel
from ..models.vae import AutoencoderKL
from ..samplers import DiffusionSchedule, SamplerConfig, make_step_fn
from .base import (AudioPipelineOutput, compute_geometry, denoise_with_nan_retry,
                   prepare_latents, run_denoise_loop)


def _dtype(module: torch.nn.Module) -> torch.dtype:
    return next(module.parameters()).dtype


def per_clip_loss(target: torch.Tensor, op: BaseOperator, audio: torch.Tensor,
                  supervised_space: str) -> torch.Tensor:
    """Sum over clips of || target - A(audio) ||_F, in the supervision space."""
    pred = op.forward(audio)
    diff = target - (op.transform(pred) if supervised_space == "mel_spectrogram" else pred)
    return diff.reshape(diff.shape[0], -1).square().sum(1).sqrt().sum()


@dataclass
class MusicLDMPipeline:
    unet: UNet2DConditionModel
    vae: AutoencoderKL
    vocoder: SpeechT5HifiGan
    schedule: DiffusionSchedule = field(default_factory=DiffusionSchedule)
    scheduler_name: str = "ddim"
    operator: BaseOperator = field(default_factory=IdentityOperator)
    dtype: torch.dtype = torch.float32   # latents and guidance algebra

    def __post_init__(self):
        for m in (self.unet, self.vae, self.vocoder):
            m.requires_grad_(False)
            m.eval()
        self.unet_cfg = self.unet.cfg
        self.vae_cfg = self.vae.cfg
        self.vocoder_cfg = self.vocoder.cfg
        self.vae_scale_factor = self.vae_cfg.scale_factor

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    @classmethod
    def random(cls, unet_cfg: UNetConfig, vae_cfg: VAEConfig, vocoder_cfg: HiFiGANConfig,
               seed: int = 0, device="cpu", weight_dtype=torch.float32, **kwargs):
        """Seeded flax-style random weights (no checkpoint needed), cast to
        `weight_dtype` on `device`."""
        models = []
        for i, m in enumerate((UNet2DConditionModel(unet_cfg), AutoencoderKL(vae_cfg),
                               SpeechT5HifiGan(vocoder_cfg))):
            init_flax_style(m, seed + i)
            models.append(m.to(device=device, dtype=weight_dtype))
        return cls(*models, **kwargs)

    # ----------------------------------------------------------------- audio
    def decode_mel(self, latents: torch.Tensor) -> torch.Tensor:
        return self.vae.decode((latents / self.vae_cfg.scaling_factor).to(_dtype(self.vae)))

    def mel_to_waveform(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, 1, T, n_mels) or (B, T, n_mels) -> (B, L) via HiFi-GAN."""
        if mel.ndim == 4:
            mel = mel[:, 0]
        return self.vocoder(mel.to(_dtype(self.vocoder)))

    def make_loss_fn(self, measurement: torch.Tensor, original_waveform_length: int,
                     supervised_space: str = "mel_spectrogram"):
        """rec_loss(pred_x0_latent) = sum over clips of || y - A(decode(x0)) ||_F."""
        op = self.operator
        if supervised_space == "mel_spectrogram":
            target = op.transform(measurement)
        elif supervised_space == "wav_form":
            target = measurement
        else:
            raise ValueError(
                "supervised_space should be either 'wav_form' or 'mel_spectrogram'")

        def loss_fn(x0_latent):
            mel = self.decode_mel(x0_latent)
            audio = op.inverse_transform(mel, self.mel_to_waveform)
            # fp32 loss head whatever the weights' dtype
            audio = audio[:, :original_waveform_length].float()
            return per_clip_loss(target, op, audio, supervised_space)

        return loss_fn

    # --------------------------------------------------------------- denoise
    def _eps(self, prompt_embeds, x, t: int, guidance_scale: float):
        dt = _dtype(self.unet)
        if guidance_scale > 1.0:
            x_in = torch.cat([x, x], dim=0)
            ts = torch.full((x_in.shape[0],), t, device=x.device)
            eps = self.unet(x_in.to(dt), ts, class_labels=prompt_embeds.to(dt)).to(x.dtype)
            uncond, text = eps.chunk(2, dim=0)
            return uncond + guidance_scale * (text - uncond)
        ts = torch.full((x.shape[0],), t, device=x.device)
        return self.unet(x.to(dt), ts, class_labels=prompt_embeds.to(dt)).to(x.dtype)

    @staticmethod
    def _cfg_is_degenerate(prompt_embeds: torch.Tensor) -> bool:
        """True when the CFG-stacked [uncond; cond] halves are identical (an
        empty prompt with an empty negative prompt): then the CFG combine is
        the identity and one UNet row suffices -- exactly."""
        n = prompt_embeds.shape[0]
        return n > 0 and n % 2 == 0 and torch.equal(prompt_embeds[:n // 2],
                                                    prompt_embeds[n // 2:])

    @torch.no_grad()
    def __call__(self,
                 prompt: Optional[str] = None,
                 audio_length_in_s: Optional[float] = None,
                 num_inference_steps: int = 200,
                 guidance_scale: float = 2.0,
                 num_waveforms_per_prompt: int = 1,
                 eta: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None,
                 prompt_embeds: Optional[torch.Tensor] = None,
                 measurement: Optional[torch.Tensor] = None,
                 ip_guidance_rate: float = 1.0,
                 supervised_space: str = "mel_spectrogram",
                 output_type: str = "np",
                 return_losses: bool = False,
                 callback=None):
        device = self.device
        sr = self.vocoder_cfg.sampling_rate
        height, owl = compute_geometry(
            audio_length_in_s if audio_length_in_s is not None else 5.0,
            sr, self.vocoder_cfg.hop_length, self.vae_scale_factor)

        if prompt_embeds is None:
            raise ValueError("the CLAP text tower is not ported yet: pass prompt_embeds "
                             f"instead of a text prompt (got prompt={prompt!r})")
        prompt_embeds = torch.as_tensor(prompt_embeds, dtype=self.dtype, device=device)
        do_cfg = guidance_scale > 1.0
        if do_cfg and self._cfg_is_degenerate(prompt_embeds):
            prompt_embeds = prompt_embeds[prompt_embeds.shape[0] // 2:]
            guidance_scale = 1.0

        if latents is None:
            latents = prepare_latents(generator, num_waveforms_per_prompt,
                                      self.unet_cfg.in_channels, height,
                                      self.vocoder_cfg.model_in_dim,
                                      self.vae_scale_factor, self.dtype, device)
        latents = torch.as_tensor(latents, dtype=self.dtype, device=device)
        batch = latents.shape[0]
        if batch > 1:
            # [uncond*B, cond*B] under CFG, matching the cat([x, x]) in _eps
            prompt_embeds = prompt_embeds.repeat_interleave(batch, dim=0)

        cfg = SamplerConfig(name=self.scheduler_name, eta=eta,
                            ip_guidance_rate=ip_guidance_rate,
                            num_inference_steps=num_inference_steps)
        needs_guidance = self.scheduler_name != "ddim"
        if needs_guidance and measurement is None:
            raise ValueError(f"scheduler '{self.scheduler_name}' requires a measurement")
        loss_fn = None
        if measurement is not None and needs_guidance:
            measurement = torch.as_tensor(measurement, dtype=torch.float32, device=device)
            loss_fn = self.make_loss_fn(measurement, owl, supervised_space)
        step_fn = make_step_fn(self.schedule, cfg, loss_fn)
        timesteps = self.schedule.timesteps(num_inference_steps)

        def model_fn(x, t):
            return self._eps(prompt_embeds, x, t, guidance_scale)

        final, losses = denoise_with_nan_retry(
            lambda lat: run_denoise_loop(step_fn, model_fn, lat, timesteps, generator,
                                         callback),
            latents, generator)

        if output_type == "latent":
            out = AudioPipelineOutput(audios=final.cpu().numpy())
        else:
            audio = self.mel_to_waveform(self.decode_mel(final))[:, :owl]
            out = AudioPipelineOutput(audios=audio.float().cpu().numpy())
        if return_losses:
            return out, losses.cpu().numpy()
        return out
