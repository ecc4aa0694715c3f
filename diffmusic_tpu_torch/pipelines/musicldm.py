"""MusicLDM pipeline for music inverse problems (port of
`diffmusic_tpu/pipelines/musicldm.py`).

One guided step: the UNet forward under `torch.no_grad()`, the DDIM algebra,
then the guidance loss || y - mel(A(vocoder(VAE.decode(x0)))) || per clip and
its gradient with respect to x_t, through the mel transform, HiFi-GAN and the
VAE decoder. Weights are frozen (`requires_grad_(False)`): guidance
differentiates activations only.

Ported: the `ddim`, `dps`, `mpgd`, `dsg`, `diffmusic` and `ditto` samplers
under any operator of `inverse_problem`, `optim_prompt`, a text prompt
through the CLAP text tower (`encode_prompt`, with a `tokenizer` callable
returning numpy `(ids, mask)`) or `prompt_embeds`, the degenerate-CFG skip,
the NaN retry, phase retrieval's phase-aware output (`phase_aware`),
`from_pretrained` (a local checkpoint, `models/checkpoint.py`), `tiny`, and
with a CLAP audio tower (`clap_audio_embed`, `clap_frame_embed`:
`models/clap_features.py`) the style-guidance operator's frame features and
`score_waveforms`, the CLAP text-audio re-ranking of candidates, and a
dp x tp `mesh` (`parallel/mesh.py`): the batch of waveforms dp-sharded over
ranks, as the JAX package shards it over devices.

DITTO and `optim_prompt` are the two paths that differentiate through the
UNet. DITTO runs the DDIM chain with eta noise from the initial latents, one
`torch.utils.checkpoint` per step, takes the guidance loss once on the final
latents and updates the initial latents by SGD, `optim_outer_loop` times;
its noise is drawn once a call, before the chain, and every outer
iteration reuses it (JAX reuses one key). `optim_prompt` takes, at each
timestep with t % 30 == 1, one SGD step on the prompt embeddings along the
gradient of the loss of x0-hat through the UNet, then the sampler's step
with the new embeddings. Both run under `torch.enable_grad()` inside
`__call__`'s `torch.no_grad()`; the weights stay frozen.
"""

import functools
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ..inverse_problem.operator import (BaseOperator, IdentityOperator,
                                        PhaseRetrievalOperator)
from ..models.clap import ClapTextModelWithProjection, get_text_features
from ..models.clap_features import make_tiny_clap_audio_embeds
from ..models.configs import (HiFiGANConfig, UNetConfig, VAEConfig, tiny_clap_text_config,
                              tiny_hifigan_config, tiny_unet_config, tiny_vae_config)
from ..models.convert import init_flax_style
from ..models.hifigan import SpeechT5HifiGan
from ..models.unet import UNet2DConditionModel
from ..models.vae import AutoencoderKL
from ..ops.stft import magphase_spectrogram
from ..parallel.mesh import Mesh, shard_batch_dp, sharded_batch
from ..samplers import DiffusionSchedule, SamplerConfig, ditto_draws, make_step_fn
from ..tracing import annotate, mark_backward
from .base import (AudioPipelineOutput, byte_tokenizer, compute_geometry,
                   denoise_with_nan_retry, mel_spectrogram_to_waveform_with_phase,
                   prepare_latents, run_denoise_loop, run_ditto)


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
    text_encoder: Optional[ClapTextModelWithProjection] = None
    tokenizer: Optional[Callable] = None   # texts -> numpy (ids, attention_mask)
    clap_audio_embed: Optional[Callable] = None   # waveform -> pooled (B, D), normalised
    # waveform -> per-frame CLAP features (B, T', D), StyleGuidanceOperator's input
    clap_frame_embed: Optional[Callable] = None
    # a dp x tp mesh (parallel/mesh.py): each rank denoises its dp rows of the batch
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        for m in self._models():
            m.requires_grad_(False)
            m.eval()
        self.unet_cfg = self.unet.cfg
        self.vae_cfg = self.vae.cfg
        self.vocoder_cfg = self.vocoder.cfg
        self.vae_scale_factor = self.vae_cfg.scale_factor

    def _models(self):
        towers = {id(e.tower): e.tower for e in (self.clap_audio_embed, self.clap_frame_embed)
                  if hasattr(e, "tower")}
        return [m for m in (self.unet, self.vae, self.vocoder, self.text_encoder,
                            *towers.values()) if m is not None]

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    @staticmethod
    def _random_models(models, seed: int, device, weight_dtype):
        """Seeded flax-style random weights, model i from seed + i, cast to
        `weight_dtype` on `device`."""
        return [init_flax_style(m, seed + i).to(device=device, dtype=weight_dtype)
                for i, m in enumerate(models)]

    @classmethod
    def random(cls, unet_cfg: UNetConfig, vae_cfg: VAEConfig, vocoder_cfg: HiFiGANConfig,
               seed: int = 0, device="cuda", weight_dtype=torch.float32,
               gn_mode: str = "plain", conv2d_kernel: bool = False,
               mask_kernel: bool = False, bsoft: bool = False, canvas: str = "off",
               stage_bwd: bool = False, conv2d_bwd: str = "plain", vae_mid_attn: str = "plain",
               adjoint_kernel: bool = False, **kwargs):
        """Seeded flax-style random weights (no checkpoint needed), cast to
        `weight_dtype` on `device` (the card unless the caller asks for the
        CPU). The route flags pick the guided step's kernel routes, all off
        by default: `gn_mode` ("plain", "fused" or "stats") for the UNet and
        VAE GroupNorms, `conv2d_kernel` for their 3x3 convs and `conv2d_bwd`
        ("plain" or "kernel") for those convs' backward, `bsoft` for the
        UNet's fused blocks, `vae_mid_attn` ("plain" or "flash") for the VAE's
        mid-block attention, and for the vocoder `mask_kernel` (the backward's
        leaky-ReLU masks), `canvas` ("off", "xbwd" or "kernel"), `stage_bwd`
        and `adjoint_kernel` (the single convs' adjoint, `models/hifigan.py`)."""
        routes = dict(gn_mode=gn_mode, conv2d_kernel=conv2d_kernel, conv2d_bwd=conv2d_bwd)
        vocoder = SpeechT5HifiGan(vocoder_cfg, mask_kernel=mask_kernel, canvas=canvas,
                                  stage_bwd=stage_bwd, adjoint_kernel=adjoint_kernel)
        return cls(*cls._random_models([UNet2DConditionModel(unet_cfg, bsoft=bsoft, **routes),
                                        AutoencoderKL(vae_cfg, vae_mid_attn=vae_mid_attn,
                                                      **routes), vocoder],
                                       seed, device, weight_dtype), **kwargs)

    # ------------------------------------------------------------------ text
    def _tokens(self, texts, tokenizer=None):
        """numpy (ids, mask) from a tokenizer -> int64 tensors on the device."""
        ids, mask = (tokenizer or self.tokenizer)(texts)
        return (torch.as_tensor(ids, dtype=torch.long, device=self.device),
                torch.as_tensor(mask, dtype=torch.long, device=self.device))

    def _clap_text(self, text: str) -> torch.Tensor:
        """Normalised CLAP text embeds of one prompt, (1, projection_dim)."""
        return get_text_features(self.text_encoder, *self._tokens([text]))

    def encode_prompt(self, prompt, negative_prompt=None, do_classifier_free_guidance=True):
        """CLAP pooled text features, normalised, CFG-stacked [uncond; cond]."""
        if self.tokenizer is None or self.text_encoder is None:
            raise ValueError("no tokenizer and CLAP text tower configured: pass "
                             "prompt_embeds instead of a text prompt")
        emb = self._clap_text(prompt or "")
        if not do_classifier_free_guidance:
            return emb
        return torch.cat([self._clap_text(negative_prompt or ""), emb], dim=0)

    # -------------------------------------------------------------- ranking
    @torch.no_grad()
    def score_waveforms(self, text: str, audio, num_waveforms_per_prompt=None):
        """Candidates (N, L) at 16 kHz ranked by the cosine of their CLAP
        audio embeddings with the text's, best first, then the best
        `num_waveforms_per_prompt` kept: (audio, similarities) as numpy."""
        if self.clap_audio_embed is None:
            raise ValueError("score_waveforms requires a CLAP audio tower (clap_audio_embed); "
                             "load one via from_pretrained")
        audio = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        text_feat = self._clap_text(text or "")
        sim = (self.clap_audio_embed(audio) @ text_feat.T.float())[:, 0]
        order = torch.argsort(-sim, stable=True)
        if num_waveforms_per_prompt is not None:
            order = order[:num_waveforms_per_prompt]
        return audio[order].cpu().numpy(), sim[order].cpu().numpy()

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
        """rec_loss(pred_x0_latent) = sum over clips of || y - A(decode(x0)) ||_F.

        Its stages are the ranges "guided.vae" (the decode), "guided.vocoder"
        (the operator's inverse transform through HiFi-GAN) and
        "guided.loss_head" (the slice, the fp32 cast, the operator, its
        transform and the norm); while a profiler records, each stage's
        output also cuts the backward into "<stage>.backward" spans
        (`tracing.mark_backward`)."""
        op = self.operator
        if supervised_space == "mel_spectrogram":
            target = op.transform(measurement)
        elif supervised_space == "wav_form":
            target = measurement
        else:
            raise ValueError(
                "supervised_space should be either 'wav_form' or 'mel_spectrogram'")

        def loss_fn(x0_latent):
            with annotate("guided.vae"):
                mel = mark_backward(self.decode_mel(x0_latent), "guided.vae")
            with annotate("guided.vocoder"):
                audio = mark_backward(op.inverse_transform(mel, self.mel_to_waveform),
                                      "guided.vocoder")
            with annotate("guided.loss_head"):
                # fp32 loss head whatever the weights' dtype
                audio = audio[:, :original_waveform_length].float()
                return mark_backward(per_clip_loss(target, op, audio, supervised_space),
                                     "guided.loss_head")

        return loss_fn

    # --------------------------------------------------------------- denoise
    def _apply_unet(self, prompt_embeds, x_in, t: int):
        """The UNet's conditioning signature; MusicLDM feeds the CLAP embeds as
        class labels."""
        dt = _dtype(self.unet)
        ts = torch.full((x_in.shape[0],), t, device=x_in.device)
        return self.unet(x_in.to(dt), ts, class_labels=prompt_embeds.to(dt)).to(x_in.dtype)

    def _eps(self, prompt_embeds, x, t: int, guidance_scale: float):
        if guidance_scale > 1.0:
            eps = self._apply_unet(prompt_embeds, torch.cat([x, x], dim=0), t)
            uncond, text = eps.chunk(2, dim=0)
            return uncond + guidance_scale * (text - uncond)
        return self._apply_unet(prompt_embeds, x, t)

    @staticmethod
    def _cfg_is_degenerate(prompt_embeds) -> bool:
        """True when the CFG-stacked [uncond; cond] halves are identical in
        every stream (an empty prompt with an empty negative prompt): then the
        CFG combine is the identity and one UNet row suffices -- exactly."""
        def halves_equal(a):
            n = a.shape[0]
            return n > 0 and n % 2 == 0 and torch.equal(a[:n // 2], a[n // 2:])
        if isinstance(prompt_embeds, tuple):
            return all(halves_equal(a) for a in prompt_embeds)
        return halves_equal(prompt_embeds)

    def _on_device(self, a) -> torch.Tensor:
        """A stream of embeds on the device; float streams in the pipeline's
        dtype, masks as they are."""
        a = torch.as_tensor(a, device=self.device)
        return a.to(self.dtype) if a.is_floating_point() else a

    @staticmethod
    def _map_embeds(fn, prompt_embeds):
        """fn over each stream of a tuple of embeds, or over the one tensor."""
        if isinstance(prompt_embeds, tuple):
            return tuple(fn(a) for a in prompt_embeds)
        return fn(prompt_embeds)

    def phase_aware_output(self, audio: torch.Tensor, measurement: torch.Tensor,
                           owl: int) -> torch.Tensor:
        """Phase retrieval's output: the measurement is the linear |STFT|, so
        the waveform is rebuilt from it with the phase estimated from the
        audio, 4 alternating projections onto the magnitude-consistent set."""
        op = self.operator
        kw = dict(n_fft=op.n_fft, hop_length=op.hop_length, win_length=op.win_length)
        wav = audio
        for _ in range(4):
            _, phase = magphase_spectrogram(wav, **kw)
            wav = mel_spectrogram_to_waveform_with_phase(
                None, phase, sample_rate=op.sample_rate, original_waveform_length=owl,
                linear_magnitude=measurement, **kw)
        return wav

    def _optim_prompt_split(self, prompt_embeds):
        """(the differentiable part, rebuild fn) for prompt-embedding
        optimization."""
        return prompt_embeds, lambda d: d

    def ditto_objective(self, prompt_embeds, guidance_scale: float, loss_fn, cfg, timesteps,
                        draws, remat: bool = True):
        """DITTO's loss_of_init(init) -> (loss_fn(final latents), final
        latents): the plain DDIM chain with the eta noise `draws` (one per
        step), differentiable with respect to init, each step under a
        checkpoint unless `remat` is off. The loss is taken once, on the final
        latents: JAX backpropagates only the last step's loss too."""
        step_fn = make_step_fn(self.schedule, cfg, None)

        def model_fn(x, t):
            return self._eps(prompt_embeds, x, t, guidance_scale)

        def loss_of_init(init):
            final, _ = run_denoise_loop(step_fn, model_fn, init, timesteps, grad=True,
                                        remat=remat, draws=draws)
            return loss_fn(final), final
        return loss_of_init

    def _optim_prompt_model_fn(self, loss_fn, prompt_embeds, guidance_scale: float,
                               lr: float):
        """The model_fn of prompt optimization, for one run of the denoise
        loop: at each timestep with t % 30 == 1 it first takes one SGD step on
        the embeddings' differentiable part along d loss_fn(x0-hat(eps(embeds),
        t, x)) / d embeds, then returns eps with the embeddings as they stand."""
        diff, rebuild = self._optim_prompt_split(prompt_embeds)
        as_tuple = isinstance(diff, tuple)
        state = {"diff": diff if as_tuple else (diff,)}

        def embeds(parts):
            return rebuild(parts if as_tuple else parts[0])

        def model_fn(x, t):
            if t % 30 == 1:
                with torch.enable_grad():
                    leaves = tuple(d.detach().requires_grad_(True) for d in state["diff"])
                    eps = self._eps(embeds(leaves), x, t, guidance_scale)
                    grads = torch.autograd.grad(
                        loss_fn(self.schedule.pred_original(eps, t, x)), leaves)
                state["diff"] = tuple(d - lr * g for d, g in zip(state["diff"], grads))
            return self._eps(embeds(state["diff"]), x, t, guidance_scale)
        return model_fn

    @torch.no_grad()
    def __call__(self,
                 prompt: Optional[str] = None,
                 audio_length_in_s: Optional[float] = None,
                 num_inference_steps: int = 200,
                 guidance_scale: float = 2.0,
                 negative_prompt: Optional[str] = None,
                 num_waveforms_per_prompt: int = 1,
                 eta: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None,
                 prompt_embeds: Optional[torch.Tensor] = None,
                 measurement: Optional[torch.Tensor] = None,
                 ip_guidance_rate: float = 1.0,
                 optim_outer_loop: int = 1,
                 supervised_space: str = "mel_spectrogram",
                 output_type: str = "np",
                 return_losses: bool = False,
                 optim_prompt: bool = False,
                 optim_prompt_learning_rate: float = 1e-4,
                 show_progress: bool = False,
                 callback=None,
                 callback_steps: int = 1,
                 phase_aware: Optional[bool] = None,
                 **_ignored):
        """Sample under the operator's guidance, with the JAX package's
        arguments (`key` becomes `generator`; arguments the pipeline does not
        use, such as run.py's `prompt_type` for MusicLDM, are ignored as
        there). Under "ditto" the losses are those of each outer iteration.
        `phase_aware` (phase retrieval with a measurement only) rebuilds the
        output from the measured |STFT| with the phase of the decoded audio,
        by 4 alternating projections; None turns it on when the noiser's
        `sigma` is at most 1e-6 (off under Poisson noise), as the JAX package
        does by default.

        With a `mesh`, each rank denoises its dp rows of the batch (the
        `latents` passed in, or drawn, are the whole batch; `generator` must
        be seeded alike on every rank) and returns what one process returns
        for the whole batch; `callback` sees this rank's rows."""
        device = self.device
        sr = self.vocoder_cfg.sampling_rate
        height, owl = compute_geometry(
            audio_length_in_s if audio_length_in_s is not None else 5.0,
            sr, self.vocoder_cfg.hop_length, self.vae_scale_factor)

        do_cfg = guidance_scale > 1.0
        if prompt_embeds is None:
            prompt_embeds = self.encode_prompt(prompt, negative_prompt, do_cfg)
        prompt_embeds = self._map_embeds(self._on_device, prompt_embeds)
        if do_cfg and self._cfg_is_degenerate(prompt_embeds):
            prompt_embeds = self._map_embeds(lambda a: a[a.shape[0] // 2:], prompt_embeds)
            guidance_scale = 1.0

        mesh = self.mesh
        if latents is None:
            latents = prepare_latents(generator, num_waveforms_per_prompt,
                                      self.unet_cfg.in_channels, height,
                                      self.vocoder_cfg.model_in_dim,
                                      self.vae_scale_factor, self.dtype, device)
        latents = torch.as_tensor(latents, dtype=self.dtype, device=device)
        if mesh is not None:   # the whole batch's latents, drawn alike on every rank
            latents = shard_batch_dp(mesh, latents)
        batch = latents.shape[0]
        if batch > 1:
            # [uncond*B, cond*B] under CFG, matching the cat([x, x]) in _eps
            prompt_embeds = self._map_embeds(lambda a: a.repeat_interleave(batch, dim=0),
                                             prompt_embeds)

        cfg = SamplerConfig(name=self.scheduler_name, eta=eta,
                            ip_guidance_rate=ip_guidance_rate,
                            num_inference_steps=num_inference_steps)
        needs_guidance = self.scheduler_name != "ddim"
        if needs_guidance and measurement is None:
            raise ValueError(f"scheduler '{self.scheduler_name}' requires a measurement")
        loss_fn = None
        if measurement is not None:
            measurement = torch.as_tensor(measurement, dtype=torch.float32, device=device)
            if needs_guidance:
                loss_fn = self.make_loss_fn(measurement, owl, supervised_space)
        timesteps = self.schedule.timesteps(num_inference_steps)

        with sharded_batch(mesh):
            if self.scheduler_name == "ditto":
                # one draw per step, once a call; every outer iteration reuses it
                draws = ditto_draws(cfg, latents.shape, len(timesteps), generator, self.dtype,
                                    device)
                objective = self.ditto_objective(prompt_embeds, guidance_scale, loss_fn, cfg,
                                                 timesteps, draws)
                final, losses = run_ditto(objective, latents, optim_outer_loop,
                                          ip_guidance_rate)
            else:
                step_fn = make_step_fn(self.schedule, cfg, loss_fn)

                def run(lat):
                    if needs_guidance and optim_prompt:   # embeddings fresh each run
                        model_fn = self._optim_prompt_model_fn(
                            loss_fn, prompt_embeds, guidance_scale,
                            float(optim_prompt_learning_rate))
                    else:
                        def model_fn(x, t):
                            return self._eps(prompt_embeds, x, t, guidance_scale)
                    return run_denoise_loop(step_fn, model_fn, lat, timesteps, generator,
                                            callback, callback_steps, show_progress)
                final, losses = denoise_with_nan_retry(run, latents, generator)

        if output_type == "latent":
            out = final
        else:
            with annotate("decode"):
                audio = self.mel_to_waveform(self.decode_mel(final))[:, :owl].float()
            if phase_aware is None:
                noiser = getattr(self.operator, "noiser", None)
                phase_aware = getattr(noiser, "sigma", 1.0) <= 1e-6
            if (phase_aware and measurement is not None
                    and isinstance(self.operator, PhaseRetrievalOperator)):
                audio = self.phase_aware_output(audio, measurement, owl)
            out = audio
        if mesh is not None:
            # every rank ends with the whole batch, and the losses (sums over
            # the clips; DDIM's slot holds the timestep) of the whole batch
            out = mesh.gather(out)
            if self.scheduler_name != "ddim":
                losses = mesh.reduce(losses)
        out = AudioPipelineOutput(audios=out.cpu().numpy())
        if return_losses:
            return out, losses.cpu().numpy()
        return out

    # ------------------------------------------------------------- factories
    @classmethod
    def from_pretrained(cls, checkpoint_dir, scheduler_name: str = "ddim", operator=None,
                        schedule=None, device="cuda", weight_dtype=torch.float32, **routes):
        """Load from a local HF-snapshot directory (`models/checkpoint.py`),
        on the card unless the caller asks for the CPU."""
        from ..models.checkpoint import load_musicldm
        return load_musicldm(checkpoint_dir, scheduler_name=scheduler_name, operator=operator,
                             schedule=schedule, device=device, weight_dtype=weight_dtype,
                             **routes)

    @classmethod
    def tiny(cls, scheduler_name: str = "ddim", operator=None, seed: int = 0, device="cuda",
             weight_dtype=torch.float32, **routes):
        """Seeded random weights at the JAX package's tiny configs, with the
        CLAP text tower, the byte tokenizer (16 tokens) and the tiny CLAP
        audio tower (fp32): the model structure at a CPU-second scale."""
        text_cfg = tiny_clap_text_config()
        text = init_flax_style(ClapTextModelWithProjection(text_cfg), seed + 3)
        audio_embed, frame_embed = make_tiny_clap_audio_embeds(
            seed + 99, text_cfg.projection_dim, device)
        return cls.random(tiny_unet_config(), tiny_vae_config(), tiny_hifigan_config(),
                          seed=seed, device=device, weight_dtype=weight_dtype,
                          scheduler_name=scheduler_name,
                          operator=operator if operator is not None else IdentityOperator(),
                          text_encoder=text.to(device=device, dtype=weight_dtype),
                          tokenizer=functools.partial(byte_tokenizer, maxlen=16),
                          clap_audio_embed=audio_embed, clap_frame_embed=frame_embed, **routes)
