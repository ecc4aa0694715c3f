"""The system under test: `diffmusic_tpu_torch`'s pipeline for one cell, built
as `python -m diffmusic_tpu_torch.run` builds it (the models on the meta
device with their default routes, the weights assigned, frozen, in eval
mode; the CLI's operator, schedule and call arguments), with the
benchmark's seeded weights in place of a snapshot and the byte tokenizer in
place of the snapshot's tokenizer files.

This is the one module of the benchmark that imports the port.
"""

import dataclasses

import torch

from diffmusic_tpu_torch.constants import NULL_TEXT
from diffmusic_tpu_torch.inverse_problem import (IdentityOperator,
                                                 MusicDereverberationOperator,
                                                 MusicInpaintingOperator)
from diffmusic_tpu_torch.kernels import launch_counts, reset_launch_counts
from diffmusic_tpu_torch.models import configs as C
from diffmusic_tpu_torch.models.clap import ClapTextModelWithProjection
from diffmusic_tpu_torch.models.gpt2 import GPT2Model
from diffmusic_tpu_torch.models.hifigan import SpeechT5HifiGan
from diffmusic_tpu_torch.models.projection import AudioLDM2ProjectionModel
from diffmusic_tpu_torch.models.t5 import T5EncoderModel
from diffmusic_tpu_torch.models.unet import UNet2DConditionModel
from diffmusic_tpu_torch.models.vae import AutoencoderKL
from diffmusic_tpu_torch.pipelines import AudioLDM2Pipeline, MusicLDMPipeline
from diffmusic_tpu_torch.pipelines.base import byte_tokenizer
from diffmusic_tpu_torch.samplers import DiffusionSchedule

__all__ = ["launch_counts", "reset_launch_counts", "model_shapes", "build", "call_kwargs",
           "text_taps", "free"]

# (config group, port class, port config class) of each model a pipeline holds
MODELS = {
    "unet": (UNet2DConditionModel, C.UNetConfig),
    "vae": (AutoencoderKL, C.VAEConfig),
    "vocoder": (SpeechT5HifiGan, C.HiFiGANConfig),
    "clap_text": (ClapTextModelWithProjection, C.ClapTextConfig),
    "t5": (T5EncoderModel, C.T5Config),
    "gpt2": (GPT2Model, C.GPT2Config),
    "projection": (AudioLDM2ProjectionModel, C.ProjectionConfig),
}
PIPELINE_MODELS = {"musicldm": ("unet", "vae", "vocoder", "clap_text"),
                   "audioldm2": ("unet", "vae", "vocoder", "clap_text", "t5", "gpt2",
                                 "projection")}


def _tuples(v):
    return tuple(_tuples(a) for a in v) if isinstance(v, list) else v


def _meta_models(config: dict) -> dict:
    out = {}
    with torch.device("meta"):
        for name in PIPELINE_MODELS[config["pipeline"]]:
            cls, cfg_cls = MODELS[name]
            out[name] = cls(cfg_cls(**{k: _tuples(v) for k, v in config[name].items()}))
    return out


def model_shapes(config: dict) -> dict:
    """{model: {parameter: shape}} of the port's models for `config`."""
    return {m: {k: tuple(v.shape) for k, v in mod.state_dict().items()}
            for m, mod in _meta_models(config).items()}


def _operator(traffic: dict, audio_s: float, ir_seed: int):
    task = traffic["task"]
    if task["name"] == "music_inpainting":
        return MusicInpaintingOperator(audio_length_in_s=audio_s, sample_rate=16000,
                                       mask_type="box",
                                       start_inpainting_s=task["start_frac"] * audio_s,
                                       end_inpainting_s=task["end_frac"] * audio_s)
    if task["name"] == "music_dereverberation":
        return MusicDereverberationOperator(ir_length=task["ir_length"],
                                            decay_factor=task["decay"],
                                            ir_generator=torch.Generator().manual_seed(ir_seed))
    if task["name"] == "music_generation":
        return IdentityOperator(sample_rate=16000)
    raise ValueError(f"unknown task {task['name']!r}")


def build(config: dict, traffic: dict, weights: dict, ir_seed: int):
    """The cell's pipeline on the weights' device."""
    models = _meta_models(config)
    for name, mod in models.items():
        mod.load_state_dict(weights[name], strict=True, assign=True)
        mod.requires_grad_(False).eval()
    s = config["scheduler"]
    schedule = DiffusionSchedule(
        num_train_timesteps=s["num_train_timesteps"], beta_start=s["beta_start"],
        beta_end=s["beta_end"], beta_schedule=s["beta_schedule"],
        set_alpha_to_one=s["set_alpha_to_one"], steps_offset=s["steps_offset"],
        timestep_spacing=s["timestep_spacing"])
    tok = lambda texts: byte_tokenizer(texts, config["tokenizer_maxlen"])
    common = dict(schedule=schedule, scheduler_name=traffic["sampler"]["name"],
                  operator=_operator(traffic, config["audio_length_in_s"], ir_seed),
                  text_encoder=models["clap_text"], tokenizer=tok)
    if config["pipeline"] == "musicldm":
        return MusicLDMPipeline(models["unet"], models["vae"], models["vocoder"], **common)
    return AudioLDM2Pipeline(models["unet"], models["vae"], models["vocoder"], t5=models["t5"],
                             gpt2=models["gpt2"], projection=models["projection"],
                             t5_tokenizer=tok, max_new_tokens=config["generated_states"],
                             **common)


def call_kwargs(config: dict, traffic: dict, pipe, prompt: str, signal, generator,
                steps: int) -> dict:
    """The pipeline call `run.py` makes for one clip: its measurement
    A(ground truth) (none for generation), the scheduler's eta and rate, the
    model's clip length, `num_waveforms_per_prompt` candidates. The guidance
    scale is the pipeline's default (MusicLDM 2.0, AudioLDM2 3.5), passed so
    that the reference reads the same number."""
    s = traffic["sampler"]
    measurement = None
    if traffic["task"]["name"] != "music_generation":
        measurement = pipe.operator.forward(torch.as_tensor(signal, device=pipe.device),
                                            generator)
    kw = dict(latents=None, prompt=prompt, negative_prompt=traffic["negative_prompt"],
              measurement=measurement, eta=s["eta"], ip_guidance_rate=s["rate"],
              optim_prompt_learning_rate=1e-4, generator=generator, optim_prompt=False,
              optim_outer_loop=1, show_progress=False, prompt_type=NULL_TEXT, transcription="",
              supervised_space="mel_spectrogram", num_inference_steps=steps,
              audio_length_in_s=config["audio_length_in_s"],
              num_waveforms_per_prompt=traffic["candidates"],
              guidance_scale=traffic["guidance_scale"])
    return kw


def text_taps(pipe) -> dict:
    """The text stack's modules whose inputs and outputs the check follows
    (AudioLDM2: the CLAP tower, T5 and each of its blocks, the projection);
    none for MusicLDM, whose CLAP tower is checked whole."""
    if getattr(pipe, "t5", None) is None:
        return {}
    taps = {"clap": pipe.text_encoder, "t5": pipe.t5, "projection": pipe.projection}
    taps.update({f"t5.block_{i}": getattr(pipe.t5, f"block_{i}")
                 for i in range(pipe.t5.cfg.num_layers)})
    return taps


def free(pipe) -> None:
    """Drop the pipeline's models (the caller drops its last reference)."""
    for f in dataclasses.fields(pipe):
        if isinstance(getattr(pipe, f.name), torch.nn.Module):
            setattr(pipe, f.name, None)
