"""Inference CLI of the port: the twin of the JAX package's `run.py`.

    python -m diffmusic_tpu_torch.run -c dps -t music_inpainting -d moises \
        -m musicldm --checkpoint_dir CKPT            # on the card
    python -m diffmusic_tpu_torch.run --device cpu --tiny --num_inference_steps 2
    python -m diffmusic_tpu_torch.run -m stable_audio -t music_generation --tiny

The same flags as `run.py`, plus `--device` (default cuda); the same config
composition over `configs/` (read from the working directory
when it holds the scheduler's YAML file, else from beside the repo); the same
output tree outputs/{model}/{data}/{scheduler}/{task}/{wav,mel}_{input,recon,label},
with files that exist skipped. Draws come from one seeded `torch.Generator`
on the device, in place of `jax.random.key(0)`.

`--mesh dp=2,tp=4` (JAX's spec) runs dp x tp ranks, one device each
(`parallel/mesh.py`): this command spawns them (`parallel.launch`; with
`--device cpu` gloo processes, on the card one GPU a rank under NCCL; a
mesh of one rank runs in this process), each denoises its dp rows of the
`num_waveforms_per_prompt` candidates, the ranks of a tp group the same
rows, and rank 0 alone prints and writes the output tree. A rank that
fails makes the command fail.

`-t style_guidance` binds the pipeline's CLAP frame features to the style
operator (`bind_style_guidance`); `-nw` above 1 samples that many
candidates and, with a CLAP audio tower, writes them re-ranked by CLAP
text-audio similarity, best first (`score_waveforms`, the order logged),
else in generation order. `-m stable_audio` generates music only (any
other task raises before anything is written): its EDM sampler is inside
the pipeline, its clip length is the model config's `audio_end_in_s`, and
its stereo audio is written at the Oobleck VAE's rate, downmixed and
resampled to the data's rate for the mel PNG only.
"""

import os
from argparse import ArgumentParser, Namespace
from pathlib import Path

import numpy as np
import torch

from .constants import (AUDIOLDM2, CLAP, CONFIG_PATH, DDIM, DIFFMUSIC, DITTO, DPS, DSG,
                        MEL_SPECTROGRAM, MOISES, MPGD, MUSIC_DEREVERBERATION,
                        MUSIC_GENERATION, MUSIC_INPAINTING, MUSICCAPS, MUSICLDM, NULL_TEXT,
                        PHASE_RETRIEVAL, STABLE_AUDIO, STYLE_GUIDANCE, SUPER_RESOLUTION, TAG,
                        WAV_FORM)
from .parallel.mesh import launch, leads, parse_mesh, seeded_generator

REPO = Path(__file__).resolve().parent.parent


def parse_arguments(argv=None) -> Namespace:
    parser = ArgumentParser(description="Guided music restoration with MusicLDM / AudioLDM2")
    parser.add_argument("-c", "--config_name", type=str, default=DIFFMUSIC,
                        choices=[DDIM, DPS, MPGD, DSG, DITTO, DIFFMUSIC])
    parser.add_argument("-t", "--task", type=str, default=MUSIC_INPAINTING,
                        choices=[MUSIC_GENERATION, MUSIC_INPAINTING, SUPER_RESOLUTION,
                                 PHASE_RETRIEVAL, MUSIC_DEREVERBERATION, STYLE_GUIDANCE])
    parser.add_argument("-d", "--datasets", type=str, default=MOISES,
                        choices=[MOISES, MUSICCAPS])
    parser.add_argument("-m", "--model", type=str, default=AUDIOLDM2,
                        choices=[AUDIOLDM2, MUSICLDM, STABLE_AUDIO])
    parser.add_argument("--mask_type", type=str, default="box",
                        choices=["box", "random", "periodic"])
    parser.add_argument("--supervised_space", type=str, default=MEL_SPECTROGRAM,
                        choices=[WAV_FORM, MEL_SPECTROGRAM])
    parser.add_argument("--prompt_type", type=str, default=NULL_TEXT,
                        choices=[NULL_TEXT, TAG, CLAP])
    parser.add_argument("-p", "--prompt", type=str, default="")
    parser.add_argument("-np", "--negative_prompt", type=str, default=None)
    parser.add_argument("--transcription", type=str, required=False, default="",
                        help="Transcription for Text-to-Speech")
    parser.add_argument("--show_progress", action="store_true")
    parser.add_argument("--checkpoint_dir", type=str, default=None,
                        help="local HF-snapshot directory of the model's weights")
    parser.add_argument("--tiny", action="store_true",
                        help="seeded random weights at tiny widths (a smoke run)")
    parser.add_argument("--num_inference_steps", type=int, default=None,
                        help="override config num_inference_steps")
    parser.add_argument("-nw", "--num_waveforms_per_prompt", type=int, default=1,
                        help="candidates per prompt, re-ranked by CLAP when above 1")
    parser.add_argument("--mesh", type=str, default=None,
                        help="device mesh spec, e.g. 'dp=4' or 'dp=2,tp=4': one rank a "
                             "device, the candidate batch sharded over dp (tp ranks "
                             "replicate it)")
    parser.add_argument("-o", "--override", action="append", default=[],
                        help="dotted config override, repeatable: "
                             "-o model.pipe.audio_length_in_s=5 -o data.root=...")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the models run on (cuda, or cpu)")
    return parser.parse_args(argv)


def check_supported(args) -> None:
    """Raise for what no pipeline supports, before anything is loaded or
    written."""
    if args.model == STABLE_AUDIO and args.task != MUSIC_GENERATION:
        raise SystemExit(
            "stable_audio supports music_generation only: its latent space is the "
            "waveform VAE's (Oobleck), and no measurement or guidance path is defined "
            "for it")


def build_operator(args, config, noiser):
    """Task -> (operator, downsample scale), as the JAX `run.py` builds it."""
    from .inverse_problem import (IdentityOperator, MusicDereverberationOperator,
                                  MusicInpaintingOperator, PhaseRetrievalOperator,
                                  StyleGuidanceOperator, SuperResolutionOperator)
    task = args.task
    downsample_scale = 1
    if task == MUSIC_GENERATION:
        op = IdentityOperator(sample_rate=config.data.sample_rate)
    elif task == MUSIC_INPAINTING:
        op = MusicInpaintingOperator(
            audio_length_in_s=config.model.pipe.audio_length_in_s,
            sample_rate=config.data.sample_rate, mask_type=args.mask_type,
            start_inpainting_s=config.data.start_inpainting_s - config.data.start_s,
            end_inpainting_s=config.data.end_inpainting_s - config.data.start_s,
            mask_percentage=0.3, interval_s=1, mask_duration_s=0.1, noiser=noiser)
    elif task == SUPER_RESOLUTION:
        downsample_scale = 2
        op = SuperResolutionOperator(sample_rate=config.data.sample_rate,
                                     scale=downsample_scale, noiser=noiser)
    elif task == PHASE_RETRIEVAL:
        op = PhaseRetrievalOperator(n_fft=config.data.n_fft, hop_length=config.data.hop_length,
                                    win_length=config.data.win_length, noiser=noiser)
    elif task == MUSIC_DEREVERBERATION:
        op = MusicDereverberationOperator(ir_length=5000, decay_factor=0.99, noiser=noiser)
    elif task == STYLE_GUIDANCE:
        # clap_embed is bound once the pipeline is loaded (bind_style_guidance)
        op = StyleGuidanceOperator(noiser=noiser)
    else:
        raise ValueError(f"Unknown task: {task}")
    return op, downsample_scale


def bind_style_guidance(pipe, operator):
    """The style operator with the pipeline's CLAP frame features as its
    `clap_embed`, set on the pipeline too: the guided loss is then the gram
    matrices' distance."""
    from dataclasses import replace
    if getattr(pipe, "clap_frame_embed", None) is None:
        raise SystemExit("style_guidance needs a CLAP audio tower: this checkpoint's "
                         "text_encoder has no audio_model weights")
    operator = replace(operator, clap_embed=pipe.clap_frame_embed)
    pipe.operator = operator
    return operator


def load_pipeline(args, config, operator):
    """The pipeline of `config.model.name` with the config's schedule: seeded
    tiny weights (`--tiny`; AudioLDM2's TTS variant with a `--transcription`)
    or a local checkpoint (`--checkpoint_dir`), on `--device`. StableAudio's
    EDM schedule is the pipeline's own (or the snapshot's): the DDIM block of
    stable_audio.yaml is not used."""
    from .pipelines import AudioLDM2Pipeline, get_pipeline
    from .samplers import DiffusionSchedule
    cls = get_pipeline(config.model.name)
    if config.model.name == STABLE_AUDIO:
        if args.tiny:
            return cls.tiny(device=args.device)
        if args.checkpoint_dir:
            return cls.from_pretrained(args.checkpoint_dir, device=args.device)
        raise SystemExit("pass --checkpoint_dir with a local HF-snapshot directory, or --tiny "
                         "for the random-weights smoke mode")
    sched = config.model.scheduler
    schedule = DiffusionSchedule(
        num_train_timesteps=sched.num_train_timesteps, beta_start=sched.beta_start,
        beta_end=sched.beta_end, beta_schedule=sched.beta_schedule,
        set_alpha_to_one=sched.set_alpha_to_one, steps_offset=sched.steps_offset,
        timestep_spacing=sched.timestep_spacing)
    if args.tiny:
        # a transcription takes AudioLDM2's TTS variant (VITS in T5's place)
        tts = {"tts": True} if args.transcription and cls is AudioLDM2Pipeline else {}
        pipe = cls.tiny(scheduler_name=config.name, operator=operator, device=args.device,
                        **tts)
        pipe.schedule = schedule
        return pipe
    if args.checkpoint_dir:
        return cls.from_pretrained(args.checkpoint_dir, scheduler_name=config.name,
                                   operator=operator, schedule=schedule, device=args.device)
    raise SystemExit("pass --checkpoint_dir with a local HF-snapshot directory, or --tiny "
                     "for the random-weights smoke mode")


def config_root(config_name: str) -> str:
    """configs/ of the working directory when it holds the scheduler's YAML
    file, else the tree beside this package."""
    if Path(CONFIG_PATH, f"{config_name}.yaml").is_file():
        return CONFIG_PATH
    return str(REPO / CONFIG_PATH)


def main(argv=None) -> None:
    args = parse_arguments(argv)
    check_supported(args)
    mesh = parse_mesh(args.mesh, args.device)
    if mesh is None:
        generate(args)
    else:
        launch(mesh, run_rank, args)


def run_rank(mesh, args) -> None:
    """One rank of a `--mesh` run (`parallel.launch`), on the rank's device."""
    args.device = str(mesh.device)
    generate(args, mesh)


def generate(args, mesh=None) -> None:
    """The run of `parse_arguments`' namespace, as this rank of `mesh` (or
    alone): every rank samples, rank 0 alone prints and writes."""
    lead = leads(mesh)
    from .config import compose
    from .data import get_dataloader, get_dataset, write_wav
    from .inverse_problem import get_noiser
    from .ops.mel import Wav2Mel
    from .ops.resample import resample
    from .pipelines.base import save_mel_spectrogram

    config = compose(config_name=args.config_name, overrides=[
        f"data={args.datasets}", f"model={args.model}", *args.override],
        config_path=config_root(args.config_name))
    if args.num_inference_steps is not None:
        config.model.pipe.num_inference_steps = args.num_inference_steps
    if args.num_waveforms_per_prompt != 1:
        config.model.pipe.num_waveforms_per_prompt = args.num_waveforms_per_prompt

    output_dir = Path("outputs", config.model.name, config.data.name, args.config_name,
                      args.task)
    if lead:
        for d in ["wav_input", "wav_recon", "wav_label", "mel_input", "mel_recon",
                  "mel_label"]:
            os.makedirs(Path(output_dir, d), exist_ok=True)

    device = torch.device(args.device)
    noiser = get_noiser(**config.inverse_problem.noise)
    operator, downsample_scale = build_operator(args, config, noiser)
    pipe = load_pipeline(args, config, operator)
    if args.task == STYLE_GUIDANCE:
        operator = bind_style_guidance(pipe, operator)
    pipe.mesh = mesh

    # stable_audio.yaml keys the clip length as audio_end_in_s
    audio_length_in_s = config.model.pipe.get("audio_length_in_s",
                                              config.model.pipe.get("audio_end_in_s"))
    sr = config.data.sample_rate
    # generated audio is written at the generator's rate: the vocoder's, or
    # the Oobleck VAE's where the pipeline has no vocoder
    out_sr = (pipe.vocoder_cfg.sampling_rate if hasattr(pipe, "vocoder_cfg")
              else pipe.vae_cfg.sampling_rate)
    wav2mel = Wav2Mel(sample_rate=sr, n_fft=config.data.n_fft,
                      hop_length=config.data.hop_length, win_length=config.data.win_length,
                      n_mels=config.data.n_mels, power=config.data.power)

    dataset = get_dataset(
        name=config.data.name, type=config.data.type, root=config.data.root,
        sample_rate=sr, audio_length_in_s=audio_length_in_s,
        start_s=config.data.start_s, end_s=config.data.end_s, transforms=None)
    loader = get_dataloader(dataset, batch_size=1, num_workers=0, train=False)

    if lead:
        print("=" * 50)
        print(f"| Model             : {config.model.name}")
        print(f"| Data              : {config.data.name}")
        print(f"| Task              : {args.task}")
        print(f"| Scheduler         : {args.config_name}")
        print(f"| Supervised Space  : {args.supervised_space}")
        print(f"| Prompt Type       : {args.prompt_type}")
        print(f"| Prompt            : '{args.prompt}'")
        print(f"| Show Progress     : {args.show_progress}")
        print(f"| Device            : {device}")
        if mesh is not None:
            print(f"| Mesh              : {mesh.shape}")
        print(f"| Number of Samples : {len(loader)}")
        print("=" * 50)

    # seeded alike on every rank of a mesh: each draws the whole batch's values
    generator = seeded_generator(0, device)
    mel_frames = int(audio_length_in_s * 100)

    def mel_of(wave):
        with torch.no_grad():
            return wav2mel(wave).cpu().numpy()[:, :, :mel_frames]

    for i, (data, file_name) in enumerate(loader, start=1):
        recon_path = Path(output_dir, "wav_recon", file_name)
        done = recon_path.exists()
        if mesh is not None:
            # rank 0's answer on every rank: a rank behind it could see the
            # file it has written and skip the collectives of the others
            done = mesh.agree(done)
        if lead:
            print(f"=====> Inference for audio {i}")
            if done:
                print(f"File {file_name} already exists. Skipping.")
        if done:
            continue

        gt_wave = torch.as_tensor(data, device=device)
        measurement = operator.forward(gt_wave, generator)
        ref_wave = None if args.task == PHASE_RETRIEVAL else measurement
        if lead:
            gt_mel = mel_of(gt_wave)
            save_mel_spectrogram(gt_mel.transpose(0, 2, 1),
                                 Path(output_dir, "mel_label", file_name).with_suffix(".png"),
                                 sr)
        if lead and ref_wave is not None:
            # the ground truth's mel clamps the frequency axis, so that a
            # downsampled input renders on the ground truth's scale
            save_mel_spectrogram(mel_of(ref_wave).transpose(0, 2, 1),
                                 Path(output_dir, "mel_input", file_name).with_suffix(".png"),
                                 sr // downsample_scale,
                                 gt_mel_spectrogram=gt_mel.transpose(0, 2, 1),
                                 gt_sample_rate=sr)

        out = pipe(
            latents=None,
            prompt=args.prompt,
            negative_prompt=args.negative_prompt,
            measurement=measurement,
            eta=config.scheduler.eta,
            ip_guidance_rate=config.scheduler.ip_guidance_rate,
            optim_prompt_learning_rate=config.scheduler.optim_prompt_learning_rate,
            generator=generator,
            optim_prompt=config.scheduler.optim_prompt,
            optim_outer_loop=config.scheduler.optim_outer_loop,
            show_progress=args.show_progress,
            prompt_type=args.prompt_type,
            transcription=args.transcription,
            supervised_space=args.supervised_space,
            **config.model.pipe,
        )
        if not lead:
            continue
        audio = np.asarray(out.audios)
        if config.model.pipe.num_waveforms_per_prompt > 1:
            # CLAP re-ranking: the best text match is written first
            if getattr(pipe, "clap_audio_embed", None) is not None:
                audio, sims = pipe.score_waveforms(args.prompt, audio,
                                                   config.model.pipe.num_waveforms_per_prompt)
                print(f"CLAP re-ranking similarities: {np.round(sims, 4)}")
            else:
                print("num_waveforms_per_prompt > 1 but no CLAP audio tower loaded; keeping "
                      "generation order")

        write_wav(Path(output_dir, "wav_label", file_name), np.asarray(data)[0], sr)
        if ref_wave is not None:
            write_wav(Path(output_dir, "wav_input", file_name), ref_wave.cpu().numpy()[0],
                      sr // downsample_scale)
        audio_mono = torch.as_tensor(audio, device=device)
        if audio_mono.ndim == 3:   # stable_audio's stereo (B, C, T): downmixed for the PNG
            audio_mono = audio_mono.mean(dim=1)
        if out_sr != sr:           # Wav2Mel runs at the data's rate
            with torch.no_grad():
                audio_mono = resample(audio_mono, out_sr, sr)
        pred_mel = mel_of(audio_mono)
        save_mel_spectrogram(pred_mel.transpose(0, 2, 1),
                             Path(output_dir, "mel_recon", file_name).with_suffix(".png"), sr)
        write_wav(recon_path, audio[0], out_sr)


if __name__ == "__main__":
    main()
