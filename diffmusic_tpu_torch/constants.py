"""String vocabulary of the CLI and config surface: a copy of
`diffmusic_tpu/constants.py`, so that `diffmusic_tpu_torch.run` takes the
same flags as the JAX package's `run.py`.
"""

CONFIG_PATH = "configs"

# datasets
MOISES = "moises"
MUSICCAPS = "music_data"

# models
AUDIOLDM2 = "audioldm2"
MUSICLDM = "musicldm"
# StableAudio: text-to-music only (-t music_generation)
STABLE_AUDIO = "stable_audio"

# tasks
MUSIC_GENERATION = "music_generation"
MUSIC_INPAINTING = "music_inpainting"
SUPER_RESOLUTION = "super_resolution"
PHASE_RETRIEVAL = "phase_retrieval"
MUSIC_DEREVERBERATION = "music_dereverberation"
STYLE_GUIDANCE = "style_guidance"

TASKS = (
    MUSIC_GENERATION,
    MUSIC_INPAINTING,
    SUPER_RESOLUTION,
    PHASE_RETRIEVAL,
    MUSIC_DEREVERBERATION,
    STYLE_GUIDANCE,
)

# schedulers / guided samplers
DDIM = "ddim"
DPS = "dps"
MPGD = "mpgd"
DSG = "dsg"
DITTO = "ditto"
DIFFMUSIC = "diffmusic"

SCHEDULERS = (DDIM, DPS, MPGD, DSG, DITTO, DIFFMUSIC)

# prompt ablation axes
NULL_TEXT = "null_text"
TAG = "tag"
CLAP = "clap"

# supervision spaces for the guidance loss
WAV_FORM = "wav_form"
MEL_SPECTROGRAM = "mel_spectrogram"
