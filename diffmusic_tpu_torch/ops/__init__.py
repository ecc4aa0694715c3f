"""DSP ops in plain PyTorch (port of `diffmusic_tpu/ops`)."""

from .masks import box_mask
from .mel import MelSpectrogram, Wav2Mel, amplitude_to_db, mel_filterbank
from .resample import resample
from .stft import frame_signal, hann_window, overlap_add, spectrogram

__all__ = [
    "box_mask", "MelSpectrogram", "Wav2Mel", "amplitude_to_db",
    "mel_filterbank", "frame_signal", "hann_window", "overlap_add", "resample",
    "spectrogram",
]
