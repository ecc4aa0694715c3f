"""DSP ops in plain PyTorch (port of `diffmusic_tpu/ops`)."""

from .filters import convolve1d, generate_impulse_response
from .masks import box_mask, periodic_mask, random_mask
from .mel import (InverseMelScale, MelScale, MelSpectrogram, Wav2Mel, amplitude_to_db,
                  mel_filterbank)
from .resample import resample
# `stft` itself is not re-exported: the name is its module's
from .stft import (frame_signal, hann_window, istft, magphase_spectrogram, overlap_add,
                   spectrogram)

__all__ = [
    "box_mask", "convolve1d", "generate_impulse_response", "InverseMelScale",
    "MelScale", "MelSpectrogram", "Wav2Mel", "amplitude_to_db", "mel_filterbank",
    "frame_signal", "hann_window", "istft", "magphase_spectrogram", "overlap_add",
    "periodic_mask", "random_mask", "resample", "spectrogram",
]
