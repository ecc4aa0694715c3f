"""VGGish (AudioSet): preprocessing, the network in PyTorch, the PCA
postprocessor, and a torchvggish state-dict loader.

Port of `diffmusic_tpu/metrics/vggish.py`. The network is torchvggish's own
layout, so a torchvggish `state_dict` loads as it is: `features` holds six
3x3 'same' convs 64-128-256-256-512-512 with ReLU and a 2x2 max-pool after
convs 0, 1, 3 and 5 (Sequential indices 0, 3, 6, 8, 11, 13), `embeddings` a
12288-4096-4096-128 ReLU MLP (indices 0, 2, 4) on the (6, 4, 512) map
flattened in NHWC order, as flax and torchvggish both flatten it. It runs in
fp32 with plain `nn.Conv2d` / `nn.Linear`, as the JAX package runs flax
`nn.Conv` outside any Pallas kernel.

Preprocessing (numpy, AudioSet vggish_params): 16 kHz mono -> |rFFT-512| of
400-sample symmetric-Hann frames at hop 160, no centre pad -> 64 HTK-mel bands
over 125-7500 Hz (DC bin zeroed) -> log(mel + 0.01) -> non-overlapping
96-frame examples. Postprocessing (torchvggish Postprocessor): PCA with the
AudioSet eigenvectors and means, clip to [-2, 2], 8-bit quantise to 0..255
(kept float32).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

SAMPLE_RATE = 16000
STFT_WINDOW = 400        # 25 ms
STFT_HOP = 160           # 10 ms
NUM_MEL_BINS = 64
MEL_MIN_HZ = 125.0
MEL_MAX_HZ = 7500.0
LOG_OFFSET = 0.01
EXAMPLE_FRAMES = 96      # 0.96 s windows, hop == window (non-overlapping)
EMBEDDING_DIM = 128

_CONV_CHANNELS = (64, 128, 256, 256, 512, 512)
_POOL_AFTER = (True, True, False, True, False, True)  # 2x2 max-pool
# torchvggish Sequential indices of the six convs and three linears
_TORCH_CONV_IDX = (0, 3, 6, 8, 11, 13)
_TORCH_FC_IDX = (0, 2, 4)
_FC_DIMS = ((512 * 6 * 4, 4096), (4096, 4096), (4096, EMBEDDING_DIM))


def _hz_to_mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_weight_matrix() -> np.ndarray:
    """(257, 64) spectrogram-bin -> HTK-mel-band weights, DC row zeroed."""
    nfft = 512
    spec_hz = np.linspace(0.0, SAMPLE_RATE / 2.0, nfft // 2 + 1)
    spec_mel = _hz_to_mel(spec_hz)
    edges = np.linspace(_hz_to_mel(MEL_MIN_HZ), _hz_to_mel(MEL_MAX_HZ),
                        NUM_MEL_BINS + 2)
    lower, center, upper = edges[:-2], edges[1:-1], edges[2:]
    lo = (spec_mel[:, None] - lower[None, :]) / (center - lower)[None, :]
    hi = (upper[None, :] - spec_mel[:, None]) / (upper - center)[None, :]
    w = np.maximum(0.0, np.minimum(lo, hi))
    w[0, :] = 0.0  # HTK excludes the DC bin
    return w.astype(np.float32)


def log_mel_examples(audio: np.ndarray) -> np.ndarray:
    """16 kHz waveform -> (num_examples, 96, 64) float32 log-mel examples."""
    x = np.asarray(audio, np.float32).reshape(-1)
    if len(x) < STFT_WINDOW:
        return np.zeros((0, EXAMPLE_FRAMES, NUM_MEL_BINS), np.float32)
    n_frames = 1 + (len(x) - STFT_WINDOW) // STFT_HOP
    idx = (np.arange(STFT_WINDOW)[None, :]
           + STFT_HOP * np.arange(n_frames)[:, None])
    frames = x[idx] * np.hanning(STFT_WINDOW).astype(np.float32)[None, :]
    mag = np.abs(np.fft.rfft(frames, n=512, axis=-1)).astype(np.float32)
    logmel = np.log(mag @ mel_weight_matrix() + LOG_OFFSET)
    n_ex = n_frames // EXAMPLE_FRAMES
    if n_ex == 0:
        return np.zeros((0, EXAMPLE_FRAMES, NUM_MEL_BINS), np.float32)
    return logmel[:n_ex * EXAMPLE_FRAMES].reshape(n_ex, EXAMPLE_FRAMES,
                                                  NUM_MEL_BINS)


class VGGish(nn.Module):
    """Feature CNN + embedding MLP. Input (N, 96, 64, 1), the JAX package's
    NHWC layout; output (N, 128) pre-postprocessing embeddings (fp32)."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 1
        for ch, pool in zip(_CONV_CHANNELS, _POOL_AFTER):
            layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.ReLU()]
            if pool:
                layers.append(nn.MaxPool2d(2, 2))
            cin = ch
        self.features = nn.Sequential(*layers)
        fcs = []
        for fin, fout in _FC_DIMS:
            fcs += [nn.Linear(fin, fout), nn.ReLU()]
        self.embeddings = nn.Sequential(*fcs)

    def forward(self, x):
        x = self.features(x.permute(0, 3, 1, 2))       # (N, 512, 6, 4)
        # flatten in NHWC order, as flax and torchvggish do: without the
        # permute every embedding is wrong
        x = x.permute(0, 2, 3, 1).flatten(1)
        return self.embeddings(x)


@dataclasses.dataclass
class VGGishPCA:
    eigen_vectors: np.ndarray  # (128, 128)
    means: np.ndarray          # (128,)

    def __call__(self, emb: np.ndarray) -> np.ndarray:
        """PCA -> clip [-2, 2] -> 8-bit quantize (kept float32), matching
        torchvggish's Postprocessor semantics."""
        y = (np.asarray(emb, np.float32) - self.means[None, :]) \
            @ self.eigen_vectors.T
        y = np.clip(y, -2.0, 2.0)
        return np.round((y + 2.0) * (255.0 / 4.0)).astype(np.float32)


def _pca_of(sd) -> VGGishPCA | None:
    """The PCA buffers of a torchvggish state dict, under 'pproc.' (the hub
    module) or at the top level."""
    for prefix in ("pproc.", ""):
        if f"{prefix}pca_eigen_vectors" in sd:
            return VGGishPCA(
                eigen_vectors=np.asarray(sd[f"{prefix}pca_eigen_vectors"], np.float32),
                means=np.asarray(sd[f"{prefix}pca_means"], np.float32).reshape(-1))
    return None


def load_vggish(path, device="cuda"):
    """A torchvggish state dict (.pth through torch, or .npz) at `path` ->
    (VGGish in eval mode on `device`, VGGishPCA | None)."""
    if str(path).endswith(".npz"):
        with np.load(path) as z:
            sd = {k: torch.from_numpy(z[k]) for k in z.files}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    pca = _pca_of({k: v.numpy() for k, v in sd.items() if "pca" in k})
    with torch.device("meta"):      # no random init of 72 M parameters to overwrite
        model = VGGish()
    model.load_state_dict({k: v.float() for k, v in sd.items()
                           if k.startswith(("features.", "embeddings."))}, assign=True)
    return model.to(device).eval(), pca


def from_flax(params) -> dict:
    """The JAX package's flax VGGish tree ({"params": {"conv_i", "fc_i"}})
    -> this module's state dict: conv kernels HWIO -> OIHW, dense (in, out)
    -> (out, in)."""
    p = params.get("params", params)
    sd = {}
    for i, ti in enumerate(_TORCH_CONV_IDX):
        sd[f"features.{ti}.weight"] = torch.from_numpy(
            np.asarray(p[f"conv_{i}"]["kernel"], np.float32).transpose(3, 2, 0, 1).copy())
        sd[f"features.{ti}.bias"] = torch.from_numpy(np.asarray(p[f"conv_{i}"]["bias"], np.float32))
    for i, ti in enumerate(_TORCH_FC_IDX):
        sd[f"embeddings.{ti}.weight"] = torch.from_numpy(
            np.asarray(p[f"fc_{i}"]["kernel"], np.float32).T.copy())
        sd[f"embeddings.{ti}.bias"] = torch.from_numpy(np.asarray(p[f"fc_{i}"]["bias"], np.float32))
    return sd


def random_state_dict(seed: int = 0) -> dict:
    """A seeded torchvggish-layout state dict of float32 numpy arrays, PCA
    buffers under 'pproc.': He-normal weights, small biases, a scaled
    orthogonal PCA basis. For random-weight runs (no weights are in the
    repository)."""
    rng = np.random.default_rng(seed)
    sd, cin = {}, 1
    for ti, ch in zip(_TORCH_CONV_IDX, _CONV_CHANNELS):
        sd[f"features.{ti}.weight"] = (rng.standard_normal((ch, cin, 3, 3), np.float32)
                                       * np.float32(np.sqrt(2.0 / (9 * cin))))
        sd[f"features.{ti}.bias"] = rng.standard_normal(ch, np.float32) * np.float32(0.01)
        cin = ch
    for ti, (fin, fout) in zip(_TORCH_FC_IDX, _FC_DIMS):
        sd[f"embeddings.{ti}.weight"] = (rng.standard_normal((fout, fin), np.float32)
                                         * np.float32(np.sqrt(2.0 / fin)))
        sd[f"embeddings.{ti}.bias"] = rng.standard_normal(fout, np.float32) * np.float32(0.01)
    # a quarter of an orthogonal basis around 2.0: these weights give
    # embeddings of mean ~2 and deviation ~3 for music-like input, so that few
    # quantised values clip at 0 or 255
    q, _ = np.linalg.qr(rng.standard_normal((EMBEDDING_DIM, EMBEDDING_DIM)))
    sd["pproc.pca_eigen_vectors"] = (0.25 * q).astype(np.float32)
    sd["pproc.pca_means"] = np.full((EMBEDDING_DIM, 1), 2.0, np.float32)
    return sd


def vggish_embedding(model: VGGish, pca, audio) -> np.ndarray:
    """Waveform (16 kHz) -> (num_examples, 128) float32 embeddings, PCA +
    quantisation applied when `pca` is present (the reference computes FAD/KL
    statistics on the postprocessed embeddings)."""
    ex = log_mel_examples(audio)
    if ex.shape[0] == 0:
        return np.zeros((0, EMBEDDING_DIM), np.float32)
    device = next(model.parameters()).device
    with torch.no_grad():
        emb = model(torch.from_numpy(ex[..., None]).to(device)).cpu().numpy()
    return pca(emb) if pca is not None else emb
