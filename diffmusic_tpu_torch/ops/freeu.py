"""FreeU Fourier filtering (port of `diffmusic_tpu/ops/freeu.py`; reference:
diffmusic/torch_utils.py:86-144).

Present but unused in the reference pipelines, as in the JAX package:
`fourier_filter` scales the centred low frequencies of skip features, and
`apply_freeu` rescales half of the backbone channels and filters the skip at
the first two resolutions.
"""

from typing import Tuple

import torch


def fourier_filter(x: torch.Tensor, threshold: int, scale: float) -> torch.Tensor:
    """Scale the frequencies inside a centred (2 threshold)^2 box of the 2-D
    FFT of x (B, C, H, W), fftshift and ifftshift included; computed in fp32,
    returned in x's dtype."""
    x_freq = torch.fft.fftshift(torch.fft.fftn(x.float(), dim=(-2, -1)), dim=(-2, -1))
    h, w = x_freq.shape[-2:]
    crow, ccol = h // 2, w // 2
    mask = torch.ones(x_freq.shape, dtype=torch.float32, device=x.device)
    mask[..., crow - threshold:crow + threshold, ccol - threshold:ccol + threshold] = scale
    x_freq = torch.fft.ifftshift(x_freq * mask, dim=(-2, -1))
    return torch.fft.ifftn(x_freq, dim=(-2, -1)).real.to(x.dtype)


def apply_freeu(resolution_idx: int, hidden_states: torch.Tensor,
                res_hidden_states: torch.Tensor,
                **freeu_kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone rescale by b1 (b2) and skip filter by s1 (s2) at resolution 0
    (1); other resolutions pass through (torch_utils.py:120-144)."""
    if resolution_idx in (0, 1):
        b, s = (("b1", "s1"), ("b2", "s2"))[resolution_idx]
        num_half = hidden_states.shape[1] // 2
        hidden_states = torch.cat([hidden_states[:, :num_half] * freeu_kwargs[b],
                                   hidden_states[:, num_half:]], dim=1)
        res_hidden_states = fourier_filter(res_hidden_states, threshold=1,
                                           scale=freeu_kwargs[s])
    return hidden_states, res_hidden_states
