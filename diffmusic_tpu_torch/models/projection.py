"""AudioLDM2ProjectionModel (port of `diffmusic_tpu/models/projection.py`):
project the CLAP and T5 streams into GPT-2's width and wrap each in its
learned SOS/EOS embeddings."""

from typing import Optional, Tuple

import torch
import torch.nn as nn

from .configs import ProjectionConfig
from .layers import Dense


def _add_special_tokens(hidden, mask, sos, eos):
    b = hidden.shape[0]
    hidden = torch.cat([sos.expand(b, 1, -1), hidden, eos.expand(b, 1, -1)], dim=1)
    if mask is not None:
        ones = torch.ones(b, 1, dtype=mask.dtype, device=mask.device)
        mask = torch.cat([ones, mask, ones], dim=-1)
    return hidden, mask


class AudioLDM2ProjectionModel(nn.Module):
    def __init__(self, cfg: ProjectionConfig):
        super().__init__()
        d = cfg.langauge_model_dim
        self.projection = Dense(cfg.text_encoder_dim, d)
        self.projection_1 = Dense(cfg.text_encoder_1_dim, d)
        for name in ("sos_embed", "eos_embed", "sos_embed_1", "eos_embed_1"):
            setattr(self, name, nn.Parameter(torch.zeros(d)))

    def forward(self, hidden_states, hidden_states_1,
                attention_mask: Optional[torch.Tensor] = None,
                attention_mask_1: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        h0, m0 = _add_special_tokens(self.projection(hidden_states), attention_mask,
                                     self.sos_embed, self.eos_embed)
        h1, m1 = _add_special_tokens(self.projection_1(hidden_states_1), attention_mask_1,
                                     self.sos_embed_1, self.eos_embed_1)
        mask = torch.cat([m0, m1], dim=-1) if m0 is not None and m1 is not None else None
        return torch.cat([h0, h1], dim=1), mask
