"""Warp fields (port of ``hypernerf_tpu/models/warping.py``): the
translation field. SE(3) and quaternion fields are ROADMAP item A.9."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from hypernerf_tpu_torch.models.modules import MLP, xavier_normal_
from hypernerf_tpu_torch.ops.posenc import posenc_orig, posenc_orig_channels


class TranslationField(nn.Module):
    """warped = points + MLP(posenc_orig(points, n_freq) ++ embed).

    Xavier-normal hidden init, U(0, 1e-4) output init.
    """

    def __init__(self, embed_ch: int, depth: int = 6, width: int = 128,
                 n_freq: int = 10, skips: Sequence[int] = (4,),
                 dtype=torch.float32):
        super().__init__()
        self.n_freq = n_freq
        self.mlp = MLP(posenc_orig_channels(3, n_freq) + embed_ch, 3, depth,
                       width, skips, hidden_init=xavier_normal_,
                       output_init=lambda w: nn.init.uniform_(w, 0.0, 1e-4),
                       dtype=dtype)

    def forward(self, points: torch.Tensor, embed: torch.Tensor):
        inputs = torch.cat([posenc_orig(points, self.n_freq),
                            embed.to(points.dtype)], dim=-1)
        return points + self.mlp(inputs).to(points.dtype)
