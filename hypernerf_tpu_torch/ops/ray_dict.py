"""Flat (N, 8|9) ray tensors -> the model's ray dict
(port of ``hypernerf_tpu/ops/ray_dict.py``)."""

from __future__ import annotations

import torch

METADATA_KEYS = ('warp', 'camera', 'appearance', 'time')


def prepare_ray_dict(rays: torch.Tensor) -> dict:
    """Split rays (..., 8|9) — origin, direction, near, far[, image id].

    Higher-rank input is flattened to (N, C). Without an id column every
    ray gets id 0. Returns {'origins', 'directions', 'viewdirs': None,
    'near', 'far', 'metadata': {key: (N, 1) int64}}.
    """
    if rays.dim() > 2:
        rays = rays.reshape(-1, rays.shape[-1])
    if rays.shape[-1] == 9:
        idx = rays[:, 8:9].to(torch.int64)
    else:
        idx = torch.zeros((rays.shape[0], 1), dtype=torch.int64,
                          device=rays.device)
    return {
        'origins': rays[:, 0:3],
        'directions': rays[:, 3:6],
        'viewdirs': None,
        'near': rays[:, 6],
        'far': rays[:, 7],
        'metadata': {k: idx for k in METADATA_KEYS},
    }
