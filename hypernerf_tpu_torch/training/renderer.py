"""Full-image rendering in fixed-size chunks
(port of ``hypernerf_tpu/training/renderer.py``).

The rays are padded to a multiple of the chunk by repeating the last ray, so
every chunk has one shape, and the padding is sliced off the outputs.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict

# Per-ray outputs kept from each chunk (weights dropped).
KEEP = ('rgb', 'depth', 'med_depth', 'acc')
# Outputs the model returns only with ``return_points``: per-sample
# 'points' and 'warped_points', per-ray 'med_points'.
POINT_OUTPUTS = ('points', 'warped_points', 'med_points')


def quantize_rgb_u8(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 on the device, bit-equal to ``utils.visualization.to_uint8``:
    clip to [0, 1], scale by 255, truncate."""
    return (torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8)


@torch.no_grad()
def render_rays(model, rays, chunk: int = 8192, keep: Sequence[str] = KEEP,
                levels: Optional[Sequence[str]] = None,
                quantize: bool = False) -> Dict[str, Dict[str, np.ndarray]]:
    """Render (N, 8|9) rays through ``model`` chunk by chunk, on the
    model's device.

    Returns numpy {level: {output: (N, ...)}} for the ``levels`` asked for
    (all when None); with ``quantize`` rgb comes back as uint8. A point
    output in ``keep`` (``POINT_OUTPUTS``) makes the model return points.
    """
    device = next(model.parameters()).device
    rays = torch.as_tensor(rays, dtype=torch.float32, device=device)
    n = rays.shape[0]
    pad = (-n) % chunk
    if pad:
        rays = torch.cat([rays, rays[-1:].expand(pad, rays.shape[1])], 0)
    parts: Dict[str, Dict[str, list]] = {}
    for start in range(0, rays.shape[0], chunk):
        out = model(prepare_ray_dict(rays[start:start + chunk]),
                    deterministic=True, return_weights=False,
                    return_points=any(k in POINT_OUTPUTS for k in keep))
        for level, res in out.items():
            if levels is not None and level not in levels:
                continue
            for k, v in res.items():
                if k not in keep:
                    continue
                if quantize and k == 'rgb':
                    v = quantize_rgb_u8(v)
                parts.setdefault(level, {}).setdefault(k, []).append(v)
    return {level: {k: torch.cat(vs, 0)[:n].cpu().numpy()
                    for k, vs in res.items()}
            for level, res in parts.items()}


class ImageRenderer:
    """``render_rays`` with its chunk, outputs and levels fixed."""

    def __init__(self, model, chunk: int = 8192, keep=KEEP, levels=None,
                 quantize: bool = False):
        self.model = model
        self.chunk = chunk
        self.keep = tuple(keep)
        self.levels = None if levels is None else tuple(levels)
        self.quantize = quantize

    def __call__(self, rays) -> Dict[str, Dict[str, np.ndarray]]:
        return render_rays(self.model, rays, self.chunk, self.keep,
                           self.levels, self.quantize)
