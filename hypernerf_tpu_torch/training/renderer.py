"""Full-image rendering in fixed-size chunks
(port of ``hypernerf_tpu/training/renderer.py``).

The rays are padded to a multiple of the chunk by repeating the last ray, so
every chunk has one shape, and the padding is sliced off the outputs. A
grid-trained model renders through its occupancy grid, passed to every
chunk.

Over a ``parallel.DataParallel`` context of N ranks (the JAX renderer's
``shard_map`` over ``P('data')``) the rays are padded to a multiple of
``chunk * N``, rank r renders the r-th contiguous share of the chunks, and
every rank gets the whole frame back (``parallel.gather_rows``: a broadcast
from each rank, since gloo has no all_gather of CUDA tensors). Each chunk
holds the rays it holds on one rank, so the frame is the one-rank frame.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
from hypernerf_tpu_torch.parallel.mesh import gather_rows

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
                quantize: bool = False,
                extra_params: Optional[dict] = None,
                occupancy_grid: Optional[torch.Tensor] = None,
                to_numpy: bool = True,
                mesh=None) -> Dict[str, Dict[str, np.ndarray]]:
    """Render (N, 8|9) rays through ``model`` chunk by chunk, on the
    model's device, at the annealing alphas ``extra_params`` (the kernels'
    window rows built once for every chunk), with the (G, G, G)
    ``occupancy_grid`` of a grid-trained model (None: uniform coarse
    sampling).

    Returns numpy {level: {output: (N, ...)}} for the ``levels`` asked for
    (all when None); with ``quantize`` rgb comes back as uint8. A point
    output in ``keep`` (``POINT_OUTPUTS``) makes the model return points.
    ``to_numpy=False`` returns the tensors on the model's device instead
    (the trainer's val stats are computed there). ``mesh``: a
    ``parallel.DataParallel`` context whose ranks share the chunks (see the
    module docstring); call it on every rank with the same rays.
    """
    device = next(model.parameters()).device
    rays = torch.as_tensor(rays, dtype=torch.float32, device=device)
    n = rays.shape[0]
    ranks = 1 if mesh is None else mesh.world_size
    pad = (-n) % (chunk * ranks)
    if pad:
        rays = torch.cat([rays, rays[-1:].expand(pad, rays.shape[1])], 0)
    share = rays.shape[0] // ranks
    first = 0 if mesh is None else mesh.rank * share
    parts: Dict[str, Dict[str, list]] = {}
    window_rows = model.window_rows(extra_params, device)
    for start in range(first, first + share, chunk):
        out = model(prepare_ray_dict(rays[start:start + chunk]),
                    deterministic=True, return_weights=False,
                    return_points=any(k in POINT_OUTPUTS for k in keep),
                    extra_params=extra_params, window_rows=window_rows,
                    occupancy_grid=occupancy_grid)
        for level, res in out.items():
            if levels is not None and level not in levels:
                continue
            for k, v in res.items():
                if k not in keep:
                    continue
                if quantize and k == 'rgb':
                    v = quantize_rgb_u8(v)
                parts.setdefault(level, {}).setdefault(k, []).append(v)
    out = {level: {k: torch.cat(vs, 0) for k, vs in res.items()}
           for level, res in parts.items()}
    if ranks > 1:
        keys = [(level, k) for level in sorted(out)
                for k in sorted(out[level])]
        for (level, k), v in zip(keys, gather_rows(
                mesh, [out[level][k] for level, k in keys])):
            out[level][k] = v
    out = {level: {k: v[:n] for k, v in res.items()}
           for level, res in out.items()}
    if to_numpy:
        out = {level: {k: v.cpu().numpy() for k, v in res.items()}
               for level, res in out.items()}
    return out


class ImageRenderer:
    """``render_rays`` with its chunk, outputs, levels, annealing alphas,
    occupancy grid and data-parallel context (``mesh``: the ranks share
    each frame's chunks) fixed."""

    def __init__(self, model, chunk: int = 8192, keep=KEEP, levels=None,
                 quantize: bool = False, extra_params=None,
                 occupancy_grid=None, mesh=None):
        self.model = model
        self.mesh = mesh
        self.chunk = chunk
        self.keep = tuple(keep)
        self.levels = None if levels is None else tuple(levels)
        self.quantize = quantize
        self.extra_params = extra_params
        self.occupancy_grid = occupancy_grid

    def __call__(self, rays) -> Dict[str, Dict[str, np.ndarray]]:
        return render_rays(self.model, rays, self.chunk, self.keep,
                           self.levels, self.quantize, self.extra_params,
                           self.occupancy_grid, mesh=self.mesh)
