"""Occupancy-grid guided coarse sampling (port of
``hypernerf_tpu/ops/occupancy.py``).

A (G, G, G) grid holds an EMA-max of the model's own density over a box
(``update_grid``, refreshed by ``training.train_state.make_occupancy_update``).
It reshapes where the coarse samples fall, not how many there are: each ray
probes the grid at M uniform bins, the piecewise-constant PDF occ / max(occ)
+ floor is inverted with ``ops.sampling.piecewise_constant_pdf`` and the
depths are sorted (``sample_occupancy_rays``); the fine draw's weights are
gated by the grid at the coarse depths (``gate_fine_weights``).

Voxel (i, j, k) covers unit coordinates [i, i + 1) / G along the first axis
and so on; its flat index is (i G + j) G + k, the axis order of
``cell_points``' ``meshgrid(indexing='ij')``. Every random draw is passed in
(``u``) or taken from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hypernerf_tpu_torch.ops.sampling import _per_ray, piecewise_constant_pdf


def config_bbox(cfg):
    """((3,), (3,)) world corners of a NerfConfig's grid box."""
    return ((cfg.occupancy_bbox_min,) * 3, (cfg.occupancy_bbox_max,) * 3)


def init_grid(resolution: int, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """A fresh (G, G, G) grid of zeros: everything empty, but the sampling
    floor keeps full support until the first update."""
    return torch.zeros((resolution,) * 3, dtype=dtype, device=device)


def _axes(bbox):
    """Each axis's (min, max - min) of the box as Python floats, the extent
    taken in float32 as the JAX package takes it. Scalars, so that no call
    copies the corners to the device (a synchronous copy a call)."""
    lo = np.asarray(bbox[0], np.float32)
    span = np.asarray(bbox[1], np.float32) - lo
    return [(float(a), float(b)) for a, b in zip(lo, span)]


def _to_unit(points: torch.Tensor, bbox) -> torch.Tensor:
    """World points -> the box's unit coordinates."""
    return torch.stack([(points[..., i] - lo) / span
                        for i, (lo, span) in enumerate(_axes(bbox))], dim=-1)


def grid_lookup(grid: torch.Tensor, points: torch.Tensor,
                bbox) -> torch.Tensor:
    """Nearest-voxel density at (..., 3) world ``points``; 0 outside the
    box. Returns (...,)."""
    res = grid.shape[0]
    uvw = _to_unit(points, bbox)
    idx = torch.clamp(torch.floor(uvw * res).to(torch.int64), 0, res - 1)
    inside = torch.all((uvw >= 0.0) & (uvw < 1.0), dim=-1)
    flat = (idx[..., 0] * res + idx[..., 1]) * res + idx[..., 2]
    vals = grid.reshape(-1)[flat]
    return torch.where(inside, vals, torch.zeros_like(vals))


def cell_points(resolution: int, bbox, u: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                device=None) -> torch.Tensor:
    """(G^3, 3) world positions of the cells in flat-index order: jittered
    within each cell by the uniforms ``u`` (G^3, 3), or by uniforms drawn
    from ``generator``; the cell centres when neither is given."""
    g = resolution
    if u is not None:
        device = u.device
    ii = torch.arange(g, dtype=torch.float32, device=device)
    zz, yy, xx = torch.meshgrid(ii, ii, ii, indexing='ij')
    uvw = torch.stack([zz, yy, xx], dim=-1).reshape(-1, 3)
    if u is None and generator is not None:
        u = torch.rand(uvw.shape, generator=generator, device=device)
    uvw = (uvw + (0.5 if u is None else u)) / g
    return torch.stack([lo + uvw[:, i] * span
                        for i, (lo, span) in enumerate(_axes(bbox))], dim=-1)


def update_grid(grid: torch.Tensor, sigma: torch.Tensor,
                decay: float) -> torch.Tensor:
    """EMA-max: max(grid * decay, sigma), ``sigma`` (G^3,) densities at the
    cells in flat-index order."""
    g = grid.shape[0]
    return torch.maximum(grid * decay, sigma.reshape(g, g, g))


def _normalised(occ: torch.Tensor, floor: float) -> torch.Tensor:
    peak = torch.amax(occ, dim=-1, keepdim=True)
    return occ / torch.clamp(peak, min=1e-6) + floor


def gate_fine_weights(grid, origins, directions, z_vals, weights, bbox,
                      floor: float = 0.01) -> torch.Tensor:
    """The fine draw's (B, S) coarse weights times the normalised occupancy
    at their depths ``z_vals`` (B, S) plus ``floor``, so that the fine
    samples go where the coarse weights and the grid agree."""
    pts = origins[:, None, :] + z_vals[..., None] * directions[:, None, :]
    return weights * _normalised(grid_lookup(grid, pts, bbox), floor)


def sample_occupancy_rays(origins, directions, grid, bbox, num_samples: int,
                          near, far, n_probes: int,
                          use_stratified_sampling: bool, floor: float = 0.01,
                          u: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None):
    """Coarse depths from the grid's piecewise-constant PDF, in place of
    ``sample_along_rays`` (linear depth): ``n_probes`` uniform bins in
    [near, far] per ray, weights occ / max(occ) + floor, ``num_samples``
    inverse-CDF depths, sorted. ``u``: (B, S) ascending uniforms of the
    stratified draw (``sorted_uniform`` from ``generator`` when absent);
    linspace(0, 1) when not stratified.

    Returns z_vals (B, S) and points (B, S, 3).
    """
    batch = origins.shape[0]
    near = _per_ray(near, batch, origins)
    far = _per_ray(far, batch, origins)
    t_edges = torch.linspace(0.0, 1.0, n_probes + 1, dtype=origins.dtype,
                             device=origins.device)
    z_edges = near * (1.0 - t_edges) + far * t_edges
    z_mid = 0.5 * (z_edges[:, 1:] + z_edges[:, :-1])
    probes = origins[:, None, :] + z_mid[..., None] * directions[:, None, :]
    weights = _normalised(grid_lookup(grid, probes, bbox), floor)
    z_vals = piecewise_constant_pdf(z_edges, weights, num_samples,
                                    use_stratified_sampling, u, generator)
    z_vals = torch.sort(z_vals, dim=-1)[0]
    points = origins[:, None, :] + z_vals[..., None] * directions[:, None, :]
    return z_vals, points
