"""Volume rendering (port of ``hypernerf_tpu/ops/rendering.py``).

Same numerics: eps 1e-5 inside the exclusive transmittance cumprod, a 1e7
"sample at infinity" delta, deltas scaled by |d|, and acc excluding the
infinity sample.
"""

from __future__ import annotations

import torch


def volumetric_rendering(rgb, sigma, z_vals, dirs, use_white_background: bool,
                         sample_at_infinity: bool = True, eps: float = 1e-5):
    """Alpha-composite (B, S, 3) rgb and (B, S) sigma at (B, S) depths.

    Returns a dict of 'rgb' (B, 3), 'depth', 'med_depth', 'acc' (B,) and
    'weights' (B, S).
    """
    last_sample_z = 1e7 if sample_at_infinity else 1e-7
    dists = torch.cat([z_vals[..., 1:] - z_vals[..., :-1],
                       torch.full_like(z_vals[..., :1], last_sample_z)],
                      dim=-1)
    dists = dists * torch.linalg.norm(dirs, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-sigma * dists)
    accum_prod = torch.cat([torch.ones_like(alpha[..., :1]),
                            torch.cumprod(1.0 - alpha[..., :-1] + eps,
                                          dim=-1)], dim=-1)
    weights = alpha * accum_prod

    out_rgb = torch.sum(weights[..., None] * rgb, dim=-2)
    exp_depth = torch.sum(weights * z_vals, dim=-1)
    med_depth = compute_depth_map(weights, z_vals)
    acc = torch.sum(weights, dim=-1)
    if use_white_background:
        out_rgb = out_rgb + (1.0 - acc[..., None])
    if sample_at_infinity:
        acc = torch.sum(weights[..., :-1], dim=-1)
    return {'rgb': out_rgb, 'depth': exp_depth, 'med_depth': med_depth,
            'acc': acc, 'weights': weights}


def compute_opaqueness_mask(weights, depth_threshold: float = 0.5):
    """One-hot at the first sample whose cumulative weight reaches the
    threshold (all zero when none does)."""
    opaqueness = torch.cumsum(weights, dim=-1) >= depth_threshold
    padded = torch.cat([torch.zeros_like(opaqueness[..., :1]),
                        opaqueness[..., :-1]], dim=-1)
    return torch.logical_xor(opaqueness, padded).to(weights.dtype)


def compute_depth_index(weights, depth_threshold: float = 0.5):
    """Sample index of the median-depth accumulation (0 when none)."""
    return torch.argmax(compute_opaqueness_mask(weights, depth_threshold),
                        dim=-1)


def compute_depth_map(weights, z_vals, depth_threshold: float = 0.5):
    """Median-accumulation depth."""
    mask = compute_opaqueness_mask(weights, depth_threshold)
    return torch.sum(mask * z_vals, dim=-1)
