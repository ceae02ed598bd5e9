"""Ray sampling (port of ``hypernerf_tpu/ops/sampling.py``).

Every random draw is either passed in (``t_rand``, ``u``) or taken from an
explicit ``torch.Generator``; the render path draws nothing. The CDF is
inverted with ``torch.searchsorted`` and gathers — the JAX package's
comparison-mask form was a TPU workaround — with the same clamps on the
bracket and the same ``denom < eps`` rule, so both give the same samples.
"""

from __future__ import annotations

from typing import Optional

import torch


def _per_ray(v, batch: int, like: torch.Tensor) -> torch.Tensor:
    """Scalar or (B,)/(B, 1) near/far -> (B, 1)."""
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return v.reshape(-1, 1).expand(batch, 1)


def sample_along_rays(origins, directions, num_samples: int, near, far,
                      use_stratified_sampling: bool,
                      use_linear_disparity: bool,
                      t_rand: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
    """Coarse depths along rays.

    Args:
      origins / directions: (B, 3).
      near / far: scalars or per-ray (B,) / (B, 1).
      t_rand: (B, S) uniforms for the stratified jitter; drawn from
        ``generator`` when absent. Unused when not stratified.

    Returns:
      z_vals (B, S) and points (B, S, 3).
    """
    b = origins.shape[0]
    near = _per_ray(near, b, origins)
    far = _per_ray(far, b, origins)
    t_vals = torch.linspace(0.0, 1.0, num_samples, dtype=origins.dtype,
                            device=origins.device)
    if not use_linear_disparity:
        z_vals = near * (1.0 - t_vals) + far * t_vals
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    if use_stratified_sampling:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        if t_rand is None:
            t_rand = torch.rand((b, num_samples), generator=generator,
                                dtype=origins.dtype, device=origins.device)
        z_vals = lower + (upper - lower) * t_rand
    else:
        z_vals = z_vals.expand(b, num_samples)
    points = origins[:, None, :] + z_vals[..., None] * directions[:, None, :]
    return z_vals, points


def sorted_uniform(n_rays: int, num_samples: int,
                   generator: Optional[torch.Generator] = None,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """(B, N) iid uniforms, ascending per row, without a sort.

    The order-statistics identity the JAX package uses: u_(i) = S_i / S_(N+1)
    with S_i the sum of i Exp(1) spacings.
    """
    e = -torch.log1p(-torch.rand((n_rays, num_samples + 1),
                                 generator=generator, dtype=dtype,
                                 device=device))
    s = torch.cumsum(e, dim=-1)
    return s[:, :-1] / s[:, -1:]


def piecewise_constant_pdf(bins, weights, num_samples: int,
                           use_stratified_sampling: bool,
                           u: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None):
    """Inverse-CDF draws from a piecewise-constant PDF over ``bins``.

    Args:
      bins: (B, n_bins + 1) ascending edges; weights: (B, n_bins) >= 0.
      u: (B, num_samples) draws in [0, 1]. Defaults to linspace(0, 1) when
        not stratified, else ``sorted_uniform`` from ``generator``.

    Returns:
      (B, num_samples) depths, detached.
    """
    eps = 1e-5
    n_rays, n_bins = weights.shape
    weights = weights + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    if u is None:
        if use_stratified_sampling:
            u = sorted_uniform(n_rays, num_samples, generator, bins.dtype,
                               bins.device)
        else:
            u = torch.linspace(0.0, 1.0, num_samples, dtype=bins.dtype,
                               device=bins.device).expand(n_rays, num_samples)
    u = u.contiguous()
    # idx = #{k : cdf_k <= u}; the bracket is [idx - 1, idx], clamped into
    # [0, n_bins - 1] x [1, n_bins] exactly as the JAX masked max/min is.
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    i0 = torch.clamp(idx - 1, 0, n_bins - 1)
    i1 = torch.clamp(idx, 1, n_bins)
    cdf_g0 = torch.gather(cdf, -1, i0)
    cdf_g1 = torch.gather(cdf, -1, i1)
    bins_g0 = torch.gather(bins, -1, i0)
    bins_g1 = torch.gather(bins, -1, i1)
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    samples = bins_g0 + (u - cdf_g0) / denom * (bins_g1 - bins_g0)
    return samples.detach()


def sample_pdf(bins, weights, origins, directions, z_vals, num_samples: int,
               use_stratified_sampling: bool,
               u: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
    """Hierarchical sampling: fine draws merged (sorted) with the coarse z.

    Returns z_vals (B, S + N) and points (B, S + N, 3).
    """
    z_samples = piecewise_constant_pdf(bins, weights, num_samples,
                                       use_stratified_sampling, u, generator)
    z_vals = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1)[0]
    points = origins[:, None, :] + z_vals[..., None] * directions[:, None, :]
    return z_vals, points
