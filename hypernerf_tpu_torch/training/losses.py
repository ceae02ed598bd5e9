"""Training losses (port of ``hypernerf_tpu/training/losses.py``): the
photometric MSE and the Nerfies elastic and background regularizers."""

from __future__ import annotations

import math

import torch


def mse_loss(results: dict, targets: torch.Tensor) -> torch.Tensor:
    """MSE on the coarse rgb plus (if present) the fine rgb."""
    loss = torch.mean((results['coarse']['rgb'] - targets) ** 2)
    if results.get('fine') is not None:
        loss = loss + torch.mean((results['fine']['rgb'] - targets) ** 2)
    return loss


loss_dict = {'mse': mse_loss}


def _sym3_eigvals_cm(xx, yy, zz, xy, xz, yz):
    """Eigenvalues of symmetric 3x3 matrices from their six component
    tensors (each (...,)), closed form; returns (l1, l2, l3), descending.

    The trigonometric method (Smith 1961): shift by the mean eigenvalue q,
    normalise by p = sqrt(tr(B^2) / 6) and read the roots of the normalised
    characteristic polynomial off acos(det(B / p) / 2). Where the spread is
    negligible against the mean (the warp's init, J ~ I) every eigenvalue is
    q: the test is scale-relative, and both branches of each select see
    safe inputs (p = 1 in the degenerate entries), so the discarded branch's
    gradient stays finite (the double-where).
    """
    q = (xx + yy + zz) / 3.0
    bxx, byy, bzz = xx - q, yy - q, zz - q
    p2 = (bxx * bxx + byy * byy + bzz * bzz
          + 2.0 * (xy * xy + xz * xz + yz * yz)) / 6.0
    degen = p2 < (1e-12 * q * q + 1e-30)
    p = torch.sqrt(torch.where(degen, torch.ones_like(p2), p2))
    det_b = (bxx * (byy * bzz - yz * yz)
             - xy * (xy * bzz - yz * xz)
             + xz * (xy * yz - byy * xz))
    r = torch.clamp(0.5 * det_b / (p * p * p), -1.0 + 1e-6, 1.0 - 1e-6)
    phi = torch.arccos(r) / 3.0
    two_p = torch.where(degen, torch.zeros_like(p), 2.0 * p)
    l1 = q + two_p * torch.cos(phi)
    l3 = q + two_p * torch.cos(phi + 2.0 * math.pi / 3.0)
    l2 = 3.0 * q - l1 - l3
    return l1, l2, l3


def _sym3_eigvals(a: torch.Tensor) -> torch.Tensor:
    """Eigenvalues (descending) of symmetric (..., 3, 3) matrices."""
    comp = [a[..., i, j] for i, j in
            ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))]
    return torch.stack(_sym3_eigvals_cm(*comp), dim=-1)


def elastic_loss(jacobian: torch.Tensor, eps: float = 1e-6,
                 scale: float = 0.03) -> torch.Tensor:
    """Per-sample Nerfies elastic penalty (Park et al. 2021, section 3.4):
    ||log Sigma||^2 over the warp Jacobian's singular values, through the
    Geman-McClure remap at ``scale``. The singular values come from the
    closed-form eigenvalues of J^T J (log sigma = 0.5 log lambda, lambda
    floored at eps^2). Identity Jacobians score exactly 0.

    Args:
      jacobian: (..., 3, 3) d warped / d points per sample.

    Returns:
      (...,) per-sample losses.
    """
    jac = jacobian.float()
    c = [jac[..., i, j] for i in range(3) for j in range(3)]

    def gram(a, b):  # (J^T J)[a, b]: columns a and b of J
        return c[a] * c[b] + c[a + 3] * c[b + 3] + c[a + 6] * c[b + 6]

    lam = _sym3_eigvals_cm(gram(0, 0), gram(1, 1), gram(2, 2), gram(0, 1),
                           gram(0, 2), gram(1, 2))
    sq_residual = 0.0
    for lam_i in lam:
        log_sval = 0.5 * torch.log(torch.clamp(lam_i, min=eps * eps))
        sq_residual = sq_residual + log_sval ** 2
    squared_scaled = sq_residual / (scale ** 2)
    return 2.0 * squared_scaled / (squared_scaled + 4.0)


def background_loss(warped_points: torch.Tensor, points: torch.Tensor,
                    scale: float = 0.001) -> torch.Tensor:
    """Per-point Nerfies background penalty (section 3.5): known-static
    points must not move under the warp; the squared displacement through
    the Geman-McClure remap at ``scale``. Returns (...,)."""
    sq = torch.sum((warped_points - points) ** 2, dim=-1)
    squared_scaled = sq / (scale ** 2)
    return 2.0 * squared_scaled / (squared_scaled + 4.0)


def weighted_elastic_loss(results: dict, scale: float = 0.03) -> torch.Tensor:
    """The elastic penalty of every level that carries a Jacobian, weighted
    by the rendering weights ('warp_jacobian_weights' where the model
    subsampled the Jacobian, else 'weights'): summed over a ray's samples,
    averaged over rays, summed over levels."""
    total = 0.0
    for level in ('coarse', 'fine'):
        res = results.get(level)
        if not res or 'warp_jacobian' not in res:
            continue
        per_sample = elastic_loss(res['warp_jacobian'], scale=scale)
        w = res.get('warp_jacobian_weights', res.get('weights')).float()
        total = total + torch.mean(torch.sum(w * per_sample, dim=-1))
    return total
