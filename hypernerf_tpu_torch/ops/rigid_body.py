"""Batched rigid-body (SE(3) / SO(3)) math (port of
``hypernerf_tpu/ops/rigid_body.py``).

Every function is batched over arbitrary leading dimensions. The matrix forms
(``exp_so3``, ``exp_se3``, ``exp_se3_from_wv``, ``transform_points``) are the
reference the vector form is tested against; the warp field uses
``se3_warp_vec``, the screw exponential applied to points with cross and dot
products only. Its gradient is the hand-derived ``se3_warp_vec_bwd`` (one
``torch.autograd.Function``), the same closed form the CUDA kernels evaluate
(``kernels/csrc/se3_trunk.cuh``), so the CPU path, the per-module CUDA path
and the level kernels compute one gradient.

Unlike the JAX forward, which takes the root of an unclamped ``sum(w * w)``
(a NaN gradient at w = 0 under autodiff), both the forward and the backward
here clamp ``|w|^2`` BEFORE the root. The values are the same: at
``|w| <= 1e-6`` the result is ``points + v`` either way.
"""

from __future__ import annotations

import torch

# Below this angle the exponential degenerates to a pure translation.
_SMALL_ANGLE = 1e-6


def skew(w):
    """Skew (cross-product) matrix of 3-vectors: (..., 3) -> (..., 3, 3)."""
    zeros = torch.zeros_like(w[..., 0])
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    return torch.stack([torch.stack([zeros, -wz, wy], dim=-1),
                        torch.stack([wz, zeros, -wx], dim=-1),
                        torch.stack([-wy, wx, zeros], dim=-1)], dim=-2)


def rp_to_se3(r, p):
    """(..., 3, 3) rotations and (..., 3) translations -> (..., 4, 4)
    homogeneous transforms."""
    top = torch.cat([r, p[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=r.dtype,
                          device=r.device).expand(*r.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def exp_so3(w, theta):
    """Rodrigues' formula: rotation about unit axes ``w`` (..., 3) by
    angles ``theta`` (...,) -> (..., 3, 3)."""
    wm = skew(w)
    theta = theta[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + torch.sin(theta) * wm + (1.0 - torch.cos(theta)) * (wm @ wm)


def exp_se3(screw_axis, theta):
    """Exponential map se(3) -> SE(3) (Modern Robotics Eqn 3.88):
    (..., 6) screw axes [w, v] with unit w, (...,) magnitudes -> (..., 4, 4).
    """
    w, v = screw_axis[..., :3], screw_axis[..., 3:]
    wm = skew(w)
    wm2 = wm @ wm
    t = theta[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    g = t * eye + (1.0 - torch.cos(t)) * wm + (t - torch.sin(t)) * wm2
    return rp_to_se3(exp_so3(w, theta), (g @ v[..., :, None]).squeeze(-1))


def exp_se3_from_wv(w, v):
    """SE(3) exponential of unnormalised (w, v): theta = |w|, the screw axis
    normalised by it, and a pure translation by ``v`` at theta <= 1e-6."""
    theta = torch.linalg.norm(w, dim=-1)
    safe = torch.clamp(theta, min=_SMALL_ANGLE)
    screw = torch.cat([w / safe[..., None], v / safe[..., None]], dim=-1)
    transform = exp_se3(screw, safe)
    translate = torch.eye(4, dtype=w.dtype, device=w.device).expand(
        *w.shape[:-1], 4, 4).clone()
    translate[..., :3, 3] = v
    return torch.where((theta <= _SMALL_ANGLE)[..., None, None], translate,
                       transform)


def cross(a, b):
    """Cross product of (..., 3) vectors from component slices."""
    a0, a1, a2 = a[..., 0:1], a[..., 1:2], a[..., 2:3]
    b0, b1, b2 = b[..., 0:1], b[..., 1:2], b[..., 2:3]
    return torch.cat([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                      a0 * b1 - a1 * b0], dim=-1)


def dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def safe_angle(w, small_angle: float = _SMALL_ANGLE):
    """(|w| with |w|^2 clamped at small_angle^2 before the root, the mask of
    rows at or below the clamp), each (..., 1)."""
    sq = dot(w, w)
    small_sq = small_angle * small_angle
    safe = torch.sqrt(torch.where(sq < small_sq, torch.full_like(sq, small_sq),
                                  sq))
    return safe, sq <= small_sq


def se3_warp_vec_fwd(w, v, points):
    """The values of ``se3_warp_vec`` (no autograd graph is meant to pass
    through here)."""
    safe, small = safe_angle(w)
    a = w / safe
    sin_t, cos_t = torch.sin(safe), torch.cos(safe)
    one_m_cos = 1.0 - cos_t
    # Unit-axis identity a x (a x x) = a (a.x) - x.
    rp = points + sin_t * cross(a, points) + one_m_cos * (a * dot(a, points)
                                                          - points)
    gv = (v + (one_m_cos / safe) * cross(a, v)
          + ((safe - sin_t) / safe) * (a * dot(a, v) - v))
    return torch.where(small, points + v, rp + gv)


def se3_warp_vec_bwd(w, v, points, g):
    """Hand-derived VJP of ``se3_warp_vec``: g -> (d_w, d_v, d_points).

    warped = R p + G v with R = I + sin(t) A + (1 - cos(t)) A^2 and
    G = I + b1 A + b2 A^2, b1 = (1 - cos(t)) / t, b2 = (t - sin(t)) / t,
    A = [a]_x, a = w / t, t = |w|. Then d_p = R^T g, d_v = G^T g; the axis'
    and the angle's cotangents collect the R and G terms and pull back through
    a = w / t: d_w = a d_t + (I - a a^T) d_a / t. At t <= 1e-6:
    d_p = d_v = g, d_w = 0.
    """
    safe, small = safe_angle(w)
    a = w / safe
    sin_t, cos_t = torch.sin(safe), torch.cos(safe)
    one_m_cos = 1.0 - cos_t
    b1 = one_m_cos / safe
    b2 = (safe - sin_t) / safe
    ag, ap, av = dot(a, g), dot(a, points), dot(a, v)
    pg, vg = dot(points, g), dot(v, g)

    axg = cross(a, g)
    a_axg = a * ag - g
    d_p = g - sin_t * axg + one_m_cos * a_axg
    d_v = g - b1 * axg + b2 * a_axg
    d_a = (sin_t * cross(points, g)
           + one_m_cos * (points * ag - 2.0 * a * pg + g * ap)
           + b1 * cross(v, g)
           + b2 * (v * ag - 2.0 * a * vg + g * av))
    b1p = sin_t / safe - one_m_cos / (safe * safe)
    b2p = (sin_t - safe * cos_t) / (safe * safe)
    d_t = (cos_t * dot(cross(a, points), g) + sin_t * (ap * ag - pg)
           + b1p * dot(cross(a, v), g) + b2p * (av * ag - vg))
    d_w = a * d_t + (d_a - a * dot(a, d_a)) / safe
    return (torch.where(small, torch.zeros_like(g), d_w),
            torch.where(small, g, d_v), torch.where(small, g, d_p))


def retraction(fwd, bwd):
    """``(w, v, points) -> warped`` with values from ``fwd`` and the gradient
    from the hand-derived ``bwd``."""

    class Retraction(torch.autograd.Function):
        @staticmethod
        def forward(ctx, w, v, points):
            ctx.save_for_backward(w, v, points)
            return fwd(w, v, points)

        @staticmethod
        def backward(ctx, g):
            return bwd(*ctx.saved_tensors, g)

    def apply(w, v, points):
        w, v, points = torch.broadcast_tensors(w, v, points)
        return Retraction.apply(w, v, points)

    return apply


se3_warp_vec = retraction(se3_warp_vec_fwd, se3_warp_vec_bwd)
se3_warp_vec.__doc__ = """``exp_se3_from_wv`` + ``transform_points`` in
vector form: raw rotations ``w`` and translations ``v`` (..., 3) applied to
``points`` (..., 3). Differentiable through ``se3_warp_vec_bwd``."""


def retraction_jacobian(bwd, w, v, points, dw, dv):
    """J = d warped / d points of warped = retract(w(p), v(p), p).

    Args:
      bwd: the retraction's hand-derived VJP (``se3_warp_vec_bwd``,
        ``quaternion.quat_warp_vec_bwd``).
      w, v, points: (..., 3).
      dw, dv: (..., 3, 3) point-tangents, dw[..., i, k] = d w_i / d p_k.

    Returns:
      (..., 3, 3) J[..., i, k] = d warped_i / d p_k = (M_w dw + M_v dv +
      M_p)[i, k], where row i of M_x = d warped / d x is the VJP at the
      cotangent e_i (one call of ``bwd`` on the three cotangents stacked),
      in the dtype of ``w``.

    Plain tensor code, which autograd differentiates for the elastic loss,
    evaluated in float64: where training starts (|w| of 1e-3 to 1e-2) the
    angle's derivatives of (1 - cos t) / t and (t - sin t) / t cancel in
    fp32, which left J 6.8e-3 and its gradient in w several times its own
    size from the exact values (SE(3), tests/test_torch_fused_jacobian.py).
    ``bwd`` keeps its clamped angle in both branches of every select, so
    rows at w = 0 get finite gradients.
    """
    dtype = w.dtype
    w, v, points, dw, dv = (t.to(torch.float64)
                            for t in (w, v, points, dw, dv))
    lead = (3,) + w.shape
    g = torch.eye(3, dtype=w.dtype, device=w.device).reshape(
        3, *([1] * (w.dim() - 1)), 3).expand(lead)
    rows = bwd(w.expand(lead), v.expand(lead), points.expand(lead), g)
    m_w, m_v, m_p = (r.movedim(0, -2) for r in rows)
    # Broadcast sums, not batched matrix products: for float64 3 x 3 blocks
    # PyTorch calls library GEMMs of 0.35 ms each on an H100 (17 ms a train
    # step).
    jac = m_p
    for j in range(3):
        jac = (jac + m_w[..., :, j, None] * dw[..., None, j, :]
               + m_v[..., :, j, None] * dv[..., None, j, :])
    return jac.to(dtype)


def to_homogenous(v):
    """(..., 3) points -> (..., 4) homogeneous coordinates."""
    return torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)


def from_homogenous(v):
    """(..., 4) homogeneous coordinates -> (..., 3) points."""
    return v[..., :3] / v[..., -1:]


def transform_points(transform, points):
    """Apply (..., 4, 4) transforms to (..., 3) points."""
    homo = to_homogenous(points)
    return from_homogenous((transform @ homo[..., :, None]).squeeze(-1))
