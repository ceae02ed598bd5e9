"""Batched quaternion math, xyzw convention: xyz imaginary, w real (port of
``hypernerf_tpu/ops/quaternion.py``).

The warp field uses ``quat_warp_vec``: the rotation by exp of a raw rotation
vector, then an uncoupled translation. Its gradient is the hand-derived
``quat_warp_vec_bwd`` (one ``torch.autograd.Function``, as
``rigid_body.se3_warp_vec``), the closed form the CUDA kernels evaluate.
"""

from __future__ import annotations

import torch

from hypernerf_tpu_torch.ops.rigid_body import (cross, dot, retraction,
                                                safe_angle)


def safe_acos(t, eps: float = 1e-7):
    """arccos clamped away from +-1 so the gradient stays finite."""
    return torch.arccos(torch.clamp(t, -1.0 + eps, 1.0 - eps))


def im(q):
    """Imaginary part: (..., 4) -> (..., 3)."""
    return q[..., :3]


def re(q):
    """Real part: (..., 4) -> (..., 1)."""
    return q[..., 3:]


def identity(dtype=torch.float32):
    """The identity quaternion [0, 0, 0, 1]."""
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype)


def conjugate(q):
    return torch.cat([-im(q), re(q)], dim=-1)


def norm(q):
    return torch.linalg.norm(q, dim=-1, keepdim=True)


def normalize(q):
    return q / norm(q)


def inverse(q):
    return normalize(conjugate(q))


def multiply(q1, q2):
    """Hamilton product, batched."""
    c = re(q1) * im(q2) + re(q2) * im(q1) + torch.linalg.cross(im(q1), im(q2))
    w = re(q1) * re(q2) - dot(im(q1), im(q2))
    return torch.cat([c, w], dim=-1)


def rotate(q, v):
    """Rotate vectors v by unit quaternions q: q * [v, 0] * q^-1."""
    q_v = torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
    return im(multiply(multiply(q, q_v), conjugate(q)))


def log(q, eps: float = 1e-8):
    """Quaternion logarithm: [axis * angle / 2, log|q|]."""
    mag = norm(q)
    v = im(q)
    denom = torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)
    return torch.cat([v / denom * safe_acos(re(q) / mag), torch.log(mag)],
                     dim=-1)


def exp(q, eps: float = 1e-8):
    """Quaternion exponential (inverse of ``log`` for pure quaternions)."""
    v = im(q)
    theta = torch.linalg.norm(v, dim=-1, keepdim=True)
    scale = torch.where(theta > eps,
                        torch.sin(theta) / torch.clamp(theta, min=eps),
                        torch.ones_like(theta))
    return torch.exp(re(q)) * torch.cat([v * scale, torch.cos(theta)], dim=-1)


def from_axis_angle(axis, angle):
    """Unit quaternion for a rotation of ``angle`` about unit ``axis``."""
    half = 0.5 * angle[..., None]
    return torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)


def quat_warp_vec_fwd(w, v, points, small_angle: float = 1e-6):
    """The values of ``quat_warp_vec``."""
    safe, small = safe_angle(w, small_angle)
    a = w / safe
    # The residual Rodrigues form: identity + small terms.
    rp = (points + torch.sin(safe) * cross(a, points)
          + (1.0 - torch.cos(safe)) * (a * dot(a, points) - points))
    return torch.where(small, points + v, rp + v)


def quat_warp_vec_bwd(w, v, points, g, small_angle: float = 1e-6):
    """Hand-derived VJP of ``quat_warp_vec``: g -> (d_w, d_v, d_points).

    warped = R p + v with R = I + sin(t) A + (1 - cos(t)) A^2, A = [a]_x,
    a = w / t, t = |w|. d_p = R^T g; d_a = sin(t) (p x g)
    + (1 - cos(t)) (p (a.g) - 2 a (p.g) + g (a.p));
    d_t = cos(t) <a x p, g> + sin(t) ((a.p)(a.g) - p.g);
    d_w = a d_t + (d_a - a <a, d_a>) / t; d_v = g. At t <= small_angle:
    d_p = g, d_w = 0.
    """
    safe, small = safe_angle(w, small_angle)
    a = w / safe
    sin_t, cos_t = torch.sin(safe), torch.cos(safe)
    one_m_cos = 1.0 - cos_t
    ag, ap, pg = dot(a, g), dot(a, points), dot(points, g)
    d_p = g - sin_t * cross(a, g) + one_m_cos * (a * ag - g)
    d_a = (sin_t * cross(points, g)
           + one_m_cos * (points * ag - 2.0 * a * pg + g * ap))
    d_t = cos_t * dot(cross(a, points), g) + sin_t * (ap * ag - pg)
    d_w = a * d_t + (d_a - a * dot(a, d_a)) / safe
    return (torch.where(small, torch.zeros_like(g), d_w), g,
            torch.where(small, g, d_p))


quat_warp_vec = retraction(quat_warp_vec_fwd, quat_warp_vec_bwd)
quat_warp_vec.__doc__ = """Quaternion rotation + translation warp:
R(exp q(w)) p + v for raw rotation vectors ``w``, translations ``v`` and
``points``, each (..., 3); ``points + v`` at |w| <= 1e-6. Differentiable
through ``quat_warp_vec_bwd``."""


def to_rotation_matrix(q):
    """Unit quaternion -> (..., 3, 3) rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], dim=-1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], dim=-1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], dim=-1)], dim=-2)
