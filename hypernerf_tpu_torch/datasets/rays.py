"""Camera-ray generation (pure numpy, host-side, one-time work).

Capability parity with reference datasets/ray_utils.py. The reference
uses kornia's meshgrid + torch; here it's plain numpy — the output feeds a
device-resident ray buffer via one `jax.device_put`, so nothing here is on
the hot path.
"""

from __future__ import annotations

import numpy as np


def get_ray_directions(h: int, w: int, focal: float) -> np.ndarray:
    """Per-pixel ray directions in camera coordinates.

    Pinhole model, no +0.5 pixel centering (matches ray_utils.py:17-22, as the
    original NeRF code has it).

    Returns:
      (H, W, 3) float32 directions.
    """
    j, i = np.meshgrid(np.arange(h, dtype=np.float32),
                       np.arange(w, dtype=np.float32), indexing='ij')
    directions = np.stack(
        [(i - w / 2) / focal, -(j - h / 2) / focal, -np.ones_like(i)], axis=-1)
    return directions.astype(np.float32)


def get_rays(directions: np.ndarray, c2w: np.ndarray):
    """World-space origins and normalized directions for one camera.

    Args:
      directions: (H, W, 3) camera-space directions.
      c2w: (3, 4) camera-to-world matrix.

    Returns:
      rays_o, rays_d: both (H*W, 3) float32.
    """
    rays_d = directions @ c2w[:, :3].T
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:, 3], rays_d.shape)
    return (rays_o.reshape(-1, 3).astype(np.float32),
            rays_d.reshape(-1, 3).astype(np.float32))


def get_ndc_rays(h: int, w: int, focal: float, near: float,
                 rays_o: np.ndarray, rays_d: np.ndarray):
    """Project rays into NDC (for forward-facing scenes).

    Matches ray_utils.py:53-94: origins shifted to the near plane, then the
    standard NDC projection (see bmild/nerf ndc_derivation.pdf).
    """
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]

    o0 = -1.0 / (w / (2.0 * focal)) * ox_oz
    o1 = -1.0 / (h / (2.0 * focal)) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (w / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -1.0 / (h / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2

    rays_o = np.stack([o0, o1, o2], axis=-1).astype(np.float32)
    rays_d = np.stack([d0, d1, d2], axis=-1).astype(np.float32)
    return rays_o, rays_d


def make_ray_tensor(rays_o, rays_d, near, far, idx=None) -> np.ndarray:
    """Pack rays into the flat (N, 8|9) layout used by the train buffer.

    Columns: origin(3), direction(3), near, far[, image index].
    """
    n = rays_o.shape[0]
    cols = [rays_o, rays_d,
            np.full((n, 1), near, np.float32),
            np.full((n, 1), far, np.float32)]
    if idx is not None:
        cols.append(np.full((n, 1), float(idx), np.float32))
    return np.concatenate(cols, axis=1).astype(np.float32)
