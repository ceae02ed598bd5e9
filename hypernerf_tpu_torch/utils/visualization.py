"""Depth visualization (parity with reference utils/visualization.py)."""

from __future__ import annotations

import numpy as np


def visualize_depth(depth: np.ndarray) -> np.ndarray:
    """Normalize a (H, W) depth map and apply the JET colormap.

    Returns an (H, W, 3) float32 RGB image in [0, 1].
    """
    x = np.nan_to_num(np.asarray(depth, np.float32))
    mi, ma = np.min(x), np.max(x)
    x = (x - mi) / (ma - mi + 1e-8)
    x = (255 * x).astype(np.uint8)
    try:
        import cv2
        bgr = cv2.applyColorMap(x, cv2.COLORMAP_JET)
        rgb = bgr[..., ::-1]
    except ImportError:  # pragma: no cover - cv2 is available in this image
        rgb = np.stack([x, x, x], axis=-1)
    return rgb.astype(np.float32) / 255.0


def to_uint8(img: np.ndarray) -> np.ndarray:
    """Clip a float image in [0,1] to uint8."""
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8)
