"""Image metrics (port of ``hypernerf_tpu/training/metrics.py``: mse and
psnr; ssim comes with the trainer, ROADMAP A.8)."""

from __future__ import annotations

import numpy as np


def mse(image_pred, image_gt) -> float:
    diff = np.asarray(image_pred, np.float32) - np.asarray(image_gt,
                                                          np.float32)
    return float(np.mean(diff * diff))


def psnr(image_pred, image_gt) -> float:
    """-10 log10(MSE) of two images in [0, 1]."""
    return float(-10.0 * np.log10(mse(image_pred, image_gt)))

