"""Metric and image logging (port of ``hypernerf_tpu/utils/logging.py``): a
CSV always, TensorBoard where ``torch.utils.tensorboard`` imports.

Scalars (lr, train/loss, train/psnr, train/rays_per_sec, val/loss,
val/psnr) go to ``<log_dir>/<exp_name>/metrics.csv`` as rows (time, step,
tag, value); an image triplet (GT / pred / depth) goes to TensorBoard and,
as PNGs, to ``<log_dir>/<exp_name>/images/``.
"""

from __future__ import annotations

import csv
import os
import time

import numpy as np


class MetricsLogger:
    def __init__(self, log_dir: str, exp_name: str,
                 use_tensorboard: bool = True):
        self.log_dir = os.path.join(log_dir, exp_name)
        os.makedirs(self.log_dir, exist_ok=True)
        self._csv_path = os.path.join(self.log_dir, 'metrics.csv')
        self._csv_file = open(self._csv_path, 'a', newline='')
        self._csv = csv.writer(self._csv_file)
        if os.path.getsize(self._csv_path) == 0:
            self._csv.writerow(['time', 'step', 'tag', 'value'])
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(self.log_dir)
            except Exception:
                self._tb = None

    def add_scalar(self, tag: str, value, step: int):
        """``value``: a number, a 0-d array or a 0-d tensor."""
        if hasattr(value, 'item'):
            value = value.item()
        value = float(value)
        self._csv.writerow([f'{time.time():.3f}', step, tag, value])
        self._csv_file.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_images(self, tag: str, images: np.ndarray, step: int):
        """images: (N, H, W, 3) float in [0, 1]; one PNG each,
        ``images/<tag with '/' as '_'>_<step>_<i>.png``."""
        images = np.asarray(images)
        if self._tb is not None:
            self._tb.add_images(tag, images, step, dataformats='NHWC')
        from PIL import Image
        img_dir = os.path.join(self.log_dir, 'images')
        os.makedirs(img_dir, exist_ok=True)
        safe_tag = tag.replace('/', '_')
        for i, img in enumerate(images):
            arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            Image.fromarray(arr).save(
                os.path.join(img_dir, f'{safe_tag}_{step}_{i}.png'))

    def close(self):
        self._csv_file.close()
        if self._tb is not None:
            self._tb.close()
