"""Image metrics (port of ``hypernerf_tpu/training/metrics.py``): mse, psnr
and a Gaussian-window ssim. Each takes numpy arrays or tensors: a tensor in
gives a tensor out (on its device), numpy in gives a Python float (or, with
``reduction='none'``, a numpy array)."""

from __future__ import annotations

import numpy as np
import torch


def _tensors(*arrays):
    """(tensors, whether the first input was a tensor): numpy inputs become
    CPU tensors, images float32, a boolean mask stays boolean; None stays
    None."""
    def one(a):
        if a is None:
            return None
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))
        return t if t.dtype == torch.bool else t.float()
    return [one(a) for a in arrays], isinstance(arrays[0], torch.Tensor)


def _result(t: torch.Tensor, is_tensor: bool):
    if is_tensor:
        return t
    return float(t) if t.dim() == 0 else t.numpy()


def _mse(pred, gt, valid_mask, reduction):
    value = (pred - gt) ** 2
    if valid_mask is not None:
        value = torch.where(valid_mask.bool(), value, torch.zeros_like(value))
        if reduction == 'mean':
            return torch.sum(value) / torch.clamp(
                torch.sum(valid_mask.float()), min=1.0)
    if reduction == 'mean':
        return torch.mean(value)
    return value


def mse(image_pred, image_gt, valid_mask=None, reduction: str = 'mean'):
    """Squared error: its mean ('mean'; over the mask's entries where one
    is given) or per element ('none', zero outside the mask)."""
    args, is_tensor = _tensors(image_pred, image_gt, valid_mask)
    return _result(_mse(*args, reduction), is_tensor)


def psnr(image_pred, image_gt, valid_mask=None, reduction: str = 'mean'):
    """-10 log10(mse) of two images in [0, 1]."""
    args, is_tensor = _tensors(image_pred, image_gt, valid_mask)
    return _result(-10.0 * torch.log10(_mse(*args, reduction)), is_tensor)


def _gaussian_kernel(window_size: int, sigma: float) -> torch.Tensor:
    x = torch.arange(window_size, dtype=torch.float32) - (
        window_size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / torch.sum(g)


def ssim(image_pred, image_gt, window_size: int = 3, sigma: float = 1.5,
         max_val: float = 1.0):
    """Structural similarity of two (H, W, C) images in [0, max_val]: the
    mean over pixels and channels, with a separable Gaussian window
    (``window_size``, ``sigma``) and edge padding, as the JAX package
    computes it (kornia's defaults, as the reference uses them)."""
    (pred, gt), is_tensor = _tensors(image_pred, image_gt)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    kernel = _gaussian_kernel(window_size, sigma).to(pred.device)
    pad = window_size // 2

    def conv1d(x, axis):
        x = torch.movedim(x, axis, -1)
        xp = torch.cat([x[..., :1].expand(*x.shape[:-1], pad), x,
                        x[..., -1:].expand(*x.shape[:-1], pad)], -1)
        n = x.shape[-1]
        out = sum(kernel[k] * xp[..., k:k + n] for k in range(window_size))
        return torch.movedim(out, -1, axis)

    def blur(img):
        return conv1d(conv1d(img, 0), 1)

    mu_p, mu_g = blur(pred), blur(gt)
    mu_p2, mu_g2, mu_pg = mu_p ** 2, mu_g ** 2, mu_p * mu_g
    sigma_p2 = blur(pred ** 2) - mu_p2
    sigma_g2 = blur(gt ** 2) - mu_g2
    sigma_pg = blur(pred * gt) - mu_pg
    num = (2 * mu_pg + c1) * (2 * sigma_pg + c2)
    den = (mu_p2 + mu_g2 + c1) * (sigma_p2 + sigma_g2 + c2)
    return _result(torch.mean(num / den), is_tensor)
