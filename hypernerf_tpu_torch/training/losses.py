"""Training losses (port of ``hypernerf_tpu/training/losses.py``): the
photometric MSE. The elastic and background regularizers are ROADMAP A.11."""

from __future__ import annotations

import torch


def mse_loss(results: dict, targets: torch.Tensor) -> torch.Tensor:
    """MSE on the coarse rgb plus (if present) the fine rgb."""
    loss = torch.mean((results['coarse']['rgb'] - targets) ** 2)
    if results.get('fine') is not None:
        loss = loss + torch.mean((results['fine']['rgb'] - targets) ** 2)
    return loss


loss_dict = {'mse': mse_loss}


def weighted_elastic_loss(*args, **kwargs):
    raise NotImplementedError('the elastic loss needs the warp Jacobian '
                              'kernels: ROADMAP A.11')


def background_loss(*args, **kwargs):
    raise NotImplementedError('the background loss: ROADMAP A.11')
