"""Optimizer and learning-rate schedule (port of
``hypernerf_tpu/training/optimizers.py``): Adam with the ``steplr``
schedule, in steps. The other optimizers and schedules are ROADMAP A.8.

``torch.optim.Adam`` computes optax's ``scale_by_adam(eps=1e-8)`` update
(bias-corrected moments, eps outside the square root) and its
``weight_decay`` is the additive L2 of ``optax.add_decayed_weights`` placed
before Adam; ``tests/test_torch_train_step.py`` holds the two together.
"""

from __future__ import annotations

import torch

from hypernerf_tpu_torch.configs import TrainConfig

_EPS = 1e-8
_LATER = 'ROADMAP A.8 (the trainer) ports it'


def get_scheduler(cfg: TrainConfig, steps_per_epoch: int):
    """step -> learning rate. ``steplr``: ``lr`` times ``decay_gamma`` for
    every boundary ``decay_step[i] * steps_per_epoch`` the step has reached
    (optax's ``piecewise_constant_schedule``); update number ``i`` (from 0)
    takes ``schedule(i)``."""
    if cfg.lr_scheduler != 'steplr':
        raise NotImplementedError(f'scheduler {cfg.lr_scheduler!r}: {_LATER}')
    if cfg.warmup_epochs > 0:
        raise NotImplementedError(f'warm-up: {_LATER}')
    boundaries = sorted(int(e) * steps_per_epoch for e in cfg.decay_step)

    def schedule(step: int) -> float:
        lr = cfg.lr
        for b in boundaries:
            if step >= b:
                lr *= cfg.decay_gamma
        return lr
    return schedule


def get_optimizer(cfg: TrainConfig, params, steps_per_epoch: int):
    """(optimizer, schedule): the schedule's value is written into the
    optimizer's ``lr`` before each step (``train_state.make_train_step``)."""
    if cfg.optimizer != 'adam':
        raise NotImplementedError(f'optimizer {cfg.optimizer!r}: {_LATER}')
    schedule = get_scheduler(cfg, steps_per_epoch)
    optimizer = torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999),
                                 eps=_EPS, weight_decay=cfg.weight_decay)
    return optimizer, schedule
