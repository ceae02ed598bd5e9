"""Train state and the single-device train step (port of
``hypernerf_tpu/training/train_state.py``).

The whole dataset (all rays and their colours) lives on the device; the step
draws its batch of ray indices there, renders coarse + fine with stratified
jitter and sigma noise, takes the MSE loss plus, where their weights are
set, the elastic regularizer (the warp Jacobian, ``NerfModel`` with
``return_warp_jacobian``) and the background regularizer (the warp on known
static points), back-propagates through both levels' kernels and applies
Adam at the scheduled rate. The JAX package's ``shard_map`` / ``pmean`` /
ZeRO-1 forms are ROADMAP A.12.

Random draws come from one ``torch.Generator`` on the device, re-seeded
every step from (base seed, step), so a step's draws depend on nothing but
those two numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from hypernerf_tpu_torch.configs import NerfConfig, TrainConfig
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
from hypernerf_tpu_torch.training.losses import (background_loss, loss_dict,
                                                 weighted_elastic_loss)


@dataclasses.dataclass
class TrainState:
    """What a step reads and updates. ``model`` holds the parameters,
    ``optimizer`` the moments; ``seed`` is the base of every step's draws."""
    step: int
    model: NerfModel
    optimizer: torch.optim.Optimizer
    seed: int = 0


def compute_extra_params(nerf_cfg: NerfConfig, train_cfg: TrainConfig,
                         step: int) -> dict:
    """Posenc annealing alphas at ``step``: none with the original encoding
    (the flagship); the Nerfies window is ROADMAP A.9."""
    if nerf_cfg.use_original_embed:
        return {}
    raise NotImplementedError('the Nerfies anneal encoding: ROADMAP A.9')


def step_generator(state: TrainState, device) -> torch.Generator:
    """The generator of step ``state.step``, seeded from (seed, step)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((state.seed * 1_000_003 + state.step) % (1 << 63))
    return gen


def make_train_step(model: NerfModel, optimizer: torch.optim.Optimizer,
                    nerf_cfg: NerfConfig, train_cfg: TrainConfig, device,
                    schedule: Optional[Callable[[int], float]] = None,
                    explicit_batch: bool = False,
                    background_points: Optional[torch.Tensor] = None):
    """Build the train step.

    Returns ``step_fn(state, all_rays, all_rgbs, draws=None) -> metrics``:
    ``all_rays`` (N, 9) and ``all_rgbs`` (N, 3) are the dataset's buffers on
    ``device`` and the step draws ``train_cfg.batch_size`` indices there.
    With ``explicit_batch`` the two arguments ARE the batch. ``draws`` passes
    the model's stochastic draws in (``NerfModel.forward``) and the
    background term's: 'background_idx' (n,) rows of ``background_points``
    (M, 3) on ``device`` and 'background_ids' (n, 1) metadata ids, n =
    ``train_cfg.background_points_per_step``; a missing key is drawn after
    the model's draws. The state is updated in place; ``metrics`` holds 0-d
    tensors ``loss`` and ``psnr`` (of the fine level where there is one) on
    the device.
    """
    if optimizer.defaults.get('fused'):
        # The level kernels' packed weights follow the parameters' version
        # counters, which a fused optimizer step does not bump.
        raise ValueError('the train step takes no fused optimizer: its '
                         'in-place update bumps no version counter, so the '
                         'level kernels would keep stale packed weights')
    loss_fn = loss_dict[train_cfg.loss_type]
    device = torch.device(device)
    elastic_on = train_cfg.elastic_loss_weight > 0
    background_on = (background_points is not None
                     and train_cfg.background_loss_weight > 0)

    def background_term(gen, draws, extra_params):
        n = train_cfg.background_points_per_step
        idx = draws.get('background_idx')
        if idx is None:
            idx = torch.randint(0, background_points.shape[0], (n,),
                                generator=gen, device=device)
        ids = draws.get('background_ids')
        if ids is None:
            ids = torch.randint(0, nerf_cfg.num_embeddings, (n, 1),
                                generator=gen, device=device)
        pts = background_points.index_select(0, idx)
        warped = model.apply_warp(pts, ids, extra_params)
        return torch.mean(background_loss(warped, pts,
                                          train_cfg.background_loss_scale))

    def step_fn(state: TrainState, all_rays, all_rgbs,
                draws: Optional[Dict[str, torch.Tensor]] = None):
        draws = draws or {}
        gen = step_generator(state, device)
        if explicit_batch:
            rays, rgbs = all_rays, all_rgbs
        else:
            idx = torch.randint(0, all_rays.shape[0],
                                (train_cfg.batch_size,), generator=gen,
                                device=device)
            rays = all_rays.index_select(0, idx)
            rgbs = all_rgbs.index_select(0, idx)
        extra_params = compute_extra_params(nerf_cfg, train_cfg, state.step)
        # The elastic loss reads the weights; otherwise they are dropped.
        results = model(prepare_ray_dict(rays), deterministic=False,
                        return_weights=elastic_on, generator=gen, draws=draws,
                        extra_params=extra_params,
                        return_warp_jacobian=elastic_on)
        loss = loss_fn(results, rgbs)
        if elastic_on:
            loss = loss + train_cfg.elastic_loss_weight * \
                weighted_elastic_loss(results, train_cfg.elastic_loss_scale)
        if background_on:
            loss = loss + train_cfg.background_loss_weight * \
                background_term(gen, draws, extra_params)
        typ = 'fine' if 'fine' in results else 'coarse'
        with torch.no_grad():
            batch_mse = torch.mean((results[typ]['rgb'] - rgbs) ** 2)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if schedule is not None:
            for group in optimizer.param_groups:
                group['lr'] = schedule(state.step)
        optimizer.step()
        state.step += 1
        return {'loss': loss.detach(),
                'psnr': -10.0 * torch.log10(batch_mse)}

    return step_fn
