"""Train state and the single-device train step (port of
``hypernerf_tpu/training/train_state.py``).

The whole dataset (all rays and their colours) lives on the device; the step
draws its batch of ray indices there, renders coarse + fine with stratified
jitter and sigma noise, takes the MSE loss, back-propagates through both
levels' kernels and applies Adam at the scheduled rate. The JAX package's
``shard_map`` / ``pmean`` / ZeRO-1 forms are ROADMAP A.12.

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
from hypernerf_tpu_torch.training.losses import loss_dict


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
                    explicit_batch: bool = False):
    """Build the train step.

    Returns ``step_fn(state, all_rays, all_rgbs, draws=None) -> metrics``:
    ``all_rays`` (N, 9) and ``all_rgbs`` (N, 3) are the dataset's buffers on
    ``device`` and the step draws ``train_cfg.batch_size`` indices there.
    With ``explicit_batch`` the two arguments ARE the batch. ``draws`` passes
    the model's stochastic draws in (``NerfModel.forward``). The state is
    updated in place; ``metrics`` holds 0-d tensors ``loss`` and ``psnr``
    (of the fine level where there is one) on the device.
    """
    if max(train_cfg.elastic_loss_weight,
           train_cfg.background_loss_weight) > 0:
        raise NotImplementedError('elastic / background losses: ROADMAP A.11')
    if optimizer.defaults.get('fused'):
        # The level kernels' packed weights follow the parameters' version
        # counters, which a fused optimizer step does not bump.
        raise ValueError('the train step takes no fused optimizer: its '
                         'in-place update bumps no version counter, so the '
                         'level kernels would keep stale packed weights')
    loss_fn = loss_dict[train_cfg.loss_type]
    device = torch.device(device)

    def step_fn(state: TrainState, all_rays, all_rgbs,
                draws: Optional[Dict[str, torch.Tensor]] = None):
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
        results = model(prepare_ray_dict(rays), deterministic=False,
                        return_weights=False, generator=gen, draws=draws,
                        extra_params=extra_params)
        loss = loss_fn(results, rgbs)
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
