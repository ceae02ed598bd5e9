"""Train state and the data-parallel train step (port of
``hypernerf_tpu/training/train_state.py``).

The whole dataset (all rays and their colours) lives on each rank's device;
the step draws its batch of ray indices there, renders coarse + fine with
stratified jitter and sigma noise, takes the MSE loss plus, where their
weights are set, the elastic regularizer (the warp Jacobian, ``NerfModel``
with ``return_warp_jacobian``) and the background regularizer (the warp on
known static points), back-propagates through both levels' kernels and
applies the optimizer at the scheduled rate.

Over a ``parallel.DataParallel`` context of N ranks (the JAX package's
``shard_map`` over the ``'data'`` mesh axis) each rank takes batch_size / N
rays, and after the backward every gradient, the loss and the batch MSE are
averaged over the ranks by one all-reduce (``lax.pmean``), so that every
rank takes the same update; ``shard_optimizer_state`` makes the optimizer
ZeRO-1's (``optimizers.get_optimizer``). The all-reduce follows the
backward, as in JAX, rather than ``DistributedDataParallel``'s hooks: the
step differentiates more than one call of the model (the render, and
``apply_warp`` for the background term), where DDP's reducer expects one
forward through its wrapper.

Random draws come from one ``torch.Generator`` on the device, re-seeded
every step from (base seed, step, rank), so a step's draws depend on nothing
but those numbers; rank 0 draws what a single process draws (the rank is
folded in from rank 1 on, as JAX folds the axis index).

With ``use_occupancy_grid`` the state carries the (G, G, G) grid, which the
step passes to the model and ``make_occupancy_update`` refreshes from the
model's own density (every ``occupancy_update_every`` steps, at the caller's
cadence); its draws come from a second generator seeded from the same two
numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from hypernerf_tpu_torch.configs import NerfConfig, TrainConfig
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.ops.occupancy import (cell_points, config_bbox,
                                               init_grid, update_grid)
from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
from hypernerf_tpu_torch.parallel.mesh import (DataParallel, all_reduce_mean,
                                               shard_batch)
from hypernerf_tpu_torch.training.losses import (background_loss, loss_dict,
                                                 weighted_elastic_loss)

# The draws of ``step_fn``'s ``draws`` with a row per ray of the global
# batch: a rank takes its rows of each.
PER_RAY_DRAWS = ('idx', 't_rand', 'coarse_u', 'fine_u', 'noise_coarse',
                 'noise_fine', 'jacobian_u_coarse', 'jacobian_u_fine')


@dataclasses.dataclass
class TrainState:
    """What a step reads and updates. ``model`` holds the parameters,
    ``optimizer`` the moments; ``seed`` is the base of every step's draws;
    ``occupancy`` the (G, G, G) float32 density grid on the parameters'
    device where the model's config uses one (made by ``init_grid`` when not
    given), else None."""
    step: int
    model: NerfModel
    optimizer: torch.optim.Optimizer
    seed: int = 0
    occupancy: Optional[torch.Tensor] = None

    def __post_init__(self):
        cfg = self.model.config
        if self.occupancy is None and cfg.use_occupancy_grid:
            self.occupancy = init_grid(
                cfg.occupancy_resolution,
                device=next(self.model.parameters()).device)


def compute_extra_params(nerf_cfg: NerfConfig, train_cfg: TrainConfig,
                         step: int) -> dict:
    """Posenc annealing alphas at ``step``, as the JAX package's
    ``compute_extra_params``: none with the original encoding (the
    flagship); with the Nerfies encoding ``nerf_alpha`` holds every spatial
    band on, and ``warp_alpha`` / ``hyper_alpha`` (= ``hyper_sheet_alpha``)
    ramp linearly to their band counts over ``warp_alpha_steps`` /
    ``hyper_alpha_steps``, in float32 as JAX computes them."""
    if nerf_cfg.use_original_embed:
        return {}
    f32 = np.float32
    step = f32(step)

    def ramp(steps, bands):
        return float(np.minimum(step / f32(max(1, steps)), f32(1.0))
                     * f32(bands))

    hyper_alpha = ramp(train_cfg.hyper_alpha_steps,
                       nerf_cfg.hyper_point_max_deg
                       - nerf_cfg.hyper_point_min_deg)
    return {'nerf_alpha': float(nerf_cfg.spatial_point_max_deg
                                - nerf_cfg.spatial_point_min_deg),
            'warp_alpha': ramp(train_cfg.warp_alpha_steps,
                               nerf_cfg.warp_max_deg - nerf_cfg.warp_min_deg),
            'hyper_alpha': hyper_alpha,
            'hyper_sheet_alpha': hyper_alpha}


def step_generator(state: TrainState, device, stream: int = 0,
                   rank: int = 0) -> torch.Generator:
    """The generator of step ``state.step`` on ``rank``, seeded from (seed,
    step, rank); ``stream`` 1 is the occupancy refresh's, apart from the
    step's 0. Rank 0's seed does not depend on the rank, so a world of one
    draws what a single process draws. The rank moves the seed's low 32
    bits, the only ones the CPU's generator reads."""
    gen = torch.Generator(device=device)
    gen.manual_seed((state.seed * 1_000_003 + state.step + (stream << 40)
                     + rank * _RANK_STRIDE) % (1 << 63))
    return gen


# An odd multiplier: ranks 1 to 2^32 - 1 move the seed's low 32 bits, each
# by a different amount, and rank r meets rank 0's seed of another step only
# 2.65e9 steps away.
_RANK_STRIDE = 0x9E3779B1


def make_train_step(model: NerfModel, optimizer: torch.optim.Optimizer,
                    nerf_cfg: NerfConfig, train_cfg: TrainConfig, device,
                    schedule: Optional[Callable[[int], float]] = None,
                    explicit_batch: bool = False,
                    background_points: Optional[torch.Tensor] = None,
                    mesh: Optional[DataParallel] = None):
    """Build the train step.

    Returns ``step_fn(state, all_rays, all_rgbs, draws=None) -> metrics``:
    ``all_rays`` (N, 9) and ``all_rgbs`` (N, 3) are the dataset's buffers on
    ``device`` and the step draws ``train_cfg.batch_size`` indices there
    (over ``mesh``'s R ranks, batch_size / R on each). With
    ``explicit_batch`` the two arguments ARE the global batch, of which
    each rank takes its rows (``parallel.shard_batch``). ``draws`` passes
    the draws in: 'idx' (batch_size,) indices of the global batch, the
    model's stochastic draws (``NerfModel.forward``; each of these a row per
    ray of the global batch, ``PER_RAY_DRAWS``, of which each rank takes its
    rows) and the background term's: 'background_idx' (n,) rows of
    ``background_points`` (M, 3) on ``device`` and 'background_ids' (n, 1)
    metadata ids, n = ``train_cfg.background_points_per_step``; a missing
    key is drawn after the model's draws. The state is updated in place;
    ``metrics`` holds 0-d tensors ``loss`` and ``psnr`` (of the fine level
    where there is one, both averaged over the ranks) on the device.

    ``mesh``: a ``parallel.DataParallel`` context; with a process group the
    gradients, the loss and the batch MSE are averaged over its ranks after
    the backward (also in a world of one). batch_size must be divisible by
    the number of ranks.
    """
    if optimizer.defaults.get('fused'):
        # The level kernels' packed weights follow the parameters' version
        # counters, which a fused optimizer step does not bump.
        raise ValueError('the train step takes no fused optimizer: its '
                         'in-place update bumps no version counter, so the '
                         'level kernels would keep stale packed weights')
    mesh = mesh or DataParallel(device=torch.device(device))
    if train_cfg.batch_size % mesh.world_size:
        raise ValueError(
            f'batch_size {train_cfg.batch_size} must be divisible by the '
            f'number of ranks {mesh.world_size}')
    per_rank = train_cfg.batch_size // mesh.world_size
    params = [p for p in model.parameters() if p.requires_grad]
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
        draws = {k: shard_batch(mesh, v) if k in PER_RAY_DRAWS else v
                 for k, v in (draws or {}).items()}
        gen = step_generator(state, device, rank=mesh.rank)
        if explicit_batch:
            rays = shard_batch(mesh, all_rays)
            rgbs = shard_batch(mesh, all_rgbs)
        else:
            idx = draws.get('idx')
            if idx is None:
                idx = torch.randint(0, all_rays.shape[0], (per_rank,),
                                    generator=gen, device=device)
            rays = all_rays.index_select(0, idx)
            rgbs = all_rgbs.index_select(0, idx)
        extra_params = compute_extra_params(nerf_cfg, train_cfg, state.step)
        # The elastic loss reads the weights; otherwise they are dropped.
        results = model(prepare_ray_dict(rays), deterministic=False,
                        return_weights=elastic_on, generator=gen, draws=draws,
                        extra_params=extra_params,
                        return_warp_jacobian=elastic_on,
                        occupancy_grid=state.occupancy)
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
        loss = loss.detach()
        if mesh.joined:
            # lax.pmean of the gradients, the loss and the batch MSE: one
            # all-reduce of a flat fp32 buffer.
            stats = torch.stack([loss, batch_mse])
            all_reduce_mean(mesh, [p.grad for p in params
                                   if p.grad is not None] + [stats])
            loss, batch_mse = stats[0], stats[1]
        if schedule is not None:
            for group in optimizer.param_groups:
                group['lr'] = schedule(state.step)
        optimizer.step()
        state.step += 1
        return {'loss': loss, 'psnr': -10.0 * torch.log10(batch_mse)}

    return step_fn


def make_occupancy_update(model: NerfModel, nerf_cfg: NerfConfig,
                          train_cfg: TrainConfig):
    """The occupancy grid's refresh, as the JAX package's
    ``make_occupancy_update``: the model's density (``query_sigma``, no
    noise, at the step's annealing alphas) at the cells' points, jittered
    within each cell, for ``occupancy_probe_ids`` image ids (at most
    ``num_embeddings``); the max over the ids goes into the grid by
    ``update_grid`` with ``occupancy_decay``. A moving object so shows in
    the grid for every frame probed.

    Returns ``update(state, u=None, ids=None) -> grid``, which replaces
    ``state.occupancy`` and returns it. ``u`` (G^3, 3) uniforms of the
    jitter and ``ids`` (n_ids,) integer ids are drawn, when absent, from the
    refresh's generator of (seed, step) (``step_generator`` stream 1),
    which folds in no rank: every rank of a launch draws the same numbers
    with the same parameters, so the grid stays the same on every rank (the
    JAX refresh folds in the step alone).
    """
    cfg = nerf_cfg
    g = cfg.occupancy_resolution
    bbox = config_bbox(cfg)
    n_ids = max(1, min(train_cfg.occupancy_probe_ids, cfg.num_embeddings))

    @torch.no_grad()
    def update(state: TrainState, u: Optional[torch.Tensor] = None,
               ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        device = state.occupancy.device
        gen = step_generator(state, device, stream=1)
        if u is None:
            u = torch.rand((g ** 3, 3), generator=gen, device=device)
        if ids is None:
            ids = torch.randint(0, cfg.num_embeddings, (n_ids,),
                                generator=gen, device=device)
        pts = cell_points(g, bbox, u=u)
        extra_params = compute_extra_params(cfg, train_cfg, state.step)
        sigma = None
        for i in range(ids.shape[0]):
            metadata_id = ids[i].reshape(1, 1).expand(
                pts.shape[0], 1).contiguous()
            probe = model.query_sigma(pts, metadata_id, extra_params)
            sigma = probe if sigma is None else torch.maximum(sigma, probe)
        state.occupancy = update_grid(state.occupancy, sigma,
                                      train_cfg.occupancy_decay)
        return state.occupancy

    return update
