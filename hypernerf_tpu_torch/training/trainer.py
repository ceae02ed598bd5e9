"""The trainer (port of ``hypernerf_tpu/training/trainer.py``): the model
from the configs, the dataset on the device, the train step, validation
with GT / pred / depth logging, the checkpoint cadence, warm start and
resume, on one device or over the ranks of a data-parallel launch.

Over a ``parallel.DataParallel`` context (the JAX trainer's mesh) every
rank holds the dataset on its card, starts from rank 0's weights
(``parallel.replicate``), takes its share of each step's batch and of each
val frame's chunks, and reads the all-reduced step metrics; rank 0 alone
prints, logs (give the other ranks no logger), writes val images,
checkpoints and the manifest, and prunes, and the others wait for each
checkpoint at a barrier.

The JAX trainer's cadences, step for step: a sanity val at step 0, the
occupancy grid's refresh every ``occupancy_update_every`` steps, the
metrics every ``log_every`` steps (read back one interval late, so that no
step waits on them), a val every ``steps_per_epoch * val_check_interval``
steps, a checkpoint every ``ckpt_every_steps`` (default: every epoch) and at
the end, its manifest carrying the last val metrics, then
``prune_checkpoints``. A val here renders and reads back at once, so it
blocks the host (the JAX trainer reads it back some steps later).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from hypernerf_tpu_torch.configs import NerfConfig, TrainConfig
from hypernerf_tpu_torch.datasets import dataset_dict
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.parallel.mesh import (DataParallel, barrier,
                                               replicate)
from hypernerf_tpu_torch.training import checkpoints as ckpt_lib
from hypernerf_tpu_torch.training.losses import loss_dict
from hypernerf_tpu_torch.training.optimizers import get_optimizer
from hypernerf_tpu_torch.training.renderer import (quantize_rgb_u8,
                                                   render_rays)
from hypernerf_tpu_torch.training.train_state import (TrainState,
                                                      compute_extra_params,
                                                      make_occupancy_update,
                                                      make_train_step)
from hypernerf_tpu_torch.utils.logging import MetricsLogger
from hypernerf_tpu_torch.utils.visualization import visualize_depth


class Trainer:
    """``Trainer(nerf_cfg, train_cfg, device, logger=None, mesh=None)``;
    ``fit()`` trains from the state's step to ``total_steps`` and returns
    the last metrics; ``validate(step)`` renders the first val image.
    ``mesh``: the ``parallel.DataParallel`` context of a launch (build the
    trainer on every rank); None trains in this process alone.

    ``seconds`` holds the last ``fit``'s wall seconds: 'fit' in all, 'val'
    and 'checkpoint' of them (each timed from a synchronized device);
    ``last_metrics`` what it returned."""

    def __init__(self, nerf_cfg: NerfConfig, train_cfg: TrainConfig,
                 device, logger: Optional[MetricsLogger] = None,
                 mesh: Optional[DataParallel] = None):
        self.train_cfg = train_cfg
        self.device = torch.device(device)
        self.logger = logger
        self.mesh = mesh or DataParallel(device=self.device)
        self.primary = self.mesh.is_primary

        dataset_cls = dataset_dict[train_cfg.dataset_name]
        kwargs = dict(root_dir=train_cfg.root_dir,
                      img_wh=tuple(train_cfg.img_wh),
                      include_idx=train_cfg.use_nerfies_meta)
        if train_cfg.dataset_name == 'llff':
            kwargs['spheric_poses'] = train_cfg.spheric_poses
        self.train_dataset = dataset_cls(split='train', **kwargs)
        self.val_dataset = dataset_cls(split='val', **kwargs)

        num_images = self.train_dataset.num_instance
        if nerf_cfg.num_embeddings < num_images:
            nerf_cfg = dataclasses.replace(nerf_cfg,
                                           num_embeddings=num_images)
        if getattr(self.train_dataset, 'white_back', False):
            nerf_cfg = dataclasses.replace(nerf_cfg,
                                           use_white_background=True)
        self.nerf_cfg = nerf_cfg
        # On the card an out-of-range id is a device assert inside
        # index_select, not an error naming the dataset: check here.
        rays = self.train_dataset.all_rays
        if rays.shape[-1] >= 9:
            max_id = int(rays[:, 8].max())
            if max_id >= nerf_cfg.num_embeddings:
                raise ValueError(
                    f'Dataset metadata id {max_id} is out of range for '
                    f'num_embeddings={nerf_cfg.num_embeddings}.')

        self.steps_per_epoch = max(1, len(rays) // train_cfg.batch_size)
        self.total_steps = (train_cfg.max_steps
                            or train_cfg.num_epochs * self.steps_per_epoch)
        self.all_rays = torch.as_tensor(rays, dtype=torch.float32,
                                        device=self.device)
        self.all_rgbs = torch.as_tensor(self.train_dataset.all_rgbs,
                                        dtype=torch.float32,
                                        device=self.device)

        torch.manual_seed(train_cfg.seed)
        self.model = NerfModel(nerf_cfg).to(self.device).train()
        # Warm start before the optimizer exists, so that ranger's slow
        # weights start from the loaded ones.
        if train_cfg.weight_path:
            ckpt_lib.load_weights(
                self.model, train_cfg.weight_path, strict=False,
                prefixes_to_ignore=train_cfg.prefixes_to_ignore)
        # Rank 0's weights on every rank, before ranger takes its slow copy.
        replicate(self.mesh, self.model)
        self.optimizer, self.lr_schedule = get_optimizer(
            train_cfg, self.model.parameters(), self.steps_per_epoch,
            self.total_steps, mesh=self.mesh)
        self.state = TrainState(0, self.model, self.optimizer,
                                seed=train_cfg.seed)
        self.ckpt_dir = os.path.join(train_cfg.ckpt_dir, train_cfg.exp_name)
        if train_cfg.ckpt_path:
            ckpt_lib.restore_checkpoint(train_cfg.ckpt_path, self.state)

        background_points = None
        if (train_cfg.background_loss_weight > 0
                and train_cfg.background_points_path):
            if not nerf_cfg.use_warp:
                raise ValueError('background_loss_weight needs a warp field '
                                 '(use_warp=True)')
            pts = np.load(train_cfg.background_points_path)
            if pts.ndim != 2 or pts.shape[1] != 3:
                raise ValueError(f'background points: shape {pts.shape}, '
                                 f'want (N, 3)')
            background_points = torch.as_tensor(pts, dtype=torch.float32,
                                                device=self.device)
        self.train_step = make_train_step(
            self.model, self.optimizer, nerf_cfg, train_cfg, self.device,
            schedule=self.lr_schedule, background_points=background_points,
            mesh=self.mesh)
        self.occupancy_update = (
            make_occupancy_update(self.model, nerf_cfg, train_cfg)
            if nerf_cfg.use_occupancy_grid else None)
        self.seconds = {}
        self.last_metrics: Dict[str, float] = {}
        self._val = None

    # ------------------------------------------------------------------ val

    def _val_sample(self):
        if self._val is None:
            sample = self.val_dataset[0]
            self._val = (sample['rays'], sample['rgbs'], torch.as_tensor(
                sample['rgbs'], dtype=torch.float32, device=self.device))
        return self._val

    def validate(self, step: int) -> Dict[str, float]:
        """Render the first val image at ``step``'s annealing alphas through
        the state's grid (its chunks shared by the ranks); 'val/loss' is
        the training loss over all levels, 'val/psnr' the final level's.
        Logs both and the GT / pred / depth triplet where the trainer has a
        logger."""
        rays, rgbs, rgbs_dev = self._val_sample()
        out = render_rays(
            self.model, rays, chunk=self.train_cfg.chunk,
            keep=('rgb', 'depth'),
            extra_params=compute_extra_params(self.nerf_cfg,
                                              self.train_cfg, step),
            occupancy_grid=self.state.occupancy, to_numpy=False,
            mesh=self.mesh)
        typ = 'fine' if self.nerf_cfg.num_fine_samples > 0 else 'coarse'
        pred = out[typ]['rgb']
        loss = loss_dict[self.train_cfg.loss_type](out, rgbs_dev)
        psnr = -10.0 * torch.log10(torch.mean((pred - rgbs_dev) ** 2))
        val_loss, val_psnr = torch.stack([loss, psnr]).tolist()
        metrics = {'val/loss': val_loss, 'val/psnr': val_psnr}
        if self.logger is not None:
            for k, v in metrics.items():
                self.logger.add_scalar(k, v, step)
            w, h = self.train_cfg.img_wh
            img = quantize_rgb_u8(pred).cpu().numpy().reshape(h, w, 3) / 255.0
            depth = visualize_depth(
                out[typ]['depth'].cpu().numpy().reshape(h, w))
            self.logger.add_images(
                'val/GT_pred_depth',
                np.stack([np.asarray(rgbs).reshape(h, w, 3), img, depth]),
                step)
        return metrics

    # ---------------------------------------------------------------- train

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def fit(self) -> Dict[str, float]:
        cfg = self.train_cfg
        start_step = self.state.step
        val_every = max(1, int(self.steps_per_epoch * cfg.val_check_interval))
        ckpt_every = cfg.ckpt_every_steps or self.steps_per_epoch
        seconds = {'fit': 0.0, 'val': 0.0, 'checkpoint': 0.0}
        t_fit = time.perf_counter()

        def timed(kind, fn, *args, **kwargs):
            self._sync()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            self._sync()
            seconds[kind] += time.perf_counter() - t
            return out

        if cfg.num_sanity_val_steps > 0 and start_step == 0:
            timed('val', self.validate, step=0)

        profiler = None
        t0 = time.time()
        rays_done = 0
        last_metrics: Dict[str, float] = {}
        pending_log = None  # (step, device metrics, rays/s) of the last log

        def flush_log():
            nonlocal pending_log
            if pending_log is None:
                return
            log_step, dev_metrics, rays_per_sec = pending_log
            loss, psnr = torch.stack([dev_metrics['loss'],
                                      dev_metrics['psnr']]).tolist()
            train_metrics = {'train/loss': loss, 'train/psnr': psnr,
                             'train/rays_per_sec': rays_per_sec,
                             'lr': self.lr_schedule(log_step - 1)}
            last_metrics.update(train_metrics)
            if self.logger is not None:
                for k, v in train_metrics.items():
                    self.logger.add_scalar(k, v, log_step)
            if self.primary:
                print(f'step {log_step}/{self.total_steps} loss={loss:.5f} '
                      f'psnr={psnr:.2f} rays/s={rays_per_sec:,.0f}',
                      flush=True)
            pending_log = None

        for step in range(start_step, self.total_steps):
            if cfg.profile_steps > 0 and step == cfg.profile_start \
                    and self.primary:
                profiler = self._start_profiler()
            if (self.occupancy_update is not None
                    and step % cfg.occupancy_update_every == 0):
                self.occupancy_update(self.state)
            metrics = self.train_step(self.state, self.all_rays,
                                      self.all_rgbs)
            if profiler is not None and \
                    step >= cfg.profile_start + cfg.profile_steps:
                self._stop_profiler(profiler)
                profiler = None
            rays_done += cfg.batch_size

            if (step + 1) % cfg.log_every == 0 or step + 1 == self.total_steps:
                flush_log()  # the previous interval's: long computed
                pending_log = (step + 1, metrics,
                               rays_done / max(time.time() - t0, 1e-9))

            if (step + 1) % val_every == 0:
                val_metrics = timed('val', self.validate, step + 1)
                last_metrics.update(val_metrics)
                if self.primary:
                    print(f'  val psnr={val_metrics["val/psnr"]:.2f} '
                          f'(step {step + 1})', flush=True)

            if (step + 1) % ckpt_every == 0 or step + 1 == self.total_steps:
                timed('checkpoint', self._save, step + 1, last_metrics)
        if profiler is not None:
            self._stop_profiler(profiler)
        flush_log()
        self._sync()
        seconds['fit'] = time.perf_counter() - t_fit
        self.seconds = seconds
        self.last_metrics = last_metrics
        return last_metrics

    def _save(self, step: int, last_metrics: Dict[str, float]) -> None:
        """Every rank: ZeRO-1 gathers its moments to rank 0, which writes
        and prunes while the others wait."""
        cfg = self.train_cfg
        ckpt_lib.save_checkpoint(
            self.ckpt_dir, step, self.state, nerf_config=self.nerf_cfg,
            train_config=cfg,
            metrics={k: v for k, v in last_metrics.items()
                     if k.startswith('val/')})
        if cfg.ckpt_keep_top_k and self.primary:
            ckpt_lib.prune_checkpoints(self.ckpt_dir, cfg.ckpt_keep_top_k)
        barrier(self.mesh)

    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler) -> None:
        """Write the window's trace, ``<log_dir>/<exp_name>/profile/
        trace.json`` (Chrome trace format: chrome://tracing, Perfetto)."""
        self._sync()
        profiler.stop()
        out = os.path.join(self.train_cfg.log_dir, self.train_cfg.exp_name,
                           'profile')
        os.makedirs(out, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(out, 'trace.json'))
