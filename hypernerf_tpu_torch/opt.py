"""CLI flags (parity with reference opt.py — same names and defaults).

One parser serves both train and eval (the reference's eval.py re-declares a
drifted subset, eval.py:20-74 — e.g. ``--meta_GLO`` vs ``meta_GLO_dim``, a
latent crash). ``configs_from_args`` resolves the flat namespace into the
typed NerfConfig/TrainConfig pair.

Extra flags beyond the reference (additive, defaults preserve behavior):
``--warp_field`` (translation|se3 — the reference hardwires TranslationField
at models.py:234 despite having SE3Field), ``--use_nerfies_embed`` (windowed
posenc annealing), ``--max_steps``, ``--compute_dtype``, ``--num_devices``.

The port's own copy of ``hypernerf_tpu/opt.py``: same flags and defaults
(``tests/test_torch_imports.py`` holds the two together). ``--no_pallas``
is accepted and inert here; ``--profile_steps`` / ``--profile_start``
trace the trainer's steps with ``torch.profiler``; ``--num_devices`` /
``--num_gpus`` N start N data-parallel ranks, one a GPU (``train.py``), and
``--shard_optimizer_state`` shards the optimizer's moments over them.
"""

from __future__ import annotations

import argparse

from hypernerf_tpu_torch.configs import NerfConfig, TrainConfig


def _str2bool(v):
    if isinstance(v, bool):
        return v
    return str(v).lower() in ('true', '1', 'yes', 'y', 't')


def build_parser(eval_mode: bool = False) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()

    parser.add_argument('--root_dir', type=str, default='',
                        help='root directory of dataset')
    parser.add_argument('--dataset_name', type=str, default='llff',
                        choices=['blender', 'llff'],
                        help='which dataset to train/val')
    parser.add_argument('--img_wh', nargs='+', type=int, default=[504, 378],
                        help='resolution (img_w, img_h) of the image')
    parser.add_argument('--spheric_poses', default=False, action='store_true',
                        help='whether images are taken in spheric poses (for llff)')

    parser.add_argument('--N_samples', type=int, default=64,
                        help='number of coarse samples')
    parser.add_argument('--N_importance', type=int, default=128,
                        help='number of additional fine samples (any value '
                             'rides the in-kernel hierarchical sampling on '
                             'TPU; non-power-of-two coarse+fine totals use '
                             'a sentinel-padded union merge)')
    parser.add_argument('--use_disp', default=False, action='store_true',
                        help='use disparity depth sampling')
    parser.add_argument('--perturb', type=float, default=1.0,
                        help='factor to perturb depth sampling points '
                             '(0 disables stratified sampling)')
    parser.add_argument('--noise_std', type=float, default=1.0,
                        help='std dev of noise added to regularize sigma')

    parser.add_argument('--loss_type', type=str, default='mse',
                        choices=['mse'], help='loss to use')
    parser.add_argument('--elastic_loss_weight', type=float, default=0.0,
                        help='Nerfies elastic regularization weight on the '
                             'warp Jacobian (0 = off, the reference '
                             'behavior; requires a warp field; the render '
                             'stays on the level kernels and the warp '
                             'Jacobian runs through its own kernels)')
    parser.add_argument('--elastic_loss_scale', type=float, default=0.03,
                        help='robust-loss scale for the elastic penalty '
                             '(Nerfies default 0.03)')
    parser.add_argument('--elastic_jacobian_samples', type=int, default=0,
                        help='evaluate the elastic Jacobian at only K '
                             'points per ray, drawn proportional to the '
                             'rendering weights (unbiased importance '
                             'estimator; 0 = every sample). 16 recovers '
                             'most of the step speed')
    parser.add_argument('--background_loss_weight', type=float, default=0.0,
                        help='Nerfies background regularization weight: '
                             'known-static points are penalized for moving '
                             'under the warp (0 = off)')
    parser.add_argument('--background_points_path', type=str, default='',
                        help='(N, 3) .npy of known-static 3-D points '
                             '(e.g. COLMAP sparse points) for the '
                             'background loss')
    parser.add_argument('--background_loss_scale', type=float, default=0.001,
                        help='robust-loss scale for the background penalty '
                             '(Nerfies default 0.001)')

    parser.add_argument('--batch_size', type=int, default=2048,
                        help='batch size (global, across all chips)')
    parser.add_argument('--chunk', type=int, default=8192,
                        help='render tile size (rays per level-kernel '
                             'launch)')
    parser.add_argument('--num_epochs', type=int, default=20,
                        help='number of training epochs')
    parser.add_argument('--max_steps', type=int, default=None,
                        help='total training steps (overrides num_epochs)')
    parser.add_argument('--num_devices', type=int, default=None,
                        help='GPUs to train on: start this many '
                             'data-parallel ranks on this host, one process '
                             'a card (gloo processes on the CPU with '
                             'HYPERNERF_PLATFORM=cpu); default: one process')
    parser.add_argument('--num_gpus', type=int, default=None,
                        help='alias of --num_devices (reference compat)')
    parser.add_argument('--precision', type=str, default='bf16',
                        choices=['bf16', '16', '32', 'fp32', 'bfloat16',
                                 'float32'],
                        help='compute precision for the MLP matmuls')

    parser.add_argument('--ckpt_path', type=str, default=None,
                        help='checkpoint path for full-state resume (train) '
                             'or weights (eval)')
    parser.add_argument('--prefixes_to_ignore', nargs='+', type=str,
                        default=['loss'],
                        help='prefixes to ignore when loading weights')
    parser.add_argument('--weight_path', type=str, default=None,
                        help='pretrained model weights to load '
                             '(no optimizer state)')

    parser.add_argument('--optimizer', type=str, default='adam',
                        choices=['sgd', 'adam', 'radam', 'ranger'])
    parser.add_argument('--shard_optimizer_state', default=False,
                        action='store_true',
                        help='ZeRO-1: shard the optimizer moments over the '
                             'ranks (the reference runs fairscale '
                             'ddp_sharded whenever num_gpus>1, '
                             'train.py:229): each rank updates its share of '
                             'the parameters and broadcasts it. Same update, '
                             'about 1/N of the moment memory per card; no '
                             'effect on one rank.')
    parser.add_argument('--lr', type=float, default=5e-4)
    parser.add_argument('--momentum', type=float, default=0.9)
    parser.add_argument('--weight_decay', type=float, default=0.0)
    parser.add_argument('--lr_scheduler', type=str, default='steplr',
                        choices=['steplr', 'cosine', 'poly'])
    parser.add_argument('--warmup_multiplier', type=float, default=1.0)
    parser.add_argument('--warmup_epochs', type=int, default=0)
    parser.add_argument('--decay_step', nargs='+', type=int, default=[20])
    parser.add_argument('--decay_gamma', type=float, default=0.1)
    parser.add_argument('--poly_exp', type=float, default=0.9)

    parser.add_argument('--exp_name', type=str, default='exp',
                        help='experiment name')

    # warp / slicing
    parser.add_argument('--use_warp', type=_str2bool, default=True,
                        help='whether to use warping (enables the warp '
                             'embedding too)')
    parser.add_argument('--warp_field', type=str, default='translation',
                        choices=['translation', 'se3', 'quaternion'],
                        help='warp field type (se3 = quaternion/screw '
                             'exp-map field)')
    parser.add_argument('--slice_method', type=str, default='bendy_sheet',
                        choices=['bendy_sheet', 'none', 'axis_aligned_plane'],
                        help='method to slice the hyperspace')
    parser.add_argument('--hyper_slice_out_dim', type=int, default=4,
                        help='output dimension of the hypersheet mlp')
    parser.add_argument('--use_nerfies_meta', type=_str2bool, default=True,
                        help='include per-ray metadata (embedding ids)')

    # embeddings
    parser.add_argument('--meta_GLO_dim', type=int, default=8)
    parser.add_argument('--share_GLO', type=_str2bool, default=True)
    parser.add_argument('--use_nerf_embedding', action='store_true')
    parser.add_argument('--use_alpha_condition', action='store_true')
    parser.add_argument('--use_rgb_condition', action='store_true')

    parser.add_argument('--xyz_fourier', type=int, default=10)
    parser.add_argument('--hyper_fourier', type=int, default=6)
    parser.add_argument('--view_fourier', type=int, default=6)

    # Nerfies windowed-annealing encoding (off by default = reference path).
    parser.add_argument('--use_nerfies_embed', action='store_true',
                        help='use the Nerfies windowed posenc with '
                             'coarse-to-fine annealing')
    parser.add_argument('--warp_alpha_steps', type=int, default=80000)
    parser.add_argument('--hyper_alpha_steps', type=int, default=10000)

    parser.add_argument('--ckpt_keep_top_k', type=int, default=None,
                        help='keep only the best K checkpoints by val/psnr '
                             '(plus the latest); default keeps everything '
                             'like the reference save_top_k=-1')
    parser.add_argument('--no_pallas', action='store_true',
                        help='kept so that the JAX package\'s command '
                             'lines parse; sets the inert use_pallas field, '
                             'the port\'s CUDA kernels still run')
    parser.add_argument('--use_occupancy_grid', type=_str2bool,
                        default=False,
                        help='occupancy-grid guided coarse sampling '
                             '(opt-in; reshapes sample placement so '
                             'N_samples can be cut 2-4x at equal quality)')
    parser.add_argument('--occupancy_resolution', type=int, default=64)
    parser.add_argument('--occupancy_probes', type=int, default=64)
    parser.add_argument('--occupancy_floor', type=float, default=0.01)
    parser.add_argument('--occupancy_bbox', nargs=2, type=float,
                        default=[-2.0, 2.0],
                        help='grid bounding cube [min max] in world units')
    parser.add_argument('--occupancy_update_every', type=int, default=16)
    parser.add_argument('--occupancy_decay', type=float, default=0.95)
    parser.add_argument('--occupancy_probe_ids', type=int, default=4,
                        help='metadata ids probed (max-ed) per grid refresh')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--log_every', type=int, default=100)
    parser.add_argument('--val_check_interval', type=float, default=0.25)
    parser.add_argument('--profile_steps', type=int, default=0,
                        help='trace this many train steps with '
                             'torch.profiler into <log_dir>/<exp_name>/'
                             'profile/trace.json (0 disables)')
    parser.add_argument('--profile_start', type=int, default=10)

    if eval_mode:
        parser.add_argument('--scene_name', type=str, default='test',
                            help='scene name, used as output folder name')
        parser.add_argument('--split', type=str, default='test',
                            help='test or test_train')
        parser.add_argument('--save_depth', default=False,
                            action='store_true')
        parser.add_argument('--depth_format', type=str, default='pfm',
                            choices=['pfm', 'bytes'])
        parser.add_argument('--gif_fps', type=int, default=30)
    return parser


def get_opts(args=None, eval_mode: bool = False):
    return build_parser(eval_mode).parse_args(args)


def configs_from_args(args) -> tuple:
    """Resolve the flat namespace into (NerfConfig, TrainConfig)."""
    precision = str(args.precision)
    compute_dtype = ('float32' if precision in ('32', 'fp32', 'float32')
                     else 'bfloat16')
    nerf_cfg = NerfConfig(
        num_coarse_samples=args.N_samples,
        num_fine_samples=args.N_importance,
        noise_std=args.noise_std,
        use_stratified_sampling=args.perturb > 0,
        use_linear_disparity=args.use_disp,
        use_warp=args.use_warp,
        warp_field_type=getattr(args, 'warp_field', 'translation'),
        hyper_slice_method=args.slice_method,
        hyper_slice_out_dim=args.hyper_slice_out_dim,
        glo_dim=args.meta_GLO_dim,
        share_glo=args.share_GLO,
        use_nerf_embed=args.use_nerf_embedding,
        use_alpha_condition=args.use_alpha_condition,
        use_rgb_condition=args.use_rgb_condition,
        xyz_freq=args.xyz_fourier,
        hyper_freq=args.hyper_fourier,
        dir_freq=args.view_fourier,
        use_original_embed=not getattr(args, 'use_nerfies_embed', False),
        compute_dtype=compute_dtype,
        use_pallas=not getattr(args, 'no_pallas', False),
        use_occupancy_grid=getattr(args, 'use_occupancy_grid', False),
        occupancy_resolution=getattr(args, 'occupancy_resolution', 64),
        occupancy_probes=getattr(args, 'occupancy_probes', 64),
        occupancy_floor=getattr(args, 'occupancy_floor', 0.01),
        occupancy_bbox_min=getattr(args, 'occupancy_bbox', [-2.0, 2.0])[0],
        occupancy_bbox_max=getattr(args, 'occupancy_bbox', [-2.0, 2.0])[1],
        elastic_jacobian_samples=getattr(args, 'elastic_jacobian_samples', 0),
    )
    train_cfg = TrainConfig(
        loss_type=args.loss_type,
        elastic_loss_weight=args.elastic_loss_weight,
        elastic_loss_scale=args.elastic_loss_scale,
        background_loss_weight=args.background_loss_weight,
        background_loss_scale=args.background_loss_scale,
        background_points_path=args.background_points_path,
        root_dir=args.root_dir,
        dataset_name=args.dataset_name,
        img_wh=tuple(args.img_wh),
        spheric_poses=args.spheric_poses,
        use_nerfies_meta=args.use_nerfies_meta,
        batch_size=args.batch_size,
        chunk=args.chunk,
        num_epochs=args.num_epochs,
        max_steps=getattr(args, 'max_steps', None),
        lr=args.lr,
        optimizer=args.optimizer,
        shard_optimizer_state=args.shard_optimizer_state,
        momentum=args.momentum,
        weight_decay=args.weight_decay,
        lr_scheduler=args.lr_scheduler,
        warmup_multiplier=args.warmup_multiplier,
        warmup_epochs=args.warmup_epochs,
        decay_step=tuple(args.decay_step),
        decay_gamma=args.decay_gamma,
        poly_exp=args.poly_exp,
        warp_alpha_steps=getattr(args, 'warp_alpha_steps', 80000),
        hyper_alpha_steps=getattr(args, 'hyper_alpha_steps', 10000),
        occupancy_update_every=getattr(args, 'occupancy_update_every', 16),
        occupancy_decay=getattr(args, 'occupancy_decay', 0.95),
        occupancy_probe_ids=getattr(args, 'occupancy_probe_ids', 4),
        exp_name=args.exp_name,
        ckpt_path=args.ckpt_path,
        weight_path=args.weight_path,
        prefixes_to_ignore=tuple(args.prefixes_to_ignore),
        ckpt_keep_top_k=getattr(args, 'ckpt_keep_top_k', None),
        seed=getattr(args, 'seed', 0),
        log_every=getattr(args, 'log_every', 100),
        val_check_interval=getattr(args, 'val_check_interval', 0.25),
        profile_steps=getattr(args, 'profile_steps', 0),
        profile_start=getattr(args, 'profile_start', 10),
    )
    return nerf_cfg, train_cfg
