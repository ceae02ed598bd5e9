"""Render a trained model along the test path: ``python -m
hypernerf_tpu_torch.eval`` (the port of the repository's ``eval.py``).

Takes eval.py's flags (``hypernerf_tpu_torch.opt.get_opts(eval_mode=True)``),
reads ``nerf_config.json`` (and ``train_config.json``, where there is one)
beside the weights (``--ckpt_path`` or ``--weight_path``: a full checkpoint
``step_N`` of ``training.checkpoints.save_checkpoint``, or a weight file of
``save_weights``, ``save_weights_only`` or ``tools/jax_ckpt_to_torch.py``),
renders at the annealing alphas of ``eval_extra_params`` at the checkpoint's
step and, where the config uses one, through the checkpoint's occupancy
grid, and writes results/{dataset}/{scene}/NNN.png,
optional depth dumps and {scene}.gif, printing the PSNR of each frame and
their mean where ground truth exists. Renders on the CUDA card, and exits
with an error when there is none; with ``HYPERNERF_PLATFORM=cpu`` in the
environment (the variable the repository's other CLIs honour) it renders on
the CPU instead, through the kernels' plain versions.

Started by ``torchrun`` or with the ``HYPERNERF_COORDINATOR`` variables
(``parallel.distributed``), every rank renders its share of each frame's
chunks and rank 0 writes the files and prints (the JAX ``eval.py`` renders
over every device); otherwise it renders on one card.
"""

from __future__ import annotations

import os


def eval_extra_params(nerf_cfg, train_cfg, step=None) -> dict:
    """The annealing alphas to render at, as the JAX package's ``eval.py``
    computes them: at a full checkpoint's ``step``; a weight file carries no
    step (None), so the model is taken as fully annealed, at the larger of
    ``warp_alpha_steps`` and ``hyper_alpha_steps``."""
    from hypernerf_tpu_torch.training.train_state import compute_extra_params
    if step is None:
        step = max(train_cfg.warp_alpha_steps, train_cfg.hyper_alpha_steps)
    return compute_extra_params(nerf_cfg, train_cfg, step)


def main(argv=None):
    from hypernerf_tpu_torch.parallel import distributed
    joined = distributed.maybe_initialize_distributed()
    try:
        _render(argv, joined)
    finally:
        if joined:
            distributed.shutdown()


def _render(argv, joined: bool):
    import numpy as np
    import torch
    from PIL import Image

    from hypernerf_tpu_torch.datasets import dataset_dict
    from hypernerf_tpu_torch.datasets.depth_io import save_pfm
    from hypernerf_tpu_torch.opt import configs_from_args, get_opts
    from hypernerf_tpu_torch.models.nerf import NerfModel
    from hypernerf_tpu_torch.parallel.distributed import rank_device
    from hypernerf_tpu_torch.parallel.mesh import create_mesh
    from hypernerf_tpu_torch.training import checkpoints, metrics
    from hypernerf_tpu_torch.training.renderer import ImageRenderer

    args = get_opts(argv, eval_mode=True)
    mesh = create_mesh() if joined else None
    device = mesh.device if mesh else rank_device()
    primary = mesh is None or mesh.is_primary
    w, h = args.img_wh
    nerf_cfg, train_cfg = configs_from_args(args)
    weight_path = args.ckpt_path or args.weight_path
    if weight_path:
        nerf_cfg = checkpoints.load_config(weight_path) or nerf_cfg
        train_cfg = checkpoints.load_train_config(weight_path) or train_cfg

    kwargs = dict(root_dir=args.root_dir, split=args.split,
                  img_wh=tuple(args.img_wh),
                  include_idx=args.use_nerfies_meta)
    if args.dataset_name == 'llff':
        kwargs['spheric_poses'] = args.spheric_poses
    dataset = dataset_dict[args.dataset_name](**kwargs)

    torch.manual_seed(args.seed)
    model = NerfModel(nerf_cfg)  # without weights eval.py renders the init
    step = grid = None
    if weight_path:
        checkpoints.load_weights(model, weight_path)
        step = checkpoints.checkpoint_step(weight_path)
        if nerf_cfg.use_occupancy_grid:
            grid = checkpoints.load_occupancy(weight_path)
    model.to(device).eval()

    typ = 'fine' if nerf_cfg.num_fine_samples > 0 else 'coarse'
    keep = ('rgb', 'depth') if args.save_depth else ('rgb',)
    renderer = ImageRenderer(
        model, chunk=args.chunk, keep=keep, levels=(typ,), quantize=True,
        extra_params=eval_extra_params(nerf_cfg, train_cfg, step),
        occupancy_grid=None if grid is None else grid.to(device), mesh=mesh)

    dir_name = f'results/{args.dataset_name}/{args.scene_name}'
    if primary:
        os.makedirs(dir_name, exist_ok=True)
    imgs, psnrs = [], []
    for i in range(len(dataset)):
        sample = dataset[i]
        out = renderer(sample['rays'])
        if not primary:
            continue
        img = out[typ]['rgb'].reshape(h, w, 3)
        if args.save_depth:
            depth = np.nan_to_num(out[typ]['depth'].reshape(h, w))
            if args.depth_format == 'pfm':
                save_pfm(os.path.join(dir_name, f'depth_{i:03d}.pfm'),
                         depth.astype(np.float32))
            else:
                with open(os.path.join(dir_name, f'depth_{i:03d}'),
                          'wb') as f:
                    f.write(depth.tobytes())
        imgs.append(Image.fromarray(img))
        imgs[-1].save(os.path.join(dir_name, f'{i:03d}.png'))
        if 'rgbs' in sample:
            # PSNR of the image written to disk, as eval.py scores it.
            frame_psnr = metrics.psnr(sample['rgbs'].reshape(h, w, 3),
                                      img.astype(np.float32) / 255.0)
            psnrs.append(frame_psnr)
            print(f'frame {i:03d}: psnr {frame_psnr:.2f}', flush=True)
        else:
            print(f'frame {i:03d} rendered', flush=True)
    if not primary:
        return
    imgs[0].save(os.path.join(dir_name, f'{args.scene_name}.gif'),
                 save_all=True, append_images=imgs[1:],
                 duration=1000.0 / args.gif_fps, loop=0)
    if psnrs:
        print(f'Mean PSNR : {np.mean(psnrs):.2f}')


if __name__ == '__main__':
    main()
