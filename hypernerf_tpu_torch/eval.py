"""Render a trained model along the test path: ``python -m
hypernerf_tpu_torch.eval`` (the port of the repository's ``eval.py``).

Takes eval.py's flags (``hypernerf_tpu_torch.opt.get_opts(eval_mode=True)``),
reads ``nerf_config.json`` beside the weight file (``--ckpt_path`` or
``--weight_path``, a file written by ``training.checkpoints.save_weights`` or
``tools/jax_ckpt_to_torch.py``) and writes results/{dataset}/{scene}/NNN.png,
optional depth dumps and {scene}.gif, printing the PSNR of each frame and
their mean where ground truth exists. Renders on the CUDA card, and exits
with an error when there is none; with ``HYPERNERF_PLATFORM=cpu`` in the
environment (the variable the repository's other CLIs honour) it renders on
the CPU instead, through the kernels' plain versions.
"""

from __future__ import annotations

import os


def render_device():
    """The device an entry point runs on: the CUDA card, or the CPU when
    ``HYPERNERF_PLATFORM=cpu`` asks for it. No card and no such request is an
    error, never a silent CPU run."""
    import torch
    platform = os.environ.get('HYPERNERF_PLATFORM', 'cuda').lower()
    if platform == 'cpu':
        return torch.device('cpu')
    if platform not in ('cuda', 'gpu'):
        raise SystemExit(f'HYPERNERF_PLATFORM={platform!r}: this package '
                         f'runs on cuda, or on cpu when asked')
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device: this entry point runs on the GPU; '
                         'set HYPERNERF_PLATFORM=cpu to run it on the CPU')
    return torch.device('cuda')


def main(argv=None):
    import numpy as np
    import torch
    from PIL import Image

    from hypernerf_tpu_torch.datasets import dataset_dict
    from hypernerf_tpu_torch.datasets.depth_io import save_pfm
    from hypernerf_tpu_torch.opt import configs_from_args, get_opts
    from hypernerf_tpu_torch.models.nerf import NerfModel
    from hypernerf_tpu_torch.training import checkpoints, metrics
    from hypernerf_tpu_torch.training.renderer import ImageRenderer

    args = get_opts(argv, eval_mode=True)
    device = render_device()
    w, h = args.img_wh
    nerf_cfg, _ = configs_from_args(args)
    weight_path = args.ckpt_path or args.weight_path
    if weight_path:
        nerf_cfg = checkpoints.load_config(weight_path) or nerf_cfg

    kwargs = dict(root_dir=args.root_dir, split=args.split,
                  img_wh=tuple(args.img_wh),
                  include_idx=args.use_nerfies_meta)
    if args.dataset_name == 'llff':
        kwargs['spheric_poses'] = args.spheric_poses
    dataset = dataset_dict[args.dataset_name](**kwargs)

    torch.manual_seed(args.seed)
    model = NerfModel(nerf_cfg)  # without weights eval.py renders the init
    if weight_path:
        checkpoints.load_weights(model, weight_path)
    model.to(device).eval()

    typ = 'fine' if nerf_cfg.num_fine_samples > 0 else 'coarse'
    keep = ('rgb', 'depth') if args.save_depth else ('rgb',)
    renderer = ImageRenderer(model, chunk=args.chunk, keep=keep,
                             levels=(typ,), quantize=True)

    dir_name = f'results/{args.dataset_name}/{args.scene_name}'
    os.makedirs(dir_name, exist_ok=True)
    imgs, psnrs = [], []
    for i in range(len(dataset)):
        sample = dataset[i]
        out = renderer(sample['rays'])
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
    imgs[0].save(os.path.join(dir_name, f'{args.scene_name}.gif'),
                 save_all=True, append_images=imgs[1:],
                 duration=1000.0 / args.gif_fps, loop=0)
    if psnrs:
        print(f'Mean PSNR : {np.mean(psnrs):.2f}')


if __name__ == '__main__':
    main()
