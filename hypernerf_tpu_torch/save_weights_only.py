"""Strip a full checkpoint to a weight file: ``python -m
hypernerf_tpu_torch.save_weights_only --ckpt_path ckpts/exp/step_10000
[--out_path weights/exp/model.pt]`` (the port of the repository's
``save_weights_only.py``).

Drops the optimizer state, the step and the occupancy grid, and keeps the
model's state dict, with ``nerf_config.json`` (and ``train_config.json``)
beside it; the default output is ``<ckpt_path>_weights.pt``. Render it with
``python -m hypernerf_tpu_torch.eval --weight_path <out_path> ...``.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--ckpt_path', type=str, required=True,
                        help='full checkpoint (a step_N directory)')
    parser.add_argument('--out_path', type=str, default=None,
                        help='weight file to write (default: '
                             '<ckpt_path>_weights.pt)')
    args = parser.parse_args(argv)

    from hypernerf_tpu_torch.training.checkpoints import save_weights_only
    out = args.out_path or args.ckpt_path.rstrip('/') + '_weights.pt'
    print(save_weights_only(args.ckpt_path, out))


if __name__ == '__main__':
    main()
