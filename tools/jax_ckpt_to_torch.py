#!/usr/bin/env python
"""Convert a hypernerf_tpu (JAX) checkpoint into the PyTorch port's weight
file, with ``nerf_config.json`` beside it.

  python tools/jax_ckpt_to_torch.py --ckpt_path ckpts/exp/step_10000 \
      --out_path weights/exp/model.pt

The model sub-tree is read with ``training.checkpoints.extract_model_params``
and renamed by ``hypernerf_tpu_torch.convert.params_from_jax``; the config is
the ``nerf_config.json`` the trainer wrote beside the checkpoint (or
``--nerf_config``). The result is checked by a strict load into the port's
NerfModel before it is written; render it with
``python -m hypernerf_tpu_torch.eval --weight_path <out_path> ...``.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(ckpt_path: str, out_path: str, nerf_config: str = None) -> str:
    from hypernerf_tpu.training.checkpoints import extract_model_params
    from hypernerf_tpu_torch.configs import NerfConfig
    from hypernerf_tpu_torch.convert import params_from_jax
    from hypernerf_tpu_torch.models.nerf import NerfModel
    from hypernerf_tpu_torch.training.checkpoints import save_weights

    cfg_path = nerf_config or os.path.join(
        os.path.dirname(os.path.abspath(ckpt_path)), 'nerf_config.json')
    with open(cfg_path) as f:
        cfg = NerfConfig.from_json(f.read())
    state = params_from_jax(extract_model_params(ckpt_path))
    NerfModel(cfg).load_state_dict(state)  # strict: every key must match
    save_weights(out_path, state, cfg)
    return out_path


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--ckpt_path', required=True,
                        help='JAX checkpoint (full or weights-only)')
    parser.add_argument('--out_path', required=True,
                        help='the port weight file to write (.pt)')
    parser.add_argument('--nerf_config', default=None,
                        help='nerf_config.json (default: beside the '
                             'checkpoint)')
    args = parser.parse_args()
    print(convert(args.ckpt_path, args.out_path, args.nerf_config))


if __name__ == '__main__':
    main()
