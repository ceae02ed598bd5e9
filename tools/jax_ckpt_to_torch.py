#!/usr/bin/env python
"""Convert a hypernerf_tpu (JAX) checkpoint into the PyTorch port's format,
with ``nerf_config.json`` (and ``train_config.json``) beside the result.

  python tools/jax_ckpt_to_torch.py --ckpt_path ckpts/exp/step_10000 \
      --out_path weights/exp/model.pt
  python tools/jax_ckpt_to_torch.py --ckpt_path ckpts/exp/step_10000 \
      --out_dir ckpts_torch/exp

``--out_path`` writes a weight file from any JAX checkpoint, full or
weights-only: the model sub-tree is read with
``training.checkpoints.extract_model_params`` and renamed by
``hypernerf_tpu_torch.convert.params_from_jax``; of a ``ranger`` run's
(fast, slow) pair it takes the fast weights, which the JAX forward reads
(``forward_params``) and the port's model holds. ``--out_dir`` converts a
full checkpoint (JAX ``save_checkpoint``) into a full port checkpoint
``out_dir/step_N``: the parameters, the step, the occupancy grid where there
is one, and the state of the run's optimizer: ``adam`` / ``radam``'s
moments (optax ``mu`` / ``nu`` -> ``exp_avg`` / ``exp_avg_sq``, ``count`` ->
each parameter's ``step``), ``sgd``'s momentum (``trace`` ->
``momentum_buffer``), ``ranger``'s RAdam moments of the fast weights, its
slow weights (each parameter's ``slow``) and ``steps_since_sync``, so that
a JAX run resumes in the port (``training.checkpoints.restore_checkpoint``).
The
configs are the ones the trainer wrote beside the checkpoint (or
``--nerf_config`` / ``--train_config``). The result is checked by a strict
load into the port's NerfModel before it is written; render it with
``python -m hypernerf_tpu_torch.eval --weight_path <out_path>`` or
``--ckpt_path <out_dir>/step_N``.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _configs(ckpt_path: str, nerf_config: str = None,
             train_config: str = None):
    """(NerfConfig, TrainConfig or None) of the port, from the JSON files
    given or beside the checkpoint."""
    from hypernerf_tpu_torch.configs import NerfConfig, TrainConfig
    beside = os.path.dirname(os.path.abspath(ckpt_path))
    with open(nerf_config or os.path.join(beside, 'nerf_config.json')) as f:
        cfg = NerfConfig.from_json(f.read())
    path = train_config or os.path.join(beside, 'train_config.json')
    train_cfg = None
    if os.path.exists(path):
        with open(path) as f:
            train_cfg = TrainConfig.from_json(f.read())
    return cfg, train_cfg


def convert(ckpt_path: str, out_path: str, nerf_config: str = None) -> str:
    """A JAX checkpoint -> the port's weight file at ``out_path``."""
    from hypernerf_tpu.training.checkpoints import extract_model_params
    from hypernerf_tpu_torch.convert import params_from_jax
    from hypernerf_tpu_torch.models.nerf import NerfModel
    from hypernerf_tpu_torch.training.checkpoints import save_weights

    cfg, train_cfg = _configs(ckpt_path, nerf_config)
    flat = extract_model_params(ckpt_path)
    if any(k.startswith('fast/') for k in flat):  # ranger's LookaheadParams
        flat = {k[5:]: v for k, v in flat.items() if k.startswith('fast/')}
    state = params_from_jax(flat)
    NerfModel(cfg).load_state_dict(state)  # strict: every key must match
    save_weights(out_path, state, cfg, train_cfg)
    return out_path


def convert_checkpoint(ckpt_path: str, out_dir: str, nerf_config: str = None,
                       train_config: str = None) -> str:
    """A full JAX checkpoint -> a full port checkpoint in ``out_dir``;
    returns its path, ``out_dir/step_N``."""
    import numpy as np
    import torch

    from hypernerf_tpu.training.checkpoints import restore_checkpoint
    from hypernerf_tpu_torch.configs import TrainConfig
    from hypernerf_tpu_torch.convert import (adam_state_from_jax,
                                             lookahead_params,
                                             params_from_jax,
                                             steps_since_sync,
                                             trace_state_from_jax)
    from hypernerf_tpu_torch.models.nerf import NerfModel
    from hypernerf_tpu_torch.training.checkpoints import save_checkpoint
    from hypernerf_tpu_torch.training.optimizers import get_optimizer
    from hypernerf_tpu_torch.training.train_state import TrainState

    raw = restore_checkpoint(ckpt_path)
    if not isinstance(raw, dict) or 'opt_state' not in raw \
            or raw.get('step') is None:
        raise ValueError(f'{ckpt_path} is not a full checkpoint (no step or '
                         f'optimizer state): convert it with --out_path')
    cfg, train_cfg = _configs(ckpt_path, nerf_config, train_config)
    train_cfg = train_cfg or TrainConfig()
    model = NerfModel(cfg)
    fast, slow = lookahead_params(raw['nerf'])
    if (slow is not None) != (train_cfg.optimizer == 'ranger'):
        raise ValueError(f'the checkpoint\'s parameters do not fit its '
                         f'optimizer {train_cfg.optimizer!r}')
    model.load_state_dict(params_from_jax(fast))  # strict
    optimizer, _ = get_optimizer(train_cfg, model.parameters(),
                                 steps_per_epoch=1)
    opt_state = raw['opt_state']
    if train_cfg.optimizer == 'sgd':
        states = trace_state_from_jax(opt_state)
    else:
        states = adam_state_from_jax(opt_state)
    if slow is not None:
        for k, v in params_from_jax(slow).items():
            states[k]['slow'] = v
        for group in optimizer.param_groups:
            group['steps_since_sync'] = steps_since_sync(opt_state)
    if states.keys() != dict(model.named_parameters()).keys():
        raise ValueError('the optimizer state does not cover the '
                         'parameters')
    for name, p in model.named_parameters():
        for k, v in states[name].items():
            if v.dim() and v.shape != p.shape:
                raise ValueError(f'{k} of {name}: shape {tuple(v.shape)}, '
                                 f'the parameter {tuple(p.shape)}')
        optimizer.state[p] = states[name]
    grid = raw.get('occupancy')
    state = TrainState(
        step=int(raw['step']), model=model, optimizer=optimizer,
        occupancy=None if grid is None else torch.from_numpy(
            np.array(grid, dtype=np.float32)))
    return save_checkpoint(out_dir, state.step, state, cfg, train_cfg)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--ckpt_path', required=True,
                        help='JAX checkpoint (full or weights-only)')
    out = parser.add_mutually_exclusive_group(required=True)
    out.add_argument('--out_path', help='the port weight file to write (.pt)')
    out.add_argument('--out_dir', help='the port checkpoint directory to '
                                       'write a full checkpoint into')
    parser.add_argument('--nerf_config', default=None,
                        help='nerf_config.json (default: beside the '
                             'checkpoint)')
    parser.add_argument('--train_config', default=None,
                        help='train_config.json of a full checkpoint '
                             '(default: beside it; else the defaults)')
    args = parser.parse_args()
    if args.out_dir:
        print(convert_checkpoint(args.ckpt_path, args.out_dir,
                                 args.nerf_config, args.train_config))
    else:
        print(convert(args.ckpt_path, args.out_path, args.nerf_config))


if __name__ == '__main__':
    main()
