"""Checkpoints: full-state resume and weight files (port of
``hypernerf_tpu/training/checkpoints.py``, in the port's own format).

* A full checkpoint is the directory ``ckpt_dir/step_N`` holding
  ``checkpoint.pt``: ``torch.save`` of {'nerf': the model's state dict,
  'opt_state': the optimizer's state dict, 'step': N} and, for a
  grid-trained model, 'occupancy': the (G, G, G) grid (``save_checkpoint``,
  ``restore_checkpoint``). ``manifest.json`` in ``ckpt_dir`` records each
  save's metrics (step -> {name: value}), by which ``best_checkpoint`` and
  ``prune_checkpoints`` rank the saves.
* A weight file is ``torch.save`` of the model's state dict alone
  (``save_weights``, ``save_weights_only``); it carries no step.

``nerf_config.json`` and, where training wrote one, ``train_config.json``
lie beside a weight file or a checkpoint's ``step_N`` directory, so that
eval renders the configuration that was trained. Every tensor is saved on
the CPU; loads map it to the CPU first.

In a data-parallel launch every rank calls ``save_checkpoint`` and rank 0
alone writes (the JAX trainer saves on process 0). Under ZeRO-1 the
moments are gathered to rank 0 first, so the file holds the replicated
optimizer's state dict, the same keys and tensors as a replicated run's:
it resumes in a run of any world size, with ZeRO on or off, and
``restore_checkpoint`` hands each rank its share.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional, Sequence

import torch

from hypernerf_tpu_torch.configs import NerfConfig, TrainConfig
from hypernerf_tpu_torch.parallel.distributed import is_primary_host
from hypernerf_tpu_torch.training.optimizers import full_state_dict

MODEL_KEY = 'nerf'
CKPT_NAME = 'checkpoint.pt'
MANIFEST_NAME = 'manifest.json'
CONFIG_NAME = 'nerf_config.json'
TRAIN_CONFIG_NAME = 'train_config.json'


def _to_cpu(tree):
    """A copy of a nest of dicts, lists and tuples with every tensor on the
    CPU (an optimizer's state dict)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _write_configs(directory: str, nerf_config=None,
                   train_config=None) -> None:
    for config, name in ((nerf_config, CONFIG_NAME),
                         (train_config, TRAIN_CONFIG_NAME)):
        if config is not None:
            with open(os.path.join(directory, name), 'w') as f:
                f.write(config.to_json())


def save_weights(path: str, state_dict: dict, config: NerfConfig,
                 train_config: Optional[TrainConfig] = None) -> None:
    """Write the weights to ``path`` and the configs beside it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)
    _write_configs(os.path.dirname(os.path.abspath(path)), config,
                   train_config)


def config_path(weight_path: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(weight_path)),
                        CONFIG_NAME)


def load_config(weight_path: str):
    """The NerfConfig saved beside ``weight_path`` (a weight file or a
    checkpoint's directory), or None."""
    path = config_path(weight_path)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return NerfConfig.from_json(f.read())


def load_train_config(weight_path: str):
    """The TrainConfig saved beside ``weight_path``, or None."""
    path = os.path.join(os.path.dirname(os.path.abspath(weight_path)),
                        TRAIN_CONFIG_NAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return TrainConfig.from_json(f.read())


def save_checkpoint(ckpt_dir: str, step: int, state, nerf_config=None,
                    train_config=None, metrics: Optional[dict] = None) -> str:
    """Save the full ``training.train_state.TrainState`` at
    ``ckpt_dir/step_{step}``, record ``metrics`` in the manifest and write
    the configs beside it; returns the checkpoint's path. In a launch, call
    it on every rank (ZeRO-1 gathers the moments): rank 0 writes, the
    others return the path without writing."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    path = os.path.join(ckpt_dir, f'step_{step}')
    opt_state = full_state_dict(state.optimizer)
    if not is_primary_host():
        return path
    os.makedirs(path, exist_ok=True)
    payload = {MODEL_KEY: _to_cpu(state.model.state_dict()),
               'opt_state': _to_cpu(opt_state),
               'step': int(step)}
    if state.occupancy is not None:
        payload['occupancy'] = _to_cpu(state.occupancy)
    torch.save(payload, os.path.join(path, CKPT_NAME))

    manifest = _read_manifest(ckpt_dir)
    manifest[str(step)] = {k: float(v) for k, v in (metrics or {}).items()}
    with open(os.path.join(ckpt_dir, MANIFEST_NAME), 'w') as f:
        json.dump(manifest, f, indent=2)
    _write_configs(ckpt_dir, nerf_config, train_config)
    return path


def _read_manifest(ckpt_dir: str) -> dict:
    path = os.path.join(ckpt_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _steps(ckpt_dir: str):
    return [int(name[5:]) for name in os.listdir(ckpt_dir)
            if name.startswith('step_') and name[5:].isdigit()]


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Path of the highest-step checkpoint in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    if not steps:
        return None
    return os.path.join(ckpt_dir, f'step_{max(steps)}')


def best_checkpoint(ckpt_dir: str, monitor: str = 'val/psnr',
                    mode: str = 'max') -> Optional[str]:
    """Path of the checkpoint whose manifest entry is best at ``monitor``
    (``mode`` 'max' or 'min'); the latest where no entry has it."""
    scored = [(v[monitor], int(k)) for k, v in _read_manifest(
        ckpt_dir).items() if monitor in v]
    if not scored:
        return latest_checkpoint(ckpt_dir)
    best = max(scored)[1] if mode == 'max' else min(scored)[1]
    return os.path.join(ckpt_dir, f'step_{best}')


def prune_checkpoints(ckpt_dir: str, keep_top_k: int,
                      monitor: str = 'val/psnr', mode: str = 'max') -> None:
    """Keep the ``keep_top_k`` checkpoints best at ``monitor`` and always
    the latest; delete the rest. A checkpoint whose manifest entry lacks
    the metric ranks last; the manifest keeps every entry."""
    if not os.path.isdir(ckpt_dir) or keep_top_k is None or keep_top_k < 1:
        return
    steps = _steps(ckpt_dir)
    if len(steps) <= keep_top_k:
        return
    manifest = _read_manifest(ckpt_dir)
    sign = 1.0 if mode == 'max' else -1.0

    def score(step):
        val = manifest.get(str(step), {}).get(monitor)
        return sign * float(val) if val is not None else -float('inf')

    keep = set(sorted(steps, key=score, reverse=True)[:keep_top_k])
    keep.add(max(steps))
    for step in steps:
        if step not in keep:
            shutil.rmtree(os.path.join(ckpt_dir, f'step_{step}'),
                          ignore_errors=True)


def _payload(path: str) -> dict:
    """The dict of a full checkpoint (its directory or its file), or
    {MODEL_KEY: state dict} of a weight file."""
    if os.path.isdir(path):
        path = os.path.join(path, CKPT_NAME)
    raw = torch.load(path, map_location='cpu', weights_only=True)
    if 'step' in raw and MODEL_KEY in raw:
        return raw
    return {MODEL_KEY: raw}


def checkpoint_step(path: str) -> Optional[int]:
    """The step a full checkpoint was saved at; None for a weight file."""
    step = _payload(path).get('step')
    return None if step is None else int(step)


def load_occupancy(path: Optional[str]) -> Optional[torch.Tensor]:
    """The occupancy grid of a full checkpoint (on the CPU); None without a
    path, for a weight file and for a checkpoint saved without a grid."""
    if not path:
        return None
    return _payload(path).get('occupancy')


def restore_checkpoint(path: str, state=None):
    """Restore a full checkpoint. Without ``state``, its raw dict. With a
    ``TrainState``, load its weights, optimizer state and step into it (in
    place, and return it); its grid replaces the state's where the state has
    one, and a checkpoint without a grid leaves the state's fresh grid as it
    is (a run that turns the grid on resumes from an older checkpoint).
    A ZeRO-1 optimizer keeps its rank's share of the moments."""
    raw = _payload(path)
    if state is None:
        return raw
    if 'opt_state' not in raw:
        raise ValueError(f'{path} is a weight file: it holds no optimizer '
                         f'state or step to resume from')
    state.model.load_state_dict(raw[MODEL_KEY])
    state.optimizer.load_state_dict(raw['opt_state'])
    state.step = int(raw['step'])
    if state.occupancy is not None and raw.get('occupancy') is not None:
        state.occupancy = raw['occupancy'].to(state.occupancy)
    return state


def load_weights(model: torch.nn.Module, path: str, strict: bool = True,
                 prefixes_to_ignore: Sequence[str] = ()) -> None:
    """Load the weights of a weight file or a full checkpoint into
    ``model``. Strict: every key must match. Otherwise a partial warm
    start: each key of the file that ``model`` has with the same shape, and
    that starts with none of ``prefixes_to_ignore``, is loaded; every other
    parameter keeps its value."""
    weights = _payload(path)[MODEL_KEY]
    if strict:
        if prefixes_to_ignore:
            raise ValueError('a strict load ignores no prefix')
        model.load_state_dict(weights)
        return
    own = model.state_dict()
    kept = {k: v for k, v in weights.items()
            if k in own and v.shape == own[k].shape
            and not any(k.startswith(p) for p in prefixes_to_ignore)}
    model.load_state_dict(kept, strict=False)


def save_weights_only(ckpt_path: str, out_path: str) -> str:
    """Strip a full checkpoint to a weight file at ``out_path``, with the
    checkpoint's configs beside it; returns ``out_path``."""
    config = load_config(ckpt_path)
    if config is None:
        raise FileNotFoundError(f'no {CONFIG_NAME} beside {ckpt_path}')
    save_weights(out_path, _payload(ckpt_path)[MODEL_KEY], config,
                 load_train_config(ckpt_path))
    return out_path
