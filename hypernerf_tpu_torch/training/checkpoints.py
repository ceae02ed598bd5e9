"""The port's weight file: ``torch.save`` of the model's state dict, with
``nerf_config.json`` beside it (the port's ``load_weights``,
``hypernerf_tpu/training/checkpoints.py:216``)."""

from __future__ import annotations

import os

import torch

from hypernerf_tpu_torch.configs import NerfConfig

CONFIG_NAME = 'nerf_config.json'


def save_weights(path: str, state_dict: dict, config: NerfConfig) -> None:
    """Write the weights to ``path`` and the config beside it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)
    with open(config_path(path), 'w') as f:
        f.write(config.to_json())


def config_path(weight_path: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(weight_path)),
                        CONFIG_NAME)


def load_config(weight_path: str):
    """The NerfConfig saved beside ``weight_path``, or None."""
    path = config_path(weight_path)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return NerfConfig.from_json(f.read())


def load_weights(model: torch.nn.Module, path: str) -> None:
    """Load a weight file into ``model`` (strict: every key must match)."""
    state = torch.load(path, map_location='cpu', weights_only=True)
    model.load_state_dict(state)
