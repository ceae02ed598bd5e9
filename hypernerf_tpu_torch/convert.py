"""flax params of ``hypernerf_tpu`` -> a state dict of this package.

The port's modules carry the flax names, so a flax path maps onto a state
dict key by renaming its leaf: a Dense ``kernel`` (in, out) becomes
``weight`` (out, in) transposed, an Embed ``embedding`` becomes ``weight``
and a ``bias`` stays. For example ``nerf_coarse/trunk/hidden_0/kernel`` ->
``nerf_coarse.trunk.hidden_0.weight`` and ``warp_embed/embed/embedding`` ->
``warp_embed.embed.weight``. An optimizer's state holds trees of the
parameters' shapes, which map the same way: Adam's and RAdam's moments
(``adam_state_from_jax``), SGD's momentum (``trace_state_from_jax``); a
lookahead (``ranger``) state keeps the RAdam state of its fast weights, and
its parameters are a (fast, slow) pair (``lookahead_params``). Uses numpy
and torch only.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_LEAF = {'kernel': 'weight', 'embedding': 'weight', 'bias': 'bias'}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        path = prefix + tuple(str(k).split('/'))
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


def params_to_jax(state: Dict[str, torch.Tensor]) -> dict:
    """State dict -> nested dict of numpy arrays, the inverse of
    ``params_from_jax``. A ``weight`` under a module named ``embed`` is an
    Embed ``embedding``; every other ``weight`` is a Dense ``kernel``."""
    params = {}
    for key, value in state.items():
        path = key.split('.')
        arr = value.detach().cpu().float().numpy()
        if path[-1] == 'weight' and path[-2] == 'embed':
            path[-1] = 'embedding'
        elif path[-1] == 'weight':
            path[-1], arr = 'kernel', arr.T
        node = params
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = np.array(arr, copy=True)
    return params


def params_from_jax(params) -> Dict[str, torch.Tensor]:
    """Nested (or '/'-flattened) dict of numpy arrays -> state dict."""
    state = {}
    for path, value in _leaves(params):
        if path[-1] not in _LEAF:
            raise KeyError(f'unknown flax leaf {"/".join(path)}')
        arr = np.asarray(value, dtype=np.float32)
        if path[-1] == 'kernel':
            arr = arr.T
        key = '.'.join(path[:-1] + (_LEAF[path[-1]],))
        state[key] = torch.from_numpy(np.array(arr, copy=True))
    return state


def _node(tree, keys):
    """The first dict of a restored optax state (nested dicts and lists)
    that has every key of ``keys``, or None."""
    if isinstance(tree, dict):
        if set(keys) <= tree.keys():
            return tree
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return None
    for child in children:
        found = _node(child, keys)
        if found is not None:
            return found
    return None


def lookahead_params(params):
    """(fast, slow) of a restored ``optax.LookaheadParams`` tree ({'fast':
    ..., 'slow': ...}); (params, None) for any other parameter tree."""
    if isinstance(params, dict) and params.keys() == {'fast', 'slow'}:
        return params['fast'], params['slow']
    return params, None


def adam_state_from_jax(opt_state) -> Dict[str, Dict[str, torch.Tensor]]:
    """optax ``scale_by_adam`` state -> ``torch.optim.Adam``'s state of each
    parameter, by state dict key: 'exp_avg' and 'exp_avg_sq' are ``mu`` and
    ``nu`` renamed and transposed as ``params_from_jax`` does the
    parameters, and 'step' is ``count`` (the updates taken). Raises where
    the state holds no Adam moments."""
    node = _node(opt_state, ('count', 'mu', 'nu'))
    if node is None:
        raise ValueError('the optimizer state holds no Adam moments '
                         '(count, mu, nu)')
    count = torch.tensor(float(np.asarray(node['count'])),
                         dtype=torch.float32)
    mu, nu = params_from_jax(node['mu']), params_from_jax(node['nu'])
    return {k: {'step': count.clone(), 'exp_avg': mu[k],
                'exp_avg_sq': nu[k]} for k in mu}


def trace_state_from_jax(opt_state) -> Dict[str, Dict[str, torch.Tensor]]:
    """optax ``trace`` state (SGD's momentum) -> ``torch.optim.SGD``'s
    'momentum_buffer' of each parameter, by state dict key."""
    node = _node(opt_state, ('trace',))
    if node is None:
        raise ValueError('the optimizer state holds no momentum (trace)')
    return {k: {'momentum_buffer': v}
            for k, v in params_from_jax(node['trace']).items()}


def steps_since_sync(opt_state) -> int:
    """The updates a restored ``optax.lookahead`` state took since its last
    sync."""
    node = _node(opt_state, ('fast_state', 'steps_since_sync'))
    if node is None:
        raise ValueError('the optimizer state is no lookahead state')
    return int(np.asarray(node['steps_since_sync']))
