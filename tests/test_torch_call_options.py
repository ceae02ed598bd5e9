"""The model call's options (``NerfModel.forward``'s ``near``, ``far``,
``use_sample_at_infinity`` and ``metadata_encoded``, the JAX
``NerfModel.__call__``'s) against the JAX model with the same weights and
rays, on both of the port's branches: the level kernels' (their plain
versions here) and the per-module one (reached with ``return_points``),
float32, to 1e-5 (the port's model tolerance, ``test_torch_model.py``).

A call's ``near`` / ``far`` take the place of the rays' own, which take the
place of the config's. ``use_sample_at_infinity`` changes the fine level
alone: the JAX model's coarse level keeps the config's, and so does the
port's. ``metadata_encoded`` reads each ray's embeddings from the metadata
('encoded_warp', 'encoded_hyper', 'encoded_nerf'): given the GLO tables'
rows of the rays' ids, the call is the ids' call.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.configs import NerfConfig
from hypernerf_tpu.models.nerf import NerfModel as JaxNerfModel
from hypernerf_tpu.ops.ray_dict import prepare_ray_dict as jax_ray_dict
from hypernerf_tpu_torch import configs as port_configs
from hypernerf_tpu_torch.convert import params_from_jax
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict

N_RAYS = 6
TOL = 1e-5
PER_RAY = ('rgb', 'depth', 'med_depth', 'acc')
BASE = dict(num_embeddings=4, glo_dim=8, num_coarse_samples=8,
            num_fine_samples=8, warp_depth=2, warp_width=16, warp_freq=4,
            hyper_sheet_depth=2, hyper_sheet_width=16, hyper_sheet_freq=3,
            xyz_freq=4, hyper_freq=2, dir_freq=2, trunk_depth=2,
            trunk_width=32, rgb_branch_depth=1, rgb_branch_width=16,
            skips=(1,), noise_std=None, compute_dtype='float32',
            use_pallas=False)
# One GLO table (the level kernels' family), and three: separate warp and
# hyper tables and the nerf embedding as both conditions.
CONFIGS = {'shared': {},
           'three_tables': dict(share_glo=False, use_nerf_embed=True,
                                use_alpha_condition=True,
                                use_rgb_condition=True)}
BRANCHES = ('level', 'module')


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rays(seed=0):
    rs = np.random.RandomState(seed)
    o = (rs.randn(N_RAYS, 3) * 0.1).astype(np.float32)
    d = rs.randn(N_RAYS, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d, np.full((N_RAYS, 1), 0.2, np.float32),
                           np.full((N_RAYS, 1), 2.0, np.float32),
                           rs.randint(0, 4, (N_RAYS, 1)).astype(np.float32)],
                          1)


def _jax_cfg(name):
    return NerfConfig(**BASE, **CONFIGS[name])


@functools.cache
def _flax_params(name):
    model = JaxNerfModel(_jax_cfg(name))
    params = jax.device_get(jax.jit(model.init)(
        {'params': jax.random.PRNGKey(0)},
        jax_ray_dict(jnp.asarray(_rays())))['params'])
    params = jax.tree.map(np.array, params)
    # Warp and sheet heads large enough that the fields move the output.
    params['warp_field']['mlp']['logit']['kernel'] *= 300.0
    params['hyper_sheet_mlp']['mlp']['logit']['kernel'] *= 1e4
    return params


def _port_model(name):
    model = NerfModel(port_configs.NerfConfig.from_json(
        _jax_cfg(name).to_json())).eval()
    model.load_state_dict(params_from_jax(_flax_params(name)))
    return model


def _jax_call(name, rays_dict=None, **kw):
    model = JaxNerfModel(_jax_cfg(name))
    if rays_dict is None:
        rays_dict = jax_ray_dict(jnp.asarray(_rays()))
    out = model.apply({'params': _flax_params(name)}, rays_dict,
                      deterministic=True, **kw)
    return jax.device_get(out)


def _port_call(name, branch, rays_dict=None, **kw):
    model = _port_model(name)
    if rays_dict is None:
        rays_dict = prepare_ray_dict(torch.from_numpy(_rays()))
    with torch.no_grad():
        return model(rays_dict, return_points=branch == 'module', **kw)


def _assert_close(got, want, tol=TOL):
    assert sorted(got) == sorted(want) == ['coarse', 'fine']
    for level in want:
        for k in PER_RAY:
            np.testing.assert_allclose(np.asarray(got[level][k]),
                                       np.asarray(want[level][k]), rtol=0,
                                       atol=tol, err_msg=f'{level}/{k}')


@pytest.mark.parametrize('branch', BRANCHES)
def test_near_far_override(branch):
    """A call's near / far replace the rays' own (0.2 / 2.0): the samples
    move, and with them every output."""
    kw = dict(near=0.5, far=1.2)
    want = _jax_call('shared', **kw)
    got = _port_call('shared', branch, **kw)
    _assert_close(got, want)
    plain = _port_call('shared', branch)
    assert not np.allclose(plain['fine']['depth'], got['fine']['depth'])


@pytest.mark.parametrize('branch', BRANCHES)
def test_sample_at_infinity_override_changes_the_fine_level_alone(branch):
    """``use_sample_at_infinity=False`` (the config's is True): the JAX
    model's fine level composites without the far sample, its coarse level
    keeps the config's; the port's too."""
    want = _jax_call('shared', use_sample_at_infinity=False)
    got = _port_call('shared', branch, use_sample_at_infinity=False)
    _assert_close(got, want)
    plain = _port_call('shared', branch)
    for k in PER_RAY:
        np.testing.assert_array_equal(got['coarse'][k], plain['coarse'][k])
    assert not np.allclose(got['fine']['rgb'], plain['fine']['rgb'])


def _encoded(name, rays):
    """The ray dicts (JAX, port) with the GLO tables' rows of the rays' ids
    as 'encoded_*' metadata."""
    params = _flax_params(name)
    ids = rays[:, 8].astype(np.int64)
    enc = {'encoded_warp': params['warp_embed']['embed']['embedding'][ids]}
    if 'hyper_embed' in params:
        enc['encoded_hyper'] = params['hyper_embed']['embed']['embedding'][ids]
    else:
        enc['encoded_hyper'] = enc['encoded_warp']
    if 'nerf_embed' in params:
        enc['encoded_nerf'] = params['nerf_embed']['embed']['embedding'][ids]
    jax_dict = jax_ray_dict(jnp.asarray(rays))
    jax_dict['metadata'] = {**jax_dict['metadata'],
                            **{k: jnp.asarray(v) for k, v in enc.items()}}
    port_dict = prepare_ray_dict(torch.from_numpy(rays))
    port_dict['metadata'] = {**port_dict['metadata'],
                             **{k: torch.from_numpy(v)
                                for k, v in enc.items()}}
    return jax_dict, port_dict, sorted(enc)


@pytest.mark.parametrize('name,branch', [('shared', 'level'),
                                         ('shared', 'module'),
                                         ('three_tables', 'module')])
def test_metadata_encoded(name, branch):
    """Embeddings read from the metadata (the tables' rows of the ids):
    the JAX model's call with them, and the port's call with the ids."""
    rays = _rays(1)
    jax_dict, port_dict, keys = _encoded(name, rays)
    if name == 'three_tables':
        assert keys == ['encoded_hyper', 'encoded_nerf', 'encoded_warp']
    want = _jax_call(name, jax_dict, metadata_encoded=True)
    got = _port_call(name, branch, port_dict, metadata_encoded=True)
    _assert_close(got, want)
    by_ids = _port_call(name, branch,
                        prepare_ray_dict(torch.from_numpy(rays)))
    _assert_close(got, by_ids, 1e-6)
    # The tables are not read: zeroed, the encoded call does not move.
    model = _port_model(name)
    with torch.no_grad():
        for table in ('warp_embed', 'hyper_embed', 'nerf_embed'):
            if hasattr(model, table):
                getattr(model, table).embed.weight.zero_()
        again = model(port_dict, return_points=branch == 'module',
                      metadata_encoded=True)
    _assert_close(again, got, 0.0)
