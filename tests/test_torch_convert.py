"""A JAX checkpoint carried into the port: saved by hypernerf_tpu, converted
by tools/jax_ckpt_to_torch.py, rendered through both packages (1e-5 at
float32)."""

import dataclasses
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.configs import NerfConfig
from hypernerf_tpu.models.nerf import NerfModel as JaxNerfModel
from hypernerf_tpu.ops.ray_dict import prepare_ray_dict as jax_ray_dict
from hypernerf_tpu.training import checkpoints as jax_ckpt
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.training import checkpoints
from hypernerf_tpu_torch.training.renderer import render_rays

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'tools'))
import jax_ckpt_to_torch  # noqa: E402

CFG = NerfConfig(num_embeddings=3, glo_dim=4, num_coarse_samples=6,
                 num_fine_samples=5, warp_depth=2, warp_width=8, warp_freq=3,
                 hyper_sheet_depth=2, hyper_sheet_width=8, hyper_sheet_freq=2,
                 xyz_freq=3, hyper_freq=2, dir_freq=2, trunk_depth=2,
                 trunk_width=16, rgb_branch_depth=1, rgb_branch_width=8,
                 skips=(0,), noise_std=None, compute_dtype='float32')


def test_jax_checkpoint_converts_and_renders_the_same(tmp_path):
    rs = np.random.RandomState(0)
    d = rs.randn(7, 3).astype(np.float32)
    rays = np.concatenate([(rs.randn(7, 3) * 0.1).astype(np.float32), d,
                           np.full((7, 1), 0.5, np.float32),
                           np.full((7, 1), 3.0, np.float32),
                           rs.randint(0, 3, (7, 1)).astype(np.float32)], 1)
    model = JaxNerfModel(CFG)
    params = jax.jit(model.init)({'params': jax.random.PRNGKey(1)},
                                 jax_ray_dict(jnp.asarray(rays)))['params']
    state = types.SimpleNamespace(params=params,
                                  opt_state={'count': np.zeros((), np.int32)})
    ckpt = jax_ckpt.save_checkpoint(str(tmp_path / 'ckpts'), 3, state,
                                    nerf_config=CFG)
    want = jax.device_get(jax.jit(lambda p, r: model.apply(
        {'params': p}, r, deterministic=True))(
            params, jax_ray_dict(jnp.asarray(rays))))

    out = jax_ckpt_to_torch.convert(ckpt, str(tmp_path / 'w' / 'model.pt'))
    # The port reads the JAX package's nerf_config.json into its own copy
    # of NerfConfig: another class, the same fields.
    assert dataclasses.asdict(checkpoints.load_config(out)) == \
        dataclasses.asdict(CFG)
    port = NerfModel(checkpoints.load_config(out))
    checkpoints.load_weights(port, out)
    got = render_rays(port, rays, chunk=4)
    for level in ('coarse', 'fine'):
        for k in ('rgb', 'depth', 'med_depth', 'acc'):
            np.testing.assert_allclose(got[level][k], want[level][k], rtol=0,
                                       atol=1e-5, err_msg=f'{level}/{k}')
    assert torch.load(out, weights_only=True).keys() == \
        port.state_dict().keys()


@pytest.mark.parametrize('warp', ['translation', 'se3', 'quaternion'])
def test_params_to_jax_inverts_params_from_jax(warp):
    """The flax tree of a JAX init, carried to a state dict and back, is the
    same tree with the same arrays (Dense kernels transposed twice); the
    state dict's keys are the port model's own (for the SE(3) family the
    ``trunk`` / ``w_net`` / ``v_net`` paths)."""
    from hypernerf_tpu_torch.convert import params_from_jax, params_to_jax
    cfg = dataclasses.replace(CFG, warp_field_type=warp, warp_max_deg=4)
    rays = jax_ray_dict(jnp.zeros((2, 9), jnp.float32))
    params = jax.device_get(JaxNerfModel(cfg).init(
        {'params': jax.random.PRNGKey(2)}, rays)['params'])
    port_cfg = checkpoints.NerfConfig(**dataclasses.asdict(cfg))
    assert params_from_jax(params).keys() == \
        NerfModel(port_cfg).state_dict().keys()
    if warp != 'translation':
        assert 'warp_field.w_net.logit.weight' in params_from_jax(params)
    back = params_to_jax(params_from_jax(params))
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat.keys() == flat_back.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(flat_back[k], v, err_msg=str(k))
