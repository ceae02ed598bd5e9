"""The warp x slicing x encoding combinations (ROADMAP B.4: the SE(3) and the
quaternion warp with the Nerfies encoding and with plane slicing, and the
plane with the Nerfies encoding) as models, against the JAX model, on the
CPU.

- the render of all seven on the level kernel's branch (on CPU tensors its
  plain version) against the JAX model on its level kernel in interpret
  mode; of the paper's two models, ``anneal_se3`` (the deformable sheet)
  and ``plane_anneal_se3`` (the axis-aligned plane), also against the dense
  JAX model (``use_pallas=False``) and module by module (``return_points``);
- one train step's loss and every gradient of those two, with the JAX
  step's draws passed in, against both JAX models, with the three windows
  (``warp_alpha``, ``nerf_alpha``, ``hyper_alpha``) partly on together;
- ``query_sigma`` and ``share_glo=False`` of ``plane_anneal_se3``;
- the fused JAX model against the dense one on the same numbers, which is
  how a disagreement between the two would show (none is known: ROADMAP D).

Small widths in float32 (``test_torch_train_step.ARCH``, the anneal tests'
degrees, an SE(3) trunk over degrees 0..4); tolerances as
``test_torch_modular_model.py``: outputs and loss 1e-5, gradients 1e-4 of
each parameter's largest entry.
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
from hypernerf_tpu.training.losses import mse_loss as jax_mse_loss
from hypernerf_tpu_torch import configs as port_configs
from hypernerf_tpu_torch import kernels as K
from hypernerf_tpu_torch.convert import params_from_jax, params_to_jax
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
from hypernerf_tpu_torch.training.losses import mse_loss
from tests.test_torch_modular_model import _assert_outputs_close
from tests.test_torch_train_step import (ARCH, _assert_trees_close, _batch,
                                         _flat, _jax_draws, _step_keys)

TOL = 1e-5
# The small anneal degrees (test_torch_anneal.ANNEAL) and an SE(3) trunk
# over degrees 0..4 (test_torch_se3_model).
NERFIES = dict(use_original_embed=False, spatial_point_max_deg=4,
               hyper_point_max_deg=2, viewdir_max_deg=2)
PLANE = dict(hyper_slice_method='axis_aligned_plane')
SE3 = dict(warp_field_type='se3', warp_min_deg=0, warp_max_deg=4)
QUAT = dict(SE3, warp_field_type='quaternion')
COMBOS = {'anneal_se3': dict(SE3, **NERFIES),
          'anneal_quaternion': dict(QUAT, **NERFIES),
          'plane_se3': dict(SE3, **PLANE),
          'plane_quaternion': dict(QUAT, **PLANE),
          'plane_anneal': dict(PLANE, **NERFIES),
          'plane_anneal_se3': dict(SE3, **PLANE, **NERFIES),
          'plane_anneal_quaternion': dict(QUAT, **PLANE, **NERFIES)}
PAPER = ('anneal_se3', 'plane_anneal_se3')
# Every window partly on: the trunk's 1.4 of 4 bands, the hyper
# coordinates' 1.4 of 2, the xyz's 3.3 of 4.
EXTRA = {'nerf_alpha': 3.3, 'warp_alpha': 1.4, 'hyper_alpha': 1.4,
         'hyper_sheet_alpha': 1.4}


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """Small products: one thread keeps the file's time on a loaded worker
    (torch starts a thread per core)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _extra(name):
    """(the JAX model's alphas, the port's) of combination ``name``: the
    trunk's window with a screw warp, the template's with the Nerfies
    encoding."""
    over = COMBOS[name]
    keys = {k: EXTRA[k] for k in EXTRA
            if ('warp_field_type' in over if k == 'warp_alpha'
                else 'use_original_embed' in over)}
    return {k: jnp.float32(v) for k, v in keys.items()}, keys


def _jax_cfg(name, fused=True, **kw):
    """The JAX model of ``name``: on its level kernel in interpret mode, or
    dense (``fused=False``)."""
    arch = {**ARCH, **COMBOS[name], **kw}
    if not fused:
        return NerfConfig(use_pallas=False, **arch)
    return NerfConfig(use_pallas=True, use_pallas_fields=True,
                      use_pallas_level=True, pallas_interpret=True,
                      pallas_tile=8, pallas_bwd_tile=8, **arch)


@functools.cache
def _flax_params(name, split=False):
    """The flax tree of ``name`` (``split``: with its own hyper table) from
    the port's seeded init (no JAX init to compile), with the warp's and the
    sheet's heads scaled up so that the warp and the sheet move the output
    and carry gradient."""
    torch.manual_seed(0)
    model = NerfModel(port_configs.NerfConfig(**ARCH, **COMBOS[name],
                                              share_glo=not split))
    params = jax.tree.map(np.array, params_to_jax(model.state_dict()))
    warp = params['warp_field']
    if 'w_net' in warp:
        for head in ('w_net', 'v_net'):
            warp[head]['logit']['kernel'] *= 1e3
    else:
        warp['mlp']['logit']['kernel'] *= 300.0
    if 'hyper_sheet_mlp' in params:
        params['hyper_sheet_mlp']['mlp']['logit']['kernel'] *= 1e4
    return params


def _port_model(name, split=False):
    model = NerfModel(port_configs.NerfConfig(**ARCH, **COMBOS[name],
                                              share_glo=not split))
    model.load_state_dict(params_from_jax(_flax_params(name, split)))
    return model


@functools.cache
def _jax_render(name, fused=True, split=False, return_points=False):
    """The JAX model's deterministic render, jitted (eager dispatch of the
    interpret-mode kernels costs several times the compile)."""
    jextra, _ = _extra(name)
    jmodel = JaxNerfModel(_jax_cfg(name, fused, share_glo=not split))
    render = jax.jit(lambda p, r, e: jmodel.apply(
        {'params': p}, r, e, deterministic=True,
        return_points=return_points))
    return jax.device_get(render(_flax_params(name, split),
                                 jax_ray_dict(jnp.asarray(_batch()[0])),
                                 jextra))


def _port_render(name, split=False, return_points=False):
    _, extra = _extra(name)
    with torch.no_grad():
        return _port_model(name, split)(
            prepare_ray_dict(torch.from_numpy(_batch()[0])),
            deterministic=True, extra_params=extra,
            return_points=return_points)


@pytest.mark.parametrize('name', sorted(COMBOS))
def test_model_builds_what_the_configuration_names(name):
    """No sheet with the plane (the template holds the 8 GLO coordinates),
    the trunk and its two heads with the screw warps, the template's
    encoding widths of the layout; the JAX model's flax tree has the port's
    keys and shapes (``jax.eval_shape`` of its init)."""
    model = _port_model(name)
    over = COMBOS[name]
    plane = 'hyper_slice_method' in over
    screw = 'warp_field_type' in over
    hyper = 8 if plane else 4
    if 'use_original_embed' in over:  # xyz 0..4 with identity, hyper 0..2
        enc = 3 * 9 + hyper * 4
    else:  # posenc_orig: xyz at 4 bands, hyper at 2
        enc = 3 * 9 + hyper * 5
    assert model.nerf_coarse.trunk.hidden_0.in_features == enc
    assert (model.level('fine').hyper is None) == plane
    assert hasattr(model.warp_field, 'trunk') == screw
    shapes = jax.eval_shape(JaxNerfModel(_jax_cfg(name, False)).init,
                            {'params': jax.random.PRNGKey(0)},
                            jax_ray_dict(jnp.asarray(_batch()[0])))['params']
    zeros = params_from_jax(jax.tree.map(
        lambda a: np.zeros(a.shape, np.float32), shapes))
    state = model.state_dict()
    assert sorted(zeros) == sorted(state)
    for k, v in zeros.items():
        assert tuple(state[k].shape) == tuple(v.shape), k


@pytest.mark.parametrize('name', sorted(COMBOS))
def test_render_matches_the_jax_level_kernel(name):
    """The level kernel's branch (one level call per level: on CPU tensors
    its plain version) against the JAX model on its level kernel."""
    calls = K.fused_level_plain.calls
    got = _port_render(name)
    assert K.fused_level_plain.calls - calls == 2
    _assert_outputs_close(got, _jax_render(name))


@pytest.mark.parametrize('name', PAPER)
def test_render_matches_the_dense_jax_model(name):
    """The paper's two models against the dense JAX model too, and the two
    JAX models against each other."""
    want = _jax_render(name, fused=False)
    _assert_outputs_close(_port_render(name), want)
    fused = _jax_render(name)
    for level in want:
        for k in ('rgb', 'depth', 'acc'):
            np.testing.assert_allclose(fused[level][k], want[level][k],
                                       rtol=0, atol=TOL)


@pytest.mark.parametrize('name', PAPER)
def test_per_module_render_matches_jax(name):
    """Asked for points, both models run module by module: the SE(3) field
    (its trunk, then the retraction), the sheet or the embedding broadcast
    as the hyper coordinates, the template on its windowed encoding."""
    calls = K.fused_level_plain.calls
    got = _port_render(name, return_points=True)
    assert K.fused_level_plain.calls == calls
    _assert_outputs_close(got, _jax_render(name, return_points=True))
    hyper = 8 if name.startswith('plane') else 4
    assert got['fine']['warped_points'].shape == (8, 16, 3 + hyper)


def test_split_glo_and_query_sigma_match_jax():
    """``plane_anneal_se3`` with a hyper table of its own (the per-module
    branch, as in JAX) and ``query_sigma`` (one sample per row, 13 rows),
    against the dense JAX model (JAX runs both module by module too)."""
    name = 'plane_anneal_se3'
    got = _port_render(name, split=True)
    _assert_outputs_close(got, _jax_render(name, fused=False, split=True))
    rs = np.random.RandomState(4)
    pts = (rs.randn(13, 3) * 0.5).astype(np.float32)
    ids = rs.randint(0, 4, (13, 1)).astype(np.int32)
    jextra, extra = _extra(name)
    want = np.asarray(JaxNerfModel(_jax_cfg(name, False)).apply(
        {'params': _flax_params(name)}, jnp.asarray(pts), jnp.asarray(ids),
        jextra, method=JaxNerfModel.query_sigma))
    with torch.no_grad():
        sigma = _port_model(name).query_sigma(
            torch.from_numpy(pts), torch.from_numpy(ids).long(), extra)
    assert sigma.shape == (13,) and (sigma >= 0).all()
    np.testing.assert_allclose(sigma.numpy(), want, rtol=0, atol=TOL)


@functools.cache
def _jax_loss_and_grads(name, fused):
    rays, rgbs = _batch()
    jextra, _ = _extra(name)
    jmodel = JaxNerfModel(_jax_cfg(name, fused))
    k_sample, k_noise = _step_keys(jax.random.PRNGKey(1), 0)

    def loss(p):
        out = jmodel.apply({'params': p}, jax_ray_dict(jnp.asarray(rays)),
                           jextra, rngs={'sampling': k_sample,
                                         'sigma_noise': k_noise})
        return jax_mse_loss(out, jnp.asarray(rgbs))

    value, grads = jax.jit(jax.value_and_grad(loss))(_flax_params(name))
    draws = _jax_draws(jmodel, _flax_params(name), k_sample, k_noise)
    return float(value), jax.device_get(grads), draws


@pytest.mark.parametrize('fused', [True, False], ids=['level_kernel',
                                                      'dense'])
@pytest.mark.parametrize('name', PAPER)
def test_loss_and_gradients_match_jax(name, fused):
    """The stochastic forward with the JAX step's draws and every window
    partly on: the loss and every parameter's gradient (the trunk's, the
    sheet's, the template's, the GLO table's), each non-zero."""
    rays, rgbs = _batch()
    want_loss, want_grads, draws = _jax_loss_and_grads(name, fused)
    _, extra = _extra(name)
    model = _port_model(name).train()
    out = model(prepare_ray_dict(torch.from_numpy(rays)),
                deterministic=False, draws=draws, extra_params=extra)
    loss = mse_loss(out, torch.from_numpy(rgbs))
    assert abs(loss.item() - want_loss) <= TOL
    loss.backward()
    got = params_to_jax({k: p.grad for k, p in model.named_parameters()})
    _assert_trees_close(got, want_grads, 1e-4, True)
    for k, g in _flat(got):
        assert np.abs(g).max() > 0, k
