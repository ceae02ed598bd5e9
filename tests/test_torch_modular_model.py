"""The per-module path as a whole: the port's NerfModel where the level
kernel's gate fails — a static NeRF (no warp, no hyper coordinates), separate
GLO tables (``share_glo=False``), the sheet's residual, ``return_points``, a
``hyper_point`` override, ``use_warp=False`` at call time, ``render_opts`` —
and ``query_sigma``, against the JAX NerfModel on the same converted weights
and rays, at float32 with the JAX field and template kernels in interpret
mode; then the loss, the gradients and three Adam steps against the JAX train
step with its own draws (recomputed from its keys and handed to the port).

Tolerances (fp32 both ways, other summation orders): per-ray and per-sample
outputs 1e-5 absolute; loss 1e-5; every parameter's gradient 1e-4 of its
largest entry; every parameter after three Adam steps 1e-5 (the reasons are
those of ``test_torch_train_step.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.configs import NerfConfig, TrainConfig
from hypernerf_tpu.models.nerf import NerfModel as JaxNerfModel
from hypernerf_tpu.ops.ray_dict import prepare_ray_dict as jax_ray_dict
from hypernerf_tpu.parallel.mesh import create_mesh
from hypernerf_tpu.training.losses import mse_loss as jax_mse_loss
from hypernerf_tpu.training.optimizers import get_optimizer as jax_optimizer
from hypernerf_tpu.training.train_state import TrainState as JaxTrainState
from hypernerf_tpu.training.train_state import \
    make_train_step as jax_make_train_step
from hypernerf_tpu_torch import configs as port_configs
from hypernerf_tpu_torch import kernels as K
from hypernerf_tpu_torch.convert import params_from_jax, params_to_jax
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
from hypernerf_tpu_torch.training.losses import mse_loss
from hypernerf_tpu_torch.training.optimizers import get_optimizer
from hypernerf_tpu_torch.training.train_state import (TrainState,
                                                      make_train_step)
from tests.test_torch_train_step import (ARCH, STEPS_PER_EPOCH, TRAIN,
                                         _assert_trees_close, _batch, _flat,
                                         _jax_draws, _step_keys)

# name -> what it changes of the small flagship (``ARCH``). All but
# ``flagship`` fail the level kernel's gate and run module by module.
CONFIGS = {
    'flagship': {},
    'static': dict(use_warp=False, hyper_slice_method='none'),
    'split_glo': dict(share_glo=False),
    'residual': dict(hyper_sheet_use_residual=True, hyper_slice_out_dim=8),
    'no_slicing': dict(hyper_slice_method='none'),
}
MODULAR = ['static', 'split_glo']
TOL = 1e-5
RENDER_OPTS = {'dust_threshold': 0.6,
               'bounding_box': (-0.6, 0.6, -0.6, 0.6, -0.6, 0.6)}


def _jax_cfg(config):
    # The JAX level kernel leaves the sheet's residual out (its gate does not
    # look at ``hyper_sheet_use_residual``); the JAX modules add it, as the
    # port does, so that configuration is held to the JAX per-module kernels.
    return NerfConfig(use_pallas=True, use_pallas_fields=True,
                      use_pallas_level=config != 'residual',
                      pallas_interpret=True,
                      pallas_tile=8, pallas_bwd_tile=8,
                      **{**ARCH, **CONFIGS[config]})


def _port_cfg(config):
    return port_configs.NerfConfig(**{**ARCH, **CONFIGS[config]})


@functools.cache
def _flax_params(config):
    """flax init of ``config`` with the warp and sheet heads scaled up so
    that the two fields move the output and carry gradient."""
    model = JaxNerfModel(NerfConfig(use_pallas=False,
                                    **{**ARCH, **CONFIGS[config]}))
    params = jax.device_get(jax.jit(model.init)(
        {'params': jax.random.PRNGKey(0)},
        jax_ray_dict(jnp.asarray(_batch()[0])))['params'])
    params = jax.tree.map(np.array, params)
    if 'warp_field' in params:
        params['warp_field']['mlp']['logit']['kernel'] *= 300.0
    if 'hyper_sheet_mlp' in params:
        params['hyper_sheet_mlp']['mlp']['logit']['kernel'] *= 1e4
    return params


def _port_model(config):
    model = NerfModel(_port_cfg(config))
    model.load_state_dict(params_from_jax(_flax_params(config)))
    return model


def _hyper_point(n, width, seed=5):
    return (np.random.RandomState(seed).randn(n, width) * 0.3).astype(
        np.float32)


def _ray_dicts(rays, hyper_point=None):
    """The same rays for both models, with an optional 'hyper_point'."""
    jd = jax_ray_dict(jnp.asarray(rays))
    td = prepare_ray_dict(torch.from_numpy(rays))
    if hyper_point is not None:
        jd['metadata'] = {**jd['metadata'],
                          'hyper_point': jnp.asarray(hyper_point)}
        td['metadata'] = {**td['metadata'],
                          'hyper_point': torch.from_numpy(hyper_point)}
    return jd, td


def _assert_outputs_close(got, want, tol=TOL):
    assert sorted(got) == sorted(want)
    for level in want:
        assert sorted(got[level]) == sorted(want[level]), level
        for k, v in want[level].items():
            a = got[level][k].detach().numpy()
            assert a.shape == np.shape(v), (level, k, a.shape, np.shape(v))
            np.testing.assert_allclose(a, v, rtol=0, atol=tol,
                                       err_msg=f'{level}/{k}')


def _render_both(config, hyper_point=None, **kw):
    rays, _ = _batch()
    jd, td = _ray_dicts(rays, hyper_point)
    jmodel = JaxNerfModel(_jax_cfg(config))
    want = jax.device_get(jmodel.apply({'params': _flax_params(config)}, jd,
                                       deterministic=True, **kw))
    with torch.no_grad():
        got = _port_model(config)(td, deterministic=True, **kw)
    return got, want


@pytest.mark.parametrize('config', ['static', 'split_glo', 'residual',
                                    'no_slicing'])
def test_deterministic_render_matches_jax(config):
    got, want = _render_both(config)
    assert sorted(want) == ['coarse', 'fine']
    _assert_outputs_close(got, want)


@pytest.mark.parametrize('config', MODULAR)
def test_stochastic_forward_matches_jax(config):
    """Stratified jitter, the ascending fine u through ``sample_pdf`` and the
    sigma noise of both levels, all with the JAX model's own draws."""
    rays, _ = _batch()
    jd, td = _ray_dicts(rays)
    jmodel = JaxNerfModel(_jax_cfg(config))
    params = _flax_params(config)
    k_sample, k_noise = _step_keys(jax.random.PRNGKey(2), 0)
    want = jax.device_get(jmodel.apply(
        {'params': params}, jd,
        rngs={'sampling': k_sample, 'sigma_noise': k_noise}))
    draws = _jax_draws(jmodel, params, k_sample, k_noise)
    with torch.no_grad():
        got = _port_model(config)(td, deterministic=False, draws=draws)
    _assert_outputs_close(got, want)


@pytest.mark.parametrize('config', ['static', 'split_glo', 'flagship'])
def test_return_points_matches_jax(config):
    """'points', 'warped_points' (with the hyper coordinates) and
    'med_points'; on the flagship the request alone leaves the level
    kernel's branch."""
    got, want = _render_both(config, return_points=True)
    width = 3 if config == 'static' else 3 + ARCH.get('hyper_slice_out_dim',
                                                      4)
    for level, s in (('coarse', 8), ('fine', 16)):
        assert got[level]['points'].shape == (8, s, 3)
        assert got[level]['warped_points'].shape == (8, s, width)
        assert got[level]['med_points'].shape == (8, 1, width)
    _assert_outputs_close(got, want)


@pytest.mark.parametrize('config', ['split_glo', 'flagship'])
def test_hyper_point_override_matches_jax(config):
    hyper_point = _hyper_point(8, 4)
    got, want = _render_both(config, hyper_point=hyper_point,
                             return_points=True)
    _assert_outputs_close(got, want)
    np.testing.assert_array_equal(
        got['fine']['warped_points'][:, 3, 3:].numpy(), hyper_point)
    plain, _ = _render_both(config)
    assert np.abs(got['fine']['rgb'].numpy()
                  - plain['fine']['rgb'].numpy()).max() > 1e-3


def test_use_warp_false_at_call_time_matches_jax():
    """A warped model without hyper coordinates renders its template on the
    bare points when the call says so."""
    got, want = _render_both('no_slicing', use_warp=False,
                             return_points=True)
    _assert_outputs_close(got, want)
    np.testing.assert_array_equal(got['fine']['warped_points'].numpy(),
                                  got['fine']['points'].numpy())


@pytest.mark.parametrize('config', ['static', 'split_glo', 'flagship'])
def test_render_opts_match_jax(config):
    """``filter_sigma`` on the fine level; the fine depths then come from
    ``sample_pdf`` on every branch."""
    got, want = _render_both(config, render_opts=RENDER_OPTS)
    _assert_outputs_close(got, want)
    plain, _ = _render_both(config)
    assert np.abs(got['fine']['acc'].numpy()
                  - plain['fine']['acc'].numpy()).max() > 1e-3
    np.testing.assert_allclose(got['coarse']['rgb'].numpy(),
                               plain['coarse']['rgb'].numpy(), atol=1e-6)


@pytest.mark.parametrize('config', ['static', 'split_glo', 'flagship',
                                    'residual'])
def test_query_sigma_matches_jax(config):
    """One sample per row and a row count (13) no tile divides."""
    rs = np.random.RandomState(4)
    pts = (rs.randn(13, 3) * 0.5).astype(np.float32)
    ids = rs.randint(0, 4, (13, 1)).astype(np.int32)
    jmodel = JaxNerfModel(_jax_cfg(config))
    want = np.asarray(jmodel.apply({'params': _flax_params(config)},
                                   jnp.asarray(pts), jnp.asarray(ids),
                                   method=JaxNerfModel.query_sigma))
    with torch.no_grad():
        got = _port_model(config).query_sigma(
            torch.from_numpy(pts), torch.from_numpy(ids).long())
    assert got.shape == (13,) and (got >= 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def _port_setup(config):
    cfg = _port_cfg(config)
    train_cfg = port_configs.TrainConfig(**TRAIN)
    model = _port_model(config).train()
    optimizer, schedule = get_optimizer(train_cfg, model.parameters(),
                                        STEPS_PER_EPOCH)
    step_fn = make_train_step(model, optimizer, cfg, train_cfg, 'cpu',
                              schedule=schedule, explicit_batch=True)
    return model, TrainState(0, model, optimizer, seed=0), step_fn


@pytest.mark.parametrize('config', MODULAR)
def test_loss_and_gradients_match_jax(config):
    rays, rgbs = _batch()
    jmodel = JaxNerfModel(_jax_cfg(config))
    params = _flax_params(config)
    k_sample, k_noise = _step_keys(jax.random.PRNGKey(1), 0)

    def jax_loss(p):
        out = jmodel.apply({'params': p}, jax_ray_dict(jnp.asarray(rays)),
                           rngs={'sampling': k_sample,
                                 'sigma_noise': k_noise})
        return jax_mse_loss(out, jnp.asarray(rgbs))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    draws = _jax_draws(jmodel, params, k_sample, k_noise)

    model, _, _ = _port_setup(config)
    out = model(prepare_ray_dict(torch.from_numpy(rays)),
                deterministic=False, draws=draws)
    loss = mse_loss(out, torch.from_numpy(rgbs))
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    loss.backward()
    got = params_to_jax({k: p.grad for k, p in model.named_parameters()})
    _assert_trees_close(got, jax.device_get(want_grads), 1e-4, True)
    names = [k for k, g in _flat(got)]
    assert ('hyper_embed/embed/embedding' in names) == (config == 'split_glo')
    for k, g in _flat(got):  # both GLO tables included
        assert np.abs(g).max() > 0, k


@pytest.mark.parametrize('config', MODULAR)
def test_three_adam_steps_match_jax(config):
    rays, rgbs = _batch()
    cfg = _jax_cfg(config)
    train_cfg = TrainConfig(**TRAIN)
    jmodel = JaxNerfModel(cfg)
    tx = jax_optimizer(train_cfg, steps_per_epoch=STEPS_PER_EPOCH)
    params = jax.tree.map(jnp.asarray, _flax_params(config))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params))
    jstep = jax_make_train_step(jmodel, tx, cfg, train_cfg,
                                create_mesh(num_devices=1),
                                explicit_batch=True)
    base_rng = jax.random.PRNGKey(1)
    model, state, step_fn = _port_setup(config)
    t_rays, t_rgbs = torch.from_numpy(rays), torch.from_numpy(rgbs)
    for step in range(3):
        draws = _jax_draws(jmodel, jax.device_get(jstate.params),
                           *_step_keys(base_rng, step))
        jstate, jmetrics = jstep(jstate, jnp.asarray(rays),
                                 jnp.asarray(rgbs), base_rng)
        metrics = step_fn(state, t_rays, t_rgbs, draws=draws)
        assert state.step == step + 1 == int(jstate.step)
        assert abs(metrics['loss'].item() - float(jmetrics['loss'])) <= 1e-5
        _assert_trees_close(params_to_jax(model.state_dict()),
                            jax.device_get(jstate.params), 1e-5, False)


def test_level_kernel_branch_is_taken_exactly_where_the_gate_holds():
    """A shared-GLO flagship call goes through ``fused_level`` and
    ``fused_composite`` (on CPU tensors: one plain call per level each); the
    same model asked for points, or given a hyper point, does not; neither
    do the static and split-GLO models."""
    rays, _ = _batch()
    counters = (K.fused_level_plain, K.fused_composite_plain)

    def calls(config, hyper_point=None, **kw):
        _, td = _ray_dicts(rays, hyper_point)
        before = [fn.calls for fn in counters]
        with torch.no_grad():
            _port_model(config)(td, **kw)
        return tuple(fn.calls - b for fn, b in zip(counters, before))

    assert calls('flagship') == (2, 2)
    assert calls('flagship', return_points=True) == (0, 0)
    assert calls('flagship', hyper_point=_hyper_point(8, 4)) == (0, 0)
    # Filtering keeps the level kernel and composites the fine level in
    # tensor code.
    assert calls('flagship', render_opts=RENDER_OPTS) == (2, 1)
    for config in ('static', 'split_glo', 'residual'):
        assert calls(config) == (0, 0), config


def test_model_builds_what_the_configuration_names():
    """The static tree has no warp field, sheet or GLO table; separate GLO
    tables add ``hyper_embed``; what is still unported raises, naming its
    ROADMAP item."""
    static = NerfModel(_port_cfg('static'))
    names = {k.split('.')[0] for k in static.state_dict()}
    assert names == {'nerf_coarse', 'nerf_fine'}
    assert static.nerf_coarse.trunk.hidden_0.in_features == 3 * (1 + 2 * 4)
    split = NerfModel(_port_cfg('split_glo'))
    assert {k.split('.')[0] for k in split.state_dict()} == {
        'warp_embed', 'hyper_embed', 'warp_field', 'hyper_sheet_mlp',
        'nerf_coarse', 'nerf_fine'}
    assert sorted(params_from_jax(_flax_params('split_glo'))) == sorted(
        split.state_dict())
    assert sorted(params_from_jax(_flax_params('static'))) == sorted(
        static.state_dict())
    with pytest.raises(ValueError, match='no hyper embedding'):
        static.encode_hyper_embed({})
    for override, item in ((dict(hyper_slice_method='axis_aligned_plane',
                                 warp_field_type='se3', rgb_channels=4),
                            'B.3'),
                           (dict(use_viewdirs=False, alpha_channels=2),
                            'B.3'),
                           (dict(rgb_channels=4), 'B.3')):
        with pytest.raises(NotImplementedError, match=item):
            NerfModel(port_configs.NerfConfig(**{**ARCH, **override}))


@pytest.mark.parametrize('channels', [3, 9])
def test_template_refuses_points_of_another_width(channels):
    """A template with hyper weights takes [xyz | hyper] points of its own
    width alone: ``use_warp=False`` at call time on the flagship (3 channels)
    and a ``hyper_point`` wider than the sheet's output are refused, not
    padded or cropped, on either device."""
    model = _port_model('flagship')
    rays = _batch()[0]
    with torch.no_grad(), pytest.raises(ValueError, match='channels'):
        if channels == 3:
            model(_ray_dicts(rays)[1], use_warp=False)
        else:
            model(_ray_dicts(rays, _hyper_point(len(rays), 6))[1])
