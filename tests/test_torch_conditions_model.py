"""The ``use_nerf_embed`` conditions and ``use_viewdirs=False``: the model
(small widths, float32, the CPU) against the JAX model on converted weights
and the same draws: the render on the level kernel's branch and on the
per-module branch, ``query_sigma``, the loss and every gradient and three
Adam steps; the zero-width rgb condition against the JAX model's XLA path
(its kernels refuse that case). Split from ``test_torch_conditions.py``
(its cases, JAX models and tolerances) so that the two files balance
across the suite's workers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.configs import TrainConfig
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
from hypernerf_tpu_torch.convert import params_to_jax
from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
from hypernerf_tpu_torch.training.losses import mse_loss
from hypernerf_tpu_torch.training.optimizers import get_optimizer
from hypernerf_tpu_torch.training.train_state import (TrainState,
                                                      make_train_step)
# one_thread: the autouse fixture of the file the cases come from.
from tests.test_torch_conditions import (TOL, _flax_params, _jax_cfg,  # noqa
                                         _port_cfg, _port_model, one_thread)
from tests.test_torch_modular_model import _assert_outputs_close
from tests.test_torch_train_step import (STEPS_PER_EPOCH, TRAIN,
                                         _assert_trees_close, _batch, _flat,
                                         _jax_draws, _step_keys)


# ---------------------------------------------------------------------------
# The model against the JAX model.


@pytest.mark.parametrize('case,return_points', [
    ('both', False), ('both', True), ('no_viewdirs', False),
    ('split', False), ('static', False)],
    ids=['level_kernel', 'per_module', 'zero_width', 'split', 'static'])
def test_render_matches_jax(case, return_points):
    """The level kernel's branch (its plain version: one call per level;
    with no rgb condition too, where the JAX model leaves its kernels for
    XLA) and the per-module branch (``return_points``, a nerf table of its
    own, the static model) against the JAX model's render."""
    rays, _ = _batch()
    jmodel = JaxNerfModel(_jax_cfg(case))
    want = jax.device_get(jmodel.apply(
        {'params': _flax_params(case)}, jax_ray_dict(jnp.asarray(rays)),
        deterministic=True, return_points=return_points))
    calls = K.fused_level_plain.calls
    with torch.no_grad():
        got = _port_model(case)(prepare_ray_dict(torch.from_numpy(rays)),
                                deterministic=True,
                                return_points=return_points)
    fused = case in ('both', 'no_viewdirs') and not return_points
    assert K.fused_level_plain.calls - calls == (2 if fused else 0)
    _assert_outputs_close(got, want)


@pytest.mark.parametrize('case', ['both', 'split', 'static'])
def test_query_sigma_matches_jax(case):
    """The density takes the id's alpha condition (the shared table, a
    nerf table of its own, the static model); 13 rows no tile divides."""
    rs = np.random.RandomState(4)
    pts = (rs.randn(13, 3) * 0.5).astype(np.float32)
    ids = rs.randint(0, 4, (13, 1)).astype(np.int32)
    jmodel = JaxNerfModel(_jax_cfg(case))
    want = np.asarray(jmodel.apply({'params': _flax_params(case)},
                                   jnp.asarray(pts), jnp.asarray(ids),
                                   method=JaxNerfModel.query_sigma))
    model = _port_model(case)
    with torch.no_grad():
        got = model.query_sigma(torch.from_numpy(pts),
                                torch.from_numpy(ids).long())
        other = model.query_sigma(torch.from_numpy(pts),
                                  torch.from_numpy((ids + 1) % 4).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    if case != 'static':  # the static density moves with the id alone
        assert not torch.allclose(got, other)


def _port_setup(case):
    cfg = _port_cfg(case)
    train_cfg = port_configs.TrainConfig(**TRAIN)
    model = _port_model(case).train()
    optimizer, schedule = get_optimizer(train_cfg, model.parameters(),
                                        STEPS_PER_EPOCH)
    step_fn = make_train_step(model, optimizer, cfg, train_cfg, 'cpu',
                              schedule=schedule, explicit_batch=True)
    return model, TrainState(0, model, optimizer, seed=0), step_fn


@pytest.mark.parametrize('case', ['both', 'no_viewdirs', 'split', 'static'])
def test_loss_and_gradients_match_jax(case):
    """The stochastic forward with the JAX model's own draws: the loss and
    every parameter's gradient; the GLO table's carries the conditions'
    share (or, with tables of their own, each table its own)."""
    rays, rgbs = _batch()
    jmodel = JaxNerfModel(_jax_cfg(case))
    params = _flax_params(case)
    k_sample, k_noise = _step_keys(jax.random.PRNGKey(1), 0)

    def jax_loss(p):
        out = jmodel.apply({'params': p}, jax_ray_dict(jnp.asarray(rays)),
                           rngs={'sampling': k_sample,
                                 'sigma_noise': k_noise})
        return jax_mse_loss(out, jnp.asarray(rgbs))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    draws = _jax_draws(jmodel, params, k_sample, k_noise)
    model, _, _ = _port_setup(case)
    out = model(prepare_ray_dict(torch.from_numpy(rays)),
                deterministic=False, draws=draws)
    loss = mse_loss(out, torch.from_numpy(rgbs))
    assert abs(loss.item() - float(want_loss)) <= TOL
    loss.backward()
    got = params_to_jax({k: p.grad for k, p in model.named_parameters()})
    _assert_trees_close(got, jax.device_get(want_grads), 1e-4, True)
    for k, g in _flat(got):
        assert np.abs(g).max() > 0, k


def test_three_adam_steps_match_jax():
    rays, rgbs = _batch()
    cfg = _jax_cfg('both')
    train_cfg = TrainConfig(**TRAIN)
    jmodel = JaxNerfModel(cfg)
    tx = jax_optimizer(train_cfg, steps_per_epoch=STEPS_PER_EPOCH)
    params = jax.tree.map(jnp.asarray, _flax_params('both'))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params))
    jstep = jax_make_train_step(jmodel, tx, cfg, train_cfg,
                                create_mesh(num_devices=1),
                                explicit_batch=True)
    base_rng = jax.random.PRNGKey(1)
    model, state, step_fn = _port_setup('both')
    t_rays, t_rgbs = torch.from_numpy(rays), torch.from_numpy(rgbs)
    for step in range(3):
        draws = _jax_draws(jmodel, jax.device_get(jstate.params),
                           *_step_keys(base_rng, step))
        jstate, jmetrics = jstep(jstate, jnp.asarray(rays),
                                 jnp.asarray(rgbs), base_rng)
        metrics = step_fn(state, t_rays, t_rgbs, draws=draws)
        assert state.step == step + 1 == int(jstate.step)
        assert abs(metrics['loss'].item() - float(jmetrics['loss'])) <= TOL
        _assert_trees_close(params_to_jax(model.state_dict()),
                            jax.device_get(jstate.params), 1e-5, False)
