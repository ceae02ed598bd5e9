"""The SE(3) and quaternion train step: the port's loss, gradients and three
Adam steps against the JAX train step on the same converted weights, the same
explicit batch and the JAX step's own draws, at float32 with the JAX kernels
in interpret mode — on the level path, on the per-module path
(``use_pallas_level=False``) and with separate GLO tables. The models and
their weights are those of ``test_torch_se3_model.py``.

Tolerances (those of ``test_torch_train_step.py``): loss 1e-5; every
parameter's gradient 1e-4 of its largest entry; every parameter after three
Adam steps with a ``steplr`` boundary inside them 1e-5.
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
from hypernerf_tpu_torch.convert import params_to_jax
from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
from hypernerf_tpu_torch.training.losses import mse_loss
from hypernerf_tpu_torch.training.optimizers import get_optimizer
from hypernerf_tpu_torch.training.train_state import (TrainState,
                                                      make_train_step)
from tests.test_torch_se3_model import (_flax_params, _jax_cfg, _port_cfg,
                                        _port_model)
from tests.test_torch_train_step import (STEPS_PER_EPOCH, TRAIN,
                                         _assert_trees_close, _batch, _flat,
                                         _jax_draws, _step_keys)


def _port_setup(kind, path):
    cfg = _port_cfg(kind, path)
    train_cfg = port_configs.TrainConfig(**TRAIN)
    model = _port_model(kind, path).train()
    optimizer, schedule = get_optimizer(train_cfg, model.parameters(),
                                        STEPS_PER_EPOCH)
    step_fn = make_train_step(model, optimizer, cfg, train_cfg, 'cpu',
                              schedule=schedule, explicit_batch=True)
    return model, TrainState(0, model, optimizer, seed=0), step_fn


@pytest.mark.parametrize('kind,path', [
    ('se3', 'level'), ('se3', 'modules'), ('se3', 'split_glo'),
    ('quaternion', 'level'), ('quaternion', 'split_glo')])
def test_loss_and_gradients_match_jax(kind, path):
    rays, rgbs = _batch()
    jmodel = JaxNerfModel(_jax_cfg(kind, path))
    params = _flax_params(kind, path)
    k_sample, k_noise = _step_keys(jax.random.PRNGKey(1), 0)

    def jax_loss(p):
        out = jmodel.apply({'params': p}, jax_ray_dict(jnp.asarray(rays)),
                           rngs={'sampling': k_sample,
                                 'sigma_noise': k_noise})
        return jax_mse_loss(out, jnp.asarray(rgbs))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    draws = _jax_draws(jmodel, params, k_sample, k_noise)

    model, _, _ = _port_setup(kind, path)
    out = model(prepare_ray_dict(torch.from_numpy(rays)),
                deterministic=False, draws=draws)
    loss = mse_loss(out, torch.from_numpy(rgbs))
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    loss.backward()
    got = params_to_jax({k: p.grad for k, p in model.named_parameters()})
    _assert_trees_close(got, jax.device_get(want_grads), 1e-4, True)
    names = [k for k, g in _flat(got)]
    assert 'warp_field/w_net/logit/kernel' in names
    assert ('hyper_embed/embed/embedding' in names) == (path == 'split_glo')
    for k, g in _flat(got):
        assert np.abs(g).max() > 0, k


@pytest.mark.parametrize('kind,path', [('se3', 'level'), ('se3', 'split_glo'),
                                       ('quaternion', 'level')])
def test_three_adam_steps_match_jax(kind, path):
    rays, rgbs = _batch()
    cfg = _jax_cfg(kind, path)
    train_cfg = TrainConfig(**TRAIN)
    jmodel = JaxNerfModel(cfg)
    tx = jax_optimizer(train_cfg, steps_per_epoch=STEPS_PER_EPOCH)
    params = jax.tree.map(jnp.asarray, _flax_params(kind, path))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params))
    jstep = jax_make_train_step(jmodel, tx, cfg, train_cfg,
                                create_mesh(num_devices=1),
                                explicit_batch=True)
    base_rng = jax.random.PRNGKey(1)
    model, state, step_fn = _port_setup(kind, path)
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
