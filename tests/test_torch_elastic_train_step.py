"""The train step with the elastic and background regularizers: the port's
loss, every gradient and three Adam steps against the JAX train step on the
same converted weights, the same explicit batch and the JAX step's own draws,
at float32 with the JAX kernels in interpret mode.

Cases here: the translation warp on the level path with the Jacobian at
every sample (K = 0) and subsampled (K = 4 per ray, the JAX draw's uniforms
handed to the port), and on the per-module path (two GLO tables: the
Jacobian at every sample); the background term on known-static points. The
SE(3) and quaternion warps are in ``test_torch_elastic_se3_train_step.py``,
with these helpers. The JAX subsample's uniforms are recomputed from its
keys; a wrapper around the JAX draw (``monkeypatch``) checks that they are
the ones it drew.

Tolerances (those of ``test_torch_train_step.py``): loss 1e-5; every
parameter's gradient 1e-4 of its largest entry; every parameter after three
Adam steps 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.configs import NerfConfig, TrainConfig
from hypernerf_tpu.models.nerf import NerfModel as JaxNerfModel
from hypernerf_tpu.ops import sampling as jax_sampling
from hypernerf_tpu.ops.ray_dict import prepare_ray_dict as jax_ray_dict
from hypernerf_tpu.parallel.mesh import create_mesh
from hypernerf_tpu.training import losses as jax_losses
from hypernerf_tpu.training.optimizers import get_optimizer as jax_optimizer
from hypernerf_tpu.training.train_state import TrainState as JaxTrainState
from hypernerf_tpu.training.train_state import \
    make_train_step as jax_make_train_step
from hypernerf_tpu_torch import configs as port_configs
from hypernerf_tpu_torch.convert import params_from_jax, params_to_jax
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
from hypernerf_tpu_torch.training.losses import weighted_elastic_loss
from hypernerf_tpu_torch.training.optimizers import get_optimizer
from hypernerf_tpu_torch.training.train_state import (TrainState,
                                                      make_train_step)
from tests.test_torch_train_step import (ARCH, BATCH, N, S, STEPS_PER_EPOCH,
                                         TRAIN, _assert_trees_close, _batch,
                                         _flat)

K = 4
N_BACKGROUND = 64
# A heavier elastic term than bench.py's 0.01, so that its gradient shows
# above the tolerance next to the MSE's.
LOSSES = dict(elastic_loss_weight=0.1, elastic_loss_scale=0.05,
              background_loss_weight=0.2, background_loss_scale=0.01,
              background_points_per_step=16)
# case -> (warp field, one GLO table (the level path), K, background term)
CASES = {'translation_k0': ('translation', True, 0, False),
         'translation_k4': ('translation', True, K, False),
         'translation_modules': ('translation', False, K, False),
         'se3_k4': ('se3', True, K, False),
         'se3_modules': ('se3', False, 0, False),
         'quaternion_k4': ('quaternion', True, K, False),
         'background': ('translation', True, K, True)}


def _arch(case):
    kind, shared, k, _ = CASES[case]
    arch = {**ARCH, 'warp_field_type': kind, 'share_glo': shared,
            'elastic_jacobian_samples': k}
    if kind != 'translation':
        arch.update(warp_min_deg=0, warp_max_deg=4)
    return arch


def _jax_cfg(case):
    return NerfConfig(use_pallas=True, use_pallas_fields=True,
                      use_pallas_level=True, pallas_interpret=True,
                      pallas_tile=8, pallas_bwd_tile=8, **_arch(case))


def _train_cfg(case, cls):
    losses = dict(LOSSES)
    if not CASES[case][3]:
        losses['background_loss_weight'] = 0.0
    return cls(**TRAIN, **losses)


@functools.cache
def _flax_params(case):
    """flax init with the warp heads and the sheet's head scaled up so that
    the warp, its Jacobian and the sheet carry gradient of ordinary size."""
    model = JaxNerfModel(NerfConfig(use_pallas=False, **_arch(case)))
    params = jax.device_get(jax.jit(model.init)(
        {'params': jax.random.PRNGKey(0)},
        jax_ray_dict(jnp.asarray(_batch()[0])))['params'])
    params = jax.tree.map(np.array, params)
    warp = params['warp_field']
    if CASES[case][0] == 'translation':
        warp['mlp']['logit']['kernel'] *= 300.0
    else:
        for head in ('w_net', 'v_net'):
            warp[head]['logit']['kernel'] *= 1e3
    params['hyper_sheet_mlp']['mlp']['logit']['kernel'] *= 1e4
    return params


def _background_points():
    rs = np.random.RandomState(9)
    return (rs.randn(N_BACKGROUND, 3) * 0.3).astype(np.float32)


def _keys(base_rng, step):
    """(k_idx, k_sample, k_noise) of the JAX step ``step`` on device 0."""
    rng = jax.random.fold_in(jax.random.fold_in(base_rng, step), 0)
    return jax.random.split(rng, 3)


def _jax_draws(case, model, params, k_idx, k_sample, k_noise):
    """The numbers the JAX step draws, in its order: per 'sampling' key the
    coarse jitter, the fine u, the coarse and the fine Jacobian subsample;
    one sigma noise per level; the background rows and ids from k_idx."""
    def keys(m):
        return ([m.make_rng('sampling') for _ in range(4)]
                + [m.make_rng('sigma_noise') for _ in range(2)])

    kc, kf, kj0, kj1, kn0, kn1 = model.apply(
        {'params': params}, rngs={'sampling': k_sample,
                                  'sigma_noise': k_noise}, method=keys)
    draws = {
        't_rand': jax.random.uniform(kc, (BATCH, S), jnp.float32),
        'fine_u': jax_sampling.sorted_uniform(kf, BATCH, N),
        'noise_coarse': jax.random.normal(kn0, (BATCH, S), jnp.float32),
        'noise_fine': jax.random.normal(kn1, (BATCH, S + N), jnp.float32),
        'jacobian_u_coarse': jax.random.uniform(kj0, (BATCH, K)),
        'jacobian_u_fine': jax.random.uniform(kj1, (BATCH, K)),
    }
    if CASES[case][3]:
        n = LOSSES['background_points_per_step']
        draws['background_idx'] = jax.random.randint(
            jax.random.fold_in(k_idx, 1), (n,), 0, N_BACKGROUND)
        draws['background_ids'] = jax.random.randint(
            jax.random.fold_in(k_idx, 2), (n, 1), 0, ARCH['num_embeddings'])
    out = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    for k in ('background_idx', 'background_ids'):
        if k in out:
            out[k] = out[k].long()
    return out


def _port_setup(case):
    cfg = port_configs.NerfConfig(**_arch(case))
    train_cfg = _train_cfg(case, port_configs.TrainConfig)
    model = NerfModel(cfg).train()
    model.load_state_dict(params_from_jax(_flax_params(case)))
    optimizer, schedule = get_optimizer(train_cfg, model.parameters(),
                                        STEPS_PER_EPOCH)
    background = (torch.from_numpy(_background_points())
                  if CASES[case][3] else None)
    step_fn = make_train_step(model, optimizer, cfg, train_cfg, 'cpu',
                              schedule=schedule, explicit_batch=True,
                              background_points=background)
    return model, TrainState(0, model, optimizer, seed=0), step_fn


def check_loss_and_gradients(case, monkeypatch):
    """The port's step against the JAX loss and gradients of ``case``."""
    rays, rgbs = _batch()
    cfg, train_cfg = _jax_cfg(case), _train_cfg(case, TrainConfig)
    jmodel = JaxNerfModel(cfg)
    params = _flax_params(case)
    k_idx, k_sample, k_noise = _keys(jax.random.PRNGKey(1), 0)
    draws = _jax_draws(case, jmodel, params, k_idx, k_sample, k_noise)

    drawn = []
    draw = jax_sampling.weighted_sample_indices

    def recording_draw(key, weights, num):
        drawn.append(np.array(jax.random.uniform(
            key, (*weights.shape[:-1], num))))
        return draw(key, weights, num)

    monkeypatch.setattr(jax_sampling, 'weighted_sample_indices',
                        recording_draw)

    def jax_loss(p):
        out = jmodel.apply({'params': p}, jax_ray_dict(jnp.asarray(rays)), {},
                           rngs={'sampling': k_sample,
                                 'sigma_noise': k_noise},
                           return_warp_jacobian=True)
        loss = jax_losses.mse_loss(out, jnp.asarray(rgbs))
        loss = loss + train_cfg.elastic_loss_weight * \
            jax_losses.weighted_elastic_loss(out, train_cfg.elastic_loss_scale)
        if CASES[case][3]:
            pts = jnp.asarray(_background_points())[
                jnp.asarray(draws['background_idx'].numpy())]
            warped = jmodel.apply(
                {'params': p}, pts, jnp.asarray(draws['background_ids']
                                                .numpy()), {},
                method=JaxNerfModel.apply_warp)['warped_points']
            loss = loss + train_cfg.background_loss_weight * jnp.mean(
                jax_losses.background_loss(
                    warped, pts, train_cfg.background_loss_scale))
        return loss

    want_loss, want_grads = jax.value_and_grad(jax_loss)(params)
    kind, shared, k, _ = CASES[case]
    # The JAX model drew the subsample on the level path alone, with the
    # uniforms recomputed above.
    assert len(drawn) == (2 if shared and k else 0)
    for got_u, name in zip(drawn, ('jacobian_u_coarse', 'jacobian_u_fine')):
        np.testing.assert_array_equal(got_u, draws[name].numpy())

    model, state, step_fn = _port_setup(case)
    metrics = step_fn(state, torch.from_numpy(rays), torch.from_numpy(rgbs),
                      draws=draws)
    assert abs(metrics['loss'].item() - float(want_loss)) <= 1e-5
    got = params_to_jax({k: p.grad for k, p in model.named_parameters()})
    _assert_trees_close(got, jax.device_get(want_grads), 1e-4, True)
    for name, g in _flat(got):
        assert np.isfinite(g).all() and np.abs(g).max() > 0, name


@pytest.mark.parametrize('case', ['translation_k0', 'translation_k4',
                                  'translation_modules', 'background'])
def test_loss_and_gradients_match_jax(case, monkeypatch):
    check_loss_and_gradients(case, monkeypatch)


def test_elastic_term_moves_the_loss_and_reads_the_weights():
    """The elastic term is non-zero and differentiable in the rendering
    weights: with the subsample, 'warp_jacobian_weights' = sum(weights) / K
    carries a gradient back to the template."""
    case = 'translation_k4'
    rays, _ = _batch()
    model, _, _ = _port_setup(case)
    out = model(prepare_ray_dict(torch.from_numpy(rays)), deterministic=False,
                generator=torch.Generator().manual_seed(0),
                return_warp_jacobian=True)
    for level in ('coarse', 'fine'):
        res = out[level]
        assert res['warp_jacobian'].shape == (BATCH, K, 3, 3)
        torch.testing.assert_close(
            res['warp_jacobian_weights'],
            (res['weights'].sum(-1, keepdim=True) / K).expand(BATCH, K))
    term = weighted_elastic_loss(out)
    assert term.item() > 0
    g, = torch.autograd.grad(term, model.nerf_fine.trunk.hidden(0).weight)
    assert g.abs().max() > 0


def check_three_adam_steps(case):
    """Three steps of the port against three of the JAX train step."""
    rays, rgbs = _batch()
    cfg, train_cfg = _jax_cfg(case), _train_cfg(case, TrainConfig)
    jmodel = JaxNerfModel(cfg)
    tx = jax_optimizer(train_cfg, steps_per_epoch=STEPS_PER_EPOCH)
    params = jax.tree.map(jnp.asarray, _flax_params(case))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params))
    background = (jnp.asarray(_background_points()) if CASES[case][3]
                  else None)
    jstep = jax_make_train_step(jmodel, tx, cfg, train_cfg,
                                create_mesh(num_devices=1),
                                explicit_batch=True,
                                background_points=background)
    base_rng = jax.random.PRNGKey(1)
    model, state, step_fn = _port_setup(case)
    t_rays, t_rgbs = torch.from_numpy(rays), torch.from_numpy(rgbs)
    for step in range(3):
        draws = _jax_draws(case, jmodel, jax.device_get(jstate.params),
                           *_keys(base_rng, step))
        jstate, jmetrics = jstep(jstate, jnp.asarray(rays),
                                 jnp.asarray(rgbs), base_rng)
        metrics = step_fn(state, t_rays, t_rgbs, draws=draws)
        assert state.step == step + 1 == int(jstate.step)
        assert abs(metrics['loss'].item() - float(jmetrics['loss'])) <= 1e-5
        _assert_trees_close(params_to_jax(model.state_dict()),
                            jax.device_get(jstate.params), 1e-5, False)


def test_three_adam_steps_match_jax():
    check_three_adam_steps('translation_k4')
