"""The slice as a whole: the port's train step against the JAX train step on
the same converted weights, the same explicit batch and the JAX step's own
draws (recomputed here from its keys and handed to the port), at float32 with
the JAX kernels in interpret mode.

Tolerances: loss 1e-5; every parameter's gradient 1e-4 of its largest entry
(fp32 both ways, other summation orders through two levels and the
compositing scans); after three Adam steps with a ``steplr`` boundary inside
them every parameter 1e-5 (Adam's normalised update is of the size of the
learning rate, 1e-3 here, so a relative gradient error of 1e-4 moves a
parameter by about 1e-7 a step, and more only where a gradient is so near
zero that eps 1e-8 no longer hides its error).
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
from hypernerf_tpu.ops.sampling import sorted_uniform
from hypernerf_tpu.parallel.mesh import create_mesh
from hypernerf_tpu.training.losses import mse_loss as jax_mse_loss
from hypernerf_tpu.training.optimizers import get_optimizer as jax_optimizer
from hypernerf_tpu.training.train_state import TrainState as JaxTrainState
from hypernerf_tpu.training.train_state import \
    make_train_step as jax_make_train_step
from hypernerf_tpu_torch import configs as port_configs
from hypernerf_tpu_torch.convert import params_from_jax, params_to_jax
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
from hypernerf_tpu_torch.training.losses import mse_loss
from hypernerf_tpu_torch.training.optimizers import get_optimizer
from hypernerf_tpu_torch.training.train_state import (TrainState,
                                                      compute_extra_params,
                                                      make_train_step)

BATCH, S, N = 8, 8, 8
NOISE_STD = 0.7
ARCH = dict(num_embeddings=4, glo_dim=8, num_coarse_samples=S,
            num_fine_samples=N, warp_depth=2, warp_width=16, warp_freq=4,
            hyper_sheet_depth=2, hyper_sheet_width=16, hyper_sheet_freq=3,
            xyz_freq=4, hyper_freq=2, dir_freq=2, trunk_depth=2,
            trunk_width=32, rgb_branch_depth=1, rgb_branch_width=16,
            skips=(1,), noise_std=NOISE_STD, compute_dtype='float32')
TRAIN = dict(batch_size=BATCH, lr=1e-3, decay_step=(2,), decay_gamma=0.5)
STEPS_PER_EPOCH = 1  # the steplr boundary falls on step 2 of the three


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    o = (rs.randn(BATCH, 3) * 0.1).astype(np.float32)
    d = rs.randn(BATCH, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((BATCH, 1), 0.2, np.float32),
                           np.full((BATCH, 1), 2.0, np.float32),
                           rs.randint(0, 4, (BATCH, 1)).astype(np.float32)],
                          1)
    return rays, rs.rand(BATCH, 3).astype(np.float32)


def _jax_cfg():
    return NerfConfig(use_pallas=True, use_pallas_fields=True,
                      use_pallas_level=True, pallas_interpret=True,
                      pallas_tile=8, pallas_bwd_tile=8, **ARCH)


@functools.cache
def _flax_params():
    """flax init with the warp and sheet heads scaled up so that the two
    fields carry gradient of ordinary size."""
    model = JaxNerfModel(NerfConfig(use_pallas=False, **ARCH))
    params = jax.device_get(jax.jit(model.init)(
        {'params': jax.random.PRNGKey(0)},
        jax_ray_dict(jnp.asarray(_batch()[0])))['params'])
    params = jax.tree.map(np.array, params)
    params['warp_field']['mlp']['logit']['kernel'] *= 300.0
    params['hyper_sheet_mlp']['mlp']['logit']['kernel'] *= 1e4
    return params


def _step_keys(base_rng, step):
    """(k_sample, k_noise) of the JAX step ``step`` on device 0 of the mesh
    (train_state.py: fold in the step, then the axis index, split in 3)."""
    rng = jax.random.fold_in(jax.random.fold_in(base_rng, step), 0)
    _, k_sample, k_noise = jax.random.split(rng, 3)
    return k_sample, k_noise


def _jax_draws(model, params, k_sample, k_noise):
    """The numbers the JAX model draws from these rngs, in its order: the
    coarse sampling key, the fine sampling key, one noise key per level."""
    def keys(m):
        return (m.make_rng('sampling'), m.make_rng('sampling'),
                m.make_rng('sigma_noise'), m.make_rng('sigma_noise'))

    k_coarse, k_fine, k_n0, k_n1 = model.apply(
        {'params': params}, rngs={'sampling': k_sample,
                                  'sigma_noise': k_noise}, method=keys)
    draws = {
        't_rand': jax.random.uniform(k_coarse, (BATCH, S), jnp.float32),
        'fine_u': sorted_uniform(k_fine, BATCH, N),
        'noise_coarse': jax.random.normal(k_n0, (BATCH, S), jnp.float32),
        'noise_fine': jax.random.normal(k_n1, (BATCH, S + N), jnp.float32),
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def _port_setup():
    cfg = port_configs.NerfConfig(**ARCH)
    train_cfg = port_configs.TrainConfig(**TRAIN)
    model = NerfModel(cfg).train()
    model.load_state_dict(params_from_jax(_flax_params()))
    optimizer, schedule = get_optimizer(train_cfg, model.parameters(),
                                        STEPS_PER_EPOCH)
    step_fn = make_train_step(model, optimizer, cfg, train_cfg, 'cpu',
                              schedule=schedule, explicit_batch=True)
    return model, TrainState(0, model, optimizer, seed=0), step_fn


def _flat(tree, prefix=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f'{prefix}{k}/')
        else:
            yield f'{prefix}{k}', np.asarray(v)


def _assert_trees_close(got, want, tol, relative_to_max):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert sorted(got) == sorted(want)
    for k, b in want.items():
        a = got[k]
        assert a.shape == b.shape, k
        scale = max(np.abs(b).max(), 1e-12) if relative_to_max else 1.0
        err = np.abs(a - b).max() / scale
        assert err <= tol, (k, err)


def test_loss_and_gradients_match_jax():
    rays, rgbs = _batch()
    jmodel = JaxNerfModel(_jax_cfg())
    params = _flax_params()
    k_sample, k_noise = _step_keys(jax.random.PRNGKey(1), 0)

    def jax_loss(p):
        out = jmodel.apply({'params': p}, jax_ray_dict(jnp.asarray(rays)),
                           rngs={'sampling': k_sample,
                                 'sigma_noise': k_noise})
        return jax_mse_loss(out, jnp.asarray(rgbs))

    want_loss, want_grads = jax.value_and_grad(jax_loss)(params)
    draws = _jax_draws(jmodel, params, k_sample, k_noise)

    model, _, _ = _port_setup()
    out = model(prepare_ray_dict(torch.from_numpy(rays)),
                deterministic=False, draws=draws)
    loss = mse_loss(out, torch.from_numpy(rgbs))
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    loss.backward()
    got = params_to_jax({k: p.grad for k, p in model.named_parameters()})
    _assert_trees_close(got, jax.device_get(want_grads), 1e-4, True)
    for k, g in _flat(got):
        assert np.abs(g).max() > 0, k


def test_three_adam_steps_match_jax():
    rays, rgbs = _batch()
    cfg = _jax_cfg()
    train_cfg = TrainConfig(**TRAIN)
    jmodel = JaxNerfModel(cfg)
    tx = jax_optimizer(train_cfg, steps_per_epoch=STEPS_PER_EPOCH)
    params = jax.tree.map(jnp.asarray, _flax_params())
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params))
    jstep = jax_make_train_step(jmodel, tx, cfg, train_cfg,
                                create_mesh(num_devices=1),
                                explicit_batch=True)
    base_rng = jax.random.PRNGKey(1)
    model, state, step_fn = _port_setup()
    t_rays, t_rgbs = torch.from_numpy(rays), torch.from_numpy(rgbs)
    lrs = []
    for step in range(3):
        draws = _jax_draws(jmodel, jax.device_get(jstate.params),
                           *_step_keys(base_rng, step))
        jstate, jmetrics = jstep(jstate, jnp.asarray(rays),
                                 jnp.asarray(rgbs), base_rng)
        metrics = step_fn(state, t_rays, t_rgbs, draws=draws)
        lrs.append(state.optimizer.param_groups[0]['lr'])
        assert state.step == step + 1 == int(jstate.step)
        assert abs(metrics['loss'].item() - float(jmetrics['loss'])) <= 1e-5
        assert abs(metrics['psnr'].item() - float(jmetrics['psnr'])) <= 1e-3
        _assert_trees_close(params_to_jax(model.state_dict()),
                            jax.device_get(jstate.params), 1e-5, False)
    assert lrs == pytest.approx([1e-3, 1e-3, 5e-4])  # the boundary at step 2


def test_step_draws_its_batch_on_the_device():
    """The index draw stays in range, the state advances, psnr is
    -10 log10(mse) of the fine level, and a step is a function of (seed,
    step) alone."""
    from hypernerf_tpu_torch.training import train_state as ts
    rs = np.random.RandomState(3)
    cfg = port_configs.NerfConfig(**ARCH)
    train_cfg = port_configs.TrainConfig(**TRAIN)
    all_rays = torch.from_numpy(np.concatenate(
        [_batch(s)[0] for s in range(5)]))
    all_rgbs = torch.from_numpy(rs.rand(len(all_rays), 3).astype(np.float32))

    def run():
        torch.manual_seed(0)
        model = NerfModel(cfg).train()
        opt, schedule = get_optimizer(train_cfg, model.parameters(), 100)
        step_fn = make_train_step(model, opt, cfg, train_cfg, 'cpu',
                                  schedule=schedule)
        state = TrainState(0, model, opt, seed=7)
        seen = []
        orig = torch.Tensor.index_select

        def spy(self, dim, index):
            seen.append(index)
            return orig(self, dim, index)

        torch.Tensor.index_select = spy
        try:
            metrics = step_fn(state, all_rays, all_rgbs)
        finally:
            torch.Tensor.index_select = orig
        return state, metrics, seen

    state, metrics, seen = run()
    assert state.step == 1
    assert len(seen) == 2 and torch.equal(seen[0], seen[1])
    idx = seen[0]
    assert idx.shape == (BATCH,) and idx.dtype == torch.int64
    assert idx.device == all_rays.device
    assert 0 <= int(idx.min()) and int(idx.max()) < len(all_rays)
    assert torch.isfinite(metrics['loss']) and torch.isfinite(metrics['psnr'])
    state2, metrics2, seen2 = run()
    assert torch.equal(seen2[0], idx)
    assert metrics2['loss'].item() == metrics['loss'].item()
    # psnr is of the fine level: recompute it with the step's own draws.
    model = NerfModel(cfg).train()
    torch.manual_seed(0)
    model.load_state_dict(NerfModel(cfg).state_dict())
    gen = ts.step_generator(TrainState(0, model, None, seed=7), 'cpu')
    idx2 = torch.randint(0, len(all_rays), (BATCH,), generator=gen)
    assert torch.equal(idx2, idx)
    with torch.no_grad():
        out = model(prepare_ray_dict(all_rays[idx]), deterministic=False,
                    generator=gen)
        mse = torch.mean((out['fine']['rgb'] - all_rgbs[idx]) ** 2)
    assert metrics['psnr'].item() == pytest.approx(
        (-10.0 * torch.log10(mse)).item(), abs=1e-5)


def test_unported_training_options_name_their_roadmap_item():
    cfg = port_configs.NerfConfig(**ARCH)
    model = NerfModel(cfg)
    for kw, item in ((dict(optimizer='sgd'), 'A.8'),
                     (dict(lr_scheduler='cosine'), 'A.8'),
                     (dict(warmup_epochs=1), 'A.8')):
        with pytest.raises(NotImplementedError, match=item):
            get_optimizer(port_configs.TrainConfig(**kw), model.parameters(),
                          10)
    # The elastic and background losses are ported (A.11); the annealing
    # schedule of the Nerfies encoding is not.
    with pytest.raises(NotImplementedError, match='A.9'):
        compute_extra_params(
            port_configs.NerfConfig(**ARCH, use_original_embed=False),
            port_configs.TrainConfig(), 0)
