"""The port's optimizers, schedules, image metrics and metrics logger against
the JAX package's.

Each optimizer x schedule x warm-up case, with and without weight decay,
takes 13 updates (two lookahead syncs for ``ranger``) of three tensors; one
of them gets gradients of 1e-6, where RAdam's eps placement shows. Before
each update the port's parameters (and ranger's slow weights) are set to
JAX's, so that both take the update from the same point; the port runs in
float64 there, so its update is read exactly, and JAX's float32 arithmetic
is the noise (the parameters are of 0.05, the tiny tensor's 5e-5). The
JAX updates and schedules run jitted, as the train step runs them (eager
JAX computes b2 ** t by another rule, an ulp away, which moves RAdam's
first rectifier by 0.6 %).

Tolerances: every update within 1e-6 of the largest JAX update entry of
its tensor in the run (JAX rounds the parameters to float32, an error of
2^-24 of the parameter, which the lookahead sync's f + u - s carries into
its update: after RAdam's large first updates and small rectified ones,
5e-6 of the second sync's own size); the schedules' values within 1e-6 of
the peak rate (numpy and XLA round a float32 cos or pow an ulp apart,
which near a schedule's end is more than 1e-6 of its value).

Metrics: ``ssim`` 1e-6 and ``psnr`` 1e-5 against JAX's on the same images;
the loggers' CSV rows and PNG files are equal.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hypernerf_tpu.configs import TrainConfig as JaxTrainConfig
from hypernerf_tpu.training import metrics as jax_metrics
from hypernerf_tpu.training.optimizers import get_optimizer as jax_optimizer
from hypernerf_tpu.training.optimizers import get_scheduler as jax_scheduler
from hypernerf_tpu.utils.logging import MetricsLogger as JaxLogger
from hypernerf_tpu_torch.configs import NerfConfig, TrainConfig
from hypernerf_tpu_torch.kernels import common
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.training import metrics
from hypernerf_tpu_torch.training.optimizers import (Ranger, get_optimizer,
                                                     get_scheduler)
from hypernerf_tpu_torch.utils.logging import MetricsLogger

UPDATES = 13
STEPS_PER_EPOCH = 2  # steplr's boundary at update 4, warm-up 2 updates
TOL = 1e-6
SHAPES = {'w': (6, 5), 'b': (5,), 'tiny': (4,)}


def _train_kw(optimizer, scheduler, warmup, weight_decay):
    return dict(optimizer=optimizer, lr_scheduler=scheduler, lr=1e-2,
                warmup_epochs=warmup, warmup_multiplier=2.0,
                weight_decay=weight_decay, decay_step=(2, 2, 5),
                decay_gamma=0.5, num_epochs=8, momentum=0.9, poly_exp=0.9)


def _params_and_grads():
    rs = np.random.RandomState(0)
    params = {k: (rs.randn(*s) * 0.05).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = []
    for _ in range(UPDATES):
        g = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
        g['tiny'] *= np.float32(1e-6)
        grads.append(g)
    params['tiny'] *= np.float32(1e-3)
    return params, grads


def _port_params(params):
    return {k: torch.nn.Parameter(torch.from_numpy(v.astype(np.float64)))
            for k, v in params.items()}


def _run(kw, port_optimizer=None):
    """Runs both; yields (update number, name, port update, JAX update) and,
    for ranger, the slow weights after each update as (.., 'slow/' name,
    port, JAX)."""
    params, grads = _params_and_grads()
    cfg = JaxTrainConfig(**kw)
    tx = jax_optimizer(cfg, STEPS_PER_EPOCH)
    update = jax.jit(tx.update)  # as the train step runs it
    ranger = kw['optimizer'] == 'ranger'
    jparams = jax.tree.map(jnp.asarray, params)
    if ranger:
        jparams = optax.LookaheadParams.init_synced(jparams)
    jstate = tx.init(jparams)
    ours = _port_params(params)
    opt, schedule = get_optimizer(TrainConfig(**kw), list(ours.values()),
                                  STEPS_PER_EPOCH)
    if port_optimizer is not None:
        opt = port_optimizer(list(ours.values()))
    for i, g in enumerate(grads):
        fast = jparams.fast if ranger else jparams
        with torch.no_grad():
            for k, p in ours.items():
                p.copy_(torch.from_numpy(np.asarray(fast[k], np.float64)))
                if ranger and isinstance(opt, Ranger):
                    opt.state[p]['slow'].copy_(torch.from_numpy(
                        np.asarray(jparams.slow[k], np.float64)))
        before = {k: p.detach().clone() for k, p in ours.items()}
        updates, jstate = update(jax.tree.map(jnp.asarray, g), jstate,
                                 jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in ours.items():
            p.grad = torch.from_numpy(g[k].astype(np.float64))
        for group in opt.param_groups:
            group['lr'] = schedule(i)
        opt.step()
        for k, p in ours.items():
            want = np.asarray(updates.fast[k] if ranger else updates[k],
                              np.float64)
            yield i, k, (p.detach() - before[k]).numpy(), want
            if ranger and isinstance(opt, Ranger):
                yield (i, f'slow/{k}', opt.state[p]['slow'].numpy(),
                       np.asarray(jparams.slow[k], np.float64))


def _worst(kw, port_optimizer=None):
    """The largest error of any update of a tensor over the largest JAX
    update entry of that tensor in the run, and where."""
    errs, scale = {}, {}
    for i, k, got, want in _run(kw, port_optimizer):
        errs[(i, k)] = np.abs(got - want).max()
        scale[k] = max(scale.get(k, 0.0), np.abs(want).max())
    assert all(v > 0 for v in scale.values()), scale
    return max((e / scale[k], (i, k)) for (i, k), e in errs.items())


@pytest.mark.parametrize('weight_decay', [0.0, 1e-2])
@pytest.mark.parametrize('warmup', [0, 1])
@pytest.mark.parametrize('scheduler', ['steplr', 'cosine', 'poly'])
@pytest.mark.parametrize('optimizer', ['sgd', 'adam', 'radam', 'ranger'])
def test_updates_match_optax(optimizer, scheduler, warmup, weight_decay):
    err, where = _worst(_train_kw(optimizer, scheduler, warmup,
                                  weight_decay))
    assert err <= TOL, (err, where)


def test_torch_adam_and_radam_are_other_updates():
    """The check sees what the port's own classes fix: torch.optim.RAdam's
    eps, 1 / sqrt(1 - beta2^t) times larger, moves the 1e-6 gradients'
    updates by percents; torch.optim.Adam's float64 bias corrections move
    every update by about 1e-5."""
    kw = _train_kw('radam', 'steplr', 0, 0.0)
    err, (i, k) = _worst(kw, lambda p: torch.optim.RAdam(p, lr=1e-2,
                                                         eps=1e-8))
    assert err > 1e-2 and k == 'tiny' and i >= 5, (err, i, k)
    err, _ = _worst(_train_kw('adam', 'steplr', 0, 0.0),
                    lambda p: torch.optim.Adam(p, lr=1e-2, eps=1e-8))
    assert 1e-6 < err < 1e-4, err


@pytest.mark.parametrize('scheduler', ['steplr', 'cosine', 'poly'])
def test_schedules_match_optax(scheduler):
    """Over a whole run and past it, with and without warm-up, and
    ``poly``'s reading of num_epochs under max_steps."""
    for warmup in (0, 3):
        kw = dict(_train_kw('adam', scheduler, warmup, 0.0), num_epochs=5)
        want = jax.jit(jax.vmap(jax_scheduler(JaxTrainConfig(**kw), 7, 60)))(
            jnp.arange(80, dtype=jnp.int32))
        got = get_scheduler(TrainConfig(**kw), 7, 60)
        peak = kw['lr'] * kw['warmup_multiplier']
        for step in range(0, 80):
            assert abs(got(step) - float(want[step])) <= 1e-6 * peak, (
                warmup, step)


def test_warmup_is_skipped_for_radam_and_ranger():
    for name in ('radam', 'ranger'):
        sched = get_scheduler(TrainConfig(**_train_kw(name, 'steplr', 1,
                                                      0.0)), 2)
        assert sched(0) == sched(1) == pytest.approx(1e-2)


def test_optimizer_steps_repack_the_level_kernels_weights():
    """Every optimizer's update, and the lookahead sync above all, writes
    through the parameter: the packed-weights key of the level kernels
    (``kernels/common.packed``) changes with each step."""
    cfg = NerfConfig(num_embeddings=2, trunk_depth=2, trunk_width=16,
                     rgb_branch_depth=1, rgb_branch_width=16,
                     warp_depth=2, warp_width=16, hyper_sheet_depth=2,
                     hyper_sheet_width=16, skips=(1,),
                     compute_dtype='float32')
    for name in ('sgd', 'adam', 'radam', 'ranger'):
        torch.manual_seed(0)
        model = NerfModel(cfg)
        owner = model.warp_field.mlp
        layers = [(lin, [(lin.in_features, lin.in_features)])
                  for lin in owner.children()
                  if isinstance(lin, torch.nn.Linear)]
        opt, _ = get_optimizer(TrainConfig(optimizer=name, lr=1e-2),
                               model.parameters(), 1)
        keys = [common.packed(owner, layers)['key']]
        for step in range(6):
            for p in model.parameters():
                p.grad = torch.full_like(p, 0.1)
            if name == 'ranger' and step == 5:
                # The sixth update syncs: the fast weights move to the
                # slow ones' new point.
                before = [p.detach().clone() for p in owner.parameters()]
            opt.step()
            keys.append(common.packed(owner, layers)['key'])
            assert keys[-1] != keys[-2], (name, step)
        if name == 'ranger':
            for p, b in zip(owner.parameters(), before):
                assert torch.equal(p, opt.state[p]['slow']) or \
                    torch.allclose(p, opt.state[p]['slow'], atol=1e-7)
                assert not torch.equal(p, b)


def test_unknown_optimizer_and_scheduler_raise():
    params = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match='optimizer'):
        get_optimizer(TrainConfig(optimizer='bogus'), params, 10)
    with pytest.raises(ValueError, match='scheduler'):
        get_scheduler(TrainConfig(lr_scheduler='bogus'), 10)


def _images(seed=0, h=12, w=16):
    rs = np.random.RandomState(seed)
    gt = rs.rand(h, w, 3).astype(np.float32)
    pred = np.clip(gt + rs.randn(h, w, 3).astype(np.float32) * 0.1, 0, 1)
    mask = rs.rand(h, w, 3) > 0.3
    return pred, gt, mask


@pytest.mark.parametrize('as_tensor', [False, True])
def test_metrics_match_jax(as_tensor):
    """``mse`` / ``psnr`` (mean, with a mask, per element) and ``ssim`` on
    the same images, given as numpy arrays or as tensors."""
    pred, gt, mask = _images()

    def conv(a):
        return torch.from_numpy(np.asarray(a)) if as_tensor else a

    j = [jnp.asarray(a) for a in (pred, gt, mask)]
    assert float(metrics.ssim(conv(pred), conv(gt))) == pytest.approx(
        float(jax_metrics.ssim(j[0], j[1])), rel=1e-6)
    assert float(metrics.ssim(conv(gt), conv(gt))) == pytest.approx(1.0)
    for kw in ({}, {'valid_mask': True}):
        args = (conv(pred), conv(gt)) + ((conv(mask),) if kw else ())
        jargs = tuple(j[:3] if kw else j[:2])
        assert float(metrics.psnr(*args)) == pytest.approx(
            float(jax_metrics.psnr(*jargs)), rel=1e-5)
        assert float(metrics.mse(*args)) == pytest.approx(
            float(jax_metrics.mse(*jargs)), rel=1e-5)
    got = metrics.mse(conv(pred), conv(gt), conv(mask), reduction='none')
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(jax_metrics.mse(*j, reduction='none')),
        rtol=1e-6)


def test_metrics_logger_matches_jax(tmp_path):
    """The same scalars and image triplet through both loggers (CSV only):
    the same CSV rows but the time, the same PNG files byte for byte."""
    pred, gt, _ = _images(1)
    depth = np.linspace(0, 1, 12 * 16 * 3).reshape(12, 16, 3)
    triplet = np.stack([gt, pred, depth]).astype(np.float32)
    rows = {}
    for name, cls in (('jax', JaxLogger), ('port', MetricsLogger)):
        logger = cls(str(tmp_path / name), 'exp', use_tensorboard=False)
        logger.add_scalar('train/loss', np.float32(0.25), 3)
        logger.add_scalar('lr', torch.tensor(5e-4), 3)
        logger.add_images('val/GT_pred_depth', triplet, 4)
        logger.close()
        with open(tmp_path / name / 'exp' / 'metrics.csv') as f:
            rows[name] = [r[1:] for r in csv.reader(f)]
    assert rows['port'] == rows['jax']
    assert rows['port'][1:] == [['3', 'train/loss', '0.25'],
                                ['3', 'lr', str(float(np.float32(5e-4)))]]
    names = sorted(os.listdir(tmp_path / 'jax' / 'exp' / 'images'))
    assert names == sorted(os.listdir(tmp_path / 'port' / 'exp' / 'images'))
    assert len(names) == 3
    for n in names:
        assert (tmp_path / 'jax' / 'exp' / 'images' / n).read_bytes() == \
            (tmp_path / 'port' / 'exp' / 'images' / n).read_bytes()
