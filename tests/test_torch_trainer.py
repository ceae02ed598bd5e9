"""The port's trainer (``training/trainer.py``) and its entry point
(``python -m hypernerf_tpu_torch.train``) against the JAX package's
``Trainer`` on ``make_smooth_llff_scene`` (16x12, 384 training rays),
``tiny_nerf_config``, float32, the CPU.

The port warm-starts from the JAX trainer's initial weights (a weight file
of ``convert.params_from_jax``), and each of its steps takes JAX's batch and
draws: the JAX step's keys are recomputed from its base key and step (as
``tests/test_torch_train_step.py`` does), and a step with ``explicit_batch``
put in place of ``trainer.train_step`` feeds them. Both trainers then run
``fit`` with their own cadences (sanity val, logs every step, vals every 3,
checkpoints every 4 steps and at the end): 8 steps of Adam at 5e-4, and 7
of ``ranger`` with ``cosine`` (and a warm-up, which both skip for it).

On this model the two runs part from the 4th step or so: the warp field's
and the sheet's layers start with gradients at the two packages'
summation noise (heads of 1e-4 and 1e-5), Adam turns such a gradient's
sign into a full-rate step, and the 2^9 posenc band grows a moved warp.
The logged losses' error grows some ten times a step from there: 2e-5 at
step 7 of this run, but 1.1e-4 at step 8 with a steplr boundary at step
6, 1.3e-4 at step 6 at 2.5e-4, 3e-3 at 2e-3, 4e-3 with the heads scaled
up as ``test_torch_train_step.py`` scales them (measured on the CPU). So
the schedules' boundaries and the warm-up are held to optax in
``test_torch_optimizers.py``, update by update, and SGD too.

Tolerances: the logged ``train/loss``, ``train/psnr``, ``lr``, ``val/loss``
and ``val/psnr`` and the manifests' metrics relative 1e-4 (float32 both
ways, other summation orders through two levels over 8 steps); the final
weights' difference 1e-1 of each tensor's movement over the run, in L2
(Adam's first updates move an entry by +-lr whatever its gradient's size,
so an entry whose gradient lies below the two packages' summation noise
may move the other way: measured 2.3e-2 on the warp field's first layer
after 8 steps, 5.4e-2 on its 3-entry head bias in a warm-up run); a
resumed run equals the unbroken one exactly (the same ops on the same
numbers).

``ranger`` cannot train in the JAX package: its step hands optax.lookahead
the gradient of both the fast and the slow weights, where lookahead takes
the fast weights' alone (``ValueError: Expected named tuple``; ROADMAP D).
Its JAX reference here is that step with the fast weights' gradient handed
on, which is what the optimizer documents, from a state whose slow weights
are a copy (``init_synced`` gives both one buffer, which the donating step
refuses to take twice).
"""

import csv
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from hypernerf_tpu.configs import TrainConfig as JaxTrainConfig
from hypernerf_tpu.ops.sampling import sorted_uniform
from hypernerf_tpu.parallel.mesh import create_mesh
from hypernerf_tpu.training.train_state import forward_params
from hypernerf_tpu.training.train_state import \
    make_train_step as jax_make_train_step
from hypernerf_tpu.training.trainer import Trainer as JaxTrainer
from hypernerf_tpu.utils.logging import MetricsLogger as JaxLogger
from hypernerf_tpu_torch import configs as port_configs
from hypernerf_tpu_torch import train as port_train
from hypernerf_tpu_torch.convert import params_from_jax, params_to_jax
from hypernerf_tpu_torch.datasets import llff as port_llff
from hypernerf_tpu_torch.training import checkpoints
from hypernerf_tpu_torch.training.train_state import make_train_step
from hypernerf_tpu_torch.training.trainer import Trainer
from hypernerf_tpu_torch.utils.logging import MetricsLogger
from tests.conftest import make_smooth_llff_scene, tiny_nerf_config

TOL = 1e-4
LOGGED = ('train/loss', 'train/psnr', 'lr', 'val/loss', 'val/psnr')


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    return make_smooth_llff_scene(tmp_path_factory.mktemp('scene'))


def _train_kw(scene, root, name, **overrides):
    return dict(dict(root_dir=scene, dataset_name='llff', img_wh=(16, 12),
                     batch_size=64, chunk=64, max_steps=8, log_every=1,
                     val_check_interval=0.5, ckpt_every_steps=4,
                     exp_name=name, ckpt_dir=os.path.join(root, 'ckpts'),
                     log_dir=os.path.join(root, 'logs')), **overrides)


def _fast_grads(tx):
    """``tx`` with the gradient of LookaheadParams' fast weights handed on:
    what optax.lookahead takes."""
    return optax.GradientTransformation(
        tx.init, lambda g, s, p=None: tx.update(g.fast, s, p))


def _run_jax(kw):
    """A JAX trainer's run: (its initial forward weights, the trainer) after
    ``fit``."""
    tc = JaxTrainConfig(**kw)
    trainer = JaxTrainer(tiny_nerf_config(), tc,
                         mesh=create_mesh(num_devices=1),
                         logger=JaxLogger(tc.log_dir, tc.exp_name,
                                          use_tensorboard=False))
    init = jax.tree.map(np.array, jax.device_get(
        forward_params(trainer.state.params)))
    if tc.optimizer == 'ranger':
        trainer.train_step = jax_make_train_step(
            trainer.model, _fast_grads(trainer.tx), trainer.nerf_cfg, tc,
            trainer.mesh)
        # init_synced's fast and slow weights are one buffer, which the
        # donating step cannot take twice.
        params = trainer.state.params
        trainer.state = trainer.state.replace(params=params._replace(
            slow=jax.tree.map(jnp.copy, params.slow)))
    trainer.fit()
    trainer.logger.close()
    return init, trainer


def _jax_batch(jt, step):
    """The batch indices and the model's draws of the JAX trainer's step
    ``step`` (train_state.py: fold in the step, then the device index, split
    in 3; the model draws the coarse key, the fine key, then a noise key per
    level)."""
    rng = jax.random.fold_in(jax.random.fold_in(jt.base_rng, step), 0)
    k_idx, k_sample, k_noise = jax.random.split(rng, 3)
    batch = jt.train_cfg.batch_size
    idx = jax.random.randint(k_idx, (batch,), 0, jt.all_rays.shape[0])

    def keys(m):
        return (m.make_rng('sampling'), m.make_rng('sampling'),
                m.make_rng('sigma_noise'), m.make_rng('sigma_noise'))

    k_coarse, k_fine, k_n0, k_n1 = jt.model.apply(
        {'params': forward_params(jt.state.params)},
        rngs={'sampling': k_sample, 'sigma_noise': k_noise}, method=keys)
    cfg = jt.nerf_cfg
    s, n = cfg.num_coarse_samples, cfg.num_fine_samples
    draws = {'t_rand': jax.random.uniform(k_coarse, (batch, s)),
             'fine_u': sorted_uniform(k_fine, batch, n),
             'noise_coarse': jax.random.normal(k_n0, (batch, s)),
             'noise_fine': jax.random.normal(k_n1, (batch, s + n))}
    return (torch.from_numpy(np.array(idx, np.int64)),
            {k: torch.from_numpy(np.array(v)) for k, v in draws.items()})


def _port_trainer(kw, init, jt, root):
    """The port's trainer warm-started from ``init``, its step fed the JAX
    trainer's batches and draws."""
    cfg = port_configs.NerfConfig.from_json(tiny_nerf_config().to_json())
    weights = os.path.join(root, 'init', 'model.pt')
    checkpoints.save_weights(weights, params_from_jax(init), cfg)
    tc = port_configs.TrainConfig(**{**kw, 'weight_path': weights})
    trainer = Trainer(cfg, tc, 'cpu', logger=MetricsLogger(
        tc.log_dir, tc.exp_name, use_tensorboard=False))
    explicit = make_train_step(trainer.model, trainer.optimizer,
                               trainer.nerf_cfg, tc, 'cpu',
                               schedule=trainer.lr_schedule,
                               explicit_batch=True)

    def step(state, all_rays, all_rgbs):
        idx, draws = _jax_batch(jt, state.step)
        return explicit(state, all_rays[idx], all_rgbs[idx], draws=draws)

    trainer.train_step = step
    return trainer


def _logged(log_dir, name):
    with open(os.path.join(log_dir, name, 'metrics.csv')) as f:
        return {(r['tag'], int(r['step'])): float(r['value'])
                for r in csv.DictReader(f) if r['tag'] in LOGGED}


def _manifest(ckpt_dir, name):
    with open(os.path.join(ckpt_dir, name, 'manifest.json')) as f:
        return json.load(f)


def _assert_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=TOL), k


def _assert_weights(got, want, init, tol=1e-1):
    """Each tensor of ``got`` minus ``want`` (state dicts) within ``tol`` of
    the tensor's movement from ``init`` over the run, in L2."""
    for k, w in want.items():
        moved = torch.linalg.norm(w - init[k]).item()
        assert moved > 0, k
        err = torch.linalg.norm(got[k] - w).item() / moved
        assert err <= tol, (k, err)


@pytest.fixture(scope='module')
def adam_runs(scene, tmp_path_factory):
    """The JAX trainer's run and the port's, 8 steps of Adam with steplr
    (its boundary past the run)."""
    root = str(tmp_path_factory.mktemp('adam'))
    kw = _train_kw(scene, root, 'jax')
    init, jt = _run_jax(kw)
    port_kw = dict(kw, exp_name='port')
    pt = _port_trainer(port_kw, init, jt, root)
    metrics = pt.fit()
    pt.logger.close()
    return dict(root=root, kw=port_kw, init=init, jt=jt, pt=pt,
                metrics=metrics)


def test_logged_metrics_match_jax_step_for_step(adam_runs):
    root = adam_runs['root']
    got = _logged(os.path.join(root, 'logs'), 'port')
    want = _logged(os.path.join(root, 'logs'), 'jax')
    assert {k for k in want if k[0] == 'train/loss'} == {
        ('train/loss', s) for s in range(1, 9)}
    assert {k for k in want if k[0] == 'val/psnr'} == {
        ('val/psnr', s) for s in (0, 3, 6)}
    _assert_close(got, want)
    lrs = [want[('lr', s)] for s in range(1, 9)]
    assert lrs == pytest.approx([5e-4] * 8), lrs
    jt = adam_runs['jt']
    _assert_weights(adam_runs['pt'].model.state_dict(), params_from_jax(
        jax.device_get(forward_params(jt.state.params))),
        params_from_jax(adam_runs['init']))
    final = adam_runs['metrics']
    assert sorted(final) == sorted(LOGGED + ('train/rays_per_sec',))
    assert final['val/psnr'] == pytest.approx(want[('val/psnr', 6)],
                                              rel=TOL)


def test_same_checkpoints_and_manifest(adam_runs):
    ckpts = os.path.join(adam_runs['root'], 'ckpts')
    names = {n: sorted(os.listdir(os.path.join(ckpts, n)))
             for n in ('jax', 'port')}
    assert names['port'] == names['jax'] == [
        'manifest.json', 'nerf_config.json', 'step_4', 'step_8',
        'train_config.json']
    got, want = _manifest(ckpts, 'port'), _manifest(ckpts, 'jax')
    assert sorted(got) == sorted(want) == ['4', '8']
    for step in want:
        _assert_close(got[step], want[step])
        assert sorted(want[step]) == ['val/loss', 'val/psnr']
    assert checkpoints.latest_checkpoint(os.path.join(ckpts, 'port')) == \
        os.path.join(ckpts, 'port', 'step_8')
    assert checkpoints.checkpoint_step(os.path.join(ckpts, 'port',
                                                   'step_8')) == 8
    # The port's trainer wrote its configs as the JAX one did.
    cfg = checkpoints.load_config(os.path.join(ckpts, 'port', 'step_8'))
    assert cfg.num_embeddings == adam_runs['jt'].nerf_cfg.num_embeddings
    images = os.listdir(os.path.join(adam_runs['root'], 'logs', 'port',
                                     'images'))
    assert sorted(images) == sorted(
        f'val_GT_pred_depth_{s}_{i}.png' for s in (0, 3, 6)
        for i in range(3))


def test_resume_equals_the_unbroken_run(adam_runs):
    """From the step-4 checkpoint to step 8: the same final weights and
    optimizer moments as the unbroken run, exactly."""
    root, kw = adam_runs['root'], adam_runs['kw']
    ckpt = os.path.join(root, 'ckpts', 'port', 'step_4')
    resumed = _port_trainer(dict(kw, exp_name='resumed', ckpt_path=ckpt),
                            adam_runs['init'], adam_runs['jt'], root)
    assert resumed.state.step == 4
    resumed.fit()
    resumed.logger.close()
    assert resumed.state.step == 8
    unbroken = adam_runs['pt']
    for (k, a), b in zip(unbroken.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(unbroken.optimizer.state.values(),
                    resumed.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)
    logged = _logged(os.path.join(root, 'logs'), 'resumed')
    assert min(s for _, s in logged) == 5  # no sanity val on a resume


def test_ranger_matches_jax_for_7_steps(scene, tmp_path):
    """``ranger`` with ``cosine`` and a warm-up asked for, which both
    packages skip for it: a lookahead sync at the 6th update, the schedule
    moving from the 2nd."""
    root = str(tmp_path)
    kw = _train_kw(scene, root, 'jax', max_steps=7, ckpt_every_steps=None,
                   optimizer='ranger', lr=2e-3, lr_scheduler='cosine',
                   warmup_epochs=1, warmup_multiplier=2.0)
    init, jt = _run_jax(kw)
    pt = _port_trainer(dict(kw, exp_name='port'), init, jt, root)
    pt.fit()
    pt.logger.close()
    want = _logged(os.path.join(root, 'logs'), 'jax')
    _assert_close(_logged(os.path.join(root, 'logs'), 'port'), want)
    lrs = [want[('lr', s)] for s in range(1, 8)]
    assert lrs[0] == pytest.approx(2e-3) and lrs[1] < lrs[0], lrs
    init = params_from_jax(init)
    _assert_weights(pt.model.state_dict(), params_from_jax(jax.device_get(
        forward_params(jt.state.params))), init)
    _assert_weights({k: pt.optimizer.state[p]['slow']
                     for k, p in pt.model.named_parameters()},
                    params_from_jax(jax.device_get(jt.state.params.slow)),
                    init)


def test_blender_white_background_propagates(tmp_path):
    rs = np.random.RandomState(0)
    frames = []
    (tmp_path / 'train').mkdir()
    for i in range(2):
        img = (rs.rand(16, 16, 4) * 255).astype(np.uint8)
        Image.fromarray(img, 'RGBA').save(tmp_path / 'train' / f'r_{i}.png')
        c2w = np.eye(4)
        c2w[2, 3] = 4.0
        frames.append({'file_path': f'./train/r_{i}',
                       'transform_matrix': c2w.tolist()})
    for split in ('train', 'val'):
        with open(tmp_path / f'transforms_{split}.json', 'w') as f:
            json.dump({'camera_angle_x': 0.7, 'frames': frames}, f)
    cfg = port_configs.NerfConfig.from_json(tiny_nerf_config(
        num_fine_samples=0, num_coarse_samples=4, noise_std=0.0).to_json())
    assert not cfg.use_white_background
    tc = port_configs.TrainConfig(
        root_dir=str(tmp_path), dataset_name='blender', img_wh=(16, 16),
        batch_size=32, chunk=64, max_steps=2, num_sanity_val_steps=0,
        log_every=1, exp_name='b', ckpt_dir=str(tmp_path / 'ckpts'),
        log_dir=str(tmp_path / 'logs'))
    trainer = Trainer(cfg, tc, 'cpu')
    assert trainer.nerf_cfg.use_white_background
    assert trainer.model.config.use_white_background
    metrics = trainer.fit()
    assert np.isfinite(metrics['train/loss'])


def test_out_of_range_ids_raise(scene, tmp_path, monkeypatch):
    orig = port_llff.LLFFDataset.__init__

    def corrupt(self, *a, **k):
        orig(self, *a, **k)
        if hasattr(self, 'all_rays'):
            self.all_rays[:, 8] = 1000

    monkeypatch.setattr(port_llff.LLFFDataset, '__init__', corrupt)
    cfg = port_configs.NerfConfig.from_json(tiny_nerf_config().to_json())
    tc = port_configs.TrainConfig(**_train_kw(scene, str(tmp_path), 'bad'))
    with pytest.raises(ValueError, match='out of range'):
        Trainer(cfg, tc, 'cpu')


def _argv(scene, *extra):
    return ['--root_dir', scene, '--img_wh', '16', '12', '--N_samples', '8',
            '--N_importance', '8', '--batch_size', '64', '--max_steps', '7',
            '--log_every', '2', '--val_check_interval', '0.5', '--chunk',
            '64', '--exp_name', 'cli', *extra]


@pytest.fixture
def one_thread():
    """The entry point builds the flagship's widths in bf16: with torch's
    thread per core in each of the suite's workers the matrix products
    oversubscribe the cores (177 s on a loaded worker against 1.5 s
    alone); one thread takes 4.5 s."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_train_entry_point_on_the_cpu(scene, tmp_path, monkeypatch, capsys,
                                      one_thread):
    """``main(argv)`` with ``HYPERNERF_PLATFORM=cpu`` (TensorBoard's import
    is blocked: the CSV is what is read here): the dataset line, step lines
    and ``Final metrics``; checkpoints at the epoch (6 steps) and the end,
    the CSV, the val images; warm start from its own checkpoint."""
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    monkeypatch.setenv('HYPERNERF_PLATFORM', 'cpu')
    monkeypatch.chdir(tmp_path)
    trainer = port_train.main(_argv(scene, '--optimizer', 'radam',
                                    '--lr_scheduler', 'poly'))
    out = capsys.readouterr().out
    assert 'Dataset: 384 rays, 6 steps/epoch, 7 total steps' in out
    assert 'step 6/7 loss=' in out and 'Final metrics:' in out
    assert trainer.state.step == 7
    assert type(trainer.optimizer).__name__ == 'RAdam'
    ckpts = tmp_path / 'ckpts' / 'cli'
    assert sorted(n for n in os.listdir(ckpts) if n.startswith('step_')) \
        == ['step_6', 'step_7']
    manifest = json.loads((ckpts / 'manifest.json').read_text())
    assert sorted(manifest['6']) == ['val/loss', 'val/psnr']
    with open(tmp_path / 'logs' / 'cli' / 'metrics.csv') as f:
        tags = {r['tag'] for r in csv.DictReader(f)}
    assert tags == set(LOGGED) | {'train/rays_per_sec'}
    assert (tmp_path / 'logs' / 'cli' / 'images').is_dir()
    cfg = checkpoints.load_config(str(ckpts / 'step_7'))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        trainer.nerf_cfg)
    warm = port_train.main(_argv(scene, '--weight_path', str(
        ckpts / 'step_7'), '--max_steps', '1', '--exp_name', 'warm'))
    assert warm.state.step == 1


def test_train_entry_point_refusals(scene, monkeypatch):
    monkeypatch.setenv('HYPERNERF_PLATFORM', 'cpu')
    for flag in ('--num_devices', '--num_gpus'):
        # A batch of 64 over 3 ranks: refused before a rank starts.
        with pytest.raises(ValueError, match='divisible'):
            port_train.main(_argv(scene, flag, '3'))
    monkeypatch.delenv('HYPERNERF_PLATFORM')
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match='no CUDA device'):
            port_train.main(_argv(scene))
