"""The trainer over data-parallel ranks: ``python -m hypernerf_tpu_torch.train
--num_devices 2`` as two gloo processes on the CPU
(``HYPERNERF_PLATFORM=cpu``) on ``tools/make_synthetic_scene.py``'s scene,
and ``Trainer`` with the occupancy grid over two ranks
(``tests/torch_parallel_worker.py``).

The entry point has no width flags, so it trains the flagship's widths, at
float32 here, with the draws off (``--perturb 0 --noise_std 0``: the batch
indices are the one draw) and SGD with momentum under ZeRO-1
(``--shard_optimizer_state``). A one-rank ``Trainer`` in this process,
handed each step's global batch as the two ranks' indices joined
(``train_state.step_generator`` of rank 0 and of rank 1), ends at the same
weights: parameters rtol 1e-5 / atol 1e-6, the logged losses rtol 1e-5 (the
ranks' mean of per-rank means sums in another order). SGD's update is
linear in the gradient, so that order stays in the last bits; Adam's first
steps turn such bits of a near-zero gradient into a full-rate step, which
``tests/test_torch_parallel.py`` meets by holding Adam one step at a time.
"""

import csv
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from hypernerf_tpu_torch import configs as port_configs
from hypernerf_tpu_torch.opt import configs_from_args, get_opts
from hypernerf_tpu_torch.training import checkpoints
from hypernerf_tpu_torch.training.train_state import step_generator
from hypernerf_tpu_torch.training.trainer import Trainer
from hypernerf_tpu_torch.utils.logging import MetricsLogger
from tests.conftest import tiny_nerf_config
from tests.torch_parallel_worker import DIST_TIMEOUT_S, ROOT, launch

sys.path.insert(0, os.path.join(ROOT, 'tools'))
import make_synthetic_scene  # noqa: E402

STEPS, BATCH, RANKS = 4, 64, 2
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    return make_synthetic_scene.make_scene(
        str(tmp_path_factory.mktemp('scene')), n_frames=3, width=16,
        height=12, focal=18.0)


def _argv(scene, *extra):
    return ['--root_dir', scene, '--img_wh', '16', '12', '--N_samples', '8',
            '--N_importance', '8', '--batch_size', str(BATCH),
            '--max_steps', str(STEPS), '--log_every', '1',
            '--val_check_interval', '0.5', '--chunk', '64', '--precision',
            '32', '--perturb', '0', '--noise_std', '0', '--optimizer', 'sgd',
            '--lr', '0.05', '--exp_name', 'dp', *extra]


@pytest.fixture(scope='module')
def cli_run(scene, tmp_path_factory):
    """The entry point with ``--num_devices 2 --shard_optimizer_state`` in
    a process of its own (and its two ranks), killed with its ranks after
    150 s: (its directory, its stdout)."""
    run_dir = tmp_path_factory.mktemp('cli')
    env = dict(os.environ, HYPERNERF_PLATFORM='cpu', OMP_NUM_THREADS='1',
               HYPERNERF_DIST_TIMEOUT=str(DIST_TIMEOUT_S))
    for var in ('HYPERNERF_COORDINATOR', 'RANK', 'WORLD_SIZE'):
        env.pop(var, None)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, 'tests', 'torch_train_cli.py'),
         *_argv(scene, '--num_devices', str(RANKS),
                '--shard_optimizer_state')],
        cwd=run_dir, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=150)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    return run_dir, out


def _csv_rows(path):
    with open(path) as f:
        return [(int(r['step']), r['tag'], float(r['value']))
                for r in csv.DictReader(f)]


def _one_rank_trainer(scene, root, *extra):
    """A Trainer of the entry point's configuration in this process, whose
    step takes the two ranks' joined indices."""
    nerf_cfg, train_cfg = configs_from_args(get_opts(_argv(scene, *extra)))
    train_cfg = port_configs.TrainConfig(**{
        **train_cfg.__dict__, 'ckpt_dir': os.path.join(root, 'ckpts'),
        'log_dir': os.path.join(root, 'logs')})
    trainer = Trainer(nerf_cfg, train_cfg, 'cpu', logger=MetricsLogger(
        train_cfg.log_dir, train_cfg.exp_name, use_tensorboard=False))
    step_fn = trainer.train_step
    n_rays = trainer.all_rays.shape[0]

    def joined_draws(state, all_rays, all_rgbs):
        idx = torch.cat([torch.randint(
            0, n_rays, (BATCH // RANKS,),
            generator=step_generator(state, 'cpu', rank=r))
            for r in range(RANKS)])
        return step_fn(state, all_rays, all_rgbs, draws={'idx': idx})

    trainer.train_step = joined_draws
    return trainer


def test_two_ranks_through_the_entry_point(scene, cli_run, tmp_path):
    """Rank 0 alone prints, logs and checkpoints; the final weights and
    every logged loss are those of one rank fed the same global batches."""
    run_dir, out = cli_run
    for line in ('Device mesh: 2 x cpu', 'Dataset: 384 rays, 6 steps/epoch, '
                 f'{STEPS} total steps', 'Final metrics:'):
        assert out.count(line) == 1, out
    assert sum(ln.startswith('step ') for ln in out.splitlines()) == STEPS
    ckpts = run_dir / 'ckpts' / 'dp'
    assert sorted(os.listdir(ckpts)) == [
        'manifest.json', 'nerf_config.json', f'step_{STEPS}',
        'train_config.json']
    assert sorted(os.listdir(run_dir / 'logs')) == ['dp']
    rows = _csv_rows(run_dir / 'logs' / 'dp' / 'metrics.csv')
    keys = [(step, tag) for step, tag, _ in rows]
    assert len(keys) == len(set(keys))  # one writer
    assert [s for s, t in keys if t == 'train/loss'] == list(
        range(1, STEPS + 1))

    trainer = _one_rank_trainer(scene, str(tmp_path))
    trainer.fit()
    trainer.logger.close()
    saved = checkpoints.restore_checkpoint(str(ckpts / f'step_{STEPS}'))
    assert saved['step'] == STEPS
    for k, v in trainer.model.state_dict().items():
        np.testing.assert_allclose(saved['nerf'][k].numpy(), v.numpy(),
                                   err_msg=k, **PARAM_TOL)
    want = {(s, t): v for s, t, v in _csv_rows(
        tmp_path / 'logs' / 'dp' / 'metrics.csv') if t in ('train/loss',
                                                           'val/loss')}
    got = {(s, t): v for s, t, v in rows if (s, t) in want}
    assert sorted(got) == sorted(want) and len(want) > STEPS
    np.testing.assert_allclose([got[k] for k in sorted(want)],
                               [want[k] for k in sorted(want)], rtol=1e-5)
    # The moments were gathered whole: one momentum buffer a parameter.
    state = saved['opt_state']['state']
    assert len(state) == len(saved['nerf'])
    assert all(sorted(s) == ['momentum_buffer'] for s in state.values())


def test_its_checkpoint_resumes_in_one_rank(scene, cli_run, tmp_path):
    """The 2-rank ZeRO-1 checkpoint resumes in a one-rank run, which takes
    its weights, momentum and step and trains on."""
    run_dir, _ = cli_run
    path = str(run_dir / 'ckpts' / 'dp' / f'step_{STEPS}')
    trainer = _one_rank_trainer(scene, str(tmp_path), '--ckpt_path', path,
                                '--max_steps', str(STEPS + 1))
    saved = checkpoints.restore_checkpoint(path)
    assert trainer.state.step == STEPS
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, saved['nerf'][k]), k
    for p, s in zip(trainer.model.parameters(),
                    saved['opt_state']['state'].values()):
        assert torch.equal(trainer.optimizer.state[p]['momentum_buffer'],
                           s['momentum_buffer'])
    metrics = trainer.fit()
    trainer.logger.close()
    assert trainer.state.step == STEPS + 1
    assert np.isfinite(metrics['train/loss'])


def test_eval_over_two_ranks_writes_the_one_process_frames(
        scene, cli_run, tmp_path, monkeypatch):
    """``python -m hypernerf_tpu_torch.eval`` in a launch of two ranks on
    the 2-rank checkpoint: rank 0 writes the frames, the GIF and nothing
    else, each frame the one-process eval's byte for byte; rank 1 writes
    nothing."""
    from hypernerf_tpu_torch import eval as port_eval
    run_dir, _ = cli_run
    argv = ['--root_dir', scene, '--dataset_name', 'llff', '--img_wh', '16',
            '12', '--split', 'test_train', '--ckpt_path',
            str(run_dir / 'ckpts' / 'dp' / f'step_{STEPS}'), '--scene_name',
            'synth', '--chunk', '64']
    torch.save(dict(argv=argv), tmp_path / 'inputs.pt')
    (ranks,) = launch([('eval', RANKS, tmp_path)])
    out = os.path.join('results', 'llff', 'synth')
    frames = [os.path.join(out, f'{i:03d}.png') for i in range(3)]
    assert ranks[0]['files'] == sorted(frames + [os.path.join(
        out, 'synth.gif')])
    assert ranks[1]['files'] == []
    one = tmp_path / 'one'
    one.mkdir()
    monkeypatch.chdir(one)
    monkeypatch.setenv('HYPERNERF_PLATFORM', 'cpu')
    for var in ('HYPERNERF_COORDINATOR', 'RANK', 'WORLD_SIZE'):
        monkeypatch.delenv(var, raising=False)
    port_eval.main(argv)
    for frame in frames:
        with open(one / frame, 'rb') as f, open(os.path.join(
                ranks[0]['run_dir'], frame), 'rb') as g:
            assert f.read() == g.read(), frame


def test_occupancy_grid_is_the_same_on_every_rank(scene, tmp_path):
    """``Trainer`` over two ranks with the occupancy grid refreshed at steps
    0 and 2: after the run both ranks hold the same grid, which the
    refreshes moved, and the same parameters; rank 1 wrote no file."""
    nerf_cfg = port_configs.NerfConfig.from_json(tiny_nerf_config(
        use_stratified_sampling=False, noise_std=None,
        use_occupancy_grid=True, occupancy_resolution=16).to_json())
    train_cfg = port_configs.TrainConfig(
        root_dir=scene, dataset_name='llff', img_wh=(16, 12),
        batch_size=BATCH, chunk=64, max_steps=3, log_every=1,
        val_check_interval=1.0, occupancy_update_every=2, exp_name='occ')
    torch.save(dict(nerf_cfg=nerf_cfg.to_json(),
                    train_cfg=train_cfg.to_json()), tmp_path / 'inputs.pt')
    (ranks,) = launch([('trainer', RANKS, tmp_path)])
    assert [r['step'] for r in ranks] == [3, 3]
    grid = ranks[0]['occupancy']
    assert grid.shape == (16, 16, 16)
    assert torch.equal(ranks[1]['occupancy'], grid)
    assert grid.std() > 0  # refreshed from the model's density
    for k, v in ranks[0]['params'].items():
        assert torch.equal(ranks[1]['params'][k], v), k
    assert os.path.isdir(ranks[0]['ckpt_dir'])
    assert not os.path.exists(ranks[1]['ckpt_dir'])
