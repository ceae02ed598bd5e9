"""Data parallelism in the port (``hypernerf_tpu_torch/parallel``, the
all-reduced and ZeRO-1 train step, the sharded render, checkpoints written
by rank 0) on gloo ranks on the CPU, each a process of its own
(``tests/torch_parallel_worker.py``, worlds of 2 and 4 launched together),
against the port's one-rank step and the JAX package's step on an N-device
mesh (the conftest's 8 CPU devices).

Model: the conftest's ``tiny_nerf_config`` with
``use_stratified_sampling=False, noise_std=None`` (no draws but the batch),
float32; the explicit global batch of ``tests/dist_util.smooth_ray_batch``
(64 rays); Adam at 1e-3.

Tolerances. N ranks against one, and ZeRO-1 against replicated: those of
the JAX package's own tests (``tests/test_train.py``), loss rtol 1e-6 /
atol 1e-7, parameters and moments rtol 1e-5 / atol 1e-6 (the ranks' mean of
per-rank means sums in another order than one rank's mean). Against the JAX
step: those of ``tests/test_torch_train_step.py``, loss 1e-5, parameters
1e-5. A checkpoint of ZeRO-1 equals a replicated run's exactly, and the
sharded render the one-rank render exactly: the same operations on the same
numbers.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.configs import TrainConfig as JaxTrainConfig
from hypernerf_tpu.models.nerf import NerfModel as JaxNerfModel
from hypernerf_tpu.parallel.mesh import create_mesh as jax_create_mesh
from hypernerf_tpu.parallel.mesh import replicate as jax_replicate
from hypernerf_tpu.parallel.mesh import shard_batch as jax_shard_batch
from hypernerf_tpu.training.optimizers import get_optimizer as jax_optimizer
from hypernerf_tpu.training.train_state import (create_train_state,
                                                make_train_step as
                                                jax_make_train_step)
from hypernerf_tpu_torch import configs as port_configs
from hypernerf_tpu_torch.convert import params_from_jax, params_to_jax
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.parallel import distributed
from hypernerf_tpu_torch.parallel.mesh import (DataParallel, create_mesh,
                                               shard_batch)
from hypernerf_tpu_torch.training import checkpoints
from hypernerf_tpu_torch.training.optimizers import get_optimizer
from hypernerf_tpu_torch.training.renderer import ImageRenderer
from hypernerf_tpu_torch.training.train_state import (TrainState,
                                                      make_train_step,
                                                      step_generator)
from tests.conftest import tiny_nerf_config
from tests.dist_util import smooth_ray_batch
from tests.torch_parallel_worker import STEPS_PER_EPOCH, launch

WORLDS = (2, 4)
BATCH = 64
CFG = dict(use_stratified_sampling=False, noise_std=None)
TRAIN = dict(batch_size=BATCH, lr=1e-3)
RENDER_RAYS, RENDER_CHUNK = 37, 8  # 5 chunks: ragged over 2 and 4 ranks
LOSS_TOL = dict(rtol=1e-6, atol=1e-7)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_cfg():
    return tiny_nerf_config(**CFG)


def _port_cfg():
    return port_configs.NerfConfig.from_json(_jax_cfg().to_json())


@pytest.fixture(scope='module')
def setup():
    """The flax init (as the JAX tests make it), the batch and the rays of
    the render, as numpy."""
    rays, rgbs = smooth_ray_batch(BATCH)
    tc = JaxTrainConfig(**TRAIN)
    state = create_train_state(JaxNerfModel(_jax_cfg()),
                               jax_optimizer(tc, STEPS_PER_EPOCH), tc,
                               jax.random.PRNGKey(0), rays[:8])
    params = jax.tree.map(np.array, jax.device_get(state.params))
    rs = np.random.RandomState(5)
    render_rays = np.concatenate(
        [smooth_ray_batch(RENDER_RAYS)[0][:, :8],
         rs.randint(0, 4, (RENDER_RAYS, 1)).astype(np.float32)], 1)
    return dict(params=params, rays=rays, rgbs=rgbs, render_rays=render_rays)


@pytest.fixture(scope='module')
def runs(setup, tmp_path_factory):
    """{world size: [each rank's outputs]} of the worker's 'steps' case."""
    jobs = []
    for n in WORLDS:
        out_dir = tmp_path_factory.mktemp(f'world{n}')
        torch.save(dict(
            nerf_cfg=_port_cfg().to_json(),
            train_cfg=port_configs.TrainConfig(**TRAIN).to_json(),
            weights=params_from_jax(setup['params']),
            rays=torch.from_numpy(setup['rays']),
            rgbs=torch.from_numpy(setup['rgbs']),
            render_rays=setup['render_rays'], render_chunk=RENDER_CHUNK),
            out_dir / 'inputs.pt')
        jobs.append(('steps', n, out_dir))
    return dict(zip(WORLDS, launch(jobs)))


def _one_rank(setup, steps: int, shard=False):
    """The port's step in this process alone: (model, state, step_fn) after
    ``steps`` explicit steps on the global batch."""
    train_cfg = port_configs.TrainConfig(**TRAIN, shard_optimizer_state=shard)
    model = NerfModel(_port_cfg()).train()
    model.load_state_dict(params_from_jax(setup['params']))
    optimizer, schedule = get_optimizer(train_cfg, model.parameters(),
                                        STEPS_PER_EPOCH)
    step_fn = make_train_step(model, optimizer, _port_cfg(), train_cfg,
                              'cpu', schedule=schedule, explicit_batch=True)
    state = TrainState(0, model, optimizer, seed=0)
    losses = [step_fn(state, torch.from_numpy(setup['rays']),
                      torch.from_numpy(setup['rgbs']))['loss'].item()
              for _ in range(steps)]
    return model, state, step_fn, losses


def _assert_params(got, want, tol=PARAM_TOL):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   err_msg=k, **tol)


@pytest.mark.parametrize('n', WORLDS)
def test_n_ranks_equal_one_rank(setup, runs, n):
    """An explicit-batch step of N ranks on the global batch: the loss and
    the parameters of the one-rank step on that batch, on every rank."""
    model, _, _, losses = _one_rank(setup, 1)
    one = {k: v.detach() for k, v in model.state_dict().items()}
    for out in runs[n]:
        assert out['world'] == n
        np.testing.assert_allclose(out['rep']['losses'][0], losses[0],
                                   **LOSS_TOL)
        _assert_params(out['rep']['params'][0], one)
    first = runs[n][0]['rep']['params'][1]
    for out in runs[n][1:]:
        for k, v in out['rep']['params'][1].items():
            assert torch.equal(v, first[k]), k  # replicated bit for bit


@pytest.mark.parametrize('n', WORLDS)
def test_n_ranks_equal_the_jax_mesh_step(setup, runs, n):
    """The port's N-rank step from the converted weights against JAX's
    ``make_train_step(..., create_mesh(num_devices=N), explicit_batch=True)``
    on the same global batch."""
    cfg = _jax_cfg()
    tc = JaxTrainConfig(**TRAIN)
    tx = jax_optimizer(tc, STEPS_PER_EPOCH)
    mesh = jax_create_mesh(num_devices=n)
    model = JaxNerfModel(cfg)
    state = create_train_state(model, tx, tc, jax.random.PRNGKey(0),
                               setup['rays'][:8])
    state = jax_replicate(mesh, state)
    step_fn = jax_make_train_step(model, tx, cfg, tc, mesh,
                                  explicit_batch=True)
    state, metrics = step_fn(
        state, jax_shard_batch(mesh, jnp.asarray(setup['rays'])),
        jax_shard_batch(mesh, jnp.asarray(setup['rgbs'])),
        jax.random.PRNGKey(1))
    want = dict(_flat(jax.device_get(state.params)))
    for out in runs[n]:
        assert abs(out['rep']['losses'][0]
                   - float(jax.device_get(metrics['loss']))) <= 1e-5
        got = dict(_flat(params_to_jax(out['rep']['params'][0])))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert np.abs(got[k] - v).max() <= 1e-5, k


def _flat(tree, prefix=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f'{prefix}{k}/')
        else:
            yield f'{prefix}{k}', np.asarray(v)


@pytest.mark.parametrize('n', WORLDS)
def test_zero1_matches_replicated(runs, n):
    """Two steps with ``shard_optimizer_state`` against two replicated
    steps: loss, parameters and the moments gathered to rank 0; each rank
    holds a strict share of the moments' bytes, the shares add up to the
    replicated optimizer's, and every parameter's version moved on every
    rank at each step (the level kernels' packed weights follow it)."""
    shares = []
    for out in runs[n]:
        rep, zero = out['rep'], out['zero']
        assert zero['optimizer'] == 'ZeroOptimizer'
        assert rep['optimizer'] == 'Adam'
        np.testing.assert_allclose(zero['losses'], rep['losses'], **LOSS_TOL)
        for got, want in zip(zero['params'], rep['params']):
            _assert_params(got, want)
        assert zero['moved'] == rep['moved'] == [True, True]
        assert 0 < zero['moment_bytes'] < rep['moment_bytes']
        shares.append(zero['moment_bytes'])
    assert sum(shares) == runs[n][0]['rep']['moment_bytes']
    want = _ckpt(runs[n][0]['rep'])['opt_state']['state']
    got = _ckpt(runs[n][0]['zero'])['opt_state']['state']
    assert sorted(got) == sorted(want)
    for i in want:
        assert sorted(got[i]) == sorted(want[i]) == ['exp_avg',
                                                     'exp_avg_sq', 'step']
        for k in want[i]:
            np.testing.assert_allclose(got[i][k].numpy(),
                                       want[i][k].numpy(), **PARAM_TOL)


def _ckpt(run, step=2):
    return checkpoints.restore_checkpoint(
        os.path.join(run['ckpt_dir'], f'step_{step}'))


def test_zero1_checkpoint_equals_replicated_and_resumes_on_one_rank(
        setup, runs):
    """A 2-rank ZeRO-1 run's checkpoint equals a 2-rank replicated run's,
    tensor for tensor; a one-rank run resumed from it takes the 2-rank
    run's next step; only rank 0 wrote files."""
    rank0, rank1 = runs[2]
    zero, rep = _ckpt(rank0['zero']), _ckpt(rank0['rep'])
    assert sorted(zero) == sorted(rep) == ['nerf', 'opt_state', 'step']
    assert zero['step'] == rep['step'] == 2
    for k, v in rep['nerf'].items():
        assert torch.equal(zero['nerf'][k], v), k
    assert zero['opt_state']['param_groups'] == \
        rep['opt_state']['param_groups']
    for i, state in rep['opt_state']['state'].items():
        for k, v in state.items():
            assert torch.equal(zero['opt_state']['state'][i][k], v), (i, k)
    for run in ('zero', 'rep'):
        assert sorted(os.listdir(rank0[run]['ckpt_dir'])) == [
            'manifest.json', 'nerf_config.json', 'step_2',
            'train_config.json']
        assert not os.path.exists(rank1[run]['ckpt_dir'])

    loss, params = _resumed_one_rank(setup, rank0['zero'])
    for out in runs[2]:
        np.testing.assert_allclose(loss, out['zero']['next_loss'],
                                   **LOSS_TOL)
        _assert_params(out['zero']['next_params'], params)


def _resumed_one_rank(setup, run):
    """(loss, parameters) of the one-rank step after ``run``'s step-2
    checkpoint."""
    model, state, step_fn, _ = _one_rank(setup, 0)
    checkpoints.restore_checkpoint(
        os.path.join(run['ckpt_dir'], 'step_2'), state)
    assert state.step == 2
    loss = step_fn(state, torch.from_numpy(setup['rays']),
                   torch.from_numpy(setup['rgbs']))['loss'].item()
    return loss, model.state_dict()


@pytest.mark.parametrize('n', WORLDS)
def test_zero1_ranks_resume_the_replicated_checkpoint(setup, runs, n):
    """N fresh ZeRO-1 ranks restore the replicated run's step-2 checkpoint:
    each keeps a strict share of the moments, the shares add up to the
    replicated optimizer's, and their next step is the one-rank next step
    from that checkpoint."""
    loss, params = _resumed_one_rank(setup, runs[n][0]['rep'])
    shares = []
    for out in runs[n]:
        resumed = out['zero_resumed']
        assert resumed['step'] == 2
        np.testing.assert_allclose(resumed['loss'], loss, **LOSS_TOL)
        _assert_params(resumed['params'], params)
        assert 0 < resumed['moment_bytes'] < out['rep']['moment_bytes']
        shares.append(resumed['moment_bytes'])
    assert sum(shares) == runs[n][0]['rep']['moment_bytes']


@pytest.mark.parametrize('n', WORLDS)
def test_sharded_render_equals_one_rank(setup, runs, n):
    """37 rays in chunks of 8 over N ranks (padded to 8 N): every rank holds
    the one-rank frame, both levels, every output, bit for bit."""
    model = NerfModel(_port_cfg()).eval()
    model.load_state_dict(params_from_jax(setup['params']))
    want = ImageRenderer(model, chunk=RENDER_CHUNK)(setup['render_rays'])
    assert sorted(want) == ['coarse', 'fine']
    for out in runs[n]:
        got = out['render']
        assert sorted(got) == sorted(want)
        for level in want:
            assert sorted(got[level]) == sorted(want[level])
            for k, v in want[level].items():
                assert v.shape[0] == RENDER_RAYS
                np.testing.assert_array_equal(got[level][k], v,
                                              err_msg=f'{level}/{k}')


def test_rank_draws(runs):
    """Rank 0 of a world of one draws what a single process drew before
    ranks existed (the generator's seed is (seed, step) alone); the ranks
    of a world of two draw different indices, each from its own generator,
    which is what the step takes (the same step with the ranks' indices
    passed in as the global draw gives the same parameters)."""
    state = types.SimpleNamespace(step=5, seed=7)
    assert step_generator(state, 'cpu').initial_seed() == 7 * 1_000_003 + 5
    assert step_generator(state, 'cpu', stream=1).initial_seed() == \
        7 * 1_000_003 + 5 + (1 << 40)
    assert step_generator(state, 'cpu', rank=1).initial_seed() != \
        step_generator(state, 'cpu').initial_seed()
    for n in WORLDS:
        idx = [out['draw']['idx'] for out in runs[n]]
        assert all(i.shape == (BATCH // n,) for i in idx)
        for out in runs[n]:
            assert out['draw']['same_step']
            assert torch.equal(out['draw']['global_idx'], torch.cat(idx))
        for r in range(1, n):
            assert not torch.equal(idx[r], idx[0])
        gen = step_generator(types.SimpleNamespace(step=0, seed=0), 'cpu',
                             rank=1)
        assert torch.equal(idx[1], torch.randint(0, BATCH, (BATCH // n,),
                                                 generator=gen))


def test_batch_must_divide_the_ranks(setup):
    """A batch that the ranks do not divide raises, in the step and in
    ``shard_batch``."""
    model = NerfModel(_port_cfg())
    train_cfg = port_configs.TrainConfig(batch_size=BATCH + 2)
    optimizer, _ = get_optimizer(train_cfg, model.parameters(), 10)
    mesh = DataParallel(world_size=4, rank=1)
    with pytest.raises(ValueError, match='divisible'):
        make_train_step(model, optimizer, _port_cfg(), train_cfg, 'cpu',
                        mesh=mesh)
    with pytest.raises(ValueError, match='divisible'):
        shard_batch(mesh, torch.zeros(BATCH + 2, 9))
    assert torch.equal(shard_batch(mesh, torch.arange(8.0)),
                       torch.tensor([2.0, 3.0]))


LAUNCH_VARS = ('HYPERNERF_COORDINATOR', 'HYPERNERF_NUM_PROCESSES',
               'HYPERNERF_PROCESS_ID', 'RANK', 'WORLD_SIZE', 'LOCAL_RANK',
               'MASTER_ADDR', 'MASTER_PORT')


def test_environment(monkeypatch):
    """``maybe_initialize_distributed`` does nothing without a launch in the
    environment, and joins the one the ``HYPERNERF_*`` variables (or
    torchrun's) describe."""
    import torch.distributed as dist
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv('HYPERNERF_PLATFORM', 'cpu')
    assert distributed.launch_env() is None
    assert distributed.maybe_initialize_distributed() is False
    assert not dist.is_initialized() and distributed.is_primary_host()
    mesh = create_mesh()
    assert (mesh.world_size, mesh.rank, mesh.joined) == (1, 0, False)

    monkeypatch.setenv('RANK', '3')
    monkeypatch.setenv('WORLD_SIZE', '4')
    monkeypatch.setenv('LOCAL_RANK', '1')
    assert distributed.launch_env() == dict(
        init_method='env://', world_size=4, rank=3, local_rank=1)
    for var in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK'):
        monkeypatch.delenv(var)

    monkeypatch.setenv('HYPERNERF_COORDINATOR',
                       f'localhost:{distributed.free_port()}')
    monkeypatch.setenv('HYPERNERF_NUM_PROCESSES', '2')
    monkeypatch.setenv('HYPERNERF_PROCESS_ID', '2')
    with pytest.raises(ValueError, match='outside a world'):
        distributed.launch_env()
    monkeypatch.setenv('HYPERNERF_NUM_PROCESSES', '1')
    monkeypatch.setenv('HYPERNERF_PROCESS_ID', '0')
    monkeypatch.setenv('HYPERNERF_DIST_TIMEOUT', '30')
    assert distributed.dist_timeout().total_seconds() == 30
    try:
        assert distributed.maybe_initialize_distributed() is True
        assert dist.is_initialized() and dist.get_backend() == 'gloo'
        mesh = create_mesh(num_devices=1)
        assert (mesh.world_size, mesh.rank, mesh.joined) == (1, 0, True)
        assert mesh.device == torch.device('cpu')
        with pytest.raises(ValueError, match='launch of 1'):
            create_mesh(num_devices=2)
    finally:
        distributed.shutdown()
    assert not dist.is_initialized()
