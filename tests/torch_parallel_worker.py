"""One rank of the data-parallel tests (``tests/test_torch_parallel.py``,
``tests/test_torch_trainer_parallel.py``, ``tests/test_torch_bench.py``).

  python -m tests.torch_parallel_worker CASE DIR

runs in each of N processes whose environment holds the launch
(``HYPERNERF_COORDINATOR``, ``HYPERNERF_NUM_PROCESSES``,
``HYPERNERF_PROCESS_ID``, ``HYPERNERF_PLATFORM=cpu``,
``HYPERNERF_DIST_TIMEOUT``), so that ``maybe_initialize_distributed`` joins
them over gloo on the CPU. It reads ``DIR/inputs.pt`` and writes
``DIR/rank<r>.pt``. It imports torch and the port alone (no jax, no
conftest), on one thread.
"""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys
import time

import torch

from hypernerf_tpu_torch.configs import NerfConfig, TrainConfig
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.parallel import distributed
from hypernerf_tpu_torch.parallel.mesh import (barrier, create_mesh,
                                               gather_rows)
from hypernerf_tpu_torch.training import checkpoints
from hypernerf_tpu_torch.training.optimizers import (get_optimizer,
                                                     moment_bytes)
from hypernerf_tpu_torch.training.renderer import ImageRenderer
from hypernerf_tpu_torch.training.train_state import (TrainState,
                                                      make_train_step)

STEPS_PER_EPOCH = 100
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The process group's timeout in every rank, seconds.
DIST_TIMEOUT_S = 60


def launch(jobs, timeout: float = 150.0):
    """Run each (case, world size, directory) of ``jobs`` as a launch of
    that many rank processes, all at once; returns, per job, the ranks'
    outputs in rank order. A rank that fails, or a launch that is not done
    within ``timeout`` seconds, kills every rank and raises with their
    output."""
    started = []
    for case, world, out_dir in jobs:
        env = dict(os.environ, HYPERNERF_PLATFORM='cpu',
                   HYPERNERF_COORDINATOR=f'localhost:'
                                         f'{distributed.free_port()}',
                   HYPERNERF_NUM_PROCESSES=str(world),
                   HYPERNERF_DIST_TIMEOUT=str(DIST_TIMEOUT_S),
                   OMP_NUM_THREADS='1')
        env.pop('RANK', None)
        env.pop('WORLD_SIZE', None)
        started.append([subprocess.Popen(
            [sys.executable, '-m', 'tests.torch_parallel_worker', case,
             str(out_dir)], cwd=ROOT,
            env=dict(env, HYPERNERF_PROCESS_ID=str(r)), text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)])
    procs = [p for ranks in started for p in ranks]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if len(logs) < len(procs) or any(p.returncode for p in procs):
        raise AssertionError('a rank failed or timed out:\n'
                             + '\n'.join(log[-3000:] for log in logs))
    return [[torch.load(os.path.join(str(out_dir), f'rank{r}.pt'),
                        weights_only=False) for r in range(world)]
            for _, world, out_dir in jobs]


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _setup(mesh, inp, shard: bool, explicit: bool = True):
    nerf_cfg = NerfConfig.from_json(inp['nerf_cfg'])
    train_cfg = dataclasses.replace(TrainConfig.from_json(inp['train_cfg']),
                                    shard_optimizer_state=shard)
    model = NerfModel(nerf_cfg).train()
    model.load_state_dict(inp['weights'])
    optimizer, schedule = get_optimizer(train_cfg, model.parameters(),
                                        STEPS_PER_EPOCH, mesh=mesh)
    step_fn = make_train_step(model, optimizer, nerf_cfg, train_cfg, 'cpu',
                              schedule=schedule, explicit_batch=explicit,
                              mesh=mesh)
    return (model, TrainState(0, model, optimizer, seed=0), step_fn,
            nerf_cfg, train_cfg)


def steps_case(mesh, inp, out_dir):
    """Replicated and ZeRO-1 steps on the explicit global batch, their
    checkpoints, a step after them, ZeRO-1 ranks resumed from the
    replicated checkpoint, the rank's batch draw and the sharded render."""
    rays, rgbs = inp['rays'], inp['rgbs']
    out = {'rank': mesh.rank, 'world': mesh.world_size}
    runs = {}
    for shard in (False, True):
        model, state, step_fn, nerf_cfg, train_cfg = _setup(mesh, inp, shard)
        losses, params, moved = [], [], []
        for _ in range(2):
            before = {k: p._version for k, p in model.named_parameters()}
            metrics = step_fn(state, rays, rgbs)
            moved.append(all(p._version > before[k]
                             for k, p in model.named_parameters()))
            losses.append(metrics['loss'].item())
            params.append(_params(model))
        name = 'zero' if shard else 'rep'
        ckpt_dir = os.path.join(out_dir, f'{name}_rank{mesh.rank}')
        checkpoints.save_checkpoint(ckpt_dir, state.step, state, nerf_cfg,
                                    train_cfg)
        out[name] = dict(losses=losses, params=params, moved=moved,
                         optimizer=type(state.optimizer).__name__,
                         moment_bytes=moment_bytes(state.optimizer),
                         ckpt_dir=ckpt_dir)
        runs[name] = (model, state, step_fn)
    # The ZeRO run's next step, from the state its checkpoint holds.
    _, state, step_fn = runs['zero']
    out['zero']['next_loss'] = step_fn(state, rays, rgbs)['loss'].item()
    out['zero']['next_params'] = _params(state.model)

    # Fresh ZeRO-1 ranks resumed from the replicated run's checkpoint
    # (rank 0 wrote it): each keeps its share of the moments, then the
    # next step.
    barrier(mesh)
    model, state, step_fn, _, _ = _setup(mesh, inp, True)
    checkpoints.restore_checkpoint(
        os.path.join(out_dir, 'rep_rank0', f'step_{runs["rep"][1].step}'),
        state)
    out['zero_resumed'] = dict(
        step=state.step, moment_bytes=moment_bytes(state.optimizer),
        loss=step_fn(state, rays, rgbs)['loss'].item(),
        params=_params(model))

    # The draw: a step without draws takes this rank's indices from its
    # generator; the same step with the ranks' indices joined as the
    # global 'idx' draw must give the same parameters.
    seen = []
    orig = torch.Tensor.index_select

    def spy(self, dim, index):
        seen.append(index.clone())
        return orig(self, dim, index)

    model, state, step_fn, _, _ = _setup(mesh, inp, False, explicit=False)
    torch.Tensor.index_select = spy
    try:
        step_fn(state, rays, rgbs)
    finally:
        torch.Tensor.index_select = orig
    idx = seen[0]
    (global_idx,) = gather_rows(mesh, [idx])
    model2, state2, step_fn2, _, _ = _setup(mesh, inp, False, explicit=False)
    step_fn2(state2, rays, rgbs, draws={'idx': global_idx})
    out['draw'] = dict(idx=idx, global_idx=global_idx, same_step=all(
        torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                          model2.state_dict().values())))

    # The sharded render of a ragged ray count.
    render_model = NerfModel(NerfConfig.from_json(inp['nerf_cfg'])).eval()
    render_model.load_state_dict(inp['weights'])
    out['render'] = ImageRenderer(render_model, chunk=inp['render_chunk'],
                                  mesh=mesh)(inp['render_rays'])
    return out


def trainer_case(mesh, inp, out_dir):
    """A Trainer over the ranks on the occupancy configuration: the grid of
    each rank after its refreshes, and the files each rank wrote."""
    from hypernerf_tpu_torch.training.trainer import Trainer
    nerf_cfg = NerfConfig.from_json(inp['nerf_cfg'])
    train_cfg = dataclasses.replace(
        TrainConfig.from_json(inp['train_cfg']),
        ckpt_dir=os.path.join(out_dir, f'ckpts_rank{mesh.rank}'),
        log_dir=os.path.join(out_dir, f'logs_rank{mesh.rank}'))
    trainer = Trainer(nerf_cfg, train_cfg, 'cpu', mesh=mesh)
    trainer.fit()
    return {'rank': mesh.rank, 'step': trainer.state.step,
            'occupancy': trainer.state.occupancy.clone(),
            'params': _params(trainer.model),
            'ckpt_dir': trainer.ckpt_dir}


def eval_case(rank, inp, out_dir):
    """``python -m hypernerf_tpu_torch.eval``'s ``main`` in this rank (it
    joins the launch and leaves it itself), from a directory of its own:
    the files the rank wrote there."""
    from hypernerf_tpu_torch import eval as port_eval
    run_dir = os.path.join(out_dir, f'eval_rank{rank}')
    os.makedirs(run_dir)
    os.chdir(run_dir)
    port_eval.main(inp['argv'])
    return {'rank': rank, 'run_dir': run_dir,
            'files': sorted(os.path.relpath(os.path.join(base, name), run_dir)
                            for base, _, names in os.walk(run_dir)
                            for name in names)}


def bench_case(rank, inp, out_dir):
    """``bench.run`` of the flagship mode at the inputs' sizes: it joins the
    launch itself; its printed lines and its line."""
    from hypernerf_tpu_torch import bench
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        line = bench.run('flagship', batch_per_chip=inp['batch_per_chip'],
                         n_rays=inp['n_rays'], overrides=inp['overrides'])
    return {'rank': rank, 'line': line, 'stdout': out.getvalue()}


CASES = {'steps': steps_case, 'trainer': trainer_case}
# Cases that join the launch themselves: (rank, inputs, directory).
SELF_JOINED = {'eval': eval_case, 'bench': bench_case}


def main(case: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(out_dir, 'inputs.pt'), weights_only=False)
    if case in SELF_JOINED:
        out = SELF_JOINED[case](int(os.environ['HYPERNERF_PROCESS_ID']), inp,
                                out_dir)
    else:
        if not distributed.maybe_initialize_distributed():
            raise SystemExit('no launch in the environment')
        try:
            out = CASES[case](create_mesh(), inp, out_dir)
        finally:
            distributed.shutdown()
    torch.save(out, os.path.join(out_dir, f'rank{out["rank"]}.pt'))


if __name__ == '__main__':
    main(*sys.argv[1:])
