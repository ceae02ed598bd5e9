"""The port's bench entry point (``python -m hypernerf_tpu_torch.bench``)
against the repository's ``bench.py``, on the CPU (the CLI's default 64 +
128 samples against the JAX package: ``tests/test_torch_fine128.py``).

- each mode's NerfConfig overrides equal ``bench.mode_overrides`` (the root
  ``bench.py``, whose module level imports no JAX), and the base
  configuration is ``bench.py``'s;
- argparse refuses ``bench.py``'s six TPU tile flags;
- the JSON line's keys and the per-card arithmetic;
- the train workload at narrow widths and a few hundred rays (its step
  counts, ``anneal`` from step 0, ``occupancy``'s grid from zeros, refreshed
  before the first step and every ``occupancy_update_every`` steps of the
  window from its first) and the render workload (uint8 rgb, the
  renderer's frame);
- one printed line in a world of one, and in a gloo world of two
  (``tests/torch_parallel_worker.py``'s launch: a 60 s group timeout, the
  launch killed after 150 s) with the batch ``--batch_per_chip`` x 2 and
  rank 1 silent.

About 15 s on one worker.
"""

import json

import numpy as np
import pytest
import torch

import bench as jax_bench
from hypernerf_tpu_torch import bench, configs as port_configs
from hypernerf_tpu_torch.flagship import flagship_config
from hypernerf_tpu_torch.training import train_state
from hypernerf_tpu_torch.training.renderer import ImageRenderer
from tests import torch_parallel_worker

# bench.py:166-175, the base configuration of every mode.
BENCH_BASE = dict(num_embeddings=100, num_coarse_samples=64,
                  num_fine_samples=64, use_warp=True,
                  warp_field_type='translation',
                  hyper_slice_method='bendy_sheet', noise_std=1.0,
                  compute_dtype='bfloat16')
TILE_FLAGS = ('--pipelined_bwd', '--pipelined_fwd', '--interleaved_fwd',
              '--bf16_epilogue', '--bwd_tile', '--fwd_tile')
# Narrow widths for the workloads on the CPU.
SMALL = dict(warp_depth=2, warp_width=16, warp_freq=4, hyper_sheet_depth=2,
             hyper_sheet_width=16, hyper_sheet_freq=3, xyz_freq=4,
             hyper_freq=2, dir_freq=2, trunk_depth=2, trunk_width=32,
             rgb_branch_depth=1, rgb_branch_width=16, skips=(1,),
             compute_dtype='float32', num_coarse_samples=8,
             num_fine_samples=8, occupancy_resolution=8)
N_RAYS, BATCH = 256, 16


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One torch thread: the workloads are small, and the suite's workers
    share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Modes, flags and the line.


def test_modes_and_overrides_are_bench_pys():
    assert bench.MODES == jax_bench.MODES
    assert bench.BASELINE_RAYS_PER_SEC == jax_bench.BASELINE_RAYS_PER_SEC
    assert bench.BASELINE_SECS_PER_FRAME == \
        jax_bench.BASELINE_SECS_PER_FRAME
    for mode in bench.MODES:
        assert bench.mode_overrides(mode) == jax_bench.mode_overrides(mode)
        for n_fine in (None, 128):
            over = bench.bench_overrides(n_fine)
            got = flagship_config(bench.MODE_CONFIGS[mode], **over)
            want = port_configs.NerfConfig(**{
                **BENCH_BASE, **jax_bench.mode_overrides(mode), **over})
            assert got == want, mode
    assert flagship_config('flagship', **bench.bench_overrides(
        128)).num_fine_samples == 128


@pytest.mark.parametrize('flag', TILE_FLAGS)
def test_the_tile_flags_are_refused(flag, capsys):
    with pytest.raises(SystemExit):
        bench.parse_args(['--mode', 'flagship', flag, '1'])
    assert 'unrecognized arguments' in capsys.readouterr().err


def test_the_cli_fixes_the_run(monkeypatch):
    calls = []
    monkeypatch.setattr(bench, 'run', lambda *a: calls.append(a))
    monkeypatch.setenv('HYPERNERF_PLATFORM', 'cpu')
    bench.main(['--mode', 'render', '--n_fine', '128'])
    bench.main([])
    assert calls == [('render', 16384, 16384, 128),
                     ('flagship', 16384, 16384, None)]
    with pytest.raises(SystemExit):
        bench.parse_args(['--mode', 'split_glo'])


@pytest.mark.parametrize('mode', ['flagship', 'render'])
def test_the_card_is_required_unless_the_cpu_is_asked_for(mode,
                                                          monkeypatch):
    """No card and no ``HYPERNERF_PLATFORM=cpu``: the run stops before any
    work, as ``train`` and ``eval`` do (``distributed.rank_device``)."""
    monkeypatch.delenv('HYPERNERF_PLATFORM', raising=False)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for var in ('HYPERNERF_COORDINATOR', 'RANK', 'WORLD_SIZE'):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match='no CUDA device'):
        bench.main(['--mode', mode])


def test_the_line_and_the_per_card_rate():
    result = dict(steps=20, batch_size=32768, seconds=4.0)
    line = bench.result_line('flagship', result, world_size=2)
    assert list(line) == ['metric', 'value', 'unit', 'vs_baseline']
    assert line['metric'] == 'rays_per_sec_per_chip'
    assert line['unit'] == 'rays/s'
    assert line['value'] == 20 * 32768 / 4.0 / 2 == 81920.0
    assert line['vs_baseline'] == round(81920.0 / 4100.0, 2)
    line = bench.result_line('render_occupancy', dict(seconds=0.25))
    assert line == {'metric': 'secs_per_frame_504x378', 'value': 0.25,
                    'unit': 's', 'vs_baseline': 120.0}


# ---------------------------------------------------------------------------
# The workloads at narrow widths.


def test_train_workload_steps_and_anneal_from_step_zero(monkeypatch):
    steps = []
    real = train_state.compute_extra_params

    def spy(nerf_cfg, train_cfg, step):
        steps.append(step)
        return real(nerf_cfg, train_cfg, step)

    monkeypatch.setattr(train_state, 'compute_extra_params', spy)
    torch.manual_seed(0)
    out = bench.train_workload('anneal', BATCH, N_RAYS, 'cpu',
                               overrides=SMALL)
    assert out['start_step'] == 0
    assert steps == list(range(1 + bench.WARMUP_STEPS + bench.TIMED_STEPS))
    assert out['steps'] == bench.TIMED_STEPS == 20
    assert out['batch_size'] == BATCH and out['refreshes'] == 0
    assert np.isfinite(out['loss']) and out['seconds'] > 0
    assert out['config'].use_original_embed is False
    # At step 0 the hyper window is shut: bench.py's anneal starts there.
    assert real(out['config'], port_configs.TrainConfig(),
                0)['hyper_alpha'] == 0.0


def test_occupancy_refreshes_at_the_training_cadence(monkeypatch):
    seen = []
    real = train_state.make_occupancy_update

    def spy(model, nerf_cfg, train_cfg):
        update = real(model, nerf_cfg, train_cfg)

        def counted(state):
            seen.append((state.step, float(state.occupancy.abs().sum())))
            return update(state)
        return counted

    monkeypatch.setattr(train_state, 'make_occupancy_update', spy)
    out = bench.train_workload('occupancy', BATCH, N_RAYS, 'cpu',
                               overrides=SMALL)
    every = port_configs.TrainConfig().occupancy_update_every
    assert every == 16
    first = 1 + bench.WARMUP_STEPS
    want = [0] + [first + i for i in range(bench.TIMED_STEPS)
                  if i % every == 0]
    assert [s for s, _ in seen] == want == [0, 4, 20]
    assert seen[0][1] == 0.0  # the grid starts at zeros, as a new state's
    assert out['refreshes'] == 2
    assert out['config'].use_occupancy_grid
    assert (out['config'].num_coarse_samples,
            out['config'].num_fine_samples) == (8, 8)


@pytest.mark.parametrize('mode', ['render', 'render_occupancy'])
def test_render_workload(mode):
    out = bench.render_workload(mode, 64, 200, 'cpu', overrides=SMALL)
    rgb = out['rgb']
    assert rgb.dtype == np.uint8 and rgb.shape == (200, 3)
    assert out['frames'] == bench.N_FRAMES == 5 and out['seconds'] > 0
    rays = bench.frame_rays(200)
    assert rays.shape == (200, 9)
    np.testing.assert_allclose(np.linalg.norm(rays[:, 3:6], axis=-1), 1.0,
                               rtol=1e-6)
    assert (rays[:, :3] == 0).all() and (rays[:, 6] == 0).all()
    assert (rays[:, 7] == 1).all() and (rays[:, 8] == 0).all()
    np.testing.assert_array_equal(bench.frame_rays()[:200], rays)
    # The frame is the renderer's on the same seeded model (and grid).
    from hypernerf_tpu_torch.flagship import bench_grid, flagship_model
    model = flagship_model('cpu', 0, bench.MODE_CONFIGS[mode], **SMALL)
    grid = (bench_grid(model.config, 'cpu')
            if mode == 'render_occupancy' else None)
    want = ImageRenderer(model, chunk=64, keep=('rgb',), levels=('fine',),
                         quantize=True, occupancy_grid=grid)(rays)
    np.testing.assert_array_equal(rgb, want['fine']['rgb'])


def test_run_prints_one_line_last(monkeypatch, capsys):
    monkeypatch.setenv('HYPERNERF_PLATFORM', 'cpu')
    for var in ('HYPERNERF_COORDINATOR', 'RANK', 'WORLD_SIZE'):
        monkeypatch.delenv(var, raising=False)
    line = bench.run('static', batch_per_chip=BATCH, n_rays=N_RAYS,
                     overrides=SMALL)
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == line
    assert sum(ln.startswith('{') for ln in out) == 1
    assert f'batch {BATCH} ({BATCH} a rank)' in out[-2]
    assert line['value'] > 0


def test_a_gloo_world_of_two_prints_once(tmp_path):
    torch.save({'batch_per_chip': BATCH, 'n_rays': N_RAYS,
                'overrides': SMALL}, tmp_path / 'inputs.pt')
    ranks, = torch_parallel_worker.launch([('bench', 2, tmp_path)])
    lines = [r['stdout'].strip().splitlines() for r in ranks]
    assert lines[1] == []
    assert len(lines[0]) == 2
    line = json.loads(lines[0][-1])
    assert line == ranks[0]['line']
    assert '2 x cpu' in lines[0][0]
    assert f'batch {2 * BATCH} ({BATCH} a rank)' in lines[0][0]
    assert line['metric'] == 'rays_per_sec_per_chip' and line['value'] > 0
