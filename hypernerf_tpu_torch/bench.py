"""Benchmark of the port: ``python -m hypernerf_tpu_torch.bench`` (the port of
the repository's ``bench.py``, with its modes, flags, workloads and output).

  python -m hypernerf_tpu_torch.bench [--mode flagship] \
      [--batch_per_chip 16384] [--render_chunk 16384] [--n_fine N]

The base configuration is ``bench.py``'s: 100 GLO embeddings, 64 coarse + 64
fine samples, the translation warp, the bendy sheet, sigma noise of
deviation 1, bf16 products; each mode changes it by ``mode_overrides``
(``flagship.CONFIGS``), and ``--n_fine`` sets the fine samples in every
mode (128 is the train CLI's default ``--N_importance``).

A train mode (``flagship``, ``se3``, ``quaternion``, ``anneal``,
``occupancy``, ``static``, ``plane``, ``elastic``, ``elastic_se3``,
``elastic_quaternion``) times the whole train step (``make_train_step``:
the batch drawn on the card from a synthetic buffer of 1 << 18 rays held
there, both levels with stratified jitter and sigma noise, MSE (+ the elastic
term at weight 0.01 in the ``elastic*`` modes), the backward and Adam at
5e-4 with the ``steplr`` schedule) from a seeded init at step 0: one step,
three more, then 20 on the host clock, which stops after the loss and one
parameter are read back. ``occupancy`` refreshes its grid (from zeros, as a
new train state holds it) once before the first step and every
``occupancy_update_every`` steps of the timed window from its first. It
prints ``rays_per_sec_per_chip``: 20 x the global batch over the seconds,
over the number of cards, so the value is per card.

A render mode (``render``, ``render_occupancy``) times 504 x 378 frames of
random unit directions from the origin (numpy ``RandomState(0)``, near 0,
far 1, image id 0) through ``training.renderer.ImageRenderer`` with the
fine level's rgb quantized to uint8 on the card, chunks of
``--render_chunk`` rays, on one card: one warm-up frame, then 5 timed. The
model is the port's init from seed 0; ``render_occupancy`` renders through
``flagship.bench_grid``. It prints ``secs_per_frame_504x378``.

The one JSON line (``metric``, ``value``, ``unit``, ``vs_baseline``: the
rate over 4100 rays/s, or 30 s a frame over the time; ``bench.py``'s
baselines) is the last line a run prints; a line before it gives the card,
the step's peak memory and the kernels' launches.

The run takes the CUDA card (``parallel.distributed.rank_device``);
``HYPERNERF_PLATFORM=cpu`` runs it on the CPU through the kernels' plain
versions, a smoke run only. On the card every kernel of the mode's path
must launch and no plain version may run; anything else ends the run with
an error. A train mode takes every card: inside a launch (``torchrun``, or
the ``HYPERNERF_*`` variables of ``parallel.distributed``) its ranks; else,
with more than one visible card, one rank a card (``distributed.spawn``);
else a world of one. The global batch is ``--batch_per_chip`` x the ranks;
each rank draws its share; rank 0 prints. ``bench.py``'s six TPU tile flags
(``--pipelined_bwd``, ``--pipelined_fwd``, ``--interleaved_fwd``,
``--bf16_epilogue``, ``--bwd_tile``, ``--fwd_tile``) set ``pallas_*``
fields that the port's kernels never read, so they are refused.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Optional

import numpy as np
import torch

from hypernerf_tpu_torch import flagship

BASELINE_RAYS_PER_SEC = 4100.0  # bench.py's, a GTX 2080Ti
BASELINE_SECS_PER_FRAME = 30.0  # bench.py's, a GTX 2080Ti
MODES = ('flagship', 'se3', 'quaternion', 'anneal', 'occupancy',
         'static', 'plane', 'elastic', 'elastic_se3', 'elastic_quaternion',
         'render', 'render_occupancy')
RENDER_MODES = ('render', 'render_occupancy')
# The flagship.CONFIGS entry of each mode.
MODE_CONFIGS = {**{m: m for m in MODES if m not in RENDER_MODES},
                'render': 'flagship', 'render_occupancy': 'occupancy'}
TRAIN_RAYS = 1 << 18  # the synthetic ray buffer
WARMUP_STEPS, TIMED_STEPS = 3, 20  # after the first step
W, H = 504, 378
N_FRAMES = 5  # after one warm-up frame
# The kernels each mode's path launches (``kernels.counted`` names).
_STEP = ('fused_level_fwd', 'fused_composite_fwd', 'fused_template_bwd',
         'fused_fields_bwd', 'fused_composite_bwd')
MODE_KERNELS = {
    **{m: _STEP for m in ('flagship', 'se3', 'quaternion', 'anneal',
                          'plane')},
    'occupancy': _STEP + ('fused_field_fwd', 'fused_template_fwd'),
    'static': ('fused_template_fwd', 'fused_template_bwd'),
    'elastic': _STEP + ('fused_jacobian_fwd', 'fused_jacobian_bwd'),
    'elastic_se3': _STEP + ('fused_se3_jacobian_fwd',
                            'fused_se3_jacobian_bwd'),
    'render': ('fused_level_fwd', 'fused_composite_fwd'),
    'render_occupancy': ('fused_level_fwd', 'fused_composite_fwd')}
MODE_KERNELS['elastic_quaternion'] = MODE_KERNELS['elastic_se3']


def mode_overrides(mode: str) -> dict:
    """The NerfConfig fields ``mode`` sets over the base configuration."""
    return dict(flagship.CONFIGS[MODE_CONFIGS[mode]])


def bench_overrides(n_fine: Optional[int] = None, overrides=None) -> dict:
    """NerfConfig overrides of a mode's configuration: ``n_fine`` fine
    samples, then ``overrides``."""
    out = {} if n_fine is None else dict(num_fine_samples=n_fine)
    return {**out, **(overrides or {})}


def train_workload(mode: str, batch_size: int, n_rays: int = TRAIN_RAYS,
                   device='cuda', mesh=None, overrides=None) -> dict:
    """Time ``mode``'s train step at the global batch ``batch_size`` on a
    synthetic buffer of ``n_rays`` rays (``overrides``: of its NerfConfig)
    over ``mesh``'s ranks (None: one process). Returns {'seconds' of the
    timed window, 'steps', 'batch_size', 'refreshes' of the grid in the
    window, 'loss' of the last step, 'start_step', 'config'}."""
    from hypernerf_tpu_torch.ops.occupancy import init_grid
    from hypernerf_tpu_torch.training.train_state import \
        make_occupancy_update
    config = MODE_CONFIGS[mode]
    state, step_fn, rays, rgbs = flagship.flagship_train_setup(
        device, seed=0, batch_size=batch_size, n_rays=n_rays, config=config,
        mesh=mesh, start_step=0, **(overrides or {}))
    cfg = state.model.config
    start_step = state.step
    update, refreshes = None, 0
    if cfg.use_occupancy_grid:
        # A new train state's grid is zeros; it is refreshed before the
        # first step and then at the training cadence inside the window.
        state.occupancy = init_grid(cfg.occupancy_resolution, device=device)
        train_cfg = flagship.flagship_train_config(config, batch_size)
        update = make_occupancy_update(state.model, cfg, train_cfg)
        every = train_cfg.occupancy_update_every
        update(state)
    metrics = step_fn(state, rays, rgbs)
    metrics['loss'].item()
    for _ in range(WARMUP_STEPS):
        metrics = step_fn(state, rays, rgbs)
    metrics['loss'].item()
    param = next(state.model.parameters())
    t0 = time.perf_counter()
    for i in range(TIMED_STEPS):
        if update is not None and i % every == 0:
            update(state)
            refreshes += 1
        metrics = step_fn(state, rays, rgbs)
    loss = metrics['loss'].item()
    param.reshape(-1)[0].item()
    seconds = time.perf_counter() - t0
    return dict(seconds=seconds, steps=TIMED_STEPS, batch_size=batch_size,
                refreshes=refreshes, loss=loss, start_step=start_step,
                config=cfg)


def frame_rays(n_rays: int = W * H) -> np.ndarray:
    """``bench.py``'s frame: (n_rays, 9) float32 rays of random unit
    directions (``RandomState(0)``) from the origin, near 0, far 1, id 0."""
    rs = np.random.RandomState(0)
    dirs = rs.randn(n_rays, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return np.concatenate([
        np.zeros((n_rays, 3), np.float32), dirs,
        np.zeros((n_rays, 1), np.float32), np.ones((n_rays, 1), np.float32),
        np.zeros((n_rays, 1), np.float32)], 1)


def render_workload(mode: str, chunk: int, n_rays: int = W * H,
                    device='cuda', overrides=None) -> dict:
    """Time frames of ``n_rays`` rays (``frame_rays``) of ``mode``'s model
    (``overrides``: of its NerfConfig) through ``ImageRenderer`` in chunks
    of ``chunk`` rays on ``device``: one warm-up frame, then ``N_FRAMES``.
    Returns {'seconds' a frame, 'frames', 'rgb' (n_rays, 3) uint8 of the
    last frame, 'config'}."""
    from hypernerf_tpu_torch.training.renderer import ImageRenderer
    config = MODE_CONFIGS[mode]
    model = flagship.flagship_model(device, seed=0, config=config,
                                    **(overrides or {}))
    cfg = model.config
    grid = (flagship.bench_grid(cfg, device) if cfg.use_occupancy_grid
            else None)
    renderer = ImageRenderer(model, chunk=chunk, keep=('rgb',),
                             levels=('fine',), quantize=True,
                             occupancy_grid=grid)
    rays = frame_rays(n_rays)
    renderer(rays)
    t0 = time.perf_counter()
    for _ in range(N_FRAMES):
        out = renderer(rays)
    seconds = (time.perf_counter() - t0) / N_FRAMES
    rgb = out['fine']['rgb']
    if rgb.dtype != np.uint8 or rgb.shape != (n_rays, 3):
        raise AssertionError(f'fine rgb {rgb.dtype} {rgb.shape}, want uint8 '
                             f'({n_rays}, 3)')
    return dict(seconds=seconds, frames=N_FRAMES, rgb=rgb, config=cfg)


def result_line(mode: str, result: dict, world_size: int = 1) -> dict:
    """The JSON line of a run: ``bench.py``'s keys; a train mode's rate is
    per card."""
    if mode in RENDER_MODES:
        secs = result['seconds']
        return {'metric': 'secs_per_frame_504x378', 'value': round(secs, 4),
                'unit': 's',
                'vs_baseline': round(BASELINE_SECS_PER_FRAME / secs, 2)}
    rate = (result['steps'] * result['batch_size'] / result['seconds']
            / world_size)
    return {'metric': 'rays_per_sec_per_chip', 'value': round(rate, 1),
            'unit': 'rays/s',
            'vs_baseline': round(rate / BASELINE_RAYS_PER_SEC, 2)}


def _counts():
    from hypernerf_tpu_torch.kernels import counted
    wrappers, plains = counted()
    return ({k: fn.launches for k, fn in wrappers.items()},
            {k: fn.calls for k, fn in plains.items()})


def run(mode: str = 'flagship', batch_per_chip: int = 16384,
        render_chunk: int = 16384, n_fine: Optional[int] = None,
        n_rays: Optional[int] = None, overrides=None) -> dict:
    """One run of ``mode`` in this process: join the launch of the
    environment where there is one (a render mode then renders on each
    rank's card alone), run the workload
    (``n_rays``: the train buffer's or the frame's rays, default the
    CLI's), check on the card that the mode's kernels launched and no plain
    version ran, and print the JSON line on rank 0. Returns the line."""
    from hypernerf_tpu_torch.parallel import distributed
    from hypernerf_tpu_torch.parallel.mesh import create_mesh
    if mode not in MODES:
        raise ValueError(f'mode {mode!r}: one of {MODES}')
    render = mode in RENDER_MODES
    joined = distributed.maybe_initialize_distributed()
    try:
        mesh = create_mesh() if joined else None
        device = mesh.device if mesh else distributed.rank_device()
        # A render runs on the rank's card alone, with no mesh.
        world = mesh.world_size if mesh and not render else 1
        over = bench_overrides(n_fine, overrides)
        if device.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(device)
        before = _counts()
        if render:
            result = render_workload(mode, render_chunk,
                                     n_rays or W * H, device, over)
        else:
            result = train_workload(mode, batch_per_chip * world,
                                    n_rays or TRAIN_RAYS, device, mesh,
                                    over)
        after = _counts()
        launches = {k: v - before[0][k] for k, v in after[0].items()
                    if v > before[0][k]}
        plain = {k: v - before[1][k] for k, v in after[1].items()
                 if v > before[1][k]}
        line = result_line(mode, result, world)
        if device.type == 'cuda':
            missing = [k for k in MODE_KERNELS[mode] if k not in launches]
            if plain or missing:
                raise RuntimeError(f'{mode}: plain versions ran on the card '
                                   f'({plain}) or kernels did not launch '
                                   f'({missing}); launches {launches}')
        if not math.isfinite(line['value']) or not line['value'] > 0:
            raise RuntimeError(f'{mode}: {line}')
        if mesh is None or mesh.is_primary:
            cfg = result['config']
            where = (torch.cuda.get_device_name(device)
                     if device.type == 'cuda' else 'cpu')
            peak = (f'{torch.cuda.max_memory_allocated(device) / 2 ** 30:.2f}'
                    f' GiB' if device.type == 'cuda' else 'not measured')
            size = (f'{result["frames"]} frames of {n_rays or W * H} rays, '
                    f'chunk {render_chunk}' if render else
                    f'batch {result["batch_size"]} ({batch_per_chip} a '
                    f'rank), {result["steps"]} steps from step '
                    f'{result["start_step"]}, {result["refreshes"]} grid '
                    f'refreshes in the window, loss {result["loss"]:.5f}')
            print(f'bench {mode}: {world} x {where}; '
                  f'{cfg.num_coarse_samples}+{cfg.num_fine_samples} samples;'
                  f' {size}; {result["seconds"]:.4f} s; peak memory {peak};'
                  f' launches {launches}; plain calls {plain}', flush=True)
            print(json.dumps(line), flush=True)
        return line
    finally:
        if joined:
            distributed.shutdown()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m hypernerf_tpu_torch.bench',
        description='Train-step rays/s per card or render s/frame of the '
                    'port (bench.py\'s modes).')
    parser.add_argument('--mode', choices=MODES, default='flagship')
    parser.add_argument('--batch_per_chip', type=int, default=16384,
                        help='rays a step on each card')
    parser.add_argument('--render_chunk', type=int, default=16384,
                        help='rays a chunk in the render modes')
    parser.add_argument('--n_fine', type=int, default=None,
                        help='fine samples a ray in every mode (default: '
                             'the mode\'s; 128 is the train CLI\'s)')
    return parser.parse_args(argv)


def main(argv=None) -> None:
    """Run ``argv``'s mode (default: the command line) and print its JSON
    line; a train mode outside a launch with more than one visible card
    starts one rank a card and returns when they end."""
    from hypernerf_tpu_torch.parallel import distributed
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if (args.mode not in RENDER_MODES and distributed.launch_env() is None
            and distributed.rank_device().type == 'cuda'
            and torch.cuda.device_count() > 1):
        distributed.spawn(main, torch.cuda.device_count(), (argv,))
        return
    run(args.mode, args.batch_per_chip, args.render_chunk, args.n_fine)


if __name__ == '__main__':
    main()
