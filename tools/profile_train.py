#!/usr/bin/env python
"""Where a train step's time goes: torch.profiler over train steps (batch
16384, 64 + 64 samples, full widths, bf16) of the PyTorch port, on one CUDA
card, for the flagship or one of its variants (``flagship.CONFIGS``).

  python tools/profile_train.py \
      [--config flagship|static|split_glo|se3|quaternion|elastic|elastic_se3|
                elastic_quaternion|anneal|plane|anneal_se3|anneal_quaternion|
                plane_se3|plane_quaternion|plane_anneal|plane_anneal_se3|
                plane_anneal_quaternion] \
      [--steps 3] [--batch 16384] [--trace train_trace.json]

Prints the card, the wall time per step without and under the profiler, the
device time per step by kernel (largest first), the device's busy share of
the wall time (the sum of kernel times over the wall time; this path runs one
stream), and the host's side of a step: the time the host spends in the
weight repack (``pack_weights``, each module's blobs; ``pack_level``, the
level kernel's joined ones), in ``Adam.step`` and in the index draw, with
the number of kernels a step launches; with the elastic loss also in the
retraction's point-Jacobian (tensor code) and the elastic loss itself, each
with the device time of its kernels; and kernel A (``template_bwd``), a
sequence of kernels (its host time; its device time is the sum of its
``tmpl_*`` kernels). Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    from hypernerf_tpu_torch.flagship import CONFIGS
    parser.add_argument('--config', default='flagship',
                        choices=tuple(CONFIGS))
    parser.add_argument('--steps', type=int, default=3)
    parser.add_argument('--batch', type=int, default=16384)
    parser.add_argument('--trace', default=None,
                        help='write a Chrome trace of the profiled steps')
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print('profile_train: no CUDA device', file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile, record_function

    import importlib

    from hypernerf_tpu_torch.flagship import flagship_train_setup

    # The package re-exports the function under the module's name.
    level_module = importlib.import_module(
        'hypernerf_tpu_torch.kernels.fused_level')
    from hypernerf_tpu_torch.kernels import common
    from hypernerf_tpu_torch.ops import rigid_body
    from hypernerf_tpu_torch.training import train_state

    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    state, step_fn, all_rays, all_rgbs = flagship_train_setup(
        'cuda', batch_size=args.batch, config=args.config)
    print(f'config {args.config}')

    def run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step_fn(state, all_rays, all_rgbs)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    run(2)  # build, first launches
    plain_wall = run(args.steps)

    # Name the host-side pieces in the trace.
    def named(fn, name):
        def wrapped(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return wrapped

    level_module.pack_level = named(level_module.pack_level, 'pack_level')
    # Kernel A is a sequence of kernels: the range holds them all.
    mlp_module = importlib.import_module(
        'hypernerf_tpu_torch.kernels.fused_mlp')
    level_module.fused_template_bwd = mlp_module.fused_template_bwd = named(
        mlp_module.fused_template_bwd, 'template_bwd')
    mlp_module.fused_template_bwd.launches = 0  # the wrapper counts here
    common.packed = named(common.packed, 'pack_weights')
    torch.randint = named(torch.randint, 'index_draw')
    rigid_body.retraction_jacobian = named(rigid_body.retraction_jacobian,
                                           'retraction_jacobian')
    train_state.weighted_elastic_loss = named(
        train_state.weighted_elastic_loss, 'elastic_loss')
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run(args.steps)
    averages = prof.key_averages()
    # Kernel events only: a CPU op's device time, and a named range's,
    # repeats its kernels'.
    ranges = ('pack_level', 'pack_weights', 'index_draw', 'Optimizer.step',
              'retraction_jacobian', 'elastic_loss', 'template_bwd')
    events = [e for e in averages if e.device_type.name == 'CUDA'
              and not e.key.startswith(ranges)]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 \
        / args.steps
    launches = sum(e.count for e in events) / args.steps
    print(f'wall {plain_wall * 1e3:.2f} ms/step ({args.batch / plain_wall:.0f}'
          f' rays/s); under the profiler {wall * 1e3:.2f} ms/step, device '
          f'{device_ms:.2f} ms/step, busy share '
          f'{device_ms / wall / 1e3:.4f}; {launches:.0f} kernel launches and '
          f'copies per step')
    for e in events[:14]:
        ms = e.self_device_time_total / 1e3 / args.steps
        print(f'{ms:10.3f} ms/step {e.count / args.steps:7.1f} calls/step  '
              f'{100 * ms / device_ms:5.1f}%  {e.key[:80]}')
    rest = sum(e.self_device_time_total for e in events[14:]) / 1e3 \
        / args.steps
    print(f'{rest:10.3f} ms/step in {len(events) - 14} other kernels')
    # Kernel A launches its kernels through ctypes, which the profiler does
    # not file under the range: its device time is the sum of its kernels'.
    a_ms = sum(e.self_device_time_total for e in events
               if 'tmpl_' in e.key) / 1e3 / args.steps
    print(f'{a_ms:10.3f} ms/step  {100 * a_ms / device_ms:5.1f}%  kernel A '
          f'(the template backward\'s kernels, tmpl_*)')
    print('host side, ms/step of host time (the device runs on meanwhile; '
          'a range that launches many kernels also holds the time the host '
          'waits for room in the launch queue):')
    for e in averages:
        if e.key.startswith(ranges) and e.device_type.name != 'CUDA':
            print(f'{e.cpu_time_total / 1e3 / args.steps:10.3f} ms/step '
                  f'{e.count / args.steps:5.1f} calls/step  {e.key}; its '
                  f'kernels {e.device_time_total / 1e3 / args.steps:.3f} '
                  f'ms/step of device time')
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == '__main__':
    sys.exit(main())
