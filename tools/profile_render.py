#!/usr/bin/env python
"""Where a frame's time goes: torch.profiler over full 504x378 renders of
the flagship, or one of its variants (``flagship.CONFIGS``; ``se3_split_glo``
is ``se3`` with two GLO tables), through the PyTorch port, on one CUDA card.

  python tools/profile_render.py \
      [--config flagship|static|split_glo|se3|quaternion|se3_split_glo|
                anneal|plane|occupancy|anneal_se3|anneal_quaternion|
                plane_se3|plane_quaternion|plane_anneal|plane_anneal_se3|
                plane_anneal_quaternion] \
      [--return_points] [--frames 2] [--chunk 8192] \
      [--trace render_trace.json]

``--return_points`` keeps each ray's median point as well (the per-module
path, as ``chip_smoke.py``'s frames with ``return_points`` render).
``anneal`` (and each configuration with the Nerfies encoding) renders at
the annealing alphas ``eval`` renders a weight file at (fully annealed);
``occupancy`` through ``flagship.bench_grid``.
Prints the card, the wall time per frame, the device time per frame by
kernel (largest first), the device's busy share of the wall time (the
sum of kernel times over the wall time; overlapping kernels would count
twice, and this path runs one stream) and the host's time per frame by
operator (self time, largest first). Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    from hypernerf_tpu_torch.flagship import B4_CONFIGS
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--config', default='flagship',
                        choices=('flagship', 'static', 'split_glo', 'se3',
                                 'quaternion', 'se3_split_glo', 'anneal',
                                 'plane', 'occupancy', *B4_CONFIGS))
    parser.add_argument('--return_points', action='store_true')
    parser.add_argument('--frames', type=int, default=2)
    parser.add_argument('--chunk', type=int, default=8192)
    parser.add_argument('--trace', default=None,
                        help='write a Chrome trace of the profiled frames')
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print('profile_render: no CUDA device', file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from hypernerf_tpu_torch.configs import TrainConfig
    from hypernerf_tpu_torch.eval import eval_extra_params
    from hypernerf_tpu_torch.flagship import (bench_grid, flagship_model,
                                              spiral_rays)
    from hypernerf_tpu_torch.training.renderer import ImageRenderer

    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    if args.config == 'se3_split_glo':
        model = flagship_model('cuda', config='se3', share_glo=False)
    else:
        model = flagship_model('cuda', config=args.config)
    print(f'config {args.config}'
          + (', return_points' if args.return_points else ''))
    keep = ('rgb', 'med_points') if args.return_points else ('rgb',)
    renderer = ImageRenderer(model, chunk=args.chunk, keep=keep,
                             levels=('fine',), quantize=True,
                             extra_params=eval_extra_params(model.config,
                                                            TrainConfig()),
                             occupancy_grid=bench_grid(model.config, 'cuda')
                             if model.config.use_occupancy_grid else None)
    frames = spiral_rays(range(0, 30 * (args.frames + 1), 30))
    renderer(frames[0])  # build, first launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for rays in frames[1:]:
            renderer(rays)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.frames
    # Kernel events only: a CPU op's device time repeats its kernels'.
    events = [e for e in prof.key_averages() if e.device_type.name == 'CUDA']
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 \
        / args.frames
    print(f'wall {wall * 1e3:.2f} ms/frame (under the profiler), device '
          f'{device_ms:.2f} ms/frame, busy share {device_ms / wall / 1e3:.4f}')
    for e in events[:15]:
        ms = e.self_device_time_total / 1e3 / args.frames
        print(f'{ms:10.3f} ms/frame {e.count // args.frames:6d} calls/frame  '
              f'{e.key[:90]}')
    host = [e for e in prof.key_averages() if e.device_type.name == 'CPU']
    host.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
    print('host, self time:')
    for e in host[:12]:
        ms = e.self_cpu_time_total / 1e3 / args.frames
        print(f'{ms:10.3f} ms/frame {e.count // args.frames:6d} calls/frame  '
              f'{e.key[:90]}')
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == '__main__':
    sys.exit(main())
