#!/usr/bin/env python3
"""Profile the float32 kernels (``--precision 32``: rows 1, 9 and 5 at
float32, ``kernels/f32.py``) on the card: one call of each under
``torch.profiler``, at the probe weights, with TF32 off, its device time by
CUDA kernel (kernels A and B are sequences of steps):

  python3 tools/time_f32.py [--rays 16384] [--samples 128]

Prints the card's name and power limit beside each table. ``chip_smoke.py``
phase 33 holds the same kernels to their plain versions and times them
whole, with CUDA events; this tool says where inside a call the time goes.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--rays', type=int, default=16384)
    parser.add_argument('--samples', type=int, default=128)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('time_f32: no CUDA device', file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from hypernerf_tpu_torch.flagship import flagship_model, load_probe_weights
    from hypernerf_tpu_torch.kernels import (build, fused_fields_bwd,
                                             fused_level, fused_template_bwd)
    from hypernerf_tpu_torch.kernels.fused_level import _launch_forward
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    build.library()
    lv = load_probe_weights(flagship_model(
        'cuda', compute_dtype='float32')).level('fine')
    r, s = args.rays, args.samples
    with torch.no_grad():
        ins = cs.level_inputs(r, s, seed=5)
        _, raw_t = _launch_forward(lv, *ins, want_raw_t=True)
        g = torch.randn(r * s, 4, generator=torch.Generator().manual_seed(
            5)).cuda()
        dx_t = fused_template_bwd(lv, raw_t, ins[4], g)[0]
        calls = (('row 1', lambda: fused_level(lv, *ins)),
                 ('row 9', lambda: fused_template_bwd(lv, raw_t, ins[4], g)),
                 ('row 5', lambda: fused_fields_bwd(lv, *ins[:4], dx_t)))
        for _, fn in calls:  # warm up
            fn()
        for label, fn in calls:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            print(f'{label} R={r} S={s}, device time by kernel; {card}')
            print(prof.key_averages().table(
                sort_by='cuda_time_total', row_limit=10,
                max_name_column_width=40), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
