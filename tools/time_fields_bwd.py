#!/usr/bin/env python
"""Kernel B's time (the fields backward, ``fused_fields_bwd``) on one CUDA
card for each warp type at the train step's R = 16384 rays, S = 64 and 128
samples, probe weights, CUDA events (mean of 5 launches after 2).

  python tools/time_fields_bwd.py [--repo DIR]

``--repo`` times the port of another checkout (for example an unpacked
``git archive`` of an earlier commit, whose ``fused_fields_bwd`` takes the
same arguments): its package is imported and its kernels built in its own
``build/``. Prints one line per warp type and S with the card's name and
power limit first; exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--repo', default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print('time_fields_bwd: no CUDA device', file=sys.stderr)
        return 1
    from hypernerf_tpu_torch.flagship import (flagship_model,
                                              load_probe_weights,
                                              probe_inputs)
    from hypernerf_tpu_torch.kernels import fused_fields_bwd

    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    rays = 16384
    with torch.no_grad():
        for warp, config in (('translation', 'flagship'), ('se3', 'se3'),
                             ('quaternion', 'quaternion')):
            probe = load_probe_weights(flagship_model('cuda', config=config))
            for s in (64, 128):
                level = probe.level('fine' if s == 128 else 'coarse')
                z, o, d, emb, _ = [torch.from_numpy(v).cuda() for v in
                                   probe_inputs(rays, s, seed=s + 3).values()]
                dx_t = F.pad(torch.randn(
                    rays * s, 7, generator=torch.Generator().manual_seed(s)),
                    (0, 1)).cuda()
                call = lambda: fused_fields_bwd(level, z, o, d, emb, dx_t)
                call()
                call()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(5):
                    call()
                end.record()
                torch.cuda.synchronize()
                print(f'kernel B {warp} R={rays} S={s}: '
                      f'{start.elapsed_time(end) / 5:.3f} ms', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
