#!/usr/bin/env python
"""A train step's wall time on one CUDA card: ``make_train_step`` of one of
the flagship's configurations (``flagship.CONFIGS``; 64 + 64 samples, full
widths, bf16, sigma noise, Adam with ``steplr``), with optional NerfConfig
overrides, from the package of this checkout or of another (``--repo``, for
example an unpacked ``git archive`` of an earlier commit, whose kernels it
builds from its own sources).

  python tools/time_train.py --config se3 [--set share_glo=False]
      [--repo DIR]

Prints the card's name and power limit, then one line: the repository, the
configuration and its overrides, ms per step and rays/s, timed as
``chip_smoke.py`` times its train steps (this checkout's ``TRAIN_RAYS`` rays
a step, ``TRAIN_STEPS`` steps after ``WARMUP_STEPS``, host clock to a
synchronize). Two trees are compared by running this once per
tree in turns (parent, this, this, parent), each in its own process. Exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import ast
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _override(text: str):
    key, _, value = text.partition('=')
    try:
        return key, ast.literal_eval(value)
    except ValueError:
        return key, value


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--config', default='flagship')
    parser.add_argument('--set', action='append', default=[], type=_override,
                        help='a NerfConfig override, key=value')
    parser.add_argument('--repo', default=REPO)
    args = parser.parse_args()
    # chip_smoke.py imports nothing of the package at its top, so the
    # package below is --repo's.
    sys.path.insert(0, REPO)
    from chip_smoke import TRAIN_RAYS, TRAIN_STEPS, WARMUP_STEPS
    sys.path.insert(0, os.path.abspath(args.repo))

    import torch
    if not torch.cuda.is_available():
        print('time_train: no CUDA device', file=sys.stderr)
        return 1
    from hypernerf_tpu_torch.flagship import flagship_train_setup

    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    overrides = dict(args.set)
    state, step_fn, rays, rgbs = flagship_train_setup(
        'cuda', seed=0, batch_size=TRAIN_RAYS, config=args.config,
        **overrides)
    for _ in range(WARMUP_STEPS):
        step_fn(state, rays, rgbs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        step_fn(state, rays, rgbs)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / TRAIN_STEPS
    print(f'{os.path.abspath(args.repo)} {args.config} {overrides}: '
          f'{secs * 1e3:.1f} ms/step, {TRAIN_RAYS / secs:.0f} rays/s over '
          f'{TRAIN_STEPS} steps after {WARMUP_STEPS}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
