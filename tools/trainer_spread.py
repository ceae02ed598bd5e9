#!/usr/bin/env python
"""How far apart trainer runs of the flagship lie on one CUDA card: kernels
against kernels, plain versions against plain versions, and kernels against
plain versions, seed by seed. It calibrates ``chip_smoke.py`` phase 25.

  python tools/trainer_spread.py [--seeds 0 1 2] [--load earlier.json ...]
      [--out chiprun_out/trainer_spread.json]

The scene is phase 25's (``tools/make_synthetic_scene.py``, written to a
temporary directory), and so are the flags (``chip_smoke.smoke_argv``: 64 +
64, bf16, Adam with steplr, batch 4096). For each seed there are two runs
through the kernels and two through the plain versions
(``chip_smoke.plain_versions``), each from that seed's weights and draws,
for 80 steps, with a log line and a checkpoint every 4 steps and a val
every 8. Each run records the logged train/loss and train/psnr, val/psnr,
and the training frames' mean PSNR (``chip_smoke.train_pose_psnr``,
rendered through the kernels) of its initial weights and of each
checkpoint.

For each metric and recorded step it prints the largest gap between two
runs of one path and one seed (kernels, plain), each seed's kernels minus
plain (the mean of its two runs each), and the largest movement since the
first recorded step; then, over every seed and every step after the first,
how often kernels minus plain is negative and positive, and its mean.
``--load`` adds the runs of earlier outputs; with ``--seeds`` and no seed
it only prints their summary, and needs no card. Every run goes to
``--out``. Exits non-zero without a card when it has seeds to run.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'tools'))

METRICS = ('pose/psnr', 'train/psnr', 'train/loss', 'val/psnr')
STEPS = 80  # phase 25's 36 steps and the steps where two runs part
EVERY = 4  # steps between the readings of the logs and the checkpoints


class Recorder:
    """A logger that keeps each scalar as {tag: {step: value}}."""

    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, {})[int(step)] = float(value)

    def add_images(self, tag, images, step):
        pass

    def close(self):
        pass


def run(scene: str, seed: int, plain: bool, exp: str) -> dict:
    """One trainer run; returns its recorder's scalars."""
    import chip_smoke
    import torch
    from hypernerf_tpu_torch.opt import configs_from_args, get_opts
    from hypernerf_tpu_torch.training import checkpoints
    from hypernerf_tpu_torch.training.trainer import Trainer

    argv = chip_smoke.smoke_argv(scene, exp, STEPS, '--seed', str(seed),
                                 '--log_every', str(EVERY))
    nerf_cfg, train_cfg = configs_from_args(get_opts(argv))
    train_cfg = dataclasses.replace(train_cfg, ckpt_every_steps=EVERY)
    log = Recorder()
    trainer = Trainer(nerf_cfg, train_cfg, 'cuda', logger=log)
    log.add_scalar('pose/psnr', chip_smoke.train_pose_psnr(trainer), 0)
    with chip_smoke.plain_versions() if plain else contextlib.nullcontext():
        trainer.fit()
    for step in range(EVERY, STEPS + 1, EVERY):
        checkpoints.load_weights(trainer.model, os.path.join(
            trainer.ckpt_dir, f'step_{step}'))
        trainer.state.step = step
        log.add_scalar('pose/psnr', chip_smoke.train_pose_psnr(trainer),
                       step)
    del trainer
    torch.cuda.empty_cache()
    return log.scalars


def summary(runs: dict) -> list:
    """Rows (metric, step, kernels-kernels, plain-plain, [kernels - plain
    per seed], movement) at each step that every run recorded."""
    seeds = sorted({seed for _, seed, _ in runs})
    rows = []
    for metric in METRICS:
        series = {key: r[metric] for key, r in runs.items()}
        steps = sorted(set.intersection(*(set(s) for s in series.values())))
        for step in steps:
            def at(path, seed):
                return [series[(path, seed, i)][step] for i in (0, 1)]
            kk = max(abs(a - b) for a, b in (at('kernels', s) for s in seeds))
            pp = max(abs(a - b) for a, b in (at('plain', s) for s in seeds))
            kp = [sum(at('kernels', s)) / 2 - sum(at('plain', s)) / 2
                  for s in seeds]
            moved = max(abs(v[step] - v[steps[0]]) for v in series.values())
            rows.append((metric, step, kk, pp, kp, moved))
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--seeds', type=int, nargs='*', default=[0, 1, 2])
    parser.add_argument('--load', nargs='*', default=[])
    parser.add_argument('--out', default=os.path.join(
        ROOT, 'chiprun_out', 'trainer_spread.json'))
    args = parser.parse_args()

    import chip_smoke
    import torch
    runs, cards = {}, set()
    for path in args.load:
        with open(path) as f:
            loaded = json.load(f)
        cards.add(loaded['card'])
        for r in loaded['runs']:
            runs[(r['path'], r['seed'], r['run'])] = {
                tag: {int(k): v for k, v in by_step.items()}
                for tag, by_step in r['scalars'].items()}
    if args.seeds:
        if not torch.cuda.is_available():
            print('trainer_spread: no CUDA device', file=sys.stderr)
            return 1
        cards.add(subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True).stdout.strip())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    card = '; '.join(sorted(cards))
    print(card, flush=True)

    import make_synthetic_scene
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            if args.seeds:
                scene = make_synthetic_scene.make_scene(
                    os.path.join(tmp, 'scene'), **chip_smoke.SMOKE_SCENE)
            for seed in args.seeds:
                for path in ('kernels', 'plain'):
                    for i in (0, 1):
                        t0 = time.perf_counter()
                        with contextlib.redirect_stdout(sys.stderr):
                            runs[(path, seed, i)] = run(
                                scene, seed, path == 'plain',
                                f'{path}_{seed}_{i}')
                        print(f'seed {seed} {path} run {i}: '
                              f'{time.perf_counter() - t0:.1f} s', flush=True)
        finally:
            os.chdir(cwd)

    rows = summary(runs)
    seeds = sorted({seed for _, seed, _ in runs})
    print(f'the flagship at batch {chip_smoke.SMOKE_BATCH}, seeds {seeds}, '
          f'two runs of each path a seed; {card}')
    print('metric step | kernels-kernels plain-plain (largest over seeds) | '
          'kernels - plain per seed | largest movement since the first step')
    for metric, step, kk, pp, kp, moved in rows:
        print(f'{metric:10s} {step:3d} | {kk:.4f} {pp:.4f} | '
              f'{" ".join(f"{v:+.4f}" for v in kp)} | {moved:.4f}')
    for metric in METRICS:
        first = min(step for m, step, *_ in rows if m == metric)
        gaps = [v for m, step, _, _, kp, _ in rows
                if m == metric and step > first for v in kp]
        print(f'{metric}: kernels - plain < 0 in {sum(v < 0 for v in gaps)}'
              f', > 0 in {sum(v > 0 for v in gaps)} of {len(gaps)} readings'
              f' (every seed, every step after the first), mean '
              f'{sum(gaps) / len(gaps):+.4f}')
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump({'card': card, 'seeds': seeds,
                   'runs': [{'path': p, 'seed': s, 'run': i, 'scalars': r}
                            for (p, s, i), r in runs.items()]}, f)
    return 0


if __name__ == '__main__':
    sys.exit(main())
