#!/usr/bin/env python
"""How far the kernels' gradients of one train step lie from the plain
versions' and from float32, draw by draw, on one CUDA card.

  python tools/step_grad_noise.py [--config occupancy] [--no_grid]
      [--seeds 11 12 13] [--rays 1024]

For each seed: the step's draws from that seed (as ``chip_smoke.py``'s
``compare_step`` draws them), then the gradients of the MSE loss on the
first ``--rays`` rays of the configuration's train setup with the kernels,
with the plain versions (bf16, the same rounding points) and with the plain
versions at ``compute_dtype='float32'``. Prints the worst parameter of
kernels against plain as ``chip_smoke.step_grad_errors`` measures it, and
for that parameter its gradient's norm and the norms of the three
differences: a reading that is large only because the gradient itself
cancels to a small remainder shows a small norm and kernel-plain within the
spread of the other draws, with both bf16 gradients equally far from
float32. A configuration with the occupancy grid renders through its first
grid (``flagship.bench_grid``) unless ``--no_grid``. Exits non-zero without
a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--config', default='occupancy')
    parser.add_argument('--no_grid', action='store_true')
    parser.add_argument('--seeds', type=int, nargs='+', default=[11, 12, 13])
    parser.add_argument('--rays', type=int, default=1024)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print('step_grad_noise: no CUDA device', file=sys.stderr)
        return 1
    import chip_smoke
    from hypernerf_tpu_torch.flagship import (flagship_model,
                                              flagship_train_setup)
    from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
    from hypernerf_tpu_torch.ops.sampling import sorted_uniform
    from hypernerf_tpu_torch.training.losses import mse_loss

    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    state, _, rays, rgbs = flagship_train_setup('cuda', config=args.config)
    model = state.model
    cfg = model.config
    f32 = flagship_model('cuda', config=args.config,
                         compute_dtype='float32').train()
    f32.load_state_dict(model.state_dict())
    grid = None if args.no_grid else state.occupancy
    n, s, nf = args.rays, cfg.num_coarse_samples, cfg.num_fine_samples
    batch = prepare_ray_dict(rays[:n])

    def grads(m, draws):
        m.zero_grad(set_to_none=True)
        out = m(batch, deterministic=False, draws=draws, occupancy_grid=grid)
        mse_loss(out, rgbs[:n]).backward()
        return {k: p.grad.clone() for k, p in m.named_parameters()}

    print(f'config {args.config}, grid {grid is not None}, {n} rays')
    for seed in args.seeds:
        gen = torch.Generator(device='cuda').manual_seed(seed)
        draws = {'t_rand': torch.rand(n, s, generator=gen, device='cuda'),
                 'fine_u': sorted_uniform(n, nf, gen, device='cuda'),
                 'noise_coarse': torch.randn(n, s, generator=gen,
                                             device='cuda'),
                 'noise_fine': torch.randn(n, s + nf, generator=gen,
                                           device='cuda')}
        if grid is not None:
            draws['coarse_u'] = sorted_uniform(n, s, gen, device='cuda')
        kernel = grads(model, draws)
        with chip_smoke.plain_versions():
            plain = grads(model, draws)
            full = grads(f32, draws)
        total, (worst, name) = chip_smoke.step_grad_errors(kernel, plain)

        def norm(t):
            return t.float().norm().item()

        print(f'seed {seed}: kernels vs plain relative L2 {total:.3e}, worst '
              f'{worst:.3e} at {name}: |plain| {norm(plain[name]):.3e}, '
              f'|float32| {norm(full[name]):.3e}, |kernels - plain| '
              f'{norm(kernel[name] - plain[name]):.3e}, |kernels - float32| '
              f'{norm(kernel[name] - full[name]):.3e}, |plain - float32| '
              f'{norm(plain[name] - full[name]):.3e}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
