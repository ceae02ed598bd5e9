#!/usr/bin/env python
"""The compositing kernels' times on one CUDA card: the forward
(``hn_fused_composite_fwd``, ``csrc/fused_composite.cu``) at the render's
chunk of R = 8192 rays, the coarse call (S = 64 with the N = 64 fine draw,
linspace u) and the fine call (S = 128, N = 0), and the train step's coarse
call (R = 16384, S = 64, N = 64, sorted u, sigma noise); the backward
(``hn_fused_composite_bwd``, ``csrc/fused_composite_bwd.cu``) at the train
step's R = 16384, S = 64 and 128, sigma noise on; CUDA events (the mean of
20 launches after 2).

  python tools/time_composite.py [--parent DIR]

With ``--parent`` the kernel library of another checkout (for example an
unpacked ``git archive`` of an earlier commit), built from its own
``kernels/csrc`` into its own ``build/``, is timed too, in turns in one
process: this, parent, parent, this. Both take the same inputs through the
same C signature. Prints the card's name and power limit first, then one
line per shape with each library's times, the share of the bound (the
inputs read once and the outputs written once over 3.35 TB/s) and, with a
parent, the ratio of the means and the largest differences of the outputs
(rgb, depth, median depth, acc; the weights; z_union; of the backward, d
packed, d z and d |d|, d z left out on the rays whose cumulative weight
passes within 1e-5 of 0.5, where another order of sums may move the
median). Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools.time_fields_bwd import _library, _time  # noqa: E402

PEAK_BYTES = 3.35e12
SHAPES = ((8192, 64, 64, 'linspace', False), (8192, 128, 0, 'linspace', False),
          (16384, 64, 64, 'sorted', True))
BWD_SHAPES = ((16384, 64), (16384, 128))


def _report(label, times, nbytes, outs, edge=None):
    """One line: each library's times, their share of the bound and, with
    a parent, the ratio of the means and the outputs' largest differences
    (rows of ``edge`` left out of the second output)."""
    import torch
    bound = nbytes / PEAK_BYTES * 1e3
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    parts = [f'{k} ' + ', '.join(f'{t:.4f}' for t in v) + ' ms'
             f' ({100 * bound / mean[k]:.1f} % of {bound:.4f})'
             for k, v in times.items()]
    if 'parent' in times:
        torch.cuda.synchronize()
        diffs = []
        for i, (a, b) in enumerate(zip(outs['this'], outs['parent'])):
            if a is None:
                continue
            d = (a - b).abs()
            if edge is not None and i == 1:
                d = d[~edge]
            diffs.append(d.max().item())
        parts.append(f'parent / this {mean["parent"] / mean["this"]:.2f}x'
                     ', outputs max|d| ' + ', '.join(f'{d:.3e}'
                                                     for d in diffs))
    print(f'{label}: ' + '; '.join(parts), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--parent', default=None)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print('time_composite: no CUDA device', file=sys.stderr)
        return 1
    from hypernerf_tpu_torch.kernels import build
    from hypernerf_tpu_torch.ops.sampling import sorted_uniform

    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = {'this': (build.library(), build)}
    if args.parent:
        libs['parent'] = _library(os.path.abspath(args.parent),
                                  'parent_kernel_build')
    order = (['this', 'parent', 'parent', 'this'] if args.parent
             else ['this', 'this'])
    stream = torch.cuda.current_stream().cuda_stream
    for r, s, n, u_kind, noisy in SHAPES:
        g = torch.Generator().manual_seed(r + s + n)
        packed = (torch.randn(r * s, 4, generator=g) * 2.0).cuda()
        z = torch.sort(torch.rand(r, s, generator=g) * 0.9 + 0.05,
                       dim=-1)[0].cuda()
        dirs = torch.randn(r, 3, generator=g).cuda()
        noise = torch.randn(r, s, generator=g).cuda() if noisy else None
        u = None
        if n:
            u = (torch.linspace(0, 1, n).expand(r, n) if u_kind == 'linspace'
                 else sorted_uniform(r, n, g)).contiguous().cuda()
        outs = {k: [torch.empty((r, 6), device='cuda'),
                    torch.empty((r, s), device='cuda'),
                    torch.empty((r, s + n), device='cuda') if n else None]
                for k in libs}

        def launch(k):
            lib, bld = libs[k]
            out, weights, z_union = outs[k]
            bld.check(lib.hn_fused_composite_fwd(
                packed.data_ptr(), z.data_ptr(), dirs.data_ptr(),
                None if noise is None else noise.data_ptr(),
                None if u is None else u.data_ptr(), out.data_ptr(),
                weights.data_ptr(),
                None if z_union is None else z_union.data_ptr(), r, s, n, 0,
                1, stream), 'hn_fused_composite_fwd')

        times = {k: [] for k in libs}
        for k in order:
            times[k].append(_time(lambda: launch(k), iters=20))
        nbytes = r * (s * (16 + 4 + 4 * noisy + 4) + 12 + 4 * n + 24
                      + 4 * (s + n) * (n > 0))
        _report(f'composite R={r} S={s} N={n} u={u_kind} '
                f'noise={"on" if noisy else "off"} (outputs, weights, '
                f'z_union)', times, nbytes, outs)

    from hypernerf_tpu_torch.kernels import fused_composite_plain
    for r, s in BWD_SHAPES:
        g = torch.Generator().manual_seed(r + s + 1)
        packed = (torch.randn(r * s, 4, generator=g) * 2.0).cuda()
        z = torch.sort(torch.rand(r, s, generator=g) * 0.9 + 0.05,
                       dim=-1)[0].cuda()
        dirs = torch.randn(r, 3, generator=g).cuda()
        noise = torch.randn(r, s, generator=g).cuda()
        d_outs = torch.randn(r, 6, generator=g).cuda()
        d_w = (torch.randn(r, s, generator=g) * 0.1).cuda()
        outs = {k: [torch.empty((r * s, 4), device='cuda'),
                    torch.empty((r, s), device='cuda'),
                    torch.empty((r, 1), device='cuda')] for k in libs}

        def launch_bwd(k):
            lib, bld = libs[k]
            d_packed, d_z, d_dnorm = outs[k]
            bld.check(lib.hn_fused_composite_bwd(
                packed.data_ptr(), z.data_ptr(), dirs.data_ptr(),
                noise.data_ptr(), d_outs.data_ptr(), d_w.data_ptr(),
                d_packed.data_ptr(), d_z.data_ptr(), d_dnorm.data_ptr(), r,
                s, 0, 1, stream), 'hn_fused_composite_bwd')

        times = {k: [] for k in libs}
        for k in order:
            times[k].append(_time(lambda: launch_bwd(k), iters=20))
        cum = torch.cumsum(fused_composite_plain(
            packed, z, dirs, None, noise=noise)['weights'], dim=-1)
        edge = ((cum - 0.5).abs() < 1e-5).any(-1)
        _report(f'composite backward R={r} S={s} noise=on (d packed, d z, '
                f'd |d|; {int(edge.sum())} rays on the median\'s edge)',
                times, r * (s * (16 + 4 + 4 + 4 + 16 + 4) + 12 + 24 + 4),
                outs, edge)
    return 0


if __name__ == '__main__':
    sys.exit(main())
