#!/usr/bin/env python
"""Where a level forward's time goes inside its kernel: the translation
variant of ``csrc/level_fwd.cuh`` built with ``-DHN_LEVEL_FWD_TRACE`` into a
library of its own, launched at the flagship widths (probe weights) on one
CUDA card; block 0 records the SM clock of each consumer warpgroup at four
points of every layer of its first four pairs of row tiles. With
``--kernel template``, ``warp``, ``sheet`` or ``se3`` the same for a
per-module forward kernel (``csrc/modular_fwd.cu``: one stage of the level
forward alone; ``se3`` the SE(3) trunk at the ``se3`` probe weights) on the
same rows; the warp field's and the trunk's blocks take three tiles a step
and the sheet's four, of which warpgroups 0 and 1 are shown. With
``--kernel warp_tangents`` or ``se3_tangents`` the same for a Jacobian's
forward (``csrc/tangents_fwd.cu``: the warp field or the trunk with its
point-tangent streams, 16 points x 4 streams a tile) on the rows' points
(``--samples 16`` for the train step's 262,144 points); its layer 0's row
work holds the tile's x_raw rows and the shared-sincos encoding. With
``--kernel plane`` the plane configuration's level forward
(``csrc/level_fwd_plane.cu``: no sheet, tiles of 448 columns, a ring of 5
stages) at its probe weights.

  python tools/trace_level_fwd.py [--rays 8192] [--samples 128]
      [--kernel level|plane|template|warp|sheet|se3|warp_tangents|
                se3_tangents]

Prints, per layer and summed over a pair of tiles (mean of pairs 1 to 3, in
SM cycles, each warpgroup): the wait for the layer's first weight stage, the
products until retired, the epilogue, and the per-row work before the
layer (encodings, heads' row work); then a pair's period (layer 0 to
layer 0) and how far warpgroup 1 runs behind warpgroup 0 at each layer's
start. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GROUPS, PAIRS, LAYERS, EVENTS = 4, 4, 32, 4  # level_fwd_trace's shape


def _trace_library(kernel: str):
    """The translation level kernel (or the per-module kernels) built with
    the trace hooks (cached by the sources' hash under build/kernels/)."""
    from hypernerf_tpu_torch.kernels import build
    stem = {'level': 'level_fwd_trans', 'plane': 'level_fwd_plane',
            'warp_tangents': 'tangents_fwd',
            'se3_tangents': 'tangents_fwd'}.get(kernel, 'modular_fwd')
    flags = [*build.NVCC_FLAGS, '-DHN_LEVEL_FWD_TRACE']
    h = hashlib.sha256(' '.join(flags).encode())
    for p in build._sources():
        h.update(p.read_bytes())
    so = build.BUILD_DIR / f'{stem}_trace_{h.hexdigest()[:16]}.so'
    if not so.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # The per-module library's template entry point sends the Nerfies
        # layout to template_fwd_anneal.cu.
        stems = [stem] + (['template_fwd_anneal'] if stem == 'modular_fwd'
                          else [])
        subprocess.run([build._nvcc(), *flags, '-shared', '-o', str(so),
                        *[str(build.CSRC / f'{s}.cu') for s in stems]],
                       check=True)
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if kernel in ('level', 'plane'):
        entry = getattr(lib, f'hn_{stem}')
        entry.argtypes = [p] * 13 + [ll, i, i, p]
        lib.trace = (lib.hn_level_fwd_trace if kernel == 'level'
                     else lib.hn_level_fwd_plane_trace)
    elif stem == 'tangents_fwd':
        lib.hn_fused_jacobian_fwd.argtypes = [p] * 4 + [ll, p]
        lib.hn_fused_se3_jacobian_fwd.argtypes = [p] * 5 + [ll, p]
        lib.trace = lib.hn_tangents_fwd_trace
    else:
        lib.hn_fused_template_fwd.argtypes = [p] * 8 + [ll, i, i, p]
        lib.hn_fused_field_fwd.argtypes = [i] + [p] * 5 + [ll, p]
        lib.hn_fused_se3_fwd.argtypes = [p] * 5 + [ll, p]
        lib.trace = lib.hn_modular_fwd_trace
    lib.trace.argtypes = [p]
    lib.trace.restype = i
    return lib


def _launch(lib, kernel, level, args, stream):
    """One launch of the traced kernel on the level's probe rows: the level
    kernel on the ray inputs, or a per-module kernel on that stage's inputs
    as the level computes them (a field or the trunk: [pts | embed]; the
    template: [warped | hyper | 0] from the field kernels)."""
    import torch
    ff = importlib.import_module('hypernerf_tpu_torch.kernels.fused_field')
    fm = importlib.import_module('hypernerf_tpu_torch.kernels.fused_mlp')
    fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
    fs = importlib.import_module('hypernerf_tpu_torch.kernels.fused_se3')
    z, o, d, emb, cond = args
    n, samples = z.numel(), z.shape[1]
    if kernel in ('level', 'plane'):
        w, b, _ = fl.pack_level(level)
        out = torch.empty((n, 4), device='cuda')
        rgbc = cond.to(torch.bfloat16).contiguous()
        entry = (lib.hn_level_fwd_trans if kernel == 'level'
                 else lib.hn_level_fwd_plane)
        return entry(
            z.data_ptr(), o.data_ptr(), d.data_ptr(), emb.data_ptr(),
            rgbc.data_ptr(), None, None, None, None, w.data_ptr(),
            b.data_ptr(), out.data_ptr(), None, n, samples, rgbc.shape[1],
            stream)
    x_raw = fl._raw_fields(z, o, d, emb).contiguous()
    if kernel == 'warp_tangents':
        fj = importlib.import_module(
            'hypernerf_tpu_torch.kernels.fused_jacobian')
        w, b, _ = fj._launch_args(level.warp.mlp, level.warp.n_freq, x_raw)
        out = torch.empty((n, fj.JAC), device='cuda')
        return lib.hn_fused_jacobian_fwd(x_raw.data_ptr(), w.data_ptr(),
                                         b.data_ptr(), out.data_ptr(), n,
                                         stream)
    if kernel == 'se3_tangents':
        _, (w, b, _) = fs._launch_args(level.warp, x_raw, None)
        out = torch.empty((n, 24), device='cuda')
        return lib.hn_fused_se3_jacobian_fwd(x_raw.data_ptr(), None,
                                             w.data_ptr(), b.data_ptr(),
                                             out.data_ptr(), n, stream)
    if kernel == 'se3':
        _, (w, b, _) = fs._launch_args(level.warp, x_raw, None)
        out = torch.empty((n, fs.OUT_PAD), device='cuda')
        return lib.hn_fused_se3_fwd(x_raw.data_ptr(), None, w.data_ptr(),
                                    b.data_ptr(), out.data_ptr(), n, stream)

    def field(module):
        which, _, (w, b, _) = ff._launch_args(module.mlp, module.n_freq,
                                              x_raw, None)
        out = torch.empty((n, ff.OUT_PAD), device='cuda')
        code = lib.hn_fused_field_fwd(which, x_raw.data_ptr(), None,
                                      w.data_ptr(), b.data_ptr(),
                                      out.data_ptr(), n, stream)
        return code, out

    if kernel != 'template':
        return field(level.warp if kernel == 'warp' else level.hyper)[0]
    (c0, warp), (c1, hyper) = field(level.warp), field(level.hyper)
    if c0 or c1:
        return c0 or c1
    raw_t = torch.cat([x_raw[:, :3] + warp[:, :3], hyper[:, :5]], dim=-1)
    (rgbc, _, _), per, _, ((w, b, _),) = fm._launch_args(level, raw_t, cond,
                                                         False)
    out = torch.empty((n, 4), device='cuda')
    return lib.hn_fused_template_fwd(
        raw_t.data_ptr(), rgbc.data_ptr(), None, None, None, w.data_ptr(),
        b.data_ptr(), out.data_ptr(), n, per, rgbc.shape[1], stream)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--rays', type=int, default=8192)
    parser.add_argument('--samples', type=int, default=128)
    parser.add_argument('--kernel', default='level',
                        choices=('level', 'plane', 'template', 'warp',
                                 'sheet',
                                 'se3', 'warp_tangents', 'se3_tangents'))
    args = parser.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('trace_level_fwd: no CUDA device', file=sys.stderr)
        return 1
    from hypernerf_tpu_torch.flagship import (flagship_model,
                                              load_probe_weights,
                                              probe_inputs)
    fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')

    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    lib = _trace_library(args.kernel)
    config = ('se3' if args.kernel.startswith('se3') else
              'plane' if args.kernel == 'plane' else 'flagship')
    level = load_probe_weights(flagship_model(
        'cuda', config=config)).level('fine')
    shapes = fl.pack_level(level)[2]
    first, end = fl.MODULE_STAGES.get(args.kernel, (0, len(shapes)))
    inputs = [torch.from_numpy(v).cuda() for v in probe_inputs(
        args.rays, args.samples, seed=0).values()]
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(2):  # the second launch's clocks are kept
        code = _launch(lib, args.kernel, level, inputs, stream)
        if code:
            raise RuntimeError(f'{args.kernel}: CUDA error {code}')
    torch.cuda.synchronize()
    t = np.zeros((GROUPS, PAIRS, LAYERS, EVENTS), dtype=np.int64)
    if lib.trace(t.ctypes.data):
        raise RuntimeError('reading the trace failed')
    t = t[:2, :, first:end].astype(np.float64)  # warpgroups 0 and 1
    # The row work before a layer: since the previous layer ended (for
    # layer 0, the previous pair's last layer).
    gap = np.empty(t.shape[:3])
    gap[..., 1:] = t[..., 1:, 0] - t[..., :-1, 3]
    gap[:, 1:, 0] = t[:, 1:, 0, 0] - t[:, :-1, -1, 3]
    pair = t[:, 1:, 0, 0] - t[:, :-1, 0, 0]  # layer 0 to layer 0
    t, gap = t[:, 1:], gap[:, 1:]  # pairs 1..3
    wait, mma, epi = (t[..., 1] - t[..., 0], t[..., 2] - t[..., 1],
                      t[..., 3] - t[..., 2])
    print(f'{args.kernel} forward R={args.rays} S={args.samples}, block 0, '
          f'SM cycles, mean of pairs 1-3 (warpgroup 0 / 1)')
    print('layer  (n, k)       stage wait        products        epilogue'
          '   row work before')
    for l, shape in enumerate(shapes[first:end]):
        cells = [f'{x[0, :, l].mean():7.0f} / {x[1, :, l].mean():<7.0f}'
                 for x in (wait, mma, epi, gap)]
        print(f'{first + l:5d}  {str(shape):11s} ' + '  '.join(cells))
    for name, x in (('stage wait', wait), ('products', mma),
                    ('epilogue', epi), ('row work', gap)):
        s = x.sum(-1).mean(-1)
        print(f'sum {name:10s}: {s[0]:.0f} / {s[1]:.0f} cycles a pair')
    print(f'a pair of tiles: {pair[0].mean():.0f} / {pair[1].mean():.0f} '
          f'cycles; warpgroup 1 behind 0 at layer starts: '
          f'{(t[1, :, :, 0] - t[0, :, :, 0]).mean():.0f} cycles (mean), '
          f'{(t[1, :, :, 0] - t[0, :, :, 0]).min():.0f} to '
          f'{(t[1, :, :, 0] - t[0, :, :, 0]).max():.0f}')
    clocks = subprocess.run(['nvidia-smi', '--query-gpu=clocks.sm',
                             '--format=csv,noheader'], capture_output=True,
                            text=True).stdout.strip()
    print(f'SM clock now: {clocks}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
