#!/usr/bin/env python
"""Where kernel B's time goes inside its kernel: the translation variant of
``csrc/fields_bwd.cuh`` (the fields backward) built with
``-DHN_FIELDS_BWD_TRACE`` into a library of its own, launched at the
flagship widths (probe weights) on one CUDA card; thread 0 of each consumer
warpgroup of block 0 adds up the SM clock of its first four block tiles of
128 rows by kind of work.

  python tools/trace_fields_bwd.py [--rays 16384] [--samples 128]

Prints, per kind and summed over a block tile (mean of tiles 1 to 3, in SM
cycles, each warpgroup): waits for a weight stage, products until retired,
epilogues (bias, ReLU or mask, rounding, stores), the dW / db flush (the
vector reductions into the gradient buffer), block barriers with waits for
a reload, and the row work: row inputs (and a layer's bias loads), the
encodings, the head steps (the SE(3) heads and retraction), the encodings'
VJPs, d z and the per-ray sums; then a tile's cycles and the card's SM
clock. Exits non-zero without a card.
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

GROUPS, TILES, KINDS = 2, 4, 10
# csrc/fields_bwd.cuh's kCy* kinds, in order.
KIND_NAMES = ('stage wait', 'products', 'epilogues', 'dW flush', 'barriers',
              'row inputs', 'encodings', 'head steps', 'VJPs', 'ray sums')


def _trace_library():
    """The translation kernel built with the trace hooks (cached by the
    sources' hash under build/kernels/)."""
    from hypernerf_tpu_torch.kernels import build
    src = build.CSRC / 'fields_bwd_trans.cu'
    flags = [*build.NVCC_FLAGS, '-DHN_FIELDS_BWD_TRACE']
    h = hashlib.sha256(' '.join(flags).encode())
    for p in build._sources():
        h.update(p.read_bytes())
    so = build.BUILD_DIR / f'fields_bwd_trace_{h.hexdigest()[:16]}.so'
    if not so.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build._nvcc(), *flags, '-shared', '-o', str(so),
                        str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hn_fields_bwd_trans.argtypes = [p] * 12 + [ll, i, i, p]
    lib.hn_fields_bwd_trans.restype = i
    lib.hn_fields_bwd_trace.argtypes = [p]
    lib.hn_fields_bwd_trace.restype = i
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--rays', type=int, default=16384)
    parser.add_argument('--samples', type=int, default=128)
    args = parser.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('trace_fields_bwd: no CUDA device', file=sys.stderr)
        return 1
    from hypernerf_tpu_torch.flagship import (flagship_model,
                                              load_probe_weights,
                                              probe_inputs)
    from hypernerf_tpu_torch.kernels import build
    fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')

    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    lib = _trace_library()
    level = load_probe_weights(flagship_model('cuda')).level('fine')
    w, b, shapes = fl.pack_level(level)
    z, o, d, emb, _ = [torch.from_numpy(v).cuda() for v in probe_inputs(
        args.rays, args.samples, seed=0).values()]
    n = args.rays * args.samples
    gen = torch.Generator().manual_seed(1)
    dx_t = torch.nn.functional.pad(torch.randn(n, 7, generator=gen),
                                   (0, 1)).cuda()
    d_z = torch.empty((args.rays, args.samples), device='cuda')
    d_ray = torch.zeros((args.rays, 14), device='cuda')
    grads, _ = fl.fields_bwd_grad_copies(shapes[:14], 'cuda')
    blocks = build.library().hn_fused_fields_bwd_blocks(n)
    scratch = torch.empty(blocks * fl.FB_SPILL_SLABS * fl.FB_SLAB_BYTES,
                          dtype=torch.uint8, device='cuda')
    stream = torch.cuda.current_stream().cuda_stream
    t = np.zeros((GROUPS, TILES, KINDS), dtype=np.int64)
    for _ in range(2):  # the second launch's clocks are kept
        if lib.hn_fields_bwd_trace(t.ctypes.data):  # read and zero
            raise RuntimeError('hn_fields_bwd_trace failed')
        code = lib.hn_fields_bwd_trans(
            z.data_ptr(), o.data_ptr(), d.data_ptr(), emb.data_ptr(),
            dx_t.data_ptr(), None, w.data_ptr(), b.data_ptr(),
            d_z.data_ptr(), d_ray.data_ptr(), grads.data_ptr(),
            scratch.data_ptr(), n, args.samples, blocks, stream)
        if code:
            raise RuntimeError(f'hn_fields_bwd_trans: CUDA error {code}')
        torch.cuda.synchronize()
    if lib.hn_fields_bwd_trace(t.ctypes.data):
        raise RuntimeError('hn_fields_bwd_trace failed')
    tiles = t[:, 1:].astype(np.float64)  # tiles 1..3
    per_tile = tiles.sum(-1).mean(-1)
    print(f'kernel B (translation) R={args.rays} S={args.samples}, block 0, '
          f'SM cycles a block tile of 128 rows, mean of tiles 1-3 '
          f'(warpgroup 0 / 1)')
    for k, name in enumerate(KIND_NAMES):
        x = tiles[..., k].mean(-1)
        print(f'{name:12s}: {x[0]:9.0f} / {x[1]:<9.0f} '
              f'({100 * x[0] / per_tile[0]:5.1f} % / '
              f'{100 * x[1] / per_tile[1]:5.1f} %)')
    print(f'a block tile: {per_tile[0]:.0f} / {per_tile[1]:.0f} cycles')
    clocks = subprocess.run(['nvidia-smi', '--query-gpu=clocks.sm',
                             '--format=csv,noheader'], capture_output=True,
                            text=True).stdout.strip()
    print(f'SM clock now: {clocks}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
