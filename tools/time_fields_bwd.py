#!/usr/bin/env python
"""The fields backward's times on one CUDA card: kernel B
(``hn_fused_fields_bwd``) for each warp type and for the plane configuration
(no sheet) at the train step's R = 16384 rays, S = 64 and 128 samples, or,
with ``--field plane_se3`` or ``plane_quaternion``, kernel B of that
configuration alone (the screw warps without a sheet; this checkout's
library alone), or, with ``--field template``, kernel A (the template
backward, ``fused_mlp.template_bwd_chunks`` launching each library's
``hn_tmpl_*`` steps) of the flagship, of the plane layout and of the anneal
configuration's Nerfies layout (its window row at
``flagship.ANNEAL_PROBE_STEP``'s alphas) at R = 16384, S = 128 and 64, or,
with ``--field template_nerfies_plane``, kernel A of the plane_anneal
configuration alone (the Nerfies plane layout; this checkout's library
alone), or, with
``--field warp|sheet|se3``, that
field alone (``hn_fused_field_bwd``, the SE(3) trunk's
``hn_fused_se3_bwd``) at 8192 x 128 and 16384 x 128 rows, or, with
``--field se3_tangents`` or ``warp_tangents``, the trunk or the
translation warp field with its point-tangents (``hn_fused_se3_jacobian_bwd``,
``hn_fused_jacobian_bwd``, the Jacobians' backwards) at the train step's
262,144 points (16384 rays x 16 Jacobian samples); probe weights, CUDA
events (the mean of 5 launches after 2).

  python tools/time_fields_bwd.py [--parent DIR]
      [--field warp|sheet|se3|se3_tangents|warp_tangents|template|
               template_nerfies_plane|plane_se3|plane_quaternion]

With ``--parent`` the kernel library of another checkout (for example an
unpacked ``git archive`` of an earlier commit), built from its own
``kernels/csrc`` into its own ``build/``, is timed too, in turns in one
process: this, parent, parent, this. Both get this checkout's packed blobs
and the same inputs; kernel B's entry point takes the same arguments in
both, a field alone's is called as the parent's ``build.py`` declares it
(the 32-row kernels before the redesign, and the translation Jacobian's
8-point kernel before its redesign: a transposed weight blob, one gradient
buffer, a ``_blocks`` entry point of their own). Prints the card's
name and power limit first, then one line per kernel and shape with each
library's times, the share of the bound (three multiply-adds per weight and
row over 989 TFLOP/s; a point is four rows with the tangents) and, with a
parent, the ratio of the means and the largest differences of the outputs:
d z, the per-ray sums (their last bits vary from run to run) or dx_raw,
each as max|d|, and dW / db as the relative L2 of the whole gradient (its
last bits vary too). Kernel A's outputs are deterministic: dx_t, d
rgb_cond and dW / db as max|d|. A parent whose kernel A steps take no raw
width (``hn_tmpl_encode`` and ``hn_tmpl_posenc_bwd`` before the Nerfies
plane layout) is called without it. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PEAK_FLOPS = 989e12


def _library(repo: str, name: str):
    """(the kernel library of the checkout at ``repo``, built from its
    sources by its own ``build.py``; that ``build`` module)."""
    path = os.path.join(repo, 'hypernerf_tpu_torch', 'kernels', 'build.py')
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.library(), module


def _time(fn, iters: int = 5) -> float:
    import torch
    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--parent', default=None)
    parser.add_argument('--field', default=None,
                        choices=('warp', 'sheet', 'se3', 'se3_tangents',
                                 'template', 'template_nerfies_plane',
                                 'warp_tangents', 'plane_se3',
                                 'plane_quaternion'))
    args = parser.parse_args()

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print('time_fields_bwd: no CUDA device', file=sys.stderr)
        return 1
    from hypernerf_tpu_torch.flagship import (anneal_condition,
                                              anneal_extra_params,
                                              flagship_model,
                                              load_probe_weights,
                                              probe_inputs)
    from hypernerf_tpu_torch.kernels import build, common
    ff = importlib.import_module('hypernerf_tpu_torch.kernels.fused_field')
    fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
    fs = importlib.import_module('hypernerf_tpu_torch.kernels.fused_se3')
    fj = importlib.import_module('hypernerf_tpu_torch.kernels.fused_jacobian')

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

    def inputs(rays, samples, seed):
        return [torch.from_numpy(v).cuda()
                for v in probe_inputs(rays, samples, seed).values()]

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    def report(label, macs, rows, launch, n_grads, this_only=False):
        """Times each library's launches in turns (``this_only``: this
        checkout's library twice); launch(lib, bld) zeroes and fills that
        library's outputs and returns them, the gradients last (``n_grads``
        buffers, flat or as copies to be summed; 0: every output compared
        as max|d|)."""
        keys = ['this'] if this_only else list(libs)
        times = {k: [] for k in keys}
        for k in (['this', 'this'] if this_only else order):
            times[k].append(_time(lambda: launch(*libs[k])))
        bound = 6.0 * macs * rows / PEAK_FLOPS * 1e3
        mean = {k: sum(v) / len(v) for k, v in times.items()}
        parts = [f'{k} ' + ', '.join(f'{t:.3f}' for t in v) + ' ms'
                 f' ({100 * bound / mean[k]:.1f} % of {bound:.4f})'
                 for k, v in times.items()]
        if 'parent' in keys:
            got = {k: [t.clone() for t in launch(*libs[k])] for k in libs}
            torch.cuda.synchronize()
            n = len(got['this']) - n_grads
            rows_d = ', '.join(f'{(a - b).abs().max().item():.3e}' for a, b
                               in zip(got['parent'][:n], got['this'][:n]))
            # The gradient copies a block adds into, summed.
            sums = {k: [t.sum(0) if t.dim() == 2 else t for t in v[n:]]
                    for k, v in got.items()}
            part = (f'parent / this {mean["parent"] / mean["this"]:.2f}x'
                    f', rows max|d| {rows_d}')
            if n_grads:
                grads_d = max(rel_l2(a, b) for a, b in
                              zip(sums['this'], sums['parent']))
                part += f', dW / db relative L2 {grads_d:.3e}'
            parts.append(part)
        print(f'{label}: ' + '; '.join(parts), flush=True)

    with torch.no_grad():
        if args.field in ('template', 'template_nerfies_plane'):
            fm = importlib.import_module(
                'hypernerf_tpu_torch.kernels.fused_mlp')
            rays_a = 16384
            ep = anneal_extra_params()

            def ops_of(lib, bld):
                """Kernel A's steps on ``lib``; a library whose encoding
                steps take no raw width gets none."""
                ops = fm._KernelOps(torch.device('cuda'))
                ops.lib = lib
                if len(bld._SIGNATURES['hn_tmpl_encode'][0]) == 7:
                    ops.encode = lambda raw, stash, col, n, sc: ops._go(
                        'hn_tmpl_encode', raw.data_ptr(), stash.data_ptr(),
                        stash.shape[1], col, n, fm._ptr(sc))
                    ops.posenc_bwd = lambda raw, e, dx, n, sc: ops._go(
                        'hn_tmpl_posenc_bwd', raw.data_ptr(), e.data_ptr(),
                        e.shape[1], dx.data_ptr(), n, fm._ptr(sc))
                return ops
            configs = (('flagship', 'plane', 'anneal')
                       if args.field == 'template' else ('plane_anneal',))
            for config in configs:
                probe = load_probe_weights(flagship_model('cuda',
                                                          config=config))
                for s in (128, 64):
                    tmpl = probe.level('fine' if s == 128 else 'coarse')
                    z, o, d, emb, cond = inputs(rays_a, s, seed=s + 5)
                    row = None
                    if tmpl.nerfies:
                        cond = torch.from_numpy(anneal_condition(
                            d.cpu().numpy(), ep['nerf_alpha'])).cuda()
                        row = fm.template_scales(tmpl, ep['nerf_alpha'],
                                                 ep['hyper_alpha'], z.device)
                    raw_t = fl._launch_forward(tmpl, z, o, d, emb, cond,
                                               want_raw_t=True,
                                               tmpl_scales=row)[1]
                    row = fm.kernel_scales(tmpl, row, z.device)
                    g = torch.randn(rays_a * s, 4, generator=torch.Generator(
                        ).manual_seed(s)).cuda()
                    (rgbc, _, _), per, layers, packs = fm._launch_args(
                        tmpl, raw_t, cond, True)
                    (w_blob, b_blob, shapes), (wt_blob, _, _) = packs
                    views = fm.layer_views(w_blob, wt_blob, b_blob, shapes)
                    macs = sum(lin.weight.numel() for lin, _ in layers)

                    def launch(lib, bld):
                        return list(fm.template_bwd_chunks(
                            ops_of(lib, bld), raw_t, rgbc, per, g, *views,
                            scales=row)[:3])
                    report(f'kernel A {config} R={rays_a} S={s}', macs,
                           rays_a * s, launch, 0,
                           this_only=config == 'plane_anneal')
            return 0
        if args.field == 'warp_tangents':
            mlp = load_probe_weights(flagship_model(
                'cuda', config='elastic')).warp_field.mlp
            layers = ff.field_layers(mlp)
            macs = sum(lin.weight.numel() for lin, _ in layers)
            w, b, shapes = fj._launch_args(mlp, 10,
                                           torch.zeros((1, 11), device='cuda'))
            wt = common.pack_layers(mlp, layers, transposed=True)[0]
            name = 'hn_fused_jacobian_bwd'
            x = fl._raw_fields(*inputs(16384, 16, seed=16384)[:4])
            x = x.contiguous()
            p = x.shape[0]
            g = torch.randn(p, fj.JAC, generator=torch.Generator(
                ).manual_seed(16384)).cuda()
            dx = torch.empty_like(x)
            copies, _ = fl.fields_bwd_grad_copies(shapes, 'cuda')
            one = torch.zeros(copies.shape[1], device='cuda')
            blocks = build.library().hn_fused_fields_bwd_blocks(4 * p)
            scratch = torch.empty(blocks * fl.FB_SPILL_SLABS
                                  * fl.FB_SLAB_BYTES, dtype=torch.uint8,
                                  device='cuda')

            def launch(lib, bld):
                if f'{name}_blocks' not in bld._SIGNATURES:
                    copies.zero_()
                    bld.check(getattr(lib, name)(
                        x.data_ptr(), None, g.data_ptr(), w.data_ptr(),
                        b.data_ptr(), dx.data_ptr(), copies.data_ptr(),
                        scratch.data_ptr(), p, blocks, stream), name)
                    return [dx, copies]
                one.zero_()
                bld.check(getattr(lib, name)(
                    x.data_ptr(), g.data_ptr(), w.data_ptr(), wt.data_ptr(),
                    b.data_ptr(), dx.data_ptr(), one.data_ptr(), p,
                    getattr(lib, f'{name}_blocks')(p), stream), name)
                return [dx, one]
            # The bound: the recompute on four streams, g W and g^T h on
            # the three tangent streams (report() counts 6 flops a weight
            # and row, so 10 / 3 rows a point).
            report(f'warp_tangents backward {p} points', macs, 10 * p / 3,
                   launch, 1)
            return 0
        if args.field in ('se3', 'se3_tangents'):
            tan = args.field == 'se3_tangents'
            field = load_probe_weights(flagship_model(
                'cuda', config='elastic_se3' if tan else 'se3')).warp_field
            layers = fs.se3_layers(field)
            macs = sum(lin.weight.numel() for lin, _ in layers)
            _, (w, b, shapes) = fs._launch_args(
                field, torch.zeros((1, 11), device='cuda'), None)
            wt = common.pack_layers(field, layers, transposed=True)[0]
            name = 'hn_fused_se3_jacobian_bwd' if tan else 'hn_fused_se3_bwd'
            width, streams = (24, 4) if tan else (8, 1)
            for rays, samples in (((16384, 16),) if tan
                                  else ((8192, 128), (16384, 128))):
                x = fl._raw_fields(*inputs(rays, samples, seed=rays)[:4])
                x = x.contiguous()
                p = x.shape[0]
                g = torch.randn(p, width, generator=torch.Generator(
                    ).manual_seed(rays)).cuda()
                if not tan:
                    g[:, 6:] = 0.0
                dx = torch.empty_like(x)
                copies, _ = fl.fields_bwd_grad_copies(shapes, 'cuda')
                one = torch.zeros(copies.shape[1], device='cuda')
                blocks = build.library().hn_fused_fields_bwd_blocks(
                    streams * p)
                scratch = torch.empty(blocks * fl.FB_SPILL_SLABS
                                      * fl.FB_SLAB_BYTES, dtype=torch.uint8,
                                      device='cuda')

                def launch(lib, bld):
                    if f'{name}_blocks' not in bld._SIGNATURES:
                        copies.zero_()
                        bld.check(getattr(lib, name)(
                            x.data_ptr(), None, g.data_ptr(), w.data_ptr(),
                            b.data_ptr(), dx.data_ptr(), copies.data_ptr(),
                            scratch.data_ptr(), p, blocks, stream), name)
                        return [dx, copies]
                    one.zero_()
                    bld.check(getattr(lib, name)(
                        x.data_ptr(), None, g.data_ptr(), w.data_ptr(),
                        wt.data_ptr(), b.data_ptr(), dx.data_ptr(),
                        one.data_ptr(), p,
                        getattr(lib, f'{name}_blocks')(p), stream), name)
                    return [dx, one]
                what = (f'{p} points' if tan else f'P={p}')
                report(f'{args.field} backward {what}', macs, streams * p,
                       launch, 1)
            return 0
        if args.field in ('warp', 'sheet'):
            probe = load_probe_weights(flagship_model('cuda'))
            field = (probe.warp_field if args.field == 'warp'
                     else probe.hyper_sheet_mlp)
            mlp, n_freq = field.mlp, field.n_freq
            layers = ff.field_layers(mlp)
            macs = sum(lin.weight.numel() for lin, _ in layers)
            out_ch = mlp.logit.out_features
            which, _, (w, b, shapes) = ff._launch_args(
                mlp, n_freq, torch.zeros((1, 11), device='cuda'), None)
            wt = common.pack_layers(mlp, layers, transposed=True)[0]
            for rays in (8192, 16384):
                x = fl._raw_fields(*inputs(rays, 128, seed=rays)[:4])
                x = x.contiguous()
                p = x.shape[0]
                g = F.pad(torch.randn(p, out_ch, generator=torch.Generator(
                    ).manual_seed(rays)), (0, 8 - out_ch)).cuda()
                dx = torch.empty_like(x)
                copies, _ = fl.fields_bwd_grad_copies(shapes, 'cuda')
                one = torch.zeros(copies.shape[1], device='cuda')
                blocks = build.library().hn_fused_fields_bwd_blocks(p)
                scratch = torch.empty(blocks * fl.FB_SPILL_SLABS
                                      * fl.FB_SLAB_BYTES, dtype=torch.uint8,
                                      device='cuda')

                def launch(lib, bld):
                    if 'hn_fused_field_bwd_plan' in bld._SIGNATURES:
                        copies.zero_()
                        bld.check(lib.hn_fused_field_bwd(
                            which, x.data_ptr(), None, g.data_ptr(),
                            w.data_ptr(), b.data_ptr(), dx.data_ptr(),
                            copies.data_ptr(), scratch.data_ptr(), p,
                            blocks, stream), 'hn_fused_field_bwd')
                        return [dx, copies]
                    one.zero_()
                    bld.check(lib.hn_fused_field_bwd(
                        which, x.data_ptr(), None, g.data_ptr(),
                        w.data_ptr(), wt.data_ptr(), b.data_ptr(),
                        dx.data_ptr(), one.data_ptr(), p,
                        lib.hn_fused_field_bwd_blocks(p), stream),
                        'hn_fused_field_bwd')
                    return [dx, one]
                report(f'{args.field} field backward P={p}', macs, p, launch,
                       1)
            return 0

        rays = 16384
        tables = ((('translation', 'flagship'), ('se3', 'se3'),
                   ('quaternion', 'quaternion'), ('plane', 'plane'))
                  if args.field is None else ((args.field, args.field),))
        for warp, config in tables:
            probe = load_probe_weights(flagship_model('cuda', config=config))
            # Without a sheet dx_t is [d warped | d hyper (8) | 0], 16
            # columns.
            width, raw = ((7, 8) if common.table_has_sheet(warp)
                          else (11, 16))
            for s in (64, 128):
                level = probe.level('fine' if s == 128 else 'coarse')
                w, b, shapes = fl.pack_level(level)
                nf = len(shapes) - 16  # the field layers
                macs = sum(lin.weight.numel()
                           for lin, _ in fl.level_layers(level)[:nf])
                z, o, d, emb, _ = inputs(rays, s, seed=s + 3)
                dx_t = F.pad(torch.randn(
                    rays * s, width,
                    generator=torch.Generator().manual_seed(s)),
                    (0, raw - width)).cuda()
                d_z = torch.empty((rays, s), device='cuda')
                d_ray = torch.zeros((rays, 14), device='cuda')
                copies, _ = fl.fields_bwd_grad_copies(shapes[:nf], 'cuda')
                blocks = build.library().hn_fused_fields_bwd_blocks(rays * s)
                scratch = torch.empty(blocks * fl.FB_SPILL_SLABS
                                      * fl.FB_SLAB_BYTES, dtype=torch.uint8,
                                      device='cuda')

                def launch(lib, bld):
                    d_ray.zero_()
                    copies.zero_()
                    bld.check(lib.hn_fused_fields_bwd(
                        common.TABLE_CODES[warp], z.data_ptr(), o.data_ptr(),
                        d.data_ptr(), emb.data_ptr(), dx_t.data_ptr(), None,
                        w.data_ptr(), b.data_ptr(), d_z.data_ptr(),
                        d_ray.data_ptr(), copies.data_ptr(),
                        scratch.data_ptr(), rays, s, blocks, stream),
                        'hn_fused_fields_bwd')
                    return [d_z, d_ray, copies]
                report(f'kernel B {warp} R={rays} S={s}', macs, rays * s,
                       launch, 1, this_only=args.field is not None)
    return 0


if __name__ == '__main__':
    sys.exit(main())
