#!/usr/bin/env python3
"""Profile the float32 kernels (``--precision 32``, ``kernels/f32.py``) on
the card: one call of each under ``torch.profiler``, at the probe weights,
with TF32 off, its device time by CUDA kernel (kernels A and B and a field
or the trunk alone backward are sequences of steps): rows 1, 9 and 5 at R
x S, the per-module rows, 8 (the template alone at R = 8192, S = 128), 10
(each field alone at 8192 x 128 rows), 11 (each field alone backward at R
x S rows) and 9 at the static template's width (R x 64), and the screw
warps' rows, 1 and 5 on the ``se3`` level with the window row at R x S,
12 (the trunk alone at 8192 x 128 rows) and 13 (its backward at R x S
rows), and rows 1 and 9 in the Nerfies layout (``anneal`` with the
template's window row at the alphas of ``flagship.ANNEAL_PROBE_STEP``) and
with the ``nerf_embed`` conditions (47 rgb columns, the alpha condition) at
R x S, and the plane tables' rows: 1 at table codes 3 (``plane``) and 6
(``plane_anneal``, its window row), 9 and 5 at code 3, all at R x S, and
8 in the posenc_orig plane layout at 8192 x 128 rows:

  python3 tools/time_f32.py [--rays 16384] [--samples 128] [--parent DIR]

With ``--parent DIR`` (a checkout, e.g. an unpacked ``git archive``) it
first builds DIR's float32 sources alone (csrc/f32_level.cu and
f32_steps.cu) into build/parent_f32/, then times the float32 level forward
of this checkout's library and of DIR's in turns (this, parent, parent,
this; CUDA events) at R = 8192 and R x S, S = 128, on the flagship table
(code 0) and, where DIR's library takes a table code, on the SE(3) table
with the trunk's window row (code 1) and the quaternion table (code 2),
and holds the outputs and raw_t of the two equal bit for bit (exit code 1
if not). Each library is called with as many arguments as its own
signature declares: the posenc_orig template, its 39-column condition, no
alpha condition. Then it runs this checkout's step sequences of rows 9, 5,
11 and 13 (kernels A and B, a field alone backward, the trunk alone
backward; R x S rows) on each library's steps in turns the same way, and
holds every output and gradient of the two equal bit for bit: the
parent's ``hn_f32_rowprod`` and ``hn_f32_dw`` lack the mask's row count
and the db row count, which these rows set to every row, so the parent is
called without them.

Prints the card's name and power limit beside each table. ``chip_smoke.py``
phases 33 and 34 hold the same kernels to their plain versions and time
them whole, with CUDA events; this tool says where inside a call the time
goes.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _parent_f32_library(repo: str):
    """DIR's float32 level forward: its csrc/f32_level.cu and f32_steps.cu
    compiled with this checkout's flags into build/parent_f32/, its entry
    point bound with DIR's own ctypes signature."""
    import ctypes
    import importlib.util

    from hypernerf_tpu_torch.kernels import build
    csrc = os.path.join(os.path.abspath(repo), 'hypernerf_tpu_torch',
                        'kernels', 'csrc')
    out = build.BUILD_DIR.parent / 'parent_f32'
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    objs, procs = [], []
    for name in ('f32_level.cu', 'f32_steps.cu'):
        obj = str(out / (name + '.o'))
        objs.append(obj)
        procs.append(subprocess.Popen([nvcc, *build.NVCC_FLAGS, '-c', '-o',
                                       obj, os.path.join(csrc, name)]))
    if any(p.wait() for p in procs):
        raise RuntimeError(f'nvcc failed on {csrc}')
    so = str(out / 'libparent_f32.so')
    subprocess.run([nvcc, '-shared', '-o', so, *objs], check=True)
    lib = ctypes.CDLL(so)
    spec = importlib.util.spec_from_file_location(
        'parent_build', os.path.join(os.path.abspath(repo),
                                     'hypernerf_tpu_torch', 'kernels',
                                     'build.py'))
    parent_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent_build)
    for name, (argtypes, restype) in parent_build._SIGNATURES.items():
        fn = getattr(lib, name, None) if name.startswith('hn_f32_') else None
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, restype
    return lib


class _ParentSteps:
    """The parent's library as this checkout's float32 steps call it. An
    entry in ``DROP`` (argument count here, index of the argument the
    parent lacks, index of the row count it must equal) is called without
    that argument where the parent's signature is one shorter; the
    argument must equal the rows (or be 0, no mask), where the parent's
    arithmetic is this checkout's."""

    DROP = {'hn_f32_rowprod': (19, 13, 17), 'hn_f32_dw': (18, 14, 15)}

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        n, i, rows = self.DROP.get(name, (0, 0, 0))
        if len(fn.argtypes) + 1 != n:
            return fn

        def call(*a):
            if a[i] not in (0, a[rows]):
                raise ValueError(f'{name}: argument {i} is {a[i]}, not the '
                                 f'{a[rows]} rows the parent assumes')
            return fn(*a[:i], *a[i + 1:])
        return call


# The arguments between the weights' pointers and the outputs' of each
# version of ``hn_f32_level_fwd``, by its argument count: none (PRs 22 and
# 23), the table code and the trunk's window row (PR 24), and since then
# also the template's window row and the alpha condition's two pointers
# (none of them here: the posenc_orig template without an alpha condition).
_LEVEL_ARGS = {13: lambda code, row: [], 15: lambda code, row: [code, row],
               18: lambda code, row: [code, row, None, None, None]}


def compare_parent(parent_lib, levels, shapes, card: str) -> bool:
    """The float32 level forward of this checkout and of the parent's
    library (``_parent_f32_library``) in
    turns at each (R, S) of ``shapes`` for each (label, level, table code,
    trunk window row or None) of ``levels`` that the parent's library takes
    (one without a table code: code 0 alone); True if every output and
    raw_t is equal bit for bit."""
    import torch

    import chip_smoke as cs
    from hypernerf_tpu_torch.kernels import build
    from hypernerf_tpu_torch.kernels.fused_level import pack_level_f32
    from hypernerf_tpu_torch.kernels.fused_mlp import cond_args
    libs = {'this': build.library(), 'parent': parent_lib}
    stream = torch.cuda.current_stream().cuda_stream
    same = True
    for label, lv, code, row in levels:
        if code and len(libs['parent'].hn_f32_level_fwd.argtypes) == 13:
            continue
        wt = pack_level_f32(lv, transposed=True)[0]
        b = pack_level_f32(lv)[1]
        for r, s in shapes:
            z, o, d, emb, cond = cs.level_inputs(r, s, seed=r + s)
            cond = cond_args(lv, cond, None, r, z.device, torch.float32)[0]
            outs = {k: (torch.empty((r * s, 4), device='cuda'),
                        torch.empty((r * s, 8), device='cuda'))
                    for k in libs}

            def launch(k):
                out, raw = outs[k]
                fn = libs[k].hn_f32_level_fwd
                build.check(fn(
                    z.data_ptr(), o.data_ptr(), d.data_ptr(), emb.data_ptr(),
                    cond.data_ptr(), cond.shape[1], wt.data_ptr(),
                    b.data_ptr(), *_LEVEL_ARGS[len(fn.argtypes)](
                        code, None if row is None else row.data_ptr()),
                    out.data_ptr(), raw.data_ptr(), r, s, stream),
                    'hn_f32_level_fwd')

            times = {k: [] for k in libs}
            for k in ('this', 'parent', 'parent', 'this'):
                times[k].append(cs.cuda_ms(lambda: launch(k), 5))
            torch.cuda.synchronize()
            equal = all(torch.equal(a, c) for a, c in zip(outs['this'],
                                                          outs['parent']))
            same = same and equal
            print(f'float32 level forward {label} (code {code}) R={r} '
                  f'S={s}: this '
                  + ', '.join(f'{t:.3f}' for t in times['this'])
                  + ' ms; parent ' + ', '.join(f'{t:.3f}' for t in
                                              times['parent'])
                  + f' ms; outputs and raw_t equal bit for bit: {equal}; '
                  f'{card}', flush=True)
    return same


def compare_parent_steps(parent_lib, calls, card: str) -> bool:
    """Each (label, call returning tensors) of ``calls`` run with this
    checkout's library and with the parent's (``_ParentSteps``) in turns
    (this, parent, parent, this; CUDA events); True if every returned
    tensor is equal bit for bit."""
    import torch

    import chip_smoke as cs
    from hypernerf_tpu_torch.kernels import build
    here = build.library
    libs = {'this': here, 'parent': lambda: _ParentSteps(parent_lib)}
    same = True
    for label, fn in calls:
        outs, times = {}, {k: [] for k in libs}
        for k in ('this', 'parent', 'parent', 'this'):
            build.library = libs[k]
            try:
                times[k].append(cs.cuda_ms(fn, 3))
                outs[k] = fn()
                torch.cuda.synchronize()
            finally:
                build.library = here
        flat = {k: [t for t in v if isinstance(t, torch.Tensor)]
                + [t for u in v if isinstance(u, (list, tuple))
                   for t in u if isinstance(t, torch.Tensor)]
                for k, v in outs.items()}
        equal = len(flat['this']) == len(flat['parent']) and all(
            torch.equal(a, c) for a, c in zip(flat['this'], flat['parent']))
        same = same and equal
        print(f'float32 {label}: this '
              + ', '.join(f'{t:.3f}' for t in times['this'])
              + ' ms; parent ' + ', '.join(f'{t:.3f}' for t in
                                          times['parent'])
              + f' ms; {len(flat["this"])} outputs and gradients equal bit '
              f'for bit: {equal}; {card}', flush=True)
    return same


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--rays', type=int, default=16384)
    parser.add_argument('--samples', type=int, default=128)
    parser.add_argument('--parent', default=None)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('time_f32: no CUDA device', file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from hypernerf_tpu_torch.flagship import (anneal_extra_params,
                                              flagship_model,
                                              load_probe_weights)
    from hypernerf_tpu_torch.kernels import (build, fused_field,
                                             fused_field_bwd,
                                             fused_fields_bwd, fused_level,
                                             fused_se3_bwd, fused_se3_wv,
                                             fused_template,
                                             fused_template_bwd)
    from hypernerf_tpu_torch.kernels.fused_se3 import se3_encoding_scales
    from hypernerf_tpu_torch.kernels.fused_level import _launch_forward
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    build.library()
    model = load_probe_weights(flagship_model('cuda',
                                              compute_dtype='float32'))
    static = load_probe_weights(flagship_model(
        'cuda', config='static', compute_dtype='float32'))
    se3 = load_probe_weights(flagship_model('cuda', config='se3',
                                            compute_dtype='float32'))
    quat = load_probe_weights(flagship_model('cuda', config='quaternion',
                                             compute_dtype='float32'))
    lv = model.level('fine')
    r, s = args.rays, args.samples
    if args.parent:
        sv = se3.level('fine')
        ws = se3_encoding_scales(sv.warp, cs.WINDOW_ALPHA, 'cuda')
        levels = (('flagship', lv, 0, None),
                  ('se3 with the window row', sv, 1, ws),
                  ('quaternion', quat.level('fine'), 2, None))
        parent_lib = _parent_f32_library(args.parent)
        with torch.no_grad():
            if not compare_parent(parent_lib, levels, ((8192, 128), (r, s)),
                                  card):
                return 1
            ins = cs.level_inputs(r, s, seed=5)
            _, raw_t = _launch_forward(lv, *ins, want_raw_t=True)
            g = torch.randn(r * s, 4, generator=torch.Generator(
                ).manual_seed(5)).cuda()
            dx_t = fused_template_bwd(lv, raw_t, ins[4], g)[0]
            bx = cs.field_rows(r * s, seed=9)
            fg = torch.randn(r * s, 8, generator=torch.Generator(
                ).manual_seed(9)).cuda()
            tg = fg.clone()
            tg[:, 6:] = 0.0
            wf = model.warp_field
            calls = (('row 9 (kernel A)',
                      lambda: fused_template_bwd(lv, raw_t, ins[4], g)),
                     ('row 5 (kernel B)',
                      lambda: fused_fields_bwd(lv, *ins[:4], dx_t)),
                     ('row 11 warp_field',
                      lambda: fused_field_bwd(wf.mlp, wf.n_freq, bx, fg)),
                     ('row 13 (window row)',
                      lambda: fused_se3_bwd(sv.warp, bx, tg, ws)))
            if not compare_parent_steps(parent_lib, calls, card):
                return 1
            del ins, raw_t, g, dx_t, bx, fg, tg
    with torch.no_grad():
        ins = cs.level_inputs(r, s, seed=5)
        _, raw_t = _launch_forward(lv, *ins, want_raw_t=True)
        g = torch.randn(r * s, 4, generator=torch.Generator().manual_seed(
            5)).cuda()
        dx_t = fused_template_bwd(lv, raw_t, ins[4], g)[0]
        tx, tcond = cs.template_rows(8192, 128, seed=6, static=False)
        sx, scond = cs.template_rows(r, 64, seed=7, static=True)
        sg = torch.randn(r * 64, 4, generator=torch.Generator().manual_seed(
            7)).cuda()
        fx = cs.field_rows(8192 * 128, seed=8)
        bx = cs.field_rows(r * s, seed=9)
        fg = torch.randn(r * s, 8, generator=torch.Generator().manual_seed(
            9)).cuda()
        stmpl = static.template_of('coarse')
        calls = (('row 1', lambda: fused_level(lv, *ins)),
                 ('row 9', lambda: fused_template_bwd(lv, raw_t, ins[4], g)),
                 ('row 5', lambda: fused_fields_bwd(lv, *ins[:4], dx_t)),
                 ('row 8 (8192 x 128)',
                  lambda: fused_template(lv, tx, tcond)),
                 ('row 9 at the static width (S = 64)',
                  lambda: fused_template_bwd(stmpl, sx, scond, sg)))
        for name in ('warp_field', 'hyper_sheet_mlp'):
            f = getattr(model, name)
            calls += ((f'row 10 {name} (8192 x 128 rows)',
                       lambda f=f: fused_field(f.mlp, f.n_freq, fx)),
                      (f'row 11 {name}',
                       lambda f=f: fused_field_bwd(f.mlp, f.n_freq, bx, fg)))
        sv = se3.level('fine')
        ws = se3_encoding_scales(sv.warp, cs.WINDOW_ALPHA, 'cuda')
        _, s_raw = _launch_forward(sv, *ins, want_raw_t=True,
                                   warp_scales=ws)
        s_dx = fused_template_bwd(sv, s_raw, ins[4], g)[0]
        tg = fg.clone()
        tg[:, 6:] = 0.0
        calls += (('row 1 se3 (window row)',
                   lambda: fused_level(sv, *ins, warp_scales=ws)),
                  ('row 5 se3 (window row)',
                   lambda: fused_fields_bwd(sv, *ins[:4], s_dx, ws)),
                  ('row 12 (8192 x 128 rows, window row)',
                   lambda: fused_se3_wv(sv.warp, fx, ws)),
                  ('row 13 (window row)',
                   lambda: fused_se3_bwd(sv.warp, bx, tg, ws)))
        extra = anneal_extra_params()
        for config in ('anneal', 'nerf_embed'):
            nm = load_probe_weights(flagship_model(
                'cuda', config=config, compute_dtype='float32'))
            nv = nm.level('fine')
            n_args, alpha = cs.f32_nerfies_level_inputs(
                nm, r, s, 10, extra['nerf_alpha'])
            ts = cs.f32_nerfies_windows(nv, extra)[1]
            n_raw = _launch_forward(nv, *n_args, want_raw_t=True,
                                    tmpl_scales=ts, alpha_cond=alpha)[1]
            calls += ((f'row 1 {config}', lambda nv=nv, a=n_args, ts=ts,
                       al=alpha: fused_level(nv, *a, tmpl_scales=ts,
                                             alpha_cond=al)),
                      (f'row 9 {config}', lambda nv=nv, raw=n_raw, a=n_args,
                       ts=ts, al=alpha: fused_template_bwd(
                           nv, raw, a[4], g, ts, al)))
        for config in ('plane', 'plane_anneal'):
            pm = load_probe_weights(flagship_model(
                'cuda', config=config, compute_dtype='float32'))
            pv = pm.level('fine')
            p_args = cs.f32_nerfies_level_inputs(pm, r, s, 11,
                                                 extra['nerf_alpha'])[0]
            ts = cs.f32_nerfies_windows(pv, extra)[1]
            calls += ((f'row 1 {config}', lambda pv=pv, a=p_args, ts=ts:
                       fused_level(pv, *a, tmpl_scales=ts)),)
            if config != 'plane':
                continue
            p_raw = _launch_forward(pv, *p_args, want_raw_t=True)[1]
            p_dx = fused_template_bwd(pv, p_raw, p_args[4], g)[0]
            px, pcond = cs.f32_plane_template_rows(pm, 8192 * 128, 128, 12,
                                                   None)
            calls += (('row 9 plane (a 176-column encoding stash)',
                       lambda pv=pv, raw=p_raw, a=p_args: fused_template_bwd(
                           pv, raw, a[4], g)),
                      ('row 5 plane (no sheet)',
                       lambda pv=pv, a=p_args, dx=p_dx: fused_fields_bwd(
                           pv, *a[:4], dx)),
                      ('row 8 plane (8192 x 128, x_raw of 16 columns)',
                       lambda pv=pv, x=px, c=pcond: fused_template(pv, x,
                                                                   c)))
        for _, fn in calls:  # warm up
            fn()
        for label, fn in calls:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            print(f'{label} (R={r} S={s} where not given), device time by '
                  f'kernel; {card}')
            print(prof.key_averages().table(
                sort_by='cuda_time_total', row_limit=10,
                max_name_column_width=40), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
