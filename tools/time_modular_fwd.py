#!/usr/bin/env python
"""The per-module forward kernels' times (the warp field and the sheet
alone, ``hn_fused_field_fwd``; the template alone, ``hn_fused_template_fwd``;
the SE(3) trunk alone, ``hn_fused_se3_fwd``) and the level forward's
(``hn_fused_level_fwd``, each warp type), the plane configuration's
template alone (``hn_fused_template_fwd_plane``) and level forward (table
code 3) and the anneal configuration's (the Nerfies layout with its window
row at ``flagship.ANNEAL_PROBE_STEP``'s alphas), on one CUDA card, for this
checkout's kernel library and, with ``--parent``, for another checkout's,
in turns in one process: this, parent, parent, this. With ``--kernel
warp_tangents`` or ``se3_tangents``, a Jacobian's forward alone instead:
the translation warp's (``hn_fused_jacobian_fwd``, the ``elastic`` probe
weights) or the SE(3) trunk's with its tangents (``hn_fused_se3_jacobian_fwd``,
``elastic_se3``, window row off and on), at 1001 and 262,144 points (the
train step's: 16384 rays x 16). With ``--config`` one of the warp x
slicing x encoding combinations (``flagship.B4_CONFIGS``), that
configuration's level forward alone at R = 8192 and 16384, S = 128, both
window rows at ``flagship.b4_extra_params``' alphas (and for
``plane_anneal`` its template alone in the Nerfies plane layout), this
checkout's library alone.

  python tools/time_modular_fwd.py [--parent DIR]
      [--kernel all|warp_tangents|se3_tangents] [--config NAME]

``DIR`` is a checkout of an earlier commit (for example an unpacked ``git
archive``) whose entry points take the same arguments and blobs, or lack
the template's window row, which is then left out of its calls (the
flagship's layout takes none), or lack the conditions' arguments (the alpha
condition, its weights and the rgb condition's width), which are then left
out of its calls (these shapes have no alpha condition and the layout's own
rgb width); its library is built from its own ``kernels/csrc`` into its own
``build/``.
Both libraries get this checkout's packed blobs of the probe weights
(``flagship.load_probe_weights``) and the same inputs. Shapes: the fields and
the trunk at 8192 x 128 and 16384 x 128 rows; the template at R = 8192 and
16384, S = 128 and 64, at 1 << 20 rows with S = 1, and the static template
at R = 8192, S = 128; the level at R = 8192, S = 128 and 64, each warp
type. CUDA events, the mean
of 10 launches after 2. Prints the card's name and power limit first, then
one line per kernel and shape with each library's two times, the ratio of
the means, the share of the bound (operations over 989 TFLOP/s) and the
largest difference of the outputs from this checkout's (a Jacobian's
bound counts its four rows a point); exits non-zero without a card.
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
    """The kernel library of the checkout at ``repo``, built from its
    sources by its own ``build.py``."""
    path = os.path.join(repo, 'hypernerf_tpu_torch', 'kernels', 'build.py')
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.library()


def _no_row(fn, n_without: int):
    """The template window row's argument for C entry point ``fn``: [None]
    (the flagship's posenc_orig layout) where ``fn`` takes it, that is
    takes more than ``n_without`` arguments, else nothing."""
    return [None] if len(fn.argtypes) > n_without else []


def _conds(fn, n_with: int, width: int):
    """The conditions' arguments of C entry point ``fn`` where it takes them
    (``n_with`` arguments): (no alpha condition, no weights) and the rgb
    condition's ``width``; ([], []) for an entry point without them."""
    if len(fn.argtypes) == n_with:
        return [None, None], [width]
    return [], []


def _time(fn, iters: int = 10) -> float:
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


def _tangents(kernel, inputs, report, stream):
    """A Jacobian's forward (``kernel``) of each library at 1001 and 262,144
    points of the probe rays, [pts | embed] rows as the train step's
    subsample gives them."""
    import torch
    from hypernerf_tpu_torch.flagship import (flagship_model,
                                              load_probe_weights)
    from hypernerf_tpu_torch.kernels import build
    ff = importlib.import_module('hypernerf_tpu_torch.kernels.fused_field')
    fj = importlib.import_module('hypernerf_tpu_torch.kernels.fused_jacobian')
    fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
    fs = importlib.import_module('hypernerf_tpu_torch.kernels.fused_se3')
    fsj = importlib.import_module(
        'hypernerf_tpu_torch.kernels.fused_se3_jacobian')
    trans = kernel == 'warp_tangents'
    field = load_probe_weights(flagship_model(
        'cuda', config='elastic' if trans else 'elastic_se3')).warp_field
    for p in (1001, 1 << 18):
        x_raw = fl._raw_fields(*inputs(-(-p // 16), 16, seed=p % 97)[:4])
        x_raw = x_raw[:p].contiguous()
        if trans:
            w, b, _ = fj._launch_args(field.mlp, 10, x_raw)
            macs = sum(lin.weight.numel()
                       for lin, _ in ff.field_layers(field.mlp))
            out = torch.empty((p, fj.JAC), device='cuda')

            def launch(lib):
                build.check(lib.hn_fused_jacobian_fwd(
                    x_raw.data_ptr(), w.data_ptr(), b.data_ptr(),
                    out.data_ptr(), p, stream), 'hn_fused_jacobian_fwd')
                return out
            report(f'warp_tangents P={p}', 4 * macs, p, launch)
            continue
        macs = sum(lin.weight.numel() for lin, _ in fs.se3_layers(field))
        for alpha in (None, 3.5):
            window = (None if alpha is None else
                      fs.se3_encoding_scales(field, alpha, 'cuda'))
            scales, (w, b, _) = fs._launch_args(field, x_raw, window)
            out = torch.empty((p, fsj.OUT), device='cuda')

            def launch(lib):
                build.check(lib.hn_fused_se3_jacobian_fwd(
                    x_raw.data_ptr(),
                    None if scales is None else scales.data_ptr(),
                    w.data_ptr(), b.data_ptr(), out.data_ptr(), p, stream),
                    'hn_fused_se3_jacobian_fwd')
                return out
            report(f'se3_tangents P={p} window='
                   f'{"off" if alpha is None else "on"}', 4 * macs, p,
                   launch)


def _b4_level(config, inputs, report, stream):
    """The level forward of B.4 configuration ``config`` (and, for the
    Nerfies plane layout, its template alone), this checkout's library."""
    import torch
    from hypernerf_tpu_torch.flagship import (anneal_condition,
                                              b4_extra_params,
                                              flagship_model,
                                              load_probe_weights)
    from hypernerf_tpu_torch.kernels import build, common
    fm = importlib.import_module('hypernerf_tpu_torch.kernels.fused_mlp')
    fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
    model = load_probe_weights(flagship_model('cuda', config=config))
    dev = next(model.parameters()).device
    warp_row, tmpl_row = model.window_rows(b4_extra_params(config), dev)
    lv = model.level('fine')
    w, b, shapes = fl.pack_level(lv)
    code, ws = fl._warp_launch_args(lv, shapes, warp_row, dev)
    ts = fm.kernel_scales(lv, tmpl_row, dev)
    macs = sum(lin.weight.numel() for lin, _ in fl.level_layers(lv))
    for rays in (8192, 16384):
        z, o, d, emb, cond = inputs(rays, 128, seed=128)
        if ts is not None:  # the Nerfies condition
            cond = torch.from_numpy(anneal_condition(d.cpu().numpy(),
                                                     10.0)).cuda()
        rgbc = cond.to(torch.bfloat16).contiguous()
        p = rays * 128
        out = torch.empty((p, 4), device='cuda')
        raw_t = torch.empty((p, fm.raw_pad(lv)), device='cuda')

        def launch(lib):
            build.check(lib.hn_fused_level_fwd(
                code, z.data_ptr(), o.data_ptr(), d.data_ptr(),
                emb.data_ptr(), rgbc.data_ptr(), None, None,
                None if ws is None else ws.data_ptr(),
                None if ts is None else ts.data_ptr(), w.data_ptr(),
                b.data_ptr(), out.data_ptr(), raw_t.data_ptr(), rays, 128,
                rgbc.shape[1], stream), 'hn_fused_level_fwd')
            return out
        report(f'{config} level forward R={rays} S=128', macs, p, launch,
               this_only=True)
        if fm.layout(lv) != 'nerfies_plane':
            continue
        _, per, _, ((tw, tb, _),) = fm._launch_args(lv, raw_t, cond, False)
        tmacs = sum(lin.weight.numel() for lin, _ in
                    fm.template_layers(lv.template))

        def launch(lib):
            build.check(lib.hn_fused_template_fwd_plane(
                raw_t.data_ptr(), rgbc.data_ptr(), None, None,
                ts.data_ptr(), tw.data_ptr(), tb.data_ptr(), out.data_ptr(),
                p, per, rgbc.shape[1], stream),
                'hn_fused_template_fwd_plane')
            return out
        report(f'{config} template R={rays} S=128', tmacs, p, launch,
               this_only=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--parent', default=None)
    parser.add_argument('--kernel', default='all',
                        choices=('all', 'warp_tangents', 'se3_tangents'))
    from hypernerf_tpu_torch.flagship import B4_CONFIGS
    parser.add_argument('--config', default=None, choices=B4_CONFIGS)
    args = parser.parse_args()

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print('time_modular_fwd: no CUDA device', file=sys.stderr)
        return 1
    from hypernerf_tpu_torch import kernels as K
    from hypernerf_tpu_torch.flagship import (anneal_condition,
                                              anneal_extra_params,
                                              flagship_model,
                                              load_probe_weights,
                                              probe_inputs)
    from hypernerf_tpu_torch.kernels import build, common
    ff = importlib.import_module('hypernerf_tpu_torch.kernels.fused_field')
    fm = importlib.import_module('hypernerf_tpu_torch.kernels.fused_mlp')
    fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
    fs = importlib.import_module('hypernerf_tpu_torch.kernels.fused_se3')

    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = {'this': build.library()}
    if args.parent:
        libs['parent'] = _library(os.path.abspath(args.parent),
                                  'parent_kernel_build')
    order = (['this', 'parent', 'parent', 'this'] if args.parent
             else ['this', 'this'])
    stream = torch.cuda.current_stream().cuda_stream

    def inputs(rays, samples, seed):
        return [torch.from_numpy(v).cuda()
                for v in probe_inputs(rays, samples, seed).values()]

    def report(label, macs, rows, launch, this_only=False):
        """Times each library's launches in turns (``this_only``: this
        checkout's library twice); launch(lib) fills and returns that
        library's output."""
        keys = ['this'] if this_only else list(libs)
        times = {k: [] for k in keys}
        for k in (['this', 'this'] if this_only else order):
            times[k].append(_time(lambda: launch(libs[k])))
        bound = 2.0 * macs * rows / PEAK_FLOPS * 1e3
        mean = {k: sum(v) / len(v) for k, v in times.items()}
        got = {k: launch(libs[k]).clone() for k in keys}
        torch.cuda.synchronize()
        parts = [f'{k} ' + ', '.join(f'{t:.3f}' for t in v) + ' ms'
                 f' ({100 * bound / mean[k]:.1f} % of {bound:.4f})'
                 for k, v in times.items()]
        if 'parent' in keys:
            diff = (got['parent'] - got['this']).abs().max().item()
            parts.append(f'parent / this {mean["parent"] / mean["this"]:.2f}x'
                         f', max|d| {diff:.3e}')
        print(f'{label}: ' + '; '.join(parts), flush=True)

    if args.kernel != 'all':
        with torch.no_grad():
            _tangents(args.kernel, inputs, report, stream)
        return 0
    if args.config:
        with torch.no_grad():
            _b4_level(args.config, inputs, report, stream)
        return 0
    probes = {c: load_probe_weights(flagship_model('cuda', config=c))
              for c in ('flagship', 'static', 'se3', 'quaternion', 'plane')}
    with torch.no_grad():
        probe = probes['flagship']
        for name, field in (('warp field', probe.warp_field),
                            ('sheet', probe.hyper_sheet_mlp)):
            mlp, n_freq = field.mlp, field.n_freq
            macs = sum(lin.weight.numel()
                       for lin, _ in ff.field_layers(mlp))
            for rays in (8192, 16384):
                x_raw = fl._raw_fields(*inputs(rays, 128, seed=rays)[:4])
                x_raw = x_raw.contiguous()
                p = x_raw.shape[0]
                which, _, (w, b, _) = ff._launch_args(mlp, n_freq, x_raw,
                                                      None)
                out = torch.empty((p, ff.OUT_PAD), device='cuda')

                def launch(lib):
                    build.check(lib.hn_fused_field_fwd(
                        which, x_raw.data_ptr(), None, w.data_ptr(),
                        b.data_ptr(), out.data_ptr(), p, stream),
                        'hn_fused_field_fwd')
                    return out
                report(f'{name} P={p}', macs, p, launch)

        field = probes['se3'].warp_field
        macs = sum(lin.weight.numel() for lin, _ in fs.se3_layers(field))
        for rays in (8192, 16384):
            x_raw = fl._raw_fields(*inputs(rays, 128, seed=rays)[:4])
            x_raw = x_raw.contiguous()
            p = x_raw.shape[0]
            _, (w, b, _) = fs._launch_args(field, x_raw, None)
            out = torch.empty((p, fs.OUT_PAD), device='cuda')

            def launch(lib):
                build.check(lib.hn_fused_se3_fwd(
                    x_raw.data_ptr(), None, w.data_ptr(), b.data_ptr(),
                    out.data_ptr(), p, stream), 'hn_fused_se3_fwd')
                return out
            report(f'se3 trunk P={p}', macs, p, launch)

        for config, level, rays, s in (
                ('flagship', 'fine', 8192, 128),
                ('flagship', 'coarse', 8192, 64),
                ('flagship', 'fine', 16384, 128),
                ('flagship', 'coarse', 16384, 64),
                ('flagship', 'fine', 1 << 20, 1),
                ('static', 'fine', 8192, 128)):
            cfg = probes[config].config
            tmpl = K.Template(probes[config]._template(level), cfg.xyz_freq,
                              cfg.hyper_freq)
            z, o, d, emb, cond = inputs(rays, s, seed=s)
            pts = fl._raw_fields(z, o, d, emb)[:, :3]
            hyper = torch.randn(rays * s, 4, device='cuda',
                                generator=torch.Generator(
                                    device='cuda').manual_seed(s)) * 0.3
            if config == 'static':
                hyper.zero_()
            x_raw = F.pad(torch.cat([pts, hyper], dim=-1), (0, 1))
            x_raw = x_raw.contiguous()
            (rgbc, _, _), per, _, ((w, b, _),) = fm._launch_args(
                tmpl, x_raw, cond, False)
            p = x_raw.shape[0]
            out = torch.empty((p, 4), device='cuda')
            macs = sum(lin.weight.numel() for lin, _ in
                       fm.template_layers(tmpl.template))

            def launch(lib):
                fn = lib.hn_fused_template_fwd
                alpha, width = _conds(fn, 12, rgbc.shape[1])
                build.check(fn(
                    x_raw.data_ptr(), rgbc.data_ptr(), *alpha,
                    *_no_row(fn, 8), w.data_ptr(), b.data_ptr(),
                    out.data_ptr(), p, per, *width, stream),
                    'hn_fused_template_fwd')
                return out
            report(f'{config} template R={rays} S={s}', macs, p, launch)

        for warp, config in (('translation', 'flagship'), ('se3', 'se3'),
                             ('quaternion', 'quaternion')):
            for s in (128, 64):
                lv = probes[config].level('fine' if s == 128 else 'coarse')
                w, b, _ = fl.pack_level(lv)
                z, o, d, emb, cond = inputs(8192, s, seed=s)
                rgbc = cond.to(torch.bfloat16).contiguous()
                p = 8192 * s
                out = torch.empty((p, 4), device='cuda')
                macs = sum(lin.weight.numel()
                           for lin, _ in fl.level_layers(lv))

                def launch(lib):
                    fn = lib.hn_fused_level_fwd
                    alpha, width = _conds(fn, 18, rgbc.shape[1])
                    build.check(fn(
                        common.WARP_CODES[warp], z.data_ptr(), o.data_ptr(),
                        d.data_ptr(), emb.data_ptr(), rgbc.data_ptr(), *alpha,
                        None, *_no_row(fn, 14), w.data_ptr(), b.data_ptr(),
                        out.data_ptr(), None, 8192, s, *width, stream),
                        'hn_fused_level_fwd')
                    return out
                report(f'{warp} level forward R=8192 S={s}', macs, p, launch)

        # The plane configuration: its level forward and its template alone
        # (raw rows of 16 columns).
        for s in (128, 64):
            lv = probes['plane'].level('fine' if s == 128 else 'coarse')
            w, b, _ = fl.pack_level(lv)
            z, o, d, emb, cond = inputs(8192, s, seed=s)
            rgbc = cond.to(torch.bfloat16).contiguous()
            p = 8192 * s
            out = torch.empty((p, 4), device='cuda')
            raw_t = torch.empty((p, common.PLANE_RAW_PAD), device='cuda')
            macs = sum(lin.weight.numel() for lin, _ in fl.level_layers(lv))

            def launch(lib):
                fn = lib.hn_fused_level_fwd
                alpha, width = _conds(fn, 18, rgbc.shape[1])
                build.check(fn(
                    common.TABLE_CODES['plane'], z.data_ptr(), o.data_ptr(),
                    d.data_ptr(), emb.data_ptr(), rgbc.data_ptr(), *alpha,
                    None, None, w.data_ptr(), b.data_ptr(), out.data_ptr(),
                    raw_t.data_ptr(), 8192, s, *width, stream),
                    'hn_fused_level_fwd')
                return out
            report(f'plane level forward R=8192 S={s}', macs, p, launch)
            _, per, layers, ((tw, tb, _),) = fm._launch_args(lv, raw_t, cond,
                                                            False)
            macs = sum(lin.weight.numel() for lin, _ in
                       fm.template_layers(lv.template))

            def launch(lib):
                fn = lib.hn_fused_template_fwd_plane
                alpha, width = _conds(fn, 12, rgbc.shape[1])
                build.check(fn(
                    raw_t.data_ptr(), rgbc.data_ptr(), *alpha, None,
                    tw.data_ptr(), tb.data_ptr(), out.data_ptr(), p, per,
                    *width, stream), 'hn_fused_template_fwd_plane')
                return out
            report(f'plane template R=8192 S={s}', macs, p, launch)

        # The anneal configuration (the Nerfies layout, its window row at
        # the probe step's alphas, a 27-column condition): its level forward
        # and its template alone on the level's raw_t.
        ep = anneal_extra_params()
        anneal = load_probe_weights(flagship_model('cuda', config='anneal'))
        for s in (128, 64):
            lv = anneal.level('fine' if s == 128 else 'coarse')
            w, b, _ = fl.pack_level(lv)
            z, o, d, emb, _ = inputs(8192, s, seed=s)
            row = fm.kernel_scales(lv, fm.template_scales(
                lv, ep['nerf_alpha'], ep['hyper_alpha'], z.device), z.device)
            cond = torch.from_numpy(anneal_condition(
                d.cpu().numpy(), ep['nerf_alpha'])).cuda()
            rgbc = cond.to(torch.bfloat16).contiguous()
            p = 8192 * s
            out = torch.empty((p, 4), device='cuda')
            raw_t = torch.empty((p, common.RAW_PAD), device='cuda')
            macs = sum(lin.weight.numel() for lin, _ in fl.level_layers(lv))

            def launch(lib):
                fn = lib.hn_fused_level_fwd
                alpha, width = _conds(fn, 18, rgbc.shape[1])
                build.check(fn(
                    common.TABLE_CODES['translation'], z.data_ptr(),
                    o.data_ptr(), d.data_ptr(), emb.data_ptr(),
                    rgbc.data_ptr(), *alpha, None, row.data_ptr(),
                    w.data_ptr(), b.data_ptr(), out.data_ptr(),
                    raw_t.data_ptr(), 8192, s, *width, stream),
                    'hn_fused_level_fwd')
                return out
            report(f'anneal level forward R=8192 S={s}', macs, p, launch)
            _, per, _, ((tw, tb, _),) = fm._launch_args(lv, raw_t, cond,
                                                        False)
            macs = sum(lin.weight.numel() for lin, _ in
                       fm.template_layers(lv.template))

            def launch(lib):
                fn = lib.hn_fused_template_fwd
                alpha, width = _conds(fn, 12, rgbc.shape[1])
                build.check(fn(
                    raw_t.data_ptr(), rgbc.data_ptr(), *alpha,
                    row.data_ptr(), tw.data_ptr(), tb.data_ptr(),
                    out.data_ptr(), p, per, *width, stream),
                    'hn_fused_template_fwd')
                return out
            report(f'anneal template R=8192 S={s}', macs, p, launch)
    return 0


if __name__ == '__main__':
    sys.exit(main())
