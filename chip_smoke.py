#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: ``python3 chip_smoke.py`` (one card).

Phases, one line each; any failure ends the run with a non-zero exit:
  1. a CUDA card (else exit 1); its name and power limit from nvidia-smi;
  2. build the kernels from kernels/csrc with nvcc (sm_90a), with the time;
  3. the level kernel at the flagship widths and at probe weights whose
     warp and hyper heads are large enough that those 14 layers move the
     output: against the JAX kernel's stored outputs (tests/data), and
     against its plain version at 512 and 37 rays and at the render's
     shapes (8192 rays at S = 64 and 128), which are also timed;
  4. the compositing kernel against its plain version (fine draw N = 64
     and 128, and no draw), at 1024 and 37 rays and at the render's shapes
     (8192 rays, S = 64 N = 64 and S = 128 N = 0), which are also timed;
  5. the render: full 504x378 frames of the flagship (64 + 64 samples,
     full widths, seeded init) through the renderer that
     ``python -m hypernerf_tpu_torch.eval`` uses, on LLFF spiral NDC rays;
     the launch counters must show both kernels on every chunk and level;
     then the same frame with the plain versions, timed apart;
  6. the kernels' JSON line, then the result line.
Times come from CUDA events (kernels) or the host clock around work that
ends in a synchronize (frames).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# Tolerances (kernel vs plain version, same inputs, same card).
# Level: both round to bf16 at the same points and differ only in the fp32
# summation order inside each product, which now and then moves a hidden
# activation across a bf16 rounding boundary (one bf16 ulp, 2^-8 relative);
# over 30 layers such flips leave differences of a few 1e-3 on outputs of
# order 1; a flip in a warp layer moves the warped point, which the 2^9
# posenc band amplifies (measured on an H100 with the warp and hyper heads
# scaled up as the probe weights have them: max 7.1e-3, mean 6.0e-5; 2.0e-3
# and 1.2e-5 at the init). The JAX kernel rounds at the same points.
# Allowed:
# |kernel - plain| <= 1e-2 + 1e-2 |plain| everywhere and a mean below 1e-4.
LEVEL_ATOL, LEVEL_RTOL, LEVEL_MEAN = 1e-2, 1e-2, 1e-4
# Composite: fp32 both ways, sequential sums against torch's reductions:
# 1e-4 on the per-ray outputs and weights. A fine depth moves by the CDF's
# last-bit difference (a few 2^-24) over its bin's CDF mass (>= ~1e-5, the
# eps floor) times the bin's width, so z_union gets 1e-4 plus
# 8 * 2^-24 / (smallest bin mass) * (widest bin), from the inputs at hand.
COMPOSITE_ATOL = 1e-4
# Whole render, kernels vs plain versions, fine rgb in [0, 1].
RENDER_ATOL, RENDER_MEAN = 5e-2, 2e-3

CHUNK = 8192
N_FRAMES = 2


def phase(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean ms of ``fn`` over ``iters`` launches after two warm-up calls."""
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


def level_inputs(n_rays: int, samples: int, seed: int):
    """The level's inputs (flagship.probe_inputs) on the card."""
    import torch
    from hypernerf_tpu_torch.flagship import probe_inputs
    return [torch.from_numpy(v).cuda()
            for v in probe_inputs(n_rays, samples, seed).values()]


def composite_inputs(n_rays: int, samples: int, n_fine: int, seed: int,
                     linspace_u: bool):
    import torch
    from hypernerf_tpu_torch.ops.sampling import sorted_uniform
    g = torch.Generator().manual_seed(seed)
    packed = torch.randn(n_rays * samples, 4, generator=g) * 2.0
    z = torch.sort(torch.rand(n_rays, samples, generator=g) * 0.9 + 0.05,
                   dim=-1)[0]
    dirs = torch.randn(n_rays, 3, generator=g)
    u = None
    if n_fine:
        u = (torch.linspace(0, 1, n_fine).expand(n_rays, n_fine)
             if linspace_u else sorted_uniform(n_rays, n_fine, g))
    return [None if t is None else t.cuda().contiguous()
            for t in (packed, z, dirs, u)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase(f'[1] card: {torch.cuda.get_device_name(0)}; torch '
          f'{torch.__version__} cuda {torch.version.cuda}')

    from hypernerf_tpu_torch.flagship import (H, W, flagship_model,
                                              load_probe_weights,
                                              read_level_reference,
                                              spiral_rays)
    from hypernerf_tpu_torch.kernels import (build, fused_composite,
                                             fused_composite_plain,
                                             fused_level, fused_level_plain)
    from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
    from hypernerf_tpu_torch.training.renderer import ImageRenderer

    t0 = time.perf_counter()
    build.library()
    report = [ln.strip() for ln in build.build_log().splitlines()
              if 'registers' in ln or 'spill' in ln]
    phase(f'[2] built {build.library_path().name} in '
          f'{time.perf_counter() - t0:.1f} s; ptxas: {" | ".join(report)}')

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = flagship_model('cuda', seed=0)
    kernels = []

    def check_level(level, args, want=None, against='plain'):
        got = fused_level(level, *args)
        if want is None:
            want = fused_level_plain(level, *args)
        torch.cuda.synchronize()
        r, s = args[0].shape
        diff = (got - want).abs()
        bad = diff > LEVEL_ATOL + LEVEL_RTOL * want.abs()
        if not torch.isfinite(got).all() or bad.any() \
                or diff.mean() > LEVEL_MEAN:
            raise AssertionError(
                f'level kernel disagrees with {against} at R={r} S={s}: max '
                f'{diff.max().item():.3e} mean {diff.mean().item():.3e} '
                f'outside {int(bad.sum())} of {bad.numel()}')
        phase(f'[3] level vs {against} R={r} S={s}: max|d| '
              f'{diff.max().item():.3e} mean {diff.mean().item():.3e} (tol '
              f'{LEVEL_ATOL}+{LEVEL_RTOL}|want|, mean {LEVEL_MEAN})')
        return diff.max().item()

    def check_composite(packed, z, dirs, u, label):
        got = fused_composite(packed, z, dirs, u)
        want = fused_composite_plain(packed, z, dirs, u)
        torch.cuda.synchronize()
        diffs = {k: (got[k] - want[k]).abs().max().item() for k in want}
        tols = {k: COMPOSITE_ATOL for k in want}
        if u is not None:
            w = want['weights'][:, 1:-1] + 1e-5
            mass = (w / w.sum(-1, keepdim=True)).min().item()
            widest = (z[:, 1:] - z[:, :-1]).max().item()
            tols['z_union'] += 8 * 2.0 ** -24 / mass * widest
        phase(f'[4] composite {label}: max|d| ' + ', '.join(
            f'{k} {d:.3e} (tol {tols[k]:.1e})'
            for k, d in sorted(diffs.items())))
        for k, d in diffs.items():
            if not d <= tols[k]:
                raise AssertionError(f'composite {k} disagrees at {label}: '
                                     f'max|d| {d:.3e}')
        return max(diffs.values())

    with torch.no_grad():
        # [3] level kernel vs plain, at the probe weights: numpy draws
        # (flagship.load_probe_weights) whose warp and hyper heads are large
        # enough that the 14 warp and hyper layers move the output (the init
        # leaves them near zero). The run shows it: a 1% change to layer 5
        # of either MLP (the layer after the skip) must move the plain
        # output by more than the tolerance. Each S takes its level's
        # template, as the render does.
        probe = load_probe_weights(flagship_model('cuda'))
        level = {64: probe.level('coarse'), 128: probe.level('fine')}
        args = level_inputs(512, 64, seed=0)
        z, o, d, emb, _ = args
        pts = o[:, None] + z[..., None] * d[:, None]
        emb = emb[:, None].expand(-1, z.shape[1], -1)
        base = fused_level_plain(level[64], *args)
        for name, field, out in (
                ('warp', probe.warp_field, probe.warp_field(pts, emb) - pts),
                ('hyper', probe.hyper_sheet_mlp,
                 probe.hyper_sheet_mlp(pts, emb))):
            layer = field.mlp.hidden(5).weight
            layer.mul_(1.01)
            moved = (fused_level_plain(level[64], *args) - base).abs()
            layer.div_(1.01)
            out = out.reshape(-1, out.shape[-1])
            phase(f'[3] probe {name} head: output mean|.| '
                  f'{out.abs().mean():.3e}, std over samples '
                  f'{out.std(0).mean():.3e}; 1% on its layer 5 moves the '
                  f'level by max {moved.max():.3e} mean {moved.mean():.3e}')
            if not moved.mean() > LEVEL_MEAN:
                raise AssertionError(f'the level check cannot see the '
                                     f'{name} layers')
        # The JAX (TPU) kernel's outputs at the same weights and inputs,
        # computed on the CPU in interpret mode
        # (tools/make_level_reference.py).
        for name, (inputs, want) in read_level_reference().items():
            check_level(probe.level(name),
                        [torch.from_numpy(v).cuda() for v in inputs.values()],
                        torch.from_numpy(want).cuda(), f'JAX {name}')
        for r, s in ((512, 64), (512, 128), (37, 13)):
            check_level(level.get(s, level[64]),
                        level_inputs(r, s, seed=s))
        # The render's shapes: compared, then timed on the same inputs.
        errs, times = [], {}
        for s in (64, 128):
            args = level_inputs(CHUNK, s, seed=s)
            errs.append(check_level(level[s], args))
            times[s] = (cuda_ms(lambda: fused_level(level[s], *args)),
                        cuda_ms(lambda: fused_level_plain(level[s], *args), 3))
            phase(f'[3] level R={CHUNK} S={s}: kernel {times[s][0]:.3f} ms, '
                  f'plain {times[s][1]:.3f} ms')
        kernels.append(dict(
            name='fused_level_fwd', route='cuda',
            source='hypernerf_tpu_torch/kernels/csrc/fused_level.cu',
            replaces='hypernerf_tpu/ops/pallas/fused_level.py:1322',
            max_abs_err=max(errs), ms=times[128][0],
            plain_ms=times[128][1]))
        del probe, level, args

        # [4] compositing kernel vs plain.
        for r, s, n, lin in ((1024, 64, 64, True), (1024, 64, 64, False),
                             (1024, 64, 128, True), (1024, 128, 0, True),
                             (37, 5, 7, False)):
            check_composite(*composite_inputs(r, s, n, seed=s + n,
                                              linspace_u=lin),
                            f'R={r} S={s} N={n} u='
                            f'{"linspace" if lin else "sorted"}')
        errs, ctimes = [], {}
        for s, n in ((64, 64), (128, 0)):
            packed, z, dirs, u = composite_inputs(CHUNK, s, n, seed=1,
                                                  linspace_u=True)
            errs.append(check_composite(packed, z, dirs, u,
                                        f'R={CHUNK} S={s} N={n} u=linspace'))
            ctimes[s] = (
                cuda_ms(lambda: fused_composite(packed, z, dirs, u)),
                cuda_ms(lambda: fused_composite_plain(packed, z, dirs, u)))
            phase(f'[4] composite R={CHUNK} S={s} N={n}: kernel '
                  f'{ctimes[s][0]:.3f} ms, plain {ctimes[s][1]:.3f} ms')
        kernels.append(dict(
            name='fused_composite_fwd', route='cuda',
            source='hypernerf_tpu_torch/kernels/csrc/fused_composite.cu',
            replaces='hypernerf_tpu/ops/pallas/fused_composite.py:437',
            max_abs_err=max(errs), ms=ctimes[64][0],
            plain_ms=ctimes[64][1]))

        # [5] the render path, end to end.
        frames = spiral_rays(range(0, 30 * (N_FRAMES + 1), 30))
        renderer = ImageRenderer(model, chunk=CHUNK,
                                 keep=('rgb', 'depth', 'acc'),
                                 levels=('fine',), quantize=True)
        small = torch.as_tensor(frames[0][::186][:1024]).cuda()
        got = model(prepare_ray_dict(small))['fine']['rgb']
        renderer(frames[0])  # warm-up frame: the first launches
        torch.cuda.synchronize()
        fused_level.launches = fused_composite.launches = 0
        fused_level_plain.calls = fused_composite_plain.calls = 0
        t0 = time.perf_counter()
        outs = [renderer(rays) for rays in frames[1:]]
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / N_FRAMES
        launches = (fused_level.launches, fused_composite.launches)
        plain_calls = (fused_level_plain.calls, fused_composite_plain.calls)
        chunks = -(-W * H // CHUNK)
        want_launches = 2 * chunks * N_FRAMES
        if launches != (want_launches, want_launches) or any(plain_calls):
            raise AssertionError(f'launches {launches} (want '
                                 f'{want_launches} each), plain calls '
                                 f'{plain_calls}')
        for out in outs:
            fine = out['fine']
            if fine['rgb'].shape != (W * H, 3) or fine['rgb'].dtype.name \
                    != 'uint8':
                raise AssertionError(f'rgb {fine["rgb"].shape} '
                                     f'{fine["rgb"].dtype}')
            for k in ('depth', 'acc'):
                v = torch.as_tensor(fine[k])
                if v.shape != (W * H,) or not torch.isfinite(v).all():
                    raise AssertionError(f'{k} not finite / misshapen')
        phase(f'[5] rendered {N_FRAMES} frames {W}x{H} (64+64, chunk '
              f'{CHUNK}): {secs:.4f} s/frame with kernels; launches '
              f'level {launches[0]} composite {launches[1]} '
              f'(= 2 levels x {chunks} chunks x {N_FRAMES} frames); plain '
              f'calls {plain_calls}')
        for k in kernels:
            k['launches'] = (launches[0] if k['name'] == 'fused_level_fwd'
                             else launches[1])

        model.level_op = fused_level_plain
        model.composite_op = fused_composite_plain
        want = model(prepare_ray_dict(small))['fine']['rgb']
        diff = (got - want).abs()
        if not torch.isfinite(got).all() or diff.max() > RENDER_ATOL \
                or diff.mean() > RENDER_MEAN:
            raise AssertionError(f'render kernels vs plain: max '
                                 f'{diff.max().item():.3e} mean '
                                 f'{diff.mean().item():.3e}')
        phase(f'[5] render of 1024 rays, kernels vs plain: fine rgb max|d| '
              f'{diff.max().item():.3e} mean {diff.mean().item():.3e} '
              f'(tol {RENDER_ATOL}, mean {RENDER_MEAN})')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        renderer(frames[1])
        torch.cuda.synchronize()
        plain_secs = time.perf_counter() - t0
        model.level_op = fused_level
        model.composite_op = fused_composite
        phase(f'[5] plain versions: {plain_secs:.4f} s/frame (1 frame)')

    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
