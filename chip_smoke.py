#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: ``python3 chip_smoke.py`` (one card).

Phases, one line each; any failure ends the run with a non-zero exit:
  1. a CUDA card (else exit 1); its name and power limit from nvidia-smi;
  2. build the kernels from kernels/csrc with nvcc (sm_90a), with the time
     and ptxas's registers and spills (the level forward's and kernel B's
     on lines of their own);
  3. the level kernel at the flagship widths and at probe weights whose
     warp and hyper heads are large enough that those 14 layers move the
     output: against the JAX kernel's stored outputs (tests/data), and
     against its plain version at 512 and 37 rays and at the render's
     shapes (8192 rays at S = 64 and 128), which are also timed; its
     compiled plan (tiles, ring, column plan, weight loads) against the
     model in kernels/fused_level.py for each warp type; its time at 8192
     and 16384 rays, S = 64 and 128, for each warp type, beside the time
     before its redesign and its share of the bound, and the weight bytes
     a call streams from L2 as the plan computes them;
  4. the compositing kernel against its plain version (fine draw N = 64
     and 128, and no draw), at 1024 and 37 rays and at the render's shapes
     (8192 rays, S = 64 N = 64 and S = 128 N = 0), which are also timed;
  5. the render: full 504x378 frames of the flagship (64 + 64 samples,
     full widths, seeded init; three timed after a warm-up) through the
     renderer that
     ``python -m hypernerf_tpu_torch.eval`` uses, on LLFF spiral NDC rays;
     the launch counters must show both kernels on every chunk and level;
     then the same frame with the plain versions, timed apart;
  6. kernel B's compiled plan (block tile, ring, the slab pool's buffer
     plan with its spills and reloads, a block tile's weight loads) against
     its model in kernels/fused_level.py for each warp type, with the
     weight bytes a call streams from L2; the three backward kernels
     (template, fields, compositing) at the probe weights: against the JAX
     kernels' stored gradients (tests/data), with
     the 1 % probes that show the check sees the warp, sheet and template
     layers' dW; against their plain versions at 37 and 512 rays and at the
     train step's shapes (16384 rays at S = 64 and 128; there the plain
     versions run in chunks of 2048 rays, which bounds their memory), which
     are also timed, the template backward (kernel A, a sequence of kernels
     over chunks of whole rays) with its share of the bound, the bytes of
     the stash it allocated, its peak allocation and its host time, and
     kernel B with its share of the bound;
     the two forward kernels as training launches them (the level with its
     raw_t output on, which then feeds the template backward; compositing
     with sigma noise and the sorted fine draw) against their plain versions
     at the same shapes;
  7. the train step: the flagship at full width (batch 16384, 64 + 64, bf16,
     sigma noise, Adam with steplr) through ``make_train_step``; the launch
     counters must show 2 launches of each of the five kernels per step and
     no plain call; every parameter gets a finite non-zero gradient; the
     loss on a fixed batch falls; before those steps, one step on a small
     explicit batch with the kernels and one with the plain versions (through
     the same autograd Functions) from the initial state, compared;
  8. the kernels of the per-module path (a field alone, forward and
     backward, as the warp field and as the hyper sheet, with and without a
     window row; the template alone, forward, with 128, 64, 13 and 1 rows per
     condition row, with and without hyper coordinates, up to the train
     step's 16384 rays at both levels; the template backward on a template
     without them, at both levels of the train step, and at 1 row per
     condition row): against the
     JAX kernels' stored outputs and gradients at the probe weights
     (tests/data), against their plain versions at small odd sizes and at
     8192 x 128 and 16384 x 128 rows, which are also timed, and against the
     level kernels (warp field, sheet and template kernels chained give the
     level kernel's output; the field backward twice on the template
     backward's dx_t gives the fields backward's gradients);
  9. the per-module path at full width: ``static`` (a plain NeRF) renders a
     504x378 frame and trains at batch 16384; ``split_glo`` (two GLO tables)
     renders a frame with ``return_points``, trains at batch 16384 and
     answers ``query_sigma`` on 1 << 20 points; the launch counters must show
     the per-module kernels on every chunk, level and step (per step: static
     2 template forwards and 2 template backwards; split_glo also 4 field
     forwards and 4 field backwards) and no level kernel and no plain call;
     every parameter gets a finite non-zero gradient; the fixed-batch loss
     falls; one small step with the kernels against one with the plain
     versions;
 10. the SE(3) trunk's kernels (forward and backward) at the probe weights of
     the ``se3`` configuration, whose w and v heads are drawn large enough
     that the rotation shows: against the JAX kernels' stored outputs and
     gradients (tests/data), with the 1 % probe of one layer, against their
     plain versions at a ragged size (a multiple of neither tile height) and
     at 8192 x 128 and 16384 x 128 rows, with and without a window row
     (alpha 3.5 of 8 bands), which are also timed;
 11. the level kernels' screw-warp variants (``se3`` and ``quaternion``): the
     level forward and the level backward (A then B) against the stored JAX
     numbers, the forward (with raw_t) and kernel B against their plain
     versions at small ragged sizes, at R = 512 (S = 64 and 128), at the
     render's R = 8192 and at the train step's R = 16384 (kernel B timed
     there at S = 64 and 128 with its share of the bound), with and without
     a window row; the trunk kernel, the
     retraction, the sheet's field kernel and the template kernel chained
     against the level kernel; and a model whose w head is zero, so that
     every row has w = 0 exactly (d w = 0, d v = d pts = g);
 12. the SE(3) paths at full width: a 504x378 frame of ``se3`` and of
     ``quaternion`` through the level kernels, a frame of ``se3`` with
     ``return_points`` (per-module: trunk, sheet and template kernels), a
     train step at batch 16384 of ``se3`` and ``quaternion`` (level kernels)
     and of ``se3`` with two GLO tables (trunk, field and template kernels,
     forward and backward), each with launch counters, no plain call and one
     kernels-vs-plain step on 1024 rays; ``query_sigma`` of ``se3`` on
     1 << 20 points;
 13. the translation warp's Jacobian kernels (forward and backward) at probe
     weights whose warp head moves J well away from I: against the JAX
     kernels' stored outputs and gradients (tests/data), with the 1 % probe
     of warp layer 5, against their plain versions at 1001 points and at the
     train step's 262,144 (16384 rays x 16 samples), which are also timed;
 14. the SE(3) trunk's tangent kernels (forward and backward), the same way,
     with and without a window row (alpha 3.5 of 8 bands);
 15. the SE(3) and quaternion retractions' point-Jacobian (tensor code)
     chained with the tangent kernel, against the plain chain and the JAX
     side channel's stored J; models whose w head is zero (J = I + dv
     exactly, finite gradients);
 16. the train steps of ``elastic``, ``elastic_se3`` and
     ``elastic_quaternion`` (16 Jacobian samples per ray, elastic weight
     0.01) at batch 16384 as phase 7 runs them: 2 launches per step of each
     Jacobian kernel beside the level and compositing kernels, no plain call,
     finite non-zero gradients, a falling fixed-batch loss, and a 1024-ray
     step with the kernels against one with the plain versions, with the
     elastic term's value;
 17. one ``split_glo`` step with the elastic loss (the per-module branch: J
     at every sample) on 1024 rays, kernels vs plain versions, with its
     launches;
 18. one ``elastic`` step with the background loss on a seeded set of
     1 << 16 static points, 1024 per step (the field kernels counted);
 19. the kernels' JSON line, then the result line.
Times come from CUDA events (kernels) or the host clock around work that
ends in a synchronize (frames, steps). A kernel's bound is the larger of
its matrix-product operations over the card's dense bf16 peak and its bytes
(each input read once, each output written once) over the memory rate.
"""

from __future__ import annotations

import contextlib
import json
import math
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
# The level with the SE(3) / quaternion warp against the JAX kernels' stored
# gradients: the same rule as GRAD_L2 with a wider relative L2. A bf16 flip in
# the trunk moves w, the retraction turns that into a moved point, and the
# template's 2^9 band amplifies it; db of the trunk's heads and of the first
# template layers are sums of such cotangents of both signs (measured on the
# CPU, the plain versions against the JAX kernels in interpret mode: up to
# 8.1e-2 on db of one layer, 3e-2 on the rest; float32 agrees to 1e-2 of the
# largest entry at worst).
SE3_LEVEL_GRAD_L2 = 0.12
# The level forward with the SE(3) / quaternion warp vs its plain version:
# the level's rule with a wider absolute term on the output (raw_t keeps
# LEVEL_ATOL). One bf16 flip in the 128-wide trunk moves w by some 4e-4 rad
# (the probe's w head has weights up to 0.1), the retraction moves the point
# by as much, and the template's 2^9 band turns that into 0.2 rad of phase;
# the translation warp's head is ten times smaller. Measured on an H100: 64
# of 2.1 M outputs beyond LEVEL_ATOL, the largest 3.4e-2, the mean 4.4e-5.
SE3_LEVEL_ATOL = 6e-2
# The SE(3) trunk's backward alone vs its plain version and vs the stored JAX
# gradients: the rule of GRAD_L2 with a tighter relative L2, which a 1 %
# change of one hidden layer exceeds on every dW (phase 10's probe).
SE3_TRUNK_GRAD_L2 = 1e-2
# Whole render, kernels vs plain versions, fine rgb in [0, 1].
RENDER_ATOL, RENDER_MEAN = 5e-2, 2e-3

# Backward kernels vs plain versions (bf16, flagship widths): both round at
# the same points; a last-bit fp32 difference moves single activations and
# cotangent entries across a bf16 rounding boundary, and the 2^9 posenc band
# amplifies it. Measured on an H100: relative L2 up to 1.4e-2 and single
# entries up to 0.14 of the largest, while kernel and plain version both lie
# 1e-1 (relative L2) from the float32 gradient. Allowed per output:
# |kernel - plain|_2 <= 5e-2 |plain|_2 and max|d| <= 0.25 max|plain|. The
# JAX kernels' stored gradients get the same bound.
GRAD_L2, GRAD_MAX = 5e-2, 0.25
# Compositing backward: fp32 both ways, 1e-5 of each output's largest entry.
COMPOSITE_GRAD_TOL = 1e-5
# One train step, kernels vs plain versions from the same state and draws:
# the loss, and the gradients as ``step_grad_errors`` measures them.
STEP_LOSS_TOL, STEP_GRAD_L2 = 2e-3, 0.1

# Published peaks of an H100 SXM: dense bf16 and device memory.
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12

CHUNK = 8192
N_FRAMES = 3
TRAIN_RAYS, TRAIN_STEPS, WARMUP_STEPS = 16384, 5, 2
PLAIN_CHUNK = 2048


T_START = time.perf_counter()


def phase(msg: str) -> None:
    """One line of the report, with the seconds since the start."""
    print(f'{msg} [at {time.perf_counter() - T_START:.1f} s]', flush=True)


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


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by) from an operation and a byte count."""
    ops_ms, bytes_ms = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, 'operations') if ops_ms >= bytes_ms else (bytes_ms,
                                                               'bytes')


def level_macs(level):
    """(fields, template) multiply-adds per sample of one level forward:
    one for every weight of its field layers (14, or 16 with the SE(3) /
    quaternion warp) and of its 16 template layers."""
    from hypernerf_tpu_torch.kernels.fused_level import level_layers
    sizes = [lin.weight.numel() for lin, _ in level_layers(level)]
    return sum(sizes[:-16]), sum(sizes[-16:])


def level_bound(level, n_rays: int, samples: int):
    """(bound_ms, bound_by) of one level forward: every weight is one
    multiply-add per sample; bytes are the ray inputs, the weights once, the
    output."""
    macs = sum(level_macs(level))
    p = n_rays * samples
    return bound(2.0 * macs * p,
                 4 * p + n_rays * (24 + 32 + 78) + 2 * macs + 16 * p)


# The level forward's times on this card before its redesign around
# wgmma and TMA (the mma.sync kernel; PERF.md, row 1), ms at R = 8192.
EARLIER_LEVEL_MS = {('translation', 64): 5.969, ('translation', 128): 11.919,
                    ('se3', 64): 6.136, ('se3', 128): 12.142,
                    ('quaternion', 64): 6.189, ('quaternion', 128): 12.128}
LEVEL_FWD_SOURCES = ('level_fwd.cuh', 'level_fwd_trans.cu',
                     'level_fwd_se3.cu', 'level_fwd_quat.cu', 'fused_level.cu')
# Kernel B, the fields backward (`wgmma`, TMA, a 128-row block tile; one
# source per warp type).
FIELDS_BWD_SOURCES = ('fields_bwd.cuh', 'fields_bwd_trans.cu',
                      'fields_bwd_se3.cu', 'fields_bwd_quat.cu')


def ptxas_lines(log: str, sources) -> str:
    """ptxas's registers and spills for each of ``sources`` from the
    build log (one section per source)."""
    out = []
    for section in log.split('== ')[1:]:
        name, _, body = section.partition('\n')
        if name.strip() not in sources:
            continue
        regs = [ln.strip() for ln in body.splitlines()
                if 'registers' in ln or 'spill' in ln]
        out.append(f'{name.strip()}: {"; ".join(regs) or "no kernel"}')
    return ' | '.join(out)


def level_forward_times(kernels) -> None:
    """Phase 3, the level forward's redesign: the compiled plan against
    its model for each warp type, then the kernel's time at R = 8192 and
    16384, S = 64 and 128, for each warp type, beside PERF.md's earlier
    figure and its share of the bound, and the weight bytes a call streams
    from L2 (computed from the plan)."""
    import importlib
    fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
    from hypernerf_tpu_torch.flagship import (flagship_model,
                                              load_probe_weights)
    from hypernerf_tpu_torch.kernels import common, fused_level
    for warp in common.WARP_CODES:
        got = fl.compiled_forward_plan(warp)
        want = fl.forward_plan(warp, common.kernel_layout(warp))
        if got != want:
            raise AssertionError(f'{warp}: the compiled forward plan is not '
                                 f'its model: {got} vs {want}')
    phase(f'[3] forward plan (compiled = model, all three warp types): '
          f'{want["config"][1]} warpgroups of {want["config"][0]} rows, '
          f'{want["config"][6]} bf16 columns each, a ring of '
          f'{want["config"][2]} stages of {want["config"][3]} bytes, '
          f'{want["config"][4]} bytes of shared memory, '
          f'{want["config"][5]} threads')
    entry = next(k for k in kernels if k['name'] == 'fused_level_fwd')
    for warp, config in (('translation', 'flagship'), ('se3', 'se3'),
                         ('quaternion', 'quaternion')):
        probe = load_probe_weights(flagship_model('cuda', config=config))
        level = {64: probe.level('coarse'), 128: probe.level('fine')}
        for r in (CHUNK, TRAIN_RAYS):
            for s in (64, 128):
                args = level_inputs(r, s, seed=s + 7)
                ms = cuda_ms(lambda: fused_level(level[s], *args))
                b_ms, b_by = level_bound(level[s], r, s)
                earlier = EARLIER_LEVEL_MS.get((warp, s)) if r == CHUNK \
                    else None
                was = (f'{earlier:.3f} ms before ({earlier / ms:.2f}x)'
                       if earlier else 'no earlier figure')
                phase(f'[3] level forward {warp} R={r} S={s}: {ms:.3f} ms, '
                      f'{was}; bound {b_ms:.3f} ms ({b_by}), '
                      f'{100 * b_ms / ms:.1f} % of it')
                entry[f'ms_{warp}_r{r}_s{s}'] = ms
        del probe, level, args
    shapes = common.kernel_layout('translation')
    for s in (64, 128):
        phase(f'[3] computed from the plan, not measured: a level forward '
              f'at R={CHUNK} S={s} streams '
              f'{fl.forward_stream_bytes(shapes, CHUNK * s):,} bytes of '
              f'weights from L2 (the blob once per pair of 64-row tiles)')


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


def grad_errors(got, want):
    """(relative L2, max|d| / max|want|, max|d|) of two tensors."""
    diff = (got - want).float()
    return ((diff.norm() / want.norm().clamp_min(1e-30)).item(),
            (diff.abs().max() / want.abs().max().clamp_min(1e-30)).item(),
            diff.abs().max().item())


def check_grads(label, names, got, want, l2_tol=GRAD_L2, max_tol=GRAD_MAX,
                tag='[6]'):
    """Hold every tensor of ``got`` to ``want``; returns the worst
    (relative L2, max|d| over the largest entry, max|d|) over the tensors and
    prints the first two."""
    import torch
    worst = [0.0, 0.0, 0.0]
    for name, a, b in zip(names, got, want):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f'{label}: {name} {tuple(a.shape)} vs '
                                 f'{tuple(b.shape)} or not finite')
        errs = grad_errors(a, b)
        if errs[0] > l2_tol or errs[1] > max_tol:
            raise AssertionError(f'{label}: {name} relative L2 {errs[0]:.3e} '
                                 f'(tol {l2_tol}), max {errs[1]:.3e} of the '
                                 f'largest entry (tol {max_tol})')
        worst = [max(w, e) for w, e in zip(worst, errs)]
    phase(f'{tag} {label}: {len(names)} outputs, worst relative L2 '
          f'{worst[0]:.3e} (tol {l2_tol}), worst max|d| {worst[1]:.3e} of '
          f'the largest entry (tol {max_tol})')
    return worst


def error_keys(worsts, l2_tol=GRAD_L2, max_tol=GRAD_MAX):
    """A backward kernel's error entries from its ``check_grads`` results.
    Gradients are not of order 1 (dW sums over millions of samples), so the
    absolute error is given beside the two relative figures the tolerance
    is stated in."""
    return dict(max_abs_err=max(w[2] for w in worsts),
                rel_l2_err=max(w[0] for w in worsts),
                max_err_over_largest_entry=max(w[1] for w in worsts),
                tolerance=f'relative L2 <= {l2_tol}, max|d| <= {max_tol} x '
                          f'the largest entry, per output')


def hold_level(got, want, label, tag='[3]', atol=LEVEL_ATOL):
    """Hold a level forward output (or its raw_t) to ``want`` under the level
    tolerance; returns max|d|."""
    import torch
    torch.cuda.synchronize()
    diff = (got - want).abs()
    bad = diff > atol + LEVEL_RTOL * want.abs()
    if got.shape != want.shape or not torch.isfinite(got).all() \
            or bad.any() or diff.mean() > LEVEL_MEAN:
        raise AssertionError(
            f'{label}: the level kernel disagrees: max '
            f'{diff.max().item():.3e} mean {diff.mean().item():.3e} '
            f'outside {int(bad.sum())} of {bad.numel()}')
    phase(f'{tag} {label}: max|d| {diff.max().item():.3e} mean '
          f'{diff.mean().item():.3e} (tol {atol}+{LEVEL_RTOL}|want|, '
          f'mean {LEVEL_MEAN})')
    return diff.max().item()


def check_composite(packed, z, dirs, u, label, noise=None, tag='[4]'):
    """The compositing forward kernel against its plain version; returns the
    largest max|d| over the outputs."""
    import torch
    from hypernerf_tpu_torch.kernels import (fused_composite,
                                             fused_composite_plain)
    got = fused_composite(packed, z, dirs, u, noise=noise)
    want = fused_composite_plain(packed, z, dirs, u, noise=noise)
    torch.cuda.synchronize()
    # med_depth is the depth of the first sample whose cumulative weight
    # reaches 0.5: a ray whose sum passes within 1e-5 of 0.5 may pick the
    # neighbour in the kernel's sequential sum. Such rays are left out of
    # med_depth's comparison (and counted).
    edge = ((torch.cumsum(want['weights'], dim=-1) - 0.5).abs() < 1e-5).any(-1)
    diffs = {k: (got[k] - want[k]).abs() for k in want}
    diffs['med_depth'] = diffs['med_depth'].masked_fill(edge, 0.0)
    diffs = {k: d.max().item() for k, d in diffs.items()}
    tols = {k: COMPOSITE_ATOL for k in want}
    if u is not None:
        w = want['weights'][:, 1:-1] + 1e-5
        mass = (w / w.sum(-1, keepdim=True)).min().item()
        widest = (z[:, 1:] - z[:, :-1]).max().item()
        tols['z_union'] += 8 * 2.0 ** -24 / mass * widest
    phase(f'{tag} composite {label}: max|d| ' + ', '.join(
        f'{k} {d:.3e} (tol {tols[k]:.1e})' for k, d in sorted(diffs.items()))
        + f'; {int(edge.sum())} rays on the median\'s edge')
    for k, d in diffs.items():
        if not d <= tols[k]:
            raise AssertionError(f'composite {k} disagrees at {label}: '
                                 f'max|d| {d:.3e}')
    return max(diffs.values())


def chunks(n_rays: int):
    return [(r0, min(n_rays, r0 + PLAIN_CHUNK))
            for r0 in range(0, n_rays, PLAIN_CHUNK)]


def plain_forward(level, args, warp_scales=None):
    """(out, raw_t) of the plain level forward, over chunks of PLAIN_CHUNK
    rays."""
    import torch
    from hypernerf_tpu_torch.kernels import fused_level_plain
    parts = [fused_level_plain(level, *[a[r0:r1].contiguous() for a in args],
                               return_raw_t=True, warp_scales=warp_scales)
             for r0, r1 in chunks(args[0].shape[0])]
    return tuple(torch.cat([p[i] for p in parts]) for i in range(2))


def plain_template_bwd(level, raw_t, rgb_cond, g):
    """The plain template backward over chunks of PLAIN_CHUNK rays (the
    plain version keeps every activation of a chunk in device memory):
    [dx_t, d rgb_cond, 32 x dW/db], per-sample and per-ray outputs
    concatenated, dW / db summed."""
    import torch
    from hypernerf_tpu_torch.kernels import fused_template_bwd_plain
    s = raw_t.shape[0] // rgb_cond.shape[0]
    parts = []
    for r0, r1 in chunks(rgb_cond.shape[0]):
        dx_t, d_cond, grads = fused_template_bwd_plain(
            level, raw_t[r0 * s:r1 * s], rgb_cond[r0:r1], g[r0 * s:r1 * s])
        parts.append([dx_t, d_cond, *grads])
    return ([torch.cat([p[i] for p in parts]) for i in range(2)]
            + [sum(p[i] for p in parts) for i in range(2, len(parts[0]))])


def plain_fields_bwd(level, args, dx_t, warp_scales=None):
    """The plain fields backward over chunks of PLAIN_CHUNK rays:
    [d z, d o, d d, d embed, 28 (or 32) x dW/db]."""
    import torch
    from hypernerf_tpu_torch.kernels import fused_fields_bwd_plain
    s = args[0].shape[1]
    parts = []
    for r0, r1 in chunks(args[0].shape[0]):
        *rays, grads = fused_fields_bwd_plain(
            level, *[a[r0:r1].contiguous() for a in args[:4]],
            dx_t[r0 * s:r1 * s], warp_scales)
        parts.append([*rays, *grads])
    return ([torch.cat([p[i] for p in parts]) for i in range(4)]
            + [sum(p[i] for p in parts) for i in range(4, len(parts[0]))])


TEMPLATE_GRAD_NAMES = ['dx_t', 'd_rgb_cond'] + [
    f'd{"Wb"[i % 2]}{14 + i // 2}' for i in range(32)]
FIELDS_GRAD_NAMES = ['d_z', 'd_origins', 'd_directions', 'd_embed'] + [
    f'd{"Wb"[i % 2]}{i // 2}' for i in range(28)]
SE3_FIELDS_GRAD_NAMES = FIELDS_GRAD_NAMES[:4] + [
    f'd{"Wb"[i % 2]}{i // 2}' for i in range(32)]


# Kernel A's sources: the row product and the weight gradient (`wgmma`,
# TMA), the narrow steps.
TEMPLATE_BWD_SOURCES = ('template_rowprod.cu', 'template_dw.cu',
                        'template_bwd.cu')


def template_bwd_bound(level, n_rays: int, samples: int):
    """(bound_ms, bound_by) of the template backward on n_rays x samples
    rows: the recompute, g W and g^T h each take one multiply-add per weight
    and row; bytes are the inputs and outputs once (raw_t, g, dx_t per row;
    the condition and its cotangent per ray) and the weights and dW once. The
    function's work, not the stash's bytes."""
    t_macs = level_macs(level)[1]
    p = n_rays * samples
    return bound(6.0 * t_macs * p,
                 p * (32 + 16 + 32) + n_rays * (78 + 156) + 6 * t_macs)


def fields_bwd_bound(level, n_rays: int, samples: int):
    """(bound_ms, bound_by) of kernel B on n_rays x samples rows: the
    recompute, g W and g^T h each take one multiply-add per weight of the
    field layers and row; bytes are the inputs and outputs once (z, dx_t, d z
    per row; the ray inputs and their cotangents per ray) and the weights
    and dW once."""
    f_macs = level_macs(level)[0]
    p = n_rays * samples
    return bound(6.0 * f_macs * p,
                 p * (4 + 32 + 4) + n_rays * (24 + 32 + 56) + 6 * f_macs)


def fields_bwd_plan_phase() -> None:
    """Phase 6, kernel B's plan: the compiled plan (block tile, ring, the
    slab pool's buffer plan with its spills and reloads, the weight loads of
    a block tile) against its model in kernels/fused_level.py for each warp
    type, and the weight bytes a call streams from L2 as the plan computes
    them."""
    import importlib
    fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
    from hypernerf_tpu_torch.kernels import common
    for warp in common.WARP_CODES:
        got = fl.compiled_fields_bwd_plan(warp)
        want = fl.fields_bwd_plan(warp, common.kernel_layout(warp))
        if got != want:
            raise AssertionError(f'{warp}: the compiled fields backward plan '
                                 f'is not its model: {got} vs {want}')
    c = want['config']
    phase(f'[6] fields backward plan (compiled = model, all three warp '
          f'types): block tiles of {c[0]} rows on {c[1]} warpgroups, a ring '
          f'of {c[2]} stages of {c[3]} bytes, {c[6]} slabs of outputs, '
          f'{c[7]} spill slabs a block, {c[4]} bytes of shared memory, '
          f'{c[5]} threads, {len(want["loads"])} weight loads a block tile')
    shapes = common.kernel_layout('translation')
    for s in (64, 128):
        phase(f'[6] computed from the plan, not measured: kernel B at '
              f'R={TRAIN_RAYS} S={s} streams '
              f'{fl.fields_bwd_stream_bytes("translation", shapes, TRAIN_RAYS * s):,}'
              f' bytes of weights from L2 (the blob once per 128-row block '
              f'tile)')


def backward_phase(kernels):
    """Phase 6; returns the three backward kernels' entries and raises the
    two forward kernels' ``max_abs_err`` in ``kernels`` to what they show at
    the train step's shapes."""
    import torch
    from hypernerf_tpu_torch.flagship import (GRAD_REFERENCE_CASE,
                                              LEVEL_INPUTS, flagship_model,
                                              load_probe_weights,
                                              read_grad_reference)
    from hypernerf_tpu_torch.kernels import (fused_composite,
                                             fused_composite_bwd,
                                             fused_composite_bwd_plain,
                                             fused_composite_plain,
                                             fused_fields_bwd, fused_level,
                                             fused_template_bwd)
    from hypernerf_tpu_torch.kernels.fused_level import (_launch_forward,
                                                         _level_params)
    from hypernerf_tpu_torch.kernels.fused_mlp import chunk_plan
    probe = load_probe_weights(flagship_model('cuda'))
    level = {64: probe.level('coarse'), 128: probe.level('fine')}
    fields_bwd_plan_phase()

    # The JAX kernels' stored gradients (tools/make_level_reference.py):
    # the CUDA kernels through the autograd Functions, as training runs them.
    ref = read_grad_reference()
    lev, comp = ref['level'], ref['composite']
    name = GRAD_REFERENCE_CASE[0]
    args = [torch.from_numpy(lev[k]).cuda().requires_grad_()
            for k in LEVEL_INPUTS]
    params = _level_params(probe.level(name))
    got = torch.autograd.grad(fused_level(probe.level(name), *args),
                              args + params,
                              torch.from_numpy(lev['cotangent']).cuda())
    names = [f'd_{k}' for k in LEVEL_INPUTS] + [
        f'd{"wb"[i % 2]}{i // 2}' for i in range(60)]
    check_grads('level backward (kernels A + B) vs stored JAX gradients',
                names, got, [torch.from_numpy(lev[n]).cuda() for n in names])
    cin = {k: torch.from_numpy(comp[k]).cuda().requires_grad_()
           for k in ('packed', 'z_vals', 'directions', 'noise')}
    out = fused_composite(cin['packed'], cin['z_vals'], cin['directions'],
                          noise=cin['noise'])
    outs = torch.cat([out['rgb'], out['depth'][:, None],
                      out['med_depth'][:, None], out['acc'][:, None]], -1)
    loss = ((outs * torch.from_numpy(comp['cot_outs']).cuda()).sum()
            + (out['weights']
               * torch.from_numpy(comp['cot_weights']).cuda()).sum())
    check_grads('compositing backward (kernel C) vs stored JAX gradients',
                list(cin), torch.autograd.grad(loss, list(cin.values())),
                [torch.from_numpy(comp[f'd_{k}']).cuda() for k in cin],
                COMPOSITE_GRAD_TOL, COMPOSITE_GRAD_TOL)

    with torch.no_grad():
        # The 1 % probe, applied to a gradient: a 1 % change of layer 5 of
        # the warp (or the sheet) must move that field's dW, in the plain
        # version, by more than the check allows.
        args = level_inputs(512, 64, seed=0)
        g = torch.randn(512 * 64, 4, generator=torch.Generator().manual_seed(
            0)).cuda()

        def plain_fields_dw():
            tmpl = plain_template_bwd(level[64],
                                      plain_forward(level[64], args)[1],
                                      args[4], g)
            return plain_fields_bwd(level[64], args, tmpl[0])[4:]

        base = plain_fields_dw()
        for fname, field, sl in (('warp', probe.warp_field, slice(0, 14)),
                                 ('sheet', probe.hyper_sheet_mlp,
                                  slice(14, 28))):
            weight = field.mlp.hidden(5).weight
            weight.mul_(1.01)
            moved = plain_fields_dw()
            weight.div_(1.01)
            l2 = [grad_errors(a, b)[0]
                  for a, b in zip(moved[sl][::2], base[sl][::2])]
            phase(f'[6] probe: 1% on {fname} layer 5 moves its 7 dW by '
                  f'relative L2 {min(l2):.3f}..{max(l2):.3f} (the check '
                  f'allows {GRAD_L2})')
            if not min(l2) > GRAD_L2:
                raise AssertionError(f'the gradient check cannot see the '
                                     f'{fname} layers')
        # The same for the template: a 1 % change of its hidden layer 5
        # must move kernel A's dW, in the plain version, by more than the
        # check allows: the 16 dW together (so at least one of them), and
        # each layer's is printed.
        raw_t = plain_forward(level[64], args)[1]
        base = plain_template_bwd(level[64], raw_t, args[4], g)[2::2]
        weight = level[64].template.trunk.hidden(5).weight
        weight.mul_(1.01)
        moved = plain_template_bwd(level[64], raw_t, args[4], g)[2::2]
        weight.div_(1.01)
        l2 = [grad_errors(a, b)[0] for a, b in zip(moved, base)]
        whole = grad_errors(torch.cat([a.reshape(-1) for a in moved]),
                            torch.cat([b.reshape(-1) for b in base]))[0]
        phase(f'[6] probe: 1% on template layer 5 moves kernel A\'s 16 dW by '
              f'relative L2 {whole:.3f} together, '
              f'{sum(x > GRAD_L2 for x in l2)} of them past the check, each: '
              + ' '.join(f'{x:.3f}' for x in l2)
              + f' (the check allows {GRAD_L2})')
        if not whole > GRAD_L2:
            raise AssertionError('the gradient check cannot see the template '
                                 'layers')
        del raw_t

        # The forward kernel with its raw_t output on, as training launches
        # it, against the plain forward; then kernel A on the kernel's own
        # raw_t and kernel B on the plain A's dx_t, each against its plain
        # version on the same inputs (A then B chained, as training runs
        # them, is held to the JAX gradients above and to the plain versions
        # in phase 7).
        errs = {'A': [], 'B': [], 'fwd': []}
        times = {}
        for r, s in ((37, 13), (512, 64), (512, 128), (TRAIN_RAYS, 64),
                     (TRAIN_RAYS, 128)):
            lv = level.get(s, level[64])
            args = level_inputs(r, s, seed=s + 1)
            g = torch.randn(r * s, 4, generator=torch.Generator().manual_seed(
                s)).cuda()
            out, raw_t = _launch_forward(lv, *args, want_raw_t=True)
            want_out, want_raw_t = plain_forward(lv, args)
            errs['fwd'] += [
                hold_level(out, want_out, f'level forward with raw_t vs '
                           f'plain R={r} S={s}: out', '[6]'),
                hold_level(raw_t, want_raw_t, f'level forward with raw_t vs '
                           f'plain R={r} S={s}: raw_t', '[6]')]
            del out, want_out, want_raw_t
            want_a = plain_template_bwd(lv, raw_t, args[4], g)
            got_dx_t, d_cond, t_grads = fused_template_bwd(lv, raw_t,
                                                           args[4], g)
            dx_t = want_a[0]
            d_z, d_o, d_d, d_e, f_grads = fused_fields_bwd(lv, *args[:4],
                                                           dx_t)
            torch.cuda.synchronize()
            errs['A'].append(check_grads(
                f'template backward (A) vs plain R={r} S={s}',
                TEMPLATE_GRAD_NAMES, [got_dx_t, d_cond, *t_grads], want_a))
            errs['B'].append(check_grads(
                f'fields backward (B) vs plain R={r} S={s}',
                FIELDS_GRAD_NAMES, [d_z, d_o, d_d, d_e, *f_grads],
                plain_fields_bwd(lv, args, dx_t)))
            if r != TRAIN_RAYS:
                continue
            times[s] = dict(
                A=cuda_ms(lambda: fused_template_bwd(lv, raw_t, args[4], g),
                          3),
                # The bytes of the stash that the timed calls allocated.
                stash=fused_template_bwd.stash_bytes,
                B=cuda_ms(lambda: fused_fields_bwd(lv, *args[:4], dx_t), 3),
                plain_A=cuda_ms(lambda: plain_template_bwd(lv, raw_t, args[4],
                                                           g), 1),
                plain_B=cuda_ms(lambda: plain_fields_bwd(lv, args, dx_t), 1))
            # One more call of kernel A: its host time (the launches alone,
            # from an idle device, so no launch waits for room in the queue)
            # and the memory it allocates above what was there before it.
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fused_template_bwd(lv, raw_t, args[4], g)
            times[s]['host'] = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            times[s]['peak'] = torch.cuda.max_memory_allocated() - base
            a_bound = template_bwd_bound(lv, r, s)[0]
            b_bound = fields_bwd_bound(lv, r, s)[0]
            phase(f'[6] level backward R={r} S={s}: kernel A '
                  f'{times[s]["A"]:.2f} ms (plain {times[s]["plain_A"]:.1f} '
                  f'ms; {a_bound / times[s]["A"]:.1%} of its bound '
                  f'{a_bound:.3f} ms; {len(chunk_plan(r * s, s))} chunks of '
                  f'whole rays; the stash it allocated '
                  f'{times[s]["stash"]} bytes; the call\'s peak allocation '
                  f'{times[s]["peak"]} bytes; its host time '
                  f'{times[s]["host"]:.3f} ms), kernel B '
                  f'{times[s]["B"]:.2f} ms (plain {times[s]["plain_B"]:.1f} '
                  f'ms; {b_bound / times[s]["B"]:.1%} of its bound '
                  f'{b_bound:.3f} ms); plain versions in chunks of '
                  f'{PLAIN_CHUNK} rays')
            del raw_t, want_a, dx_t
            torch.cuda.empty_cache()

        # The compositing forward as training launches it: sigma noise on,
        # the coarse level with the ascending fine draw, the fine level
        # without one.
        fwd_c = []
        for r, s, n in ((37, 5, 7), (TRAIN_RAYS, 64, 64),
                        (TRAIN_RAYS, 128, 0)):
            packed, z, dirs, u = composite_inputs(r, s, n, seed=r + s + n,
                                                  linspace_u=False)
            noise = torch.randn(r, s, generator=torch.Generator().manual_seed(
                r + s)).cuda()
            fwd_c.append(check_composite(
                packed, z, dirs, u, f'forward with noise R={r} S={s} N={n} '
                f'u=sorted', noise=noise, tag='[6]'))
        for k in kernels:
            if k['name'] == 'fused_level_fwd':
                k['max_abs_err'] = max(k['max_abs_err'], *errs['fwd'])
            if k['name'] == 'fused_composite_fwd':
                k['max_abs_err'] = max(k['max_abs_err'], *fwd_c)

        # Kernel C vs plain, noise on, white background and infinity both
        # ways.
        c_errs, c_times = [], {}
        gen = torch.Generator().manual_seed(5)
        for r, s in ((37, 5), (512, 64), (TRAIN_RAYS, 64), (TRAIN_RAYS, 128)):
            for white, infinity in ((False, True), (True, False),
                                    (True, True), (False, False)):
                packed, z, dirs, _ = composite_inputs(r, s, 0, seed=r + s,
                                                      linspace_u=True)
                noise = torch.randn(r, s, generator=gen).cuda()
                d_outs = torch.randn(r, 6, generator=gen).cuda()
                d_w = (torch.randn(r, s, generator=gen) * 0.1).cuda()
                got = fused_composite_bwd(packed, z, dirs, noise, d_outs,
                                          d_w, white, infinity)
                dnorm = torch.linalg.norm(dirs, dim=-1, keepdim=True)
                want = fused_composite_bwd_plain(packed, z, dnorm, noise,
                                                 d_outs, d_w, white,
                                                 infinity)
                torch.cuda.synchronize()
                # d z carries d med_depth at the first sample whose
                # cumulative weight reaches 0.5: a ray whose sum passes
                # within 1e-5 of 0.5 may pick the neighbour in the kernel's
                # sequential sum. Such rays are left out of d z's comparison.
                cum = torch.cumsum(fused_composite_plain(
                    packed, z, dirs, None, white, infinity,
                    noise)['weights'], dim=-1)
                edge = ((cum - 0.5).abs() < 1e-5).any(-1)
                got, want = list(got), list(want)
                got[1] = got[1].masked_fill(edge[:, None], 0.0)
                want[1] = want[1].masked_fill(edge[:, None], 0.0)
                c_errs.append(check_grads(
                    f'compositing backward (C) vs plain R={r} S={s} '
                    f'white={int(white)} infinity={int(infinity)} '
                    f'({int(edge.sum())} rays on the median\'s edge)',
                    ['d_packed', 'd_z', 'd_dnorm', 'd_noise'], got, want,
                    COMPOSITE_GRAD_TOL, COMPOSITE_GRAD_TOL))
            if r == TRAIN_RAYS:
                c_times[s] = (
                    cuda_ms(lambda: fused_composite_bwd(
                        packed, z, dirs, noise, d_outs, d_w)),
                    cuda_ms(lambda: fused_composite_bwd_plain(
                        packed, z, dnorm, noise, d_outs, d_w)))
                phase(f'[6] compositing backward R={r} S={s}: kernel '
                      f'{c_times[s][0]:.3f} ms, plain {c_times[s][1]:.3f} ms')

    # Bounds at the train step's fine level (R = 16384, S = 128). A and B:
    # the recompute, g W and g^T h each take one multiply-add per weight and
    # sample. Bytes: inputs once, outputs once, the weights and dW once.
    p, r = TRAIN_RAYS * 128, TRAIN_RAYS
    a_ms, a_by = template_bwd_bound(level[128], r, 128)
    b_ms, b_by = fields_bwd_bound(level[128], r, 128)
    c_ms, c_by = bound(0.0, p * (16 + 4 + 4 + 4 + 16 + 4) + r * (12 + 24 + 4))
    src = 'hypernerf_tpu_torch/kernels/csrc/'
    return [
        dict(name='fused_template_bwd', route='cuda',
             source=', '.join(src + f for f in TEMPLATE_BWD_SOURCES),
             replaces='hypernerf_tpu/ops/pallas/fused_mlp.py:736',
             ms=times[128]['A'], **error_keys(errs['A']),
             plain_ms=times[128]['plain_A'], bound_ms=a_ms, bound_by=a_by,
             library_ms=None, ms_s64=times[64]['A'],
             stash_bytes_per_chunk=times[128]['stash'],
             call_peak_bytes=times[128]['peak'],
             host_ms=times[128]['host']),
        dict(name='fused_fields_bwd', route='cuda',
             source=', '.join(src + f for f in FIELDS_BWD_SOURCES),
             replaces='hypernerf_tpu/ops/pallas/fused_level.py:846',
             ms=times[128]['B'], **error_keys(errs['B']),
             plain_ms=times[128]['plain_B'], bound_ms=b_ms, bound_by=b_by,
             library_ms=None, ms_s64=times[64]['B'],
             bound_ms_s64=fields_bwd_bound(level[64], r, 64)[0]),
        dict(name='fused_composite_bwd', route='cuda',
             source=src + 'fused_composite_bwd.cu',
             replaces='hypernerf_tpu/ops/pallas/fused_composite.py:477',
             ms=c_times[128][0],
             **error_keys(c_errs, COMPOSITE_GRAD_TOL, COMPOSITE_GRAD_TOL),
             plain_ms=c_times[128][1], bound_ms=c_ms, bound_by=c_by,
             library_ms=None)]


def step_grad_errors(got, want):
    """Two {name: gradient} dicts of one model: (relative L2 over all
    parameters together, (worst parameter's |d|_2 over its scale, name)).
    A parameter's scale is its gradient's own norm, or, where that is
    smaller, the norm it would have with entries of the whole gradient's
    root mean square: some gradients (the alpha heads' above all, sums of
    d sigma of both signs) cancel to a small remainder, which the last bits
    of bf16 activations move by more than its own size."""
    import torch
    sq = sum(want[k].float().pow(2).sum() for k in want)
    count = sum(want[k].numel() for k in want)
    d_sq = sum((got[k] - want[k]).float().pow(2).sum() for k in want)
    worst = max(
        (((got[k] - want[k]).float().norm() / torch.maximum(
            want[k].float().norm(), (sq * want[k].numel() / count).sqrt())
          ).item(), k) for k in want)
    return (d_sq / sq).sqrt().item(), worst


@contextlib.contextmanager
def plain_versions():
    """Inside, every wrapper runs its plain version on the card, forward and
    backward, through the same autograd Functions as its kernel: the one name
    by which the wrappers choose, ``kernels.common.runs_plain``, is rebound.
    For the comparison renders and steps of phases 5, 7 and 9; the port
    itself never takes a plain version on a CUDA tensor."""
    from hypernerf_tpu_torch.kernels import common
    saved = common.runs_plain
    common.runs_plain = lambda t, name: True
    try:
        yield
    finally:
        common.runs_plain = saved


def compare_step(model, all_rays, all_rgbs, tag='[7]',
                 elastic_weight: float = 0.0):
    """One step's loss and gradients on a small explicit batch from the same
    state and draws: the kernels, then the plain versions. Run on the seeded
    initial state, so the reading is the same from run to run (after train
    steps the state differs in its last bits, and the reading with it).
    With ``elastic_weight`` the loss adds the elastic term (the warp
    Jacobian, subsampled by the same draws); its value is printed and must
    be non-zero. Returns the launches of the kernels' step."""
    import torch
    from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
    from hypernerf_tpu_torch.ops.sampling import sorted_uniform
    from hypernerf_tpu_torch.training.losses import (mse_loss,
                                                     weighted_elastic_loss)
    cfg = model.config
    n = 1024
    gen = torch.Generator(device='cuda').manual_seed(11)
    s, nf = cfg.num_coarse_samples, cfg.num_fine_samples
    draws = {'t_rand': torch.rand(n, s, generator=gen, device='cuda'),
             'fine_u': sorted_uniform(n, nf, gen, device='cuda'),
             'noise_coarse': torch.randn(n, s, generator=gen, device='cuda'),
             'noise_fine': torch.randn(n, s + nf, generator=gen,
                                       device='cuda')}
    k = cfg.elastic_jacobian_samples
    if elastic_weight and k:
        draws.update({f'jacobian_u_{level}': torch.rand(
            n, k, generator=gen, device='cuda') for level in ('coarse',
                                                              'fine')})
    terms = []

    def one_step():
        model.zero_grad(set_to_none=True)
        out = model(prepare_ray_dict(all_rays[:n]), deterministic=False,
                    return_weights=bool(elastic_weight), draws=draws,
                    return_warp_jacobian=bool(elastic_weight))
        loss = mse_loss(out, all_rgbs[:n])
        if elastic_weight:
            terms.append(weighted_elastic_loss(out))
            loss = loss + elastic_weight * terms[-1]
        loss.backward()
        return loss.item(), {k: p.grad.clone()
                             for k, p in model.named_parameters()}

    reset_counts()
    loss_k, grads_k = one_step()
    launches = {k: fn.launches for k, fn in kernel_wrappers()[0].items()
                if fn.launches}
    with plain_versions():
        loss_p, grads_p = one_step()
    model.zero_grad(set_to_none=True)
    total, worst = step_grad_errors(grads_k, grads_p)
    elastic = (f'; elastic term {terms[0].item():.6e} vs '
               f'{terms[1].item():.6e} (weight {elastic_weight})'
               if terms else '')
    phase(f'{tag} one step on {n} rays, kernels vs plain versions: loss '
          f'{loss_k:.6f} vs {loss_p:.6f} (tol {STEP_LOSS_TOL}); gradients: '
          f'relative L2 over all parameters {total:.3e}, worst parameter '
          f'{worst[0]:.3e} of its scale at {worst[1]} (tol {STEP_GRAD_L2} '
          f'both){elastic}')
    if not abs(loss_k - loss_p) <= STEP_LOSS_TOL or \
            not max(total, worst[0]) <= STEP_GRAD_L2:
        raise AssertionError('train step: kernels and plain versions '
                             'disagree')
    if terms and not (math.isfinite(terms[0].item()) and terms[0].item() > 0):
        raise AssertionError(f'the elastic term is {terms[0].item()}')
    return launches


def kernel_wrappers():
    """({kernel name: wrapper with a ``launches`` count}, [plain versions
    with a ``calls`` count]) of all fourteen kernels."""
    from hypernerf_tpu_torch import kernels as K
    wrappers = {'fused_level_fwd': K.fused_level,
                'fused_composite_fwd': K.fused_composite,
                'fused_template_bwd': K.fused_template_bwd,
                'fused_fields_bwd': K.fused_fields_bwd,
                'fused_composite_bwd': K.fused_composite_bwd,
                'fused_field_fwd': K.fused_field,
                'fused_field_bwd': K.fused_field_bwd,
                'fused_template_fwd': K.fused_template,
                'fused_se3_fwd': K.fused_se3_wv,
                'fused_se3_bwd': K.fused_se3_bwd,
                'fused_jacobian_fwd': K.fused_warp_jacobian,
                'fused_jacobian_bwd': K.fused_jacobian_bwd,
                'fused_se3_jacobian_fwd': K.fused_se3_wv_tangents,
                'fused_se3_jacobian_bwd': K.fused_se3_jacobian_bwd}
    plains = [K.fused_level_plain, K.fused_composite_plain,
              K.fused_template_bwd_plain, K.fused_fields_bwd_plain,
              K.fused_composite_bwd_plain, K.fused_field_plain,
              K.fused_field_bwd_plain, K.fused_template_plain,
              K.fused_se3_plain, K.fused_se3_bwd_plain,
              K.fused_jacobian_plain, K.fused_jacobian_bwd_plain,
              K.fused_se3_jacobian_plain, K.fused_se3_jacobian_bwd_plain]
    return wrappers, plains


def reset_counts():
    wrappers, plains = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    for fn in plains:
        fn.calls = 0


def read_counts(want: dict, label: str) -> dict:
    """The launch counts since ``reset_counts``; raises unless they are
    ``want`` (kernels not named: 0) and no plain version was called."""
    wrappers, plains = kernel_wrappers()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    plain_calls = [fn.calls for fn in plains]
    if launches != {name: want.get(name, 0) for name in wrappers} \
            or any(plain_calls):
        raise AssertionError(f'{label}: launches {launches}, want {want} '
                             f'and 0 elsewhere; plain calls {plain_calls}')
    return {k: v for k, v in launches.items() if v}


# Launches per train step on each configuration's path.
STEP_LAUNCHES = {
    'flagship': {'fused_level_fwd': 2, 'fused_composite_fwd': 2,
                 'fused_template_bwd': 2, 'fused_fields_bwd': 2,
                 'fused_composite_bwd': 2},
    'static': {'fused_template_fwd': 2, 'fused_template_bwd': 2},
    'split_glo': {'fused_field_fwd': 4, 'fused_field_bwd': 4,
                  'fused_template_fwd': 2, 'fused_template_bwd': 2},
    # The trunk's kernels for the warp, the field kernels for the sheet.
    'se3_split_glo': {'fused_se3_fwd': 2, 'fused_se3_bwd': 2,
                      'fused_field_fwd': 2, 'fused_field_bwd': 2,
                      'fused_template_fwd': 2, 'fused_template_bwd': 2}}
STEP_LAUNCHES['se3'] = STEP_LAUNCHES['quaternion'] = STEP_LAUNCHES['flagship']
# The elastic loss adds the Jacobian kernels, once per level and step.
STEP_LAUNCHES['elastic'] = {**STEP_LAUNCHES['flagship'],
                            'fused_jacobian_fwd': 2, 'fused_jacobian_bwd': 2}
STEP_LAUNCHES['elastic_se3'] = STEP_LAUNCHES['elastic_quaternion'] = {
    **STEP_LAUNCHES['flagship'], 'fused_se3_jacobian_fwd': 2,
    'fused_se3_jacobian_bwd': 2}
# A path that is a configuration with overrides: (configuration, overrides).
PATHS = {'se3_split_glo': ('se3', dict(share_glo=False))}


def train_path(config: str, tag: str) -> dict:
    """The train step of ``config`` (a configuration, or a name of ``PATHS``)
    at full width (batch 16384, 64 + 64, bf16, sigma noise, Adam with steplr)
    through ``make_train_step``; returns its launches over the timed steps."""
    import torch
    from hypernerf_tpu_torch.flagship import flagship_train_setup
    from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
    from hypernerf_tpu_torch.training.losses import mse_loss
    from hypernerf_tpu_torch.training.train_state import (TrainState,
                                                          step_generator)
    from hypernerf_tpu_torch.flagship import TRAIN_CONFIGS
    base, overrides = PATHS.get(config, (config, {}))
    state, step_fn, all_rays, all_rgbs = flagship_train_setup(
        'cuda', seed=0, batch_size=TRAIN_RAYS, config=base, **overrides)
    elastic = TRAIN_CONFIGS.get(base, {}).get('elastic_loss_weight', 0.0)
    model = state.model
    cfg = model.config
    fixed = slice(0, 4096)

    def fixed_loss():  # a deterministic render of a fixed batch
        with torch.no_grad():
            out = model(prepare_ray_dict(all_rays[fixed]),
                        return_weights=False)
            return mse_loss(out, all_rgbs[fixed]).item()

    before = fixed_loss()
    compare_step(model, all_rays, all_rgbs, tag, elastic)
    for _ in range(WARMUP_STEPS):
        step_fn(state, all_rays, all_rgbs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    metrics = [step_fn(state, all_rays, all_rgbs) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = read_counts({k: v * TRAIN_STEPS
                            for k, v in STEP_LAUNCHES[config].items()},
                           f'{config} train steps')
    losses = [m['loss'].item() for m in metrics]
    psnrs = [m['psnr'].item() for m in metrics]
    after = fixed_loss()
    if not all(map(math.isfinite, losses + psnrs)) or not after < before:
        raise AssertionError(f'{config} train losses {losses}, fixed-batch '
                             f'loss {before} -> {after}')
    # Every parameter's gradient of the last step: finite and non-zero; a
    # GLO table non-zero exactly on the rows of the batch's image ids.
    last = TrainState(state.step - 1, model, state.optimizer, state.seed)
    idx = torch.randint(0, all_rays.shape[0], (TRAIN_RAYS,),
                        generator=step_generator(last, all_rays.device),
                        device=all_rays.device)
    used = torch.zeros(cfg.num_embeddings, dtype=torch.bool, device='cuda')
    used[all_rays[idx, 8].long()] = True
    for name, p in model.named_parameters():
        g = p.grad
        if g is None or not torch.isfinite(g).all() or not g.abs().sum() > 0:
            raise AssertionError(f'{config}: gradient of {name} missing, '
                                 f'not finite or zero')
        if name.endswith('_embed.embed.weight') and not torch.equal(
                g.abs().sum(-1) > 0, used):
            raise AssertionError(f'{config}: gradient rows of {name} do not '
                                 f'match the batch\'s image ids')
    phase(f'{tag} {config} train step (batch {TRAIN_RAYS}, 64+64, full '
          f'widths, bf16, noise_std {cfg.noise_std}, Adam lr '
          f'{state.optimizer.param_groups[0]["lr"]}): {secs * 1e3:.1f} '
          f'ms/step, {TRAIN_RAYS / secs:.0f} rays/s over {TRAIN_STEPS} steps '
          f'after {WARMUP_STEPS}; launches per step '
          + ', '.join(f'{k} {v // TRAIN_STEPS}' for k, v in launches.items())
          + f'; no plain call; loss {losses[0]:.5f} -> '
          f'{losses[-1]:.5f}, psnr {psnrs[-1]:.2f}; fixed-batch loss '
          f'{before:.5f} -> {after:.5f}; {len(list(model.parameters()))} '
          f'parameters with finite non-zero gradients; peak memory '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB')
    return launches


def train_phase(kernels) -> None:
    """Phase 7: the flagship train step; fills in the train launches of its
    kernels' entries."""
    launches = train_path('flagship', '[7]')
    for k in kernels:
        k['train_launches'] = launches[k['name']]
        k.setdefault('launches', launches[k['name']])


# -- the per-module path ------------------------------------------------------

ROWS_128 = 128  # rows per ray of the inputs the module kernels are fed


def row_chunks(n_rows: int):
    step = PLAIN_CHUNK * ROWS_128
    return [(a, min(n_rows, a + step)) for a in range(0, n_rows, step)]


def field_rows(n_rows: int, seed: int):
    """(P, 11) raw rows [points on probe rays | the rays' GLO codes]."""
    from hypernerf_tpu_torch.kernels.fused_level import _raw_fields
    z, o, d, emb, _ = level_inputs(-(-n_rows // ROWS_128), ROWS_128, seed)
    return _raw_fields(z, o, d, emb)[:n_rows].contiguous()


def template_rows(n_rays: int, samples: int, seed: int, static: bool):
    """The template's raw rows (P, 8) [points | hyper coordinates of
    deviation 0.3, or zeros | 0] and condition (R, 39)."""
    import torch
    from hypernerf_tpu_torch.ops.posenc import posenc_orig
    p = n_rays * samples
    pts = field_rows(p, seed)[:, :3]
    gen = torch.Generator(device='cuda').manual_seed(seed)
    hyper = torch.randn(p, 4, generator=gen, device='cuda') * (
        0.0 if static else 0.3)
    dirs = torch.randn(n_rays, 3, generator=gen, device='cuda')
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    x_raw = torch.cat([pts, hyper, torch.zeros_like(pts[:, :1])], dim=-1)
    return x_raw.contiguous(), posenc_orig(dirs, 6)


def plain_field(mlp, n_freq, x_raw, scales=None):
    """The plain field forward over chunks of rows."""
    import torch
    from hypernerf_tpu_torch.kernels import fused_field_plain
    return torch.cat([fused_field_plain(mlp, n_freq, x_raw[a:b], scales)
                      for a, b in row_chunks(x_raw.shape[0])])


def plain_field_bwd(mlp, n_freq, x_raw, g, scales=None):
    """The plain field backward over chunks of rows: [dx_raw, 14 x dW/db]."""
    import torch
    from hypernerf_tpu_torch.kernels import fused_field_bwd_plain
    parts = [fused_field_bwd_plain(mlp, n_freq, x_raw[a:b], g[a:b], scales)
             for a, b in row_chunks(x_raw.shape[0])]
    return [torch.cat([dx for dx, _ in parts])] + [
        sum(grads[i] for _, grads in parts) for i in range(len(parts[0][1]))]


def plain_template(tmpl, x_raw, rgb_cond):
    """The plain template forward over chunks of condition rows."""
    import torch
    from hypernerf_tpu_torch.kernels import fused_template_plain
    s = x_raw.shape[0] // rgb_cond.shape[0]
    step = max(1, PLAIN_CHUNK * ROWS_128 // s)
    return torch.cat([
        fused_template_plain(tmpl, x_raw[r0 * s:(r0 + step) * s],
                             rgb_cond[r0:r0 + step])
        for r0 in range(0, rgb_cond.shape[0], step)])


def modular_kernel_phase():
    """Phase 8; returns the entries of the three kernels of the per-module
    path (times and bounds: the warp field, the flagship template)."""
    import torch
    import torch.nn.functional as F
    from hypernerf_tpu_torch import kernels as K
    from hypernerf_tpu_torch.flagship import (MODULAR_REFERENCE_CASES,
                                              flagship_model,
                                              load_probe_weights,
                                              read_modular_reference)
    from hypernerf_tpu_torch.kernels import common
    from hypernerf_tpu_torch.kernels.fused_field import (encoding_scales,
                                                         field_layers)
    from hypernerf_tpu_torch.kernels.fused_level import (_launch_forward,
                                                         _raw_fields)
    from hypernerf_tpu_torch.kernels.fused_mlp import template_layers
    probes = {c: load_probe_weights(flagship_model('cuda', config=c))
              for c in ('flagship', 'static')}
    probe = probes['flagship']
    fields = {'warp': probe.warp_field, 'sheet': probe.hyper_sheet_mlp}

    def tmpl(config, level):
        cfg = probes[config].config
        return K.Template(probes[config]._template(level), cfg.xyz_freq,
                          cfg.hyper_freq)

    def names_of(layers, first):
        return first + [f'd{"Wb"[i % 2]}{i // 2}'
                        for i in range(2 * len(layers))]

    # The JAX kernels' stored outputs and gradients
    # (tools/make_level_reference.py): the CUDA kernels through their
    # autograd Functions, as training runs them.
    ref = read_modular_reference()
    for case, (kind, config, module, _, per, _) in \
            MODULAR_REFERENCE_CASES.items():
        arrays = {k: torch.from_numpy(v).cuda() for k, v in ref[case].items()}
        x = arrays['x_raw'].requires_grad_()
        if kind == 'field':
            field = getattr(probes[config], module)
            scales = None if per is None else encoding_scales(
                field.n_freq, 8, per, 'cuda')
            layers = field_layers(field.mlp)
            out = K.fused_field(field.mlp, field.n_freq, x, scales)
            inputs, first = [x], ['dx']
        else:
            t = tmpl(config, module)
            layers = template_layers(t.template)
            cond = arrays['rgb_cond'].requires_grad_()
            out = K.fused_template(t, x, cond)
            inputs, first = [x, cond], ['dx', 'd_rgb_cond']
        hold_level(out.detach(), arrays['out'],
                   f'{case} vs the stored JAX output', '[8]')
        got = torch.autograd.grad(out, inputs + common.layer_params(layers),
                                  arrays['cotangent'][:, :out.shape[1]])
        names = names_of(layers, first)
        check_grads(f'{case} backward vs the stored JAX gradients', names,
                    got, [arrays[n.lower()] for n in names], tag='[8]')

    errs = {'field_fwd': [], 'field_bwd': [], 'template_fwd': [], 'A': []}
    times = {}
    gen = torch.Generator().manual_seed(8)
    with torch.no_grad():
        # A field alone vs its plain version, forward and backward.
        for fname, field in fields.items():
            mlp, n_freq = field.mlp, field.n_freq
            out_ch = mlp.logit.out_features
            window = encoding_scales(n_freq, 8, 0.45 * n_freq, 'cuda')
            grad_names = names_of(field_layers(mlp), ['dx_raw'])
            for p, scales in ((481, None), (481, window),
                              (CHUNK * 128, None), (CHUNK * 128, window),
                              (TRAIN_RAYS * 128, None)):
                label = (f'{fname} field P={p} window='
                         f'{"off" if scales is None else "on"}')
                x = field_rows(p, seed=p % 89 + n_freq)
                g = F.pad(torch.randn(p, out_ch, generator=gen),
                          (0, 8 - out_ch)).cuda()
                want = plain_field(mlp, n_freq, x, scales)
                errs['field_fwd'].append(hold_level(
                    K.fused_field(mlp, n_freq, x, scales), want,
                    f'{label} forward vs plain', '[8]'))
                dx, grads = K.fused_field_bwd(mlp, n_freq, x, g, scales)
                torch.cuda.synchronize()
                errs['field_bwd'].append(check_grads(
                    f'{label} backward vs plain', grad_names, [dx, *grads],
                    plain_field_bwd(mlp, n_freq, x, g, scales), tag='[8]'))
                if scales is not None or p < CHUNK * 128:
                    continue
                times[fname, p] = dict(
                    fwd=cuda_ms(lambda: K.fused_field(mlp, n_freq, x)),
                    plain_fwd=cuda_ms(lambda: plain_field(mlp, n_freq, x), 2),
                    bwd=cuda_ms(lambda: K.fused_field_bwd(mlp, n_freq, x, g),
                                3),
                    plain_bwd=cuda_ms(lambda: plain_field_bwd(mlp, n_freq, x,
                                                              g), 1))
                t = times[fname, p]
                phase(f'[8] {fname} field P={p}: forward {t["fwd"]:.3f} ms '
                      f'(plain {t["plain_fwd"]:.2f} ms), backward '
                      f'{t["bwd"]:.3f} ms (plain {t["plain_bwd"]:.1f} ms); '
                      f'plain versions in chunks of {PLAIN_CHUNK * 128} rows')
            del x, g, want, dx, grads
            torch.cuda.empty_cache()

        # The template alone vs its plain version: with and without hyper
        # coordinates, 128, 64, 13 and 1 rows per condition row.
        for config, level, r, s in (
                ('flagship', 'coarse', 37, 13), ('flagship', 'fine', 1001, 1),
                ('flagship', 'fine', CHUNK, 128),
                ('flagship', 'coarse', CHUNK, 64),
                ('flagship', 'fine', TRAIN_RAYS, 128),
                ('flagship', 'coarse', TRAIN_RAYS, 64),
                ('flagship', 'fine', 1 << 20, 1),
                ('static', 'coarse', 37, 13), ('static', 'fine', 1001, 1),
                ('static', 'fine', CHUNK, 128),
                ('static', 'coarse', CHUNK, 64),
                ('static', 'fine', TRAIN_RAYS, 128),
                ('static', 'coarse', TRAIN_RAYS, 64)):
            t = tmpl(config, level)
            x, cond = template_rows(r, s, seed=r % 83 + s,
                                    static=config == 'static')
            errs['template_fwd'].append(hold_level(
                K.fused_template(t, x, cond), plain_template(t, x, cond),
                f'{config} template forward R={r} S={s} vs plain', '[8]'))
            if r < CHUNK:
                continue
            times[config, r, s] = (
                cuda_ms(lambda: K.fused_template(t, x, cond)),
                cuda_ms(lambda: plain_template(t, x, cond), 2))
            phase(f'[8] {config} template forward R={r} S={s}: kernel '
                  f'{times[config, r, s][0]:.3f} ms, plain '
                  f'{times[config, r, s][1]:.2f} ms')

        # The template backward (kernel A) without hyper coordinates and at
        # one row per condition row.
        for config, level, r, s in (
                ('static', 'coarse', 37, 13), ('static', 'fine', 1001, 1),
                ('flagship', 'fine', 1001, 1),
                ('static', 'coarse', TRAIN_RAYS, 64),
                ('static', 'fine', TRAIN_RAYS, 128)):
            t = tmpl(config, level)
            x, cond = template_rows(r, s, seed=r % 79 + s,
                                    static=config == 'static')
            g = torch.randn(r * s, 4, generator=gen).cuda()
            dx_t, d_cond, grads = K.fused_template_bwd(t, x, cond, g)
            torch.cuda.synchronize()
            errs['A'].append(check_grads(
                f'{config} template backward (A) R={r} S={s} vs plain',
                TEMPLATE_GRAD_NAMES, [dx_t, d_cond, *grads],
                plain_template_bwd(t, x, cond, g), tag='[8]'))
            if (r, s) == (TRAIN_RAYS, 128):
                times['A', config] = cuda_ms(
                    lambda: K.fused_template_bwd(t, x, cond, g), 3)
                phase(f'[8] {config} template backward (A) R={r} S={s}: '
                      f'{times["A", config]:.2f} ms')
        del x, cond, g, dx_t, d_cond, grads
        torch.cuda.empty_cache()

        # Kernels against kernels, on the flagship: the warp field, the sheet
        # and the template kernels chained give the level kernel's output,
        # and the field backward twice on the template backward's dx_t gives
        # the fields backward's gradients.
        for s in (64, 128):
            lv = probe.level('coarse' if s == 64 else 'fine')
            args = level_inputs(512, s, seed=40 + s)
            z, o, d = args[:3]
            x_raw = _raw_fields(*args[:4]).contiguous()
            warped = x_raw[:, :3] + K.fused_field(
                lv.warp.mlp, lv.warp.n_freq, x_raw)
            hyper = K.fused_field(lv.hyper.mlp, lv.hyper.n_freq, x_raw)
            raw_t = F.pad(torch.cat([warped, hyper], dim=-1), (0, 1))
            want, want_raw_t = _launch_forward(lv, *args, want_raw_t=True)
            hold_level(raw_t, want_raw_t, f'field kernels vs the level '
                       f'kernel R=512 S={s}: raw_t', '[8]')
            hold_level(K.fused_template(lv, raw_t, args[4]), want,
                       f'field + template kernels vs the level kernel R=512 '
                       f'S={s}: out', '[8]')
            g = torch.randn(512 * s, 4, generator=gen).cuda()
            dx_t, _, _ = K.fused_template_bwd(lv, want_raw_t, args[4], g)
            want_b = K.fused_fields_bwd(lv, *args[:4], dx_t)
            dx_w, grads_w = K.fused_field_bwd(
                lv.warp.mlp, lv.warp.n_freq, x_raw,
                F.pad(dx_t[:, :3], (0, 5)).contiguous())
            dx_h, grads_h = K.fused_field_bwd(
                lv.hyper.mlp, lv.hyper.n_freq, x_raw,
                F.pad(dx_t[:, 3:7], (0, 4)).contiguous())
            d_pts = ((dx_t[:, :3] + dx_w[:, :3]) + dx_h[:, :3]).reshape(
                512, s, 3)
            d_emb = (dx_w[:, 3:] + dx_h[:, 3:]).reshape(512, s, -1).sum(1)
            torch.cuda.synchronize()
            check_grads(
                f'field backward twice vs the fields backward (B) R=512 '
                f'S={s}', FIELDS_GRAD_NAMES,
                [(d_pts * d[:, None]).sum(-1), d_pts.sum(1),
                 (d_pts * z[..., None]).sum(1), d_emb, *grads_w, *grads_h],
                [*want_b[:4], *want_b[4]], tag='[8]')

    # Bounds. A field at the render chunk (forward) and the train batch
    # (backward), P = R x 128 rows: one multiply-add per weight and row
    # forward, three backward; bytes are the rows in and out and the weights
    # (and dW) once. The template forward at R = CHUNK, S = 128.
    w_macs = sum(lin.weight.numel()
                 for lin, _ in field_layers(fields['warp'].mlp))
    t_macs = level_macs(probe.level('fine'))[1]
    p_r, p_t = CHUNK * 128, TRAIN_RAYS * 128
    f_ms, f_by = bound(2.0 * w_macs * p_r, p_r * (44 + 32) + 2 * w_macs)
    b_ms, b_by = bound(6.0 * w_macs * p_t,
                       p_t * (44 + 32 + 44) + 6 * w_macs)
    t_ms, t_by = bound(2.0 * t_macs * p_r,
                       p_r * (32 + 16) + CHUNK * 78 + 2 * t_macs)
    src = 'hypernerf_tpu_torch/kernels/csrc/'
    level_tol = (f'|d| <= {LEVEL_ATOL} + {LEVEL_RTOL} |plain|, mean |d| <= '
                 f'{LEVEL_MEAN}')
    warp_r, warp_t = times['warp', p_r], times['warp', p_t]
    sheet_r, sheet_t = times['sheet', p_r], times['sheet', p_t]
    return [
        dict(name='fused_field_fwd', route='cuda',
             source=src + 'fused_field.cu',
             replaces='hypernerf_tpu/ops/pallas/fused_field.py:495',
             max_abs_err=max(errs['field_fwd']), tolerance=level_tol,
             ms=warp_r['fwd'], plain_ms=warp_r['plain_fwd'], bound_ms=f_ms,
             bound_by=f_by, library_ms=None, shape=f'warp field, P={p_r}',
             warp_ms_train_rows=warp_t['fwd'], sheet_ms=sheet_r['fwd'],
             sheet_plain_ms=sheet_r['plain_fwd'],
             sheet_ms_train_rows=sheet_t['fwd']),
        dict(name='fused_field_bwd', route='cuda',
             source=src + 'fused_field_bwd.cu',
             replaces='hypernerf_tpu/ops/pallas/fused_field.py:532',
             **error_keys(errs['field_bwd']), ms=warp_t['bwd'],
             plain_ms=warp_t['plain_bwd'], bound_ms=b_ms, bound_by=b_by,
             library_ms=None, shape=f'warp field, P={p_t}',
             sheet_ms=sheet_t['bwd'], sheet_plain_ms=sheet_t['plain_bwd']),
        dict(name='fused_template_fwd', route='cuda',
             source=src + 'fused_template.cu',
             replaces='hypernerf_tpu/ops/pallas/fused_mlp.py:656',
             max_abs_err=max(errs['template_fwd']), tolerance=level_tol,
             ms=times['flagship', CHUNK, 128][0],
             plain_ms=times['flagship', CHUNK, 128][1], bound_ms=t_ms,
             bound_by=t_by, library_ms=None, shape=f'R={CHUNK} S=128',
             ms_s64=times['flagship', CHUNK, 64][0],
             static_ms=times['static', CHUNK, 128][0],
             ms_one_row_per_ray_2_20_rows=times['flagship', 1 << 20, 1][0],
             static_template_bwd_ms=times['A', 'static'],
             template_bwd_errors=error_keys(errs['A']))]


def modular_paths_phase(kernels) -> None:
    """Phase 9: the per-module path at full width on ``static`` and
    ``split_glo``; fills in the launches of the three kernels' entries."""
    import torch
    from hypernerf_tpu_torch.flagship import H, W, flagship_model, spiral_rays
    from hypernerf_tpu_torch.training.renderer import ImageRenderer
    chunks_per_frame = -(-W * H // CHUNK)
    frames = spiral_rays((0, 30))
    counts = {}
    for config in ('static', 'split_glo'):
        fields = 2 if config == 'split_glo' else 0
        model = flagship_model('cuda', seed=0, config=config)
        keep = ('rgb', 'depth', 'acc') + (
            ('med_points',) if fields else ())
        renderer = ImageRenderer(model, chunk=CHUNK, keep=keep,
                                 levels=('fine',), quantize=True)
        renderer(frames[0])  # warm-up frame: the first launches
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        fine = renderer(frames[1])['fine']
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_counts(
            {'fused_template_fwd': 2 * chunks_per_frame,
             'fused_field_fwd': 2 * fields * chunks_per_frame},
            f'{config} frame')
        shapes = {'rgb': (W * H, 3), 'depth': (W * H,), 'acc': (W * H,),
                  'med_points': (W * H, 1, 7)}
        for k in keep:
            v = torch.as_tensor(fine[k])
            if v.shape != shapes[k] or not torch.isfinite(v.float()).all():
                raise AssertionError(f'{config} frame: {k} {v.shape} not '
                                     f'finite / misshapen')
        if fine['rgb'].dtype.name != 'uint8':
            raise AssertionError(f'{config} frame: rgb {fine["rgb"].dtype}')
        phase(f'[9] {config}: rendered a {W}x{H} frame (64+64, chunk {CHUNK}'
              f'{", return_points" if fields else ""}): {secs:.4f} s/frame; '
              f'launches {launches} (= 2 levels x {chunks_per_frame} chunks'
              f'{" x 2 fields" if fields else ""}); no level kernel, no '
              f'plain call')
        counts[config, 'frame'] = launches
        del renderer, model, fine
        torch.cuda.empty_cache()
        counts[config, 'train'] = train_path(config, '[9]')
        torch.cuda.empty_cache()

    # query_sigma: one sample per row, a million points of one frame id.
    model = flagship_model('cuda', seed=0, config='split_glo')
    n = 1 << 20
    gen = torch.Generator(device='cuda').manual_seed(3)
    pts = torch.randn(n, 3, generator=gen, device='cuda') * 0.5
    ids = torch.full((n, 1), 3, dtype=torch.int64, device='cuda')
    with torch.no_grad():
        model.query_sigma(pts[:4096], ids[:4096])
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        sigma = model.query_sigma(pts, ids)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts['split_glo', 'query_sigma'] = read_counts(
            {'fused_field_fwd': 2, 'fused_template_fwd': 1}, 'query_sigma')
        with plain_versions():
            want = model.query_sigma(pts[:4099], ids[:4099])
    diff = (sigma[:4099] - want).abs()
    if sigma.shape != (n,) or not torch.isfinite(sigma).all() \
            or (sigma < 0).any() \
            or (diff > LEVEL_ATOL + LEVEL_RTOL * want.abs()).any():
        raise AssertionError(f'query_sigma: shape {tuple(sigma.shape)}, '
                             f'max|d| {diff.max().item():.3e}')
    phase(f'[9] split_glo query_sigma on {n} points: {secs * 1e3:.2f} ms; '
          f'launches {counts["split_glo", "query_sigma"]}; vs the plain '
          f'versions on 4099 points max|d| {diff.max().item():.3e} (tol '
          f'{LEVEL_ATOL}+{LEVEL_RTOL}|want|)')
    for k in kernels:
        name = k['name']
        for (config, path), launches in counts.items():
            if launches.get(name):
                k[f'{config}_{path}_launches'] = launches[name]
        if name in ('fused_field_fwd', 'fused_field_bwd',
                    'fused_template_fwd'):
            k['launches'] = counts['split_glo', 'train'][name]


# -- the SE(3) / quaternion warps ---------------------------------------------

WINDOW_ALPHA = 3.5  # of the trunk's 8 bands


def plain_se3(field, x_raw, scales=None):
    """The plain trunk forward over chunks of rows: (P, 6) [w | v]."""
    import torch
    from hypernerf_tpu_torch.kernels import fused_se3_plain
    return torch.cat([fused_se3_plain(field, x_raw[a:b], scales)
                      for a, b in row_chunks(x_raw.shape[0])])


def plain_se3_bwd(field, x_raw, g, scales=None):
    """The plain trunk backward over chunks of rows: [dx_raw, 18 x dW/db]."""
    import torch
    from hypernerf_tpu_torch.kernels import fused_se3_bwd_plain
    parts = [fused_se3_bwd_plain(field, x_raw[a:b], g[a:b], scales)
             for a, b in row_chunks(x_raw.shape[0])]
    return [torch.cat([dx for dx, _ in parts])] + [
        sum(grads[i] for _, grads in parts) for i in range(len(parts[0][1]))]


def wv_of(field, x_raw, scales=None):
    """(P, 6) [w | v] of the trunk kernel."""
    import torch
    from hypernerf_tpu_torch.kernels import fused_se3_wv
    return torch.cat(fused_se3_wv(field, x_raw, scales), dim=-1)


def se3_kernel_phase():
    """Phase 10; returns the entries of the trunk's two kernels."""
    import torch
    import torch.nn.functional as F
    from hypernerf_tpu_torch import kernels as K
    from hypernerf_tpu_torch.flagship import (SE3_TRUNK_CASES, flagship_model,
                                              load_probe_weights,
                                              read_se3_reference)
    from hypernerf_tpu_torch.kernels import common
    from hypernerf_tpu_torch.kernels.fused_se3 import (se3_encoding_scales,
                                                       se3_layers)
    probe = load_probe_weights(flagship_model('cuda', config='se3'))
    field = probe.warp_field
    layers = se3_layers(field)
    grad_names = ['dx'] + [f'd{"Wb"[i % 2]}{i // 2}'
                           for i in range(2 * len(layers))]
    window = se3_encoding_scales(field, WINDOW_ALPHA, 'cuda')

    # The JAX kernels' stored outputs and gradients
    # (tools/make_level_reference.py): the CUDA kernels through their
    # autograd Function, as training runs them.
    ref = read_se3_reference()
    for case, (_, alpha, _) in SE3_TRUNK_CASES.items():
        arrays = {k: torch.from_numpy(v).cuda() for k, v in ref[case].items()}
        x = arrays['x_raw'].requires_grad_()
        scales = None if alpha is None else se3_encoding_scales(field, alpha,
                                                                'cuda')
        out = wv_of(field, x, scales)
        hold_level(out.detach(), arrays['out'],
                   f'SE(3) {case} vs the stored JAX output', '[10]')
        got = torch.autograd.grad(out, [x] + common.layer_params(layers),
                                  arrays['cotangent'][:, :6])
        check_grads(f'SE(3) {case} backward vs the stored JAX gradients',
                    grad_names, got, [arrays[n.lower()] for n in grad_names],
                    l2_tol=SE3_TRUNK_GRAD_L2, tag='[10]')

    errs = {'fwd': [], 'bwd': []}
    times = {}
    gen = torch.Generator().manual_seed(10)
    with torch.no_grad():
        # The 1 % probe: a 1 % change of hidden layer 5 must move the plain
        # [w | v] and the plain dW by more than the checks allow.
        x = field_rows(CHUNK, seed=5)
        g = F.pad(torch.randn(CHUNK, 6, generator=gen), (0, 2)).cuda()
        base_out, base = plain_se3(field, x), plain_se3_bwd(field, x, g)
        weight = field.trunk.hidden(5).weight
        weight.mul_(1.01)
        moved_out = (plain_se3(field, x) - base_out).abs()
        moved = plain_se3_bwd(field, x, g)
        weight.div_(1.01)
        l2 = [grad_errors(a, b)[0] for a, b in zip(moved[1::2], base[1::2])]
        phase(f'[10] probe: |w| mean {base_out[:, :3].norm(dim=-1).mean():.3f} '
              f'rad, |v| mean {base_out[:, 3:].norm(dim=-1).mean():.3f}; 1% on '
              f'trunk layer 5 moves [w | v] by mean {moved_out.mean():.3e} '
              f'(the check allows {LEVEL_MEAN}) and the 9 dW by relative L2 '
              f'{min(l2):.3f}..{max(l2):.3f} (the check allows '
              f'{SE3_TRUNK_GRAD_L2})')
        if not (moved_out.mean() > LEVEL_MEAN
                and min(l2) > SE3_TRUNK_GRAD_L2):
            raise AssertionError('the checks cannot see the trunk\'s layers')

        # 481 rows: a multiple of neither the forward tile's 64 nor the
        # backward tile's 32 rows.
        for p, scales in ((481, None), (481, window), (CHUNK * 128, None),
                          (CHUNK * 128, window), (TRAIN_RAYS * 128, None)):
            label = (f'SE(3) trunk P={p} window='
                     f'{"off" if scales is None else "on"}')
            x = field_rows(p, seed=p % 89 + 8)
            g = F.pad(torch.randn(p, 6, generator=gen), (0, 2)).cuda()
            errs['fwd'].append(hold_level(
                wv_of(field, x, scales), plain_se3(field, x, scales),
                f'{label} forward vs plain', '[10]'))
            dx, grads = K.fused_se3_bwd(field, x, g, scales)
            torch.cuda.synchronize()
            errs['bwd'].append(check_grads(
                f'{label} backward vs plain', grad_names, [dx, *grads],
                plain_se3_bwd(field, x, g, scales),
                l2_tol=SE3_TRUNK_GRAD_L2, tag='[10]'))
            if scales is not None or p < CHUNK * 128:
                continue
            times[p] = dict(
                fwd=cuda_ms(lambda: K.fused_se3_wv(field, x)),
                plain_fwd=cuda_ms(lambda: plain_se3(field, x), 2),
                bwd=cuda_ms(lambda: K.fused_se3_bwd(field, x, g), 3),
                plain_bwd=cuda_ms(lambda: plain_se3_bwd(field, x, g), 1))
            t = times[p]
            phase(f'[10] SE(3) trunk P={p}: forward {t["fwd"]:.3f} ms (plain '
                  f'{t["plain_fwd"]:.2f} ms), backward {t["bwd"]:.3f} ms '
                  f'(plain {t["plain_bwd"]:.1f} ms); plain versions in '
                  f'chunks of {PLAIN_CHUNK * 128} rows')
        # A row of ones is no window.
        x = field_rows(481, seed=3)
        same = torch.equal(wv_of(field, x, torch.ones_like(window)),
                           wv_of(field, x))
        phase(f'[10] a window row of ones gives the numbers of no row: {same}')
        if not same:
            raise AssertionError('a window row of ones changes the trunk')
        del x, g, dx, grads
        torch.cuda.empty_cache()

    # Bounds: one multiply-add per weight and row forward, three backward;
    # bytes are the rows in and out and the weights (and dW) once. Forward at
    # the render chunk, backward at the train batch, P = R x 128 rows.
    macs = sum(lin.weight.numel() for lin, _ in layers)
    p_r, p_t = CHUNK * 128, TRAIN_RAYS * 128
    f_ms, f_by = bound(2.0 * macs * p_r, p_r * (44 + 32) + 2 * macs)
    b_ms, b_by = bound(6.0 * macs * p_t, p_t * (44 + 32 + 44) + 6 * macs)
    src = 'hypernerf_tpu_torch/kernels/csrc/'
    return [
        dict(name='fused_se3_fwd', route='cuda', source=src + 'fused_se3.cu',
             replaces='hypernerf_tpu/ops/pallas/fused_se3.py:374',
             max_abs_err=max(errs['fwd']),
             tolerance=f'|d| <= {LEVEL_ATOL} + {LEVEL_RTOL} |plain|, mean '
                       f'|d| <= {LEVEL_MEAN}',
             ms=times[p_r]['fwd'], plain_ms=times[p_r]['plain_fwd'],
             bound_ms=f_ms, bound_by=f_by, library_ms=None,
             shape=f'P={p_r}', macs_per_row=macs,
             ms_train_rows=times[p_t]['fwd']),
        dict(name='fused_se3_bwd', route='cuda',
             source=src + 'fused_se3_bwd.cu',
             replaces='hypernerf_tpu/ops/pallas/fused_se3.py:412',
             **error_keys(errs['bwd'], SE3_TRUNK_GRAD_L2),
             ms=times[p_t]['bwd'],
             plain_ms=times[p_t]['plain_bwd'], bound_ms=b_ms, bound_by=b_by,
             library_ms=None, shape=f'P={p_t}')]


def se3_level_phase(kernels) -> None:
    """Phase 11: the level kernels' ``se3`` and ``quaternion`` variants;
    raises the level forward's and the fields backward's ``max_abs_err`` to
    what the variants show and adds the variants' times to their entries."""
    import torch
    import torch.nn.functional as F
    from hypernerf_tpu_torch import kernels as K
    from hypernerf_tpu_torch.flagship import (LEVEL_INPUTS, SE3_LEVEL_CASES,
                                              flagship_model,
                                              load_probe_weights,
                                              read_se3_reference)
    from hypernerf_tpu_torch.kernels.fused_level import (_launch_forward,
                                                         _level_params,
                                                         _raw_fields)
    from hypernerf_tpu_torch.kernels.fused_se3 import se3_encoding_scales
    probes = {c: load_probe_weights(flagship_model('cuda', config=c))
              for c in ('se3', 'quaternion')}
    window = se3_encoding_scales(probes['se3'].warp_field, WINDOW_ALPHA,
                                 'cuda')

    # The JAX level kernel's stored outputs and gradients, through the
    # autograd Function (forward with raw_t, then A, then B).
    ref = read_se3_reference()
    for case, (config, name, _, _, alpha, _) in SE3_LEVEL_CASES.items():
        arrays = {k: torch.from_numpy(v).cuda() for k, v in ref[case].items()}
        args = [arrays[k].requires_grad_() for k in LEVEL_INPUTS]
        lv = probes[config].level(name)
        scales = None if alpha is None else se3_encoding_scales(
            lv.warp, alpha, 'cuda')
        out = K.fused_level(lv, *args, scales)
        hold_level(out.detach(), arrays['out'],
                   f'{case} vs the stored JAX output', '[11]', SE3_LEVEL_ATOL)
        got = torch.autograd.grad(out, args + _level_params(lv),
                                  arrays['cotangent'])
        names = [f'd_{k}' for k in LEVEL_INPUTS] + [
            f'd{"wb"[i % 2]}{i // 2}' for i in range(64)]
        check_grads(f'{case} backward (kernels A + B) vs the stored JAX '
                    f'gradients', names, got, [arrays[n] for n in names],
                    l2_tol=SE3_LEVEL_GRAD_L2, tag='[11]')

    errs = {'fwd': [], 'B': []}
    times = {}
    with torch.no_grad():
        for config, probe in probes.items():
            level = {64: probe.level('coarse'), 128: probe.level('fine')}
            for r, s, scales in ((37, 13, None), (37, 13, window),
                                 (512, 64, window), (512, 128, None),
                                 (CHUNK, 64, None), (CHUNK, 128, None),
                                 (TRAIN_RAYS, 64, None),
                                 (TRAIN_RAYS, 128, window)):
                lv = level.get(s, level[64])
                args = level_inputs(r, s, seed=s + 3)
                label = (f'{config} level R={r} S={s} window='
                         f'{"off" if scales is None else "on"}')
                out, raw_t = _launch_forward(lv, *args, want_raw_t=True,
                                             warp_scales=scales)
                want_out, want_raw_t = plain_forward(lv, args, scales)
                errs['fwd'] += [
                    hold_level(out, want_out, f'{label} forward vs plain: '
                               f'out', '[11]', SE3_LEVEL_ATOL),
                    hold_level(raw_t, want_raw_t, f'{label} forward vs '
                               f'plain: raw_t', '[11]')]
                if r == CHUNK:
                    times[config, 'fwd', s] = (
                        cuda_ms(lambda: K.fused_level(lv, *args)),
                        cuda_ms(lambda: plain_forward(lv, args), 2))
                    phase(f'[11] {config} level forward R={r} S={s}: kernel '
                          f'{times[config, "fwd", s][0]:.3f} ms, plain '
                          f'{times[config, "fwd", s][1]:.2f} ms')
                    continue
                # Kernel B on a cotangent of the template's raw input.
                dx_t = F.pad(torch.randn(
                    r * s, 7, generator=torch.Generator().manual_seed(s)),
                    (0, 1)).cuda()
                d_z, d_o, d_d, d_e, f_grads = K.fused_fields_bwd(
                    lv, *args[:4], dx_t, scales)
                torch.cuda.synchronize()
                errs['B'].append(check_grads(
                    f'{label} fields backward (B) vs plain',
                    SE3_FIELDS_GRAD_NAMES, [d_z, d_o, d_d, d_e, *f_grads],
                    plain_fields_bwd(lv, args, dx_t, scales), tag='[11]'))
                if r == TRAIN_RAYS:
                    times[config, 'B', s] = (
                        cuda_ms(lambda: K.fused_fields_bwd(lv, *args[:4],
                                                           dx_t, scales), 3),
                        cuda_ms(lambda: plain_fields_bwd(lv, args, dx_t,
                                                         scales), 1))
                    b_bound = fields_bwd_bound(lv, r, s)[0]
                    phase(f'[11] {config} fields backward R={r} S={s}: '
                          f'kernel B {times[config, "B", s][0]:.2f} ms '
                          f'({b_bound / times[config, "B", s][0]:.1%} of its '
                          f'bound {b_bound:.3f} ms), plain '
                          f'{times[config, "B", s][1]:.1f} ms')
                del out, raw_t, want_out, want_raw_t
                torch.cuda.empty_cache()

            # Kernels against kernels: the trunk kernel, the retraction, the
            # sheet's field kernel and the template kernel chained give the
            # level kernel's output.
            lv = level[64]
            args = level_inputs(512, 64, seed=71)
            x_raw = _raw_fields(*args[:4]).contiguous()
            w, v = K.fused_se3_wv(lv.warp, x_raw, window)
            warped = lv.warp.retract(w, v, x_raw[:, :3])
            hyper = K.fused_field(lv.hyper.mlp, lv.hyper.n_freq, x_raw)
            raw_t = F.pad(torch.cat([warped, hyper], dim=-1), (0, 1))
            want, want_raw_t = _launch_forward(lv, *args, want_raw_t=True,
                                               warp_scales=window)
            hold_level(raw_t, want_raw_t, f'{config}: trunk kernel + '
                       f'retraction + sheet kernel vs the level kernel '
                       f'R=512 S=64: raw_t', '[11]')
            hold_level(K.fused_template(lv, raw_t, args[4]), want,
                       f'{config}: + template kernel vs the level kernel: '
                       f'out', '[11]', SE3_LEVEL_ATOL)

            # Every row at w = 0 exactly: a zero w head. The retraction is
            # then points + v, and its backward d w = 0, d v = d pts = g.
            head = lv.warp.w_net.logit
            saved = (head.weight.clone(), head.bias.clone())
            head.weight.zero_()
            head.bias.zero_()
            out, raw_t = _launch_forward(lv, *args, want_raw_t=True)
            want_out, want_raw_t = plain_forward(lv, args)
            hold_level(out, want_out, f'{config} level with w = 0 vs plain: '
                       f'out', '[11]', SE3_LEVEL_ATOL)
            hold_level(raw_t, want_raw_t, f'{config} level with w = 0 vs '
                       f'plain: raw_t', '[11]')
            dx_t = F.pad(torch.randn(
                512 * 64, 7, generator=torch.Generator().manual_seed(9)),
                (0, 1)).cuda()
            d_z, d_o, d_d, d_e, f_grads = K.fused_fields_bwd(lv, *args[:4],
                                                             dx_t)
            torch.cuda.synchronize()
            check_grads(f'{config} fields backward (B) with w = 0 vs plain',
                        SE3_FIELDS_GRAD_NAMES, [d_z, d_o, d_d, d_e, *f_grads],
                        plain_fields_bwd(lv, args, dx_t), tag='[11]')
            dw_head = f_grads[14]
            if not torch.isfinite(dw_head).all() or dw_head.abs().max() != 0:
                raise AssertionError(f'{config}: d w must be 0 at w = 0, '
                                     f'got max {dw_head.abs().max():.3e}')
            phase(f'[11] {config} with w = 0: the w head\'s dW is exactly 0 '
                  f'and every gradient is finite')
            head.weight.copy_(saved[0])
            head.bias.copy_(saved[1])

    for k in kernels:
        if k['name'] == 'fused_level_fwd':
            k['max_abs_err'] = max(k['max_abs_err'], *errs['fwd'])
            for config in probes:
                k[f'{config}_ms'] = times[config, 'fwd', 128][0]
                k[f'{config}_plain_ms'] = times[config, 'fwd', 128][1]
        if k['name'] == 'fused_fields_bwd':
            worst = error_keys(errs['B'])
            for key in ('max_abs_err', 'rel_l2_err',
                        'max_err_over_largest_entry'):
                k[key] = max(k[key], worst[key])
            for config in probes:
                k[f'{config}_ms'] = times[config, 'B', 128][0]
                k[f'{config}_plain_ms'] = times[config, 'B', 128][1]
                k[f'{config}_ms_s64'] = times[config, 'B', 64][0]


def se3_paths_phase(kernels) -> None:
    """Phase 12: the SE(3) and quaternion models' paths at full width; fills
    in the launches of the trunk kernels' entries."""
    import torch
    from hypernerf_tpu_torch.flagship import H, W, flagship_model, spiral_rays
    from hypernerf_tpu_torch.training.renderer import ImageRenderer
    chunks_per_frame = -(-W * H // CHUNK)
    per_frame = 2 * chunks_per_frame
    frames = spiral_rays((0, 30))
    counts = {}
    for label, config, return_points, want in (
            ('se3', 'se3', False,
             {'fused_level_fwd': per_frame, 'fused_composite_fwd': per_frame}),
            ('quaternion', 'quaternion', False,
             {'fused_level_fwd': per_frame, 'fused_composite_fwd': per_frame}),
            ('se3 return_points', 'se3', True,
             {'fused_se3_fwd': per_frame, 'fused_field_fwd': per_frame,
              'fused_template_fwd': per_frame})):
        model = flagship_model('cuda', seed=0, config=config)
        keep = ('rgb', 'depth', 'acc') + (
            ('med_points',) if return_points else ())
        renderer = ImageRenderer(model, chunk=CHUNK, keep=keep,
                                 levels=('fine',), quantize=True)
        renderer(frames[0])  # warm-up frame: the first launches
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        fine = renderer(frames[1])['fine']
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_counts(want, f'{label} frame')
        shapes = {'rgb': (W * H, 3), 'depth': (W * H,), 'acc': (W * H,),
                  'med_points': (W * H, 1, 7)}
        for k in keep:
            v = torch.as_tensor(fine[k])
            if v.shape != shapes[k] or not torch.isfinite(v.float()).all():
                raise AssertionError(f'{label} frame: {k} {v.shape} not '
                                     f'finite / misshapen')
        if fine['rgb'].dtype.name != 'uint8':
            raise AssertionError(f'{label} frame: rgb {fine["rgb"].dtype}')
        phase(f'[12] {label}: rendered a {W}x{H} frame (64+64, chunk '
              f'{CHUNK}): {secs:.4f} s/frame; launches {launches} (= 2 '
              f'levels x {chunks_per_frame} chunks); no plain call')
        counts[label, 'frame'] = launches
        del renderer, model, fine
        torch.cuda.empty_cache()
    for config in ('se3', 'quaternion', 'se3_split_glo'):
        counts[config, 'train'] = train_path(config, '[12]')
        torch.cuda.empty_cache()

    # query_sigma: one sample per row, a million points of one frame id.
    model = flagship_model('cuda', seed=0, config='se3')
    n = 1 << 20
    gen = torch.Generator(device='cuda').manual_seed(3)
    pts = torch.randn(n, 3, generator=gen, device='cuda') * 0.5
    ids = torch.full((n, 1), 3, dtype=torch.int64, device='cuda')
    with torch.no_grad():
        model.query_sigma(pts[:4096], ids[:4096])
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        sigma = model.query_sigma(pts, ids)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts['se3', 'query_sigma'] = read_counts(
            {'fused_se3_fwd': 1, 'fused_field_fwd': 1,
             'fused_template_fwd': 1}, 'se3 query_sigma')
        with plain_versions():
            want = model.query_sigma(pts[:4099], ids[:4099])
    diff = (sigma[:4099] - want).abs()
    if sigma.shape != (n,) or not torch.isfinite(sigma).all() \
            or (sigma < 0).any() \
            or (diff > LEVEL_ATOL + LEVEL_RTOL * want.abs()).any():
        raise AssertionError(f'se3 query_sigma: shape {tuple(sigma.shape)}, '
                             f'max|d| {diff.max().item():.3e}')
    phase(f'[12] se3 query_sigma on {n} points: {secs * 1e3:.2f} ms; '
          f'launches {counts["se3", "query_sigma"]}; vs the plain versions '
          f'on 4099 points max|d| {diff.max().item():.3e} (tol '
          f'{LEVEL_ATOL}+{LEVEL_RTOL}|want|)')
    for k in kernels:
        name = k['name']
        for (label, path), launches in counts.items():
            if launches.get(name):
                k[f'{label.replace(" ", "_")}_{path}_launches'] = \
                    launches[name]
        if name in ('fused_se3_fwd', 'fused_se3_bwd'):
            k['launches'] = counts['se3_split_glo', 'train'][name]

# -- the warp Jacobians (the elastic loss) -----------------------------------

# The Jacobian kernels vs their plain versions and vs the stored JAX numbers:
# both round at the same points (bf16 activations and tangents; the
# translation backward's cotangent fp32, held as two bf16 halves by the
# kernel and rounded alike in the plain version); a last-bit fp32 difference
# moves a bf16 rounding, and the 2^9 band amplifies it (measured on an H100
# at 262,144 points: relative L2 up to 2.7e-3). A 1 % change of layer 5 moves
# J, the tangents and every dW by 3 to 5 % (the probe below). Allowed per
# output: relative L2 1e-2, max|d| 0.25 of the largest entry (GRAD_MAX).
JAC_L2 = 1e-2
# Points per call on the train step's path: 16 Jacobian samples per ray.
JAC_POINTS = TRAIN_RAYS * 16
JAC_CHUNK = 65536  # points per call of a plain version


def plain_jacobian(mlp, x_raw):
    """(P, 9) J of the plain version over chunks of points."""
    import torch
    from hypernerf_tpu_torch.kernels import fused_jacobian_plain
    return torch.cat([fused_jacobian_plain(mlp, 10, x_raw[a:a + JAC_CHUNK])
                      for a in range(0, x_raw.shape[0], JAC_CHUNK)])


def plain_jacobian_bwd(mlp, x_raw, g):
    """[dx_raw, 14 x dW/db] of the plain backward over chunks of points."""
    import torch
    from hypernerf_tpu_torch.kernels import fused_jacobian_bwd_plain
    parts = [fused_jacobian_bwd_plain(mlp, 10, x_raw[a:a + JAC_CHUNK],
                                      g[a:a + JAC_CHUNK])
             for a in range(0, x_raw.shape[0], JAC_CHUNK)]
    return [torch.cat([dx for dx, _ in parts])] + [
        sum(grads[i] for _, grads in parts) for i in range(len(parts[0][1]))]


def plain_tangents(field, x_raw, scales=None):
    """(P, 24) [w | v | dw | dv] of the plain version over chunks."""
    import torch
    from hypernerf_tpu_torch.kernels import fused_se3_jacobian_plain
    return torch.cat([fused_se3_jacobian_plain(field, x_raw[a:a + JAC_CHUNK],
                                               scales)
                      for a in range(0, x_raw.shape[0], JAC_CHUNK)])


def plain_tangents_bwd(field, x_raw, g, scales=None):
    """[dx_raw, 18 x dW/db] of the plain backward over chunks of points."""
    import torch
    from hypernerf_tpu_torch.kernels import fused_se3_jacobian_bwd_plain
    parts = [fused_se3_jacobian_bwd_plain(field, x_raw[a:a + JAC_CHUNK],
                                          g[a:a + JAC_CHUNK], scales)
             for a in range(0, x_raw.shape[0], JAC_CHUNK)]
    return [torch.cat([dx for dx, _ in parts])] + [
        sum(grads[i] for _, grads in parts) for i in range(len(parts[0][1]))]


def tangents_of(field, x_raw, scales=None):
    """(P, 24) [w | v | dw | dv] of the kernel."""
    import torch
    from hypernerf_tpu_torch.kernels import fused_se3_wv_tangents
    return torch.cat([t.reshape(x_raw.shape[0], -1)
                      for t in fused_se3_wv_tangents(field, x_raw, scales)],
                     dim=-1)


def jacobian_phase(kind: str):
    """Phase 13 (``kind`` 'translation': kernels 14 and 15) or 14 ('se3':
    kernels 16 and 17, with and without a window row): against the JAX
    kernels' stored numbers, the 1 % probe of layer 5, the plain versions at
    a ragged size and at the train step's 262,144 points (timed). Returns
    the two kernels' entries."""
    import torch
    from hypernerf_tpu_torch import kernels as K
    from hypernerf_tpu_torch.flagship import (JACOBIAN_CASES, flagship_model,
                                              load_probe_weights,
                                              read_jacobian_reference)
    from hypernerf_tpu_torch.kernels import common
    from hypernerf_tpu_torch.kernels.fused_field import field_layers
    from hypernerf_tpu_torch.kernels.fused_se3 import (se3_encoding_scales,
                                                       se3_layers)
    tag = '[13]' if kind == 'translation' else '[14]'
    trans = kind == 'translation'
    probe = load_probe_weights(flagship_model(
        'cuda', config='elastic' if trans else 'elastic_se3'))
    field = probe.warp_field
    if trans:
        mlp = field.mlp
        layers, width, hidden5 = field_layers(mlp), 9, mlp.hidden(5)
        fwd = lambda x, sc=None: K.fused_warp_jacobian(
            mlp, 10, x[:, :3], x[:, 3:]).reshape(-1, 9)
        bwd = lambda x, g, sc=None: K.fused_jacobian_bwd(mlp, 10, x, g)
        plain = lambda x, sc=None: plain_jacobian(mlp, x)
        plain_bwd = lambda x, g, sc=None: plain_jacobian_bwd(mlp, x, g)
        windows = (None,)
    else:
        layers, width, hidden5 = se3_layers(field), 24, field.trunk.hidden(5)
        fwd = lambda x, sc=None: tangents_of(field, x, sc)
        bwd = lambda x, g, sc=None: K.fused_se3_jacobian_bwd(field, x, g, sc)
        plain = lambda x, sc=None: plain_tangents(field, x, sc)
        plain_bwd = lambda x, g, sc=None: plain_tangents_bwd(field, x, g, sc)
        windows = (None, se3_encoding_scales(field, WINDOW_ALPHA, 'cuda'))
    out_name = 'J' if trans else 'w | v | dw | dv'
    grad_names = ['dx'] + [f'd{"Wb"[i % 2]}{i // 2}'
                           for i in range(2 * len(layers))]
    params = common.layer_params(layers)

    # The JAX kernels' stored outputs and gradients, through the autograd
    # Function as training runs them.
    ref = read_jacobian_reference()
    for case, (_, _, alpha, _) in JACOBIAN_CASES.items():
        if (case == 'translation') != trans:
            continue
        arrays = {k: torch.from_numpy(v).cuda() for k, v in ref[case].items()}
        x = arrays['x_raw'].requires_grad_()
        scales = None if alpha is None else se3_encoding_scales(field, alpha,
                                                                'cuda')
        out = fwd(x, scales)
        check_grads(f'{case} forward vs the stored JAX output', [out_name],
                    [out.detach()], [arrays['out']], JAC_L2, tag=tag)
        got = torch.autograd.grad(out, [x] + params, arrays['cotangent'])
        check_grads(f'{case} backward vs the stored JAX gradients',
                    grad_names, got, [arrays[n.lower()] for n in grad_names],
                    JAC_L2, tag=tag)

    errs = {'fwd': [], 'bwd': []}
    gen = torch.Generator().manual_seed(13)
    with torch.no_grad():
        # The 1 % probe: a 1 % change of layer 5 must move the plain outputs
        # and every plain dW by more than the checks allow.
        x = field_rows(8192, seed=13)
        g = torch.randn(8192, width, generator=gen).cuda()
        base_out, base = plain(x), plain_bwd(x, g)
        hidden5.weight.mul_(1.01)
        moved_out, moved = plain(x), plain_bwd(x, g)
        hidden5.weight.div_(1.01)
        l2_out = grad_errors(moved_out, base_out)[0]
        l2 = [grad_errors(a, b)[0] for a, b in zip(moved[1::2], base[1::2])]
        size = ((base_out.reshape(-1, 3, 3) - torch.eye(3, device='cuda'))
                .abs().mean().item() if trans else
                base_out[:, :3].norm(dim=-1).mean().item())
        phase(f'{tag} probe: {"mean |J - I|" if trans else "mean |w|"} '
              f'{size:.3f}; 1% on layer 5 moves {out_name} by relative L2 '
              f'{l2_out:.3e} and the {len(l2)} dW by {min(l2):.3e}..'
              f'{max(l2):.3e} (the checks allow {JAC_L2})')
        if not (l2_out > JAC_L2 and min(l2) > JAC_L2):
            raise AssertionError(f'the {kind} Jacobian checks cannot see '
                                 f'layer 5')

        times = {}
        # 1001 points: a multiple of neither tile (16 and 8 points).
        for p in (1001, JAC_POINTS):
            for scales in windows if p == 1001 else (None,):
                label = (f'{kind} P={p} window='
                         f'{"off" if scales is None else "on"}')
                x = field_rows(p, seed=p % 97)
                g = torch.randn(p, width, generator=gen).cuda()
                errs['fwd'].append(check_grads(
                    f'{label} forward vs plain', [out_name], [fwd(x, scales)],
                    [plain(x, scales)], JAC_L2, tag=tag))
                dx, grads = bwd(x, g, scales)
                torch.cuda.synchronize()
                errs['bwd'].append(check_grads(
                    f'{label} backward vs plain', grad_names, [dx, *grads],
                    plain_bwd(x, g, scales), JAC_L2, tag=tag))
            if p == JAC_POINTS:
                times = dict(fwd=cuda_ms(lambda: fwd(x)),
                             plain_fwd=cuda_ms(lambda: plain(x), 2),
                             bwd=cuda_ms(lambda: bwd(x, g), 3),
                             plain_bwd=cuda_ms(lambda: plain_bwd(x, g), 1))
                phase(f'{tag} {kind} Jacobian P={p}: forward '
                      f'{times["fwd"]:.3f} ms (plain {times["plain_fwd"]:.2f}'
                      f' ms), backward {times["bwd"]:.3f} ms (plain '
                      f'{times["plain_bwd"]:.1f} ms); plain versions in '
                      f'chunks of {JAC_CHUNK} points')
        del x, g, dx, grads
        torch.cuda.empty_cache()

    # Bounds at the train step's points: one multiply-add per weight, point
    # and row block (four) forward; the backward recomputes the four blocks
    # and runs g W and t^T g on the tangent blocks (translation: three) or on
    # all four (SE(3)). Bytes: the raw rows, the outputs, the cotangent and
    # dx once, the weights (and dW) once.
    macs = sum(lin.weight.numel() for lin, _ in layers)
    p = JAC_POINTS
    back_blocks = 4 + 2 * (3 if trans else 4)
    f_ms, f_by = bound(2.0 * 4 * macs * p, p * (44 + 4 * width) + 2 * macs)
    b_ms, b_by = bound(2.0 * back_blocks * macs * p,
                       p * (44 + 4 * width + 44) + 6 * macs)
    src = 'hypernerf_tpu_torch/kernels/csrc/'
    stem = 'fused_jacobian' if trans else 'fused_se3_jacobian'
    fwd_line, bwd_line = (269, 302) if trans else (286, 331)
    pallas = f'hypernerf_tpu/ops/pallas/{stem}.py'
    return [
        dict(name=f'{stem}_fwd', route='cuda', source=f'{src}{stem}.cu',
             replaces=f'{pallas}:{fwd_line}',
             **error_keys(errs['fwd'], JAC_L2), ms=times['fwd'],
             plain_ms=times['plain_fwd'], bound_ms=f_ms, bound_by=f_by,
             library_ms=None, shape=f'P={p}', macs_per_row=macs),
        dict(name=f'{stem}_bwd', route='cuda', source=f'{src}{stem}_bwd.cu',
             replaces=f'{pallas}:{bwd_line}',
             **error_keys(errs['bwd'], JAC_L2),
             ms=times['bwd'], plain_ms=times['plain_bwd'], bound_ms=b_ms,
             bound_by=b_by, library_ms=None, shape=f'P={p}')]


def retraction_phase() -> None:
    """Phase 15: kernel 16 chained with the retraction's point-Jacobian
    (tensor code, float64 inside) for the SE(3) and the quaternion warp,
    against the plain chain and against the JAX side channel's stored J;
    then models whose w head is zero, so that every row has w = 0 exactly:
    J = I + dv, every gradient finite, the w head's exactly 0."""
    import torch
    from hypernerf_tpu_torch import kernels as K
    from hypernerf_tpu_torch.flagship import (JACOBIAN_CASES, flagship_model,
                                              load_probe_weights,
                                              read_jacobian_reference)
    from hypernerf_tpu_torch.kernels import common
    from hypernerf_tpu_torch.kernels.fused_se3 import (se3_encoding_scales,
                                                       se3_layers)
    from hypernerf_tpu_torch.ops import quaternion, rigid_body

    def split(out):
        p = out.shape[0]
        return (out[:, :3], out[:, 3:6], out[:, 6:15].reshape(p, 3, 3),
                out[:, 15:].reshape(p, 3, 3))

    field = load_probe_weights(flagship_model(
        'cuda', config='elastic_se3')).warp_field
    ref = read_jacobian_reference()
    with torch.no_grad():
        for case in ('se3', 'se3_window'):
            arrays = {k: torch.from_numpy(v).cuda()
                      for k, v in ref[case].items()}
            alpha = JACOBIAN_CASES[case][2]
            scales = None if alpha is None else se3_encoding_scales(
                field, alpha, 'cuda')
            x = arrays['x_raw']
            got = split(tangents_of(field, x, scales))
            want = split(plain_tangents(field, x, scales))
            for kind, bwd in (('se3', rigid_body.se3_warp_vec_bwd),
                              ('quaternion', quaternion.quat_warp_vec_bwd)):
                jac = rigid_body.retraction_jacobian(
                    bwd, got[0], got[1], x[:, :3], got[2], got[3])
                plain = rigid_body.retraction_jacobian(
                    bwd, want[0], want[1], x[:, :3], want[2], want[3])
                check_grads(f'{case}: kernel 16 + the {kind} retraction\'s '
                            f'Jacobian vs the plain chain and vs the stored '
                            f'JAX J', ['J', 'J (JAX)'],
                            [jac.reshape(-1, 9)] * 2,
                            [plain.reshape(-1, 9), arrays[f'jac_{kind}']],
                            JAC_L2, tag='[15]')

    for config in ('elastic_se3', 'elastic_quaternion'):
        field = load_probe_weights(flagship_model('cuda',
                                                  config=config)).warp_field
        head = field.w_net.logit
        with torch.no_grad():
            head.weight.zero_()
            head.bias.zero_()
        x = field_rows(4099, seed=15)
        layers = se3_layers(field)
        jac = field.jacobian(x[:, :3], x[:, 3:])
        grads = torch.autograd.grad(jac.square().sum(),
                                    common.layer_params(layers))
        with torch.no_grad():
            dv = K.fused_se3_wv_tangents(field, x)[3]
        exact = torch.equal(jac, torch.eye(3, device='cuda') + dv)
        finite = all(torch.isfinite(g).all() for g in grads)
        zero = not grads[-4].any() and not grads[-3].any()
        phase(f'[15] {config} with w = 0: J = I + dv exactly: {exact}; '
              f'{len(grads)} gradients finite: {finite}; the w head\'s dW '
              f'and db exactly 0: {zero}')
        if not (exact and finite and zero):
            raise AssertionError(f'{config}: the retraction Jacobian at '
                                 f'w = 0')


def elastic_paths_phase(kernels) -> None:
    """Phases 16 to 18: the three elastic configurations' train steps at
    full width; one step of ``split_glo`` with the elastic loss (the
    per-module branch, J at every sample) on 1024 rays, kernels vs plain
    versions; one ``elastic`` step with the background loss. Fills in the
    launches of the Jacobian kernels' entries."""
    import torch
    from hypernerf_tpu_torch.flagship import (flagship_train_setup,
                                              synthetic_background_points)
    from hypernerf_tpu_torch.training.losses import background_loss
    counts = {}
    for config in ('elastic', 'elastic_se3', 'elastic_quaternion'):
        counts[config] = train_path(config, '[16]')
        torch.cuda.empty_cache()

    state, _, all_rays, all_rgbs = flagship_train_setup(
        'cuda', config='split_glo', train_overrides=dict(
            elastic_loss_weight=0.01))
    want = {'fused_field_fwd': 4, 'fused_field_bwd': 4,
            'fused_template_fwd': 2, 'fused_template_bwd': 2,
            'fused_jacobian_fwd': 2, 'fused_jacobian_bwd': 2}
    launches = compare_step(state.model, all_rays, all_rgbs, '[17] split_glo '
                            '+ elastic:', 0.01)
    phase(f'[17] split_glo + elastic: launches of the kernels\' step '
          f'{launches}')
    if launches != want:
        raise AssertionError(f'split_glo + elastic launches {launches}, '
                             f'want {want}')
    del state
    torch.cuda.empty_cache()

    n_bg = 1024
    state, step_fn, all_rays, all_rgbs = flagship_train_setup(
        'cuda', config='elastic', train_overrides=dict(
            background_loss_weight=1.0, background_points_per_step=n_bg))
    model = state.model
    for _ in range(WARMUP_STEPS):
        step_fn(state, all_rays, all_rgbs)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        metrics = step_fn(state, all_rays, all_rgbs)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / TRAIN_STEPS
    want = {k: v * TRAIN_STEPS for k, v in {
        **STEP_LAUNCHES['elastic'], 'fused_field_fwd': 1,
        'fused_field_bwd': 1}.items()}
    counts['background'] = read_counts(want, 'elastic + background step')
    pts = torch.from_numpy(synthetic_background_points()[:n_bg]).cuda()
    ids = torch.arange(n_bg, device='cuda')[:, None] % 100
    with torch.no_grad():
        term = background_loss(model.apply_warp(pts, ids), pts).mean()
    warp_grads = [p.grad for p in model.warp_field.parameters()]
    if not (math.isfinite(metrics['loss'].item()) and term.item() > 0
            and all(g is not None and torch.isfinite(g).all()
                    and g.abs().sum() > 0 for g in warp_grads)):
        raise AssertionError(f'elastic + background step: loss '
                             f'{metrics["loss"].item()}, term {term.item()}')
    phase(f'[18] elastic + background (weight 1.0, {n_bg} of '
          f'{1 << 16} static points per step): {secs * 1e3:.1f} ms/step '
          f'over {TRAIN_STEPS} steps after {WARMUP_STEPS}; '
          f'loss {metrics["loss"].item():.5f}; background term on {n_bg} '
          f'points {term.item():.4e}; launches '
          + ', '.join(f'{k} {v // TRAIN_STEPS}'
                      for k, v in counts['background'].items())
          + ' per step; no plain call; the warp field\'s gradients finite and '
          'non-zero')
    del state, model
    torch.cuda.empty_cache()

    for k in kernels:
        name = k['name']
        for path, launches in counts.items():
            if launches.get(name):
                k[f'{path}_train_launches'] = launches[name]
        if name.startswith('fused_jacobian'):
            k['launches'] = counts['elastic'][name]
        elif name.startswith('fused_se3_jacobian'):
            k['launches'] = counts['elastic_se3'][name]


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
    phase(f'[2] level forward (consumers raise their registers to 232 with '
          f'setmaxnreg): '
          f'{ptxas_lines(build.build_log(), LEVEL_FWD_SOURCES)}')
    phase(f'[2] fields backward, kernel B (the same): '
          f'{ptxas_lines(build.build_log(), FIELDS_BWD_SOURCES)}')

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = flagship_model('cuda', seed=0)
    kernels = []

    def check_level(level, args, want=None, against='plain'):
        got = fused_level(level, *args)
        if want is None:
            want = fused_level_plain(level, *args)
        r, s = args[0].shape
        return hold_level(got, want, f'level vs {against} R={r} S={s}')

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
        b_ms, b_by = level_bound(level[128], CHUNK, 128)
        kernels.append(dict(
            name='fused_level_fwd', route='cuda',
            source=', '.join('hypernerf_tpu_torch/kernels/csrc/' + f
                             for f in LEVEL_FWD_SOURCES),
            replaces='hypernerf_tpu/ops/pallas/fused_level.py:1322',
            max_abs_err=max(errs), ms=times[128][0],
            plain_ms=times[128][1], bound_ms=b_ms, bound_by=b_by,
            library_ms=None, ms_s64=times[64][0]))
        del probe, level, args
        level_forward_times(kernels)

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
        # Bound at R = CHUNK, S = 64, N = 64: no matrix product; bytes are
        # packed, z, directions, u in and outs, weights, z_union out.
        b_ms, b_by = bound(0.0, CHUNK * (64 * (16 + 4) + 12 + 4 * 64
                                         + 24 + 4 * 64 + 4 * 128))
        kernels.append(dict(
            name='fused_composite_fwd', route='cuda',
            source='hypernerf_tpu_torch/kernels/csrc/fused_composite.cu',
            replaces='hypernerf_tpu/ops/pallas/fused_composite.py:437',
            max_abs_err=max(errs), ms=ctimes[64][0],
            plain_ms=ctimes[64][1], bound_ms=b_ms, bound_by=b_by,
            library_ms=None))

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
        # Render launches; the train step's are added in phase 7.
        for k in kernels:
            k['launches'] = (launches[0] if k['name'] == 'fused_level_fwd'
                             else launches[1])

        with plain_versions():
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
        with plain_versions():
            renderer(frames[1])
            torch.cuda.synchronize()
        plain_secs = time.perf_counter() - t0
        phase(f'[5] plain versions: {plain_secs:.4f} s/frame (1 frame)')

    kernels += backward_phase(kernels)
    train_phase(kernels)
    kernels += modular_kernel_phase()
    modular_paths_phase(kernels)
    kernels += se3_kernel_phase()
    se3_level_phase(kernels)
    se3_paths_phase(kernels)
    kernels += jacobian_phase('translation')
    kernels += jacobian_phase('se3')
    retraction_phase()
    elastic_paths_phase(kernels)
    if len(kernels) != 14:
        raise AssertionError(f'{len(kernels)} kernels in the line, want 14')
    return finish(kernels)


def finish(kernels) -> int:
    """Phase 19: the kernels' line and the result line."""
    import torch
    for k in kernels:
        missing = {'name', 'route', 'source', 'replaces', 'launches',
                   'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
                   'library_ms'} - set(k)
        if missing or not k['launches'] > 0:
            raise AssertionError(f'kernel line incomplete: {k["name"]} '
                                 f'{missing} launches {k.get("launches")}')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
