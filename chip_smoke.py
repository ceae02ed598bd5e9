#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: ``python3 chip_smoke.py`` (one card).

Phases, one line each; any failure ends the run with a non-zero exit:
  1. a CUDA card (else exit 1); its name and power limit from nvidia-smi;
  2. build the kernels from kernels/csrc with nvcc (sm_90a), with the time
     and ptxas's registers and spills (the level forward's, kernel B's, the
     per-module forwards', a field alone backward's, the SE(3) trunk's
     two backwards', the Jacobians' forwards', the plane
     configuration's three kernels and the B.4 combinations' sources on
     lines of their own);
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
     (8192 rays, S = 64 N = 64 and S = 128 N = 0), which are also timed
     (the kernel alone through its C entry point, and through the
     wrapper, whose host work now takes longer than the kernel);
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
     the stash it allocated, its peak allocation and its host time,
     kernel B with its share of the bound, and the compositing backward (a
     warp per ray; also at S = 40, a ragged last chunk) through its C entry
     point beside its time before the redesign, with its share of the bound;
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
  8. the kernels of the per-module path (the forwards are the level
     forward's stages run alone on its block, a field's backward kernel B's
     block run on the field alone: each one's compiled plan against its
     model in kernels/fused_level.py; a field alone, forward and backward,
     as the warp field and as the hyper sheet, with and without a window
     row; the template alone, forward, with 128, 64, 13 and 1 rows per
     condition row, with and without hyper coordinates, up to the train
     step's 16384 rays at both levels; the template backward on a template
     without them, at both levels of the train step, and at 1 row per
     condition row): against the
     JAX kernels' stored outputs and gradients at the probe weights
     (tests/data), against their plain versions at small odd sizes and at
     8192 x 128 and 16384 x 128 rows, which are also timed (each forward
     and each field backward with its share of the bound and its time
     before the redesign), and
     against the level kernels (warp field, sheet and template kernels
     chained give the level kernel's output bit for bit; the field backward
     twice on the template backward's dx_t gives the fields backward's
     gradients);
  9. the per-module path at full width: ``static`` (a plain NeRF) renders a
     504x378 frame and trains at batch 16384; ``split_glo`` (two GLO tables)
     renders a frame with ``return_points``, trains at batch 16384 and
     answers ``query_sigma`` on 1 << 20 points; the launch counters must show
     the per-module kernels on every chunk, level and step (3 timed frames
     after a warm-up, as phase 5; per step: static
     2 template forwards and 2 template backwards; split_glo also 4 field
     forwards and 4 field backwards) and no level kernel and no plain call;
     every parameter gets a finite non-zero gradient; the fixed-batch loss
     falls; one small step with the kernels against one with the plain
     versions;
 10. the SE(3) trunk's kernels (forward and backward) at the probe weights of
     the ``se3`` configuration, whose w and v heads are drawn large enough
     that the rotation shows (the forward is the level forward's trunk stage
     run alone on its block, the backward kernel B's block run on the trunk
     alone: each one's compiled plan against its model in
     kernels/fused_level.py): against the JAX kernels' stored outputs and
     gradients (tests/data), with the 1 % probe of one layer, against their
     plain versions at a ragged size (a multiple of neither tile height) and
     at 8192 x 128 and 16384 x 128 rows, with and without a window row
     (alpha 3.5 of 8 bands), which are also timed (each beside its time
     before the redesign and its share of the bound);
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
     ``return_points`` and one of ``se3`` with two GLO tables (per-module:
     trunk, sheet and template kernels; 3 timed frames each after a
     warm-up, as phase 5), a
     train step at batch 16384 of ``se3`` and ``quaternion`` (level kernels)
     and of each with two GLO tables (trunk, field and template kernels,
     forward and backward), each with launch counters, no plain call and one
     kernels-vs-plain step on 1024 rays; ``query_sigma`` of ``se3`` on
     1 << 20 points;
 13. the translation warp's Jacobian kernels (forward and backward) at probe
     weights whose warp head moves J well away from I: against the JAX
     kernels' stored outputs and gradients (tests/data), with the 1 % probe
     of warp layer 5, against their plain versions at 1001 points and at the
     train step's 262,144 (16384 rays x 16 samples), which are also timed;
     the forward is the level forward's block run on the warp field with
     its tangent streams (16 points x 4 streams a tile), the backward
     kernel B's block on the same streams, its cotangent in two bf16
     halves: each one's compiled plan against its model, its time beside
     its time before the redesign and its share of the bound;
 14. the SE(3) trunk's tangent kernels (forward and backward), the same way,
     with and without a window row (alpha 3.5 of 8 bands), on the same two
     blocks run on the trunk with its tangent streams;
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
 19. the ``anneal`` configuration (the Nerfies template encoding, windowed
     by the annealing alphas): the level forward, the template alone and
     kernel A at that layout at its probe weights and the alphas of step
     3750 (hyper_alpha 1.5) against the JAX kernels' stored outputs and
     gradients (tests/data; kernel B chained) and against their plain
     versions up to the render's and the train step's shapes, each timed
     beside the flagship layout's in turns; then three 504x378 frames
     through the level kernels (fully annealed, as ``eval`` renders a weight
     file) with launch counters, 1024 rays against the plain versions, and
     one frame with ``return_points`` (the per-module kernels);
 20. the ``anneal`` train step at batch 16384 from step 3750 as phase 7
     runs it (2 launches of each of the five kernels per step, no plain
     call, a 1024-ray step against the plain versions);
 21. the ``plane`` configuration (axis_aligned_plane: no sheet, the GLO
     embedding as the hyper coordinates, a 167-column template encoding in
     192): the compiled plans of its level forward, template alone and
     kernel B against their models; rows 1, 8, 9 (kernel A) and 5 (kernel
     B) at its probe weights against the JAX kernels' stored outputs and
     gradients (tests/data, two draws of the level's inputs, the backward
     twice each) and against their plain versions up to the render's and
     the train step's shapes, each timed beside the flagship layout's
     kernel in turns; then three 504x378 frames through the level kernels
     (and the flagship's in the same call), 1024 rays against the plain
     versions, one frame with ``return_points`` (the warp field alone and
     the template alone) and ``query_sigma``;
 22. the ``plane`` train step at batch 16384 as phase 7 runs it (2
     launches of each of the five kernels per step, no plain call, a
     1024-ray step against the plain versions), and with two GLO tables
     (``share_glo=False``: the warp field and the template alone at the
     plane layout, forward and backward, module by module);
 23. the ``occupancy`` configuration (``bench.py --mode occupancy`` /
     ``render_occupancy``: the flagship at 32 + 32 samples with the G = 64
     occupancy grid): the level forward at R = 8192, S = 32 and 64 and the
     compositing forward at S = 32 with N = 0 (render and, with noise,
     training) against their plain versions; kernels A, B and C at the train
     step's R = 16384, S = 32 and 64 against theirs (the S = 32 shapes
     timed); one grid refresh (4 ids x 262,144 jittered cell points through
     ``query_sigma``) against the same refresh through the plain versions,
     timed; three 504x378 frames through ``flagship.bench_grid`` (2 launches
     of each forward kernel per chunk) and the flagship's in the same call,
     1024 rays against the plain versions; the train step at batch 16384
     with a refresh inside the timed window as ``bench.py`` runs it (every
     16 steps from the first), its time without the refresh and amortised
     over 16 steps, a 1024-ray step through the grid against the plain
     versions;
 24. the kernels' JSON line, then the result line (after phase 38);
 25. the trainer and its entry point: ``tools/make_synthetic_scene.py``
     writes an 8-frame 160x120 scene into a temporary directory (never the
     repo), where ``hypernerf_tpu_torch.train.main(argv)`` trains the
     flagship (64 + 64, bf16, Adam with steplr) for N = 36 steps at batch
     4096 (a sanity val, a val every 8 steps, a checkpoint at the epoch's
     32 and at 36); the launch counters must show 2 launches of each of the
     five step kernels a step, the two forward kernels on every chunk and
     level of each val, and no plain call; one val timed apart; a second
     call with ``--ckpt_path`` on step 36 resumes there and trains to 72
     (the manifest and ``latest_checkpoint`` at 72); ``python -m
     hypernerf_tpu_torch.eval`` renders that checkpoint's training poses
     and prints ``Mean PSNR``; the same 36 steps through the plain versions
     from the same weights and draws: the training frames' mean PSNR at
     step 36 within 1.0 dB of the kernels' (an untrained model must lie
     further off) and the val PSNR at step 32 within 0.5 dB; the kernels
     again, whose spread is printed; steps per second of each, with the
     card's name and power limit;
 26. the ``use_nerf_embed`` conditions (``nerf_embed``: the GLO embedding
     as the alpha condition and after the view directions in the rgb
     condition, 8 and 47 columns): rows 1, 8 and 9 with both conditions
     against the JAX kernels' stored outputs and gradients (tests/data,
     d alpha_cond too) and, for each new condition width (47, 8 and 0 in
     the flagship's layout, 35 in the Nerfies one), against their plain
     versions at 37 x 13 rays and at the render's and the train step's
     shapes, timed in turns with the flagship's kernels; then three
     504x378 ``nerf_embed`` frames (and the flagship's in the same call),
     1024 rays against the plain versions, a ``return_points`` frame and
     ``query_sigma``;
 27. the ``nerf_embed`` train step at batch 16384 as phase 7 runs it; one
     frame and one step each of ``use_viewdirs=False`` (a zero-width rgb
     condition), the static model with its own nerf table and ``anneal``
     with the embedding; ``train.main`` with ``--use_nerf_embedding
     --use_alpha_condition --use_rgb_condition`` for 8 steps on phase 25's
     scene, against the same steps through the plain versions (val PSNR
     within 0.5 dB);
 28. the warp x slicing x encoding combinations (ROADMAP B.4: the SE(3)
     and quaternion warps with the Nerfies encoding and with plane slicing,
     plane with the Nerfies encoding; seven configurations): the compiled
     plans of their new tables and of the Nerfies plane template alone
     against their models; rows 1, 5, 8 and 9 of every new instantiation
     against the JAX kernels' stored numbers (tests/data/fused_b4_jax_ref
     .npz, both window rows in one call where the level has both) and
     against their plain versions at 37 x 13 rays and at the render's and
     the train step's shapes, each timed beside its counterpart's kernel in
     turns at R = 8192 and 16384, S = 128, with its share of the bound;
 29. their paths: three 504x378 frames and the train step at batch 16384
     of the paper's two models (``anneal_se3``, ``plane_anneal_se3``) beside
     the flagship's, a ``return_points`` frame and ``query_sigma`` of
     ``plane_anneal_se3``, and a 1024-ray step of each of the other five
     against the plain versions;
 30. data-parallel training (ROADMAP A.12, ``parallel/``): (a) a world of
     every card over NCCL (one rank, in this process, on a one-card
     machine): the flagship step at batch 16384 through the data-parallel
     step with ZeRO-1 off and on, 5 steps after 2 in turns with the
     single-process step, the launch counters showing 2 launches of each of
     the five step kernels a step on the rank and no plain call, the
     gradient bytes all-reduced and the optimizer state bytes held, and one
     1024-ray explicit-batch step held to the single process; (b) two ranks
     as processes of their own (NCCL over two cards where there are two,
     else gloo with both on cuda:0, whose times are no speed figure): the
     split batch against one process, three ZeRO-1 steps after which every
     parameter's version has moved at each step, the ranks' parameters are
     equal bit for bit and each rank's cached level blobs equal a fresh
     pack, and a 504x378 frame over the two ranks against the one-rank
     frame; (c) ``train.main`` with ``--num_devices 1
     --shard_optimizer_state`` for 8 steps on a 3-frame 80x60 scene, its
     checkpoint resumed in one process (launches counted);
 31. the model call's options (ROADMAP A.4): a 504x378 frame with ``near``
     / ``far`` overrides and ``use_sample_at_infinity=False`` through the
     level kernels against the plain versions (the options must move the
     frame), and a frame with ``metadata_encoded`` equal to the ids' frame.
 32. the train CLI's default 64 + 128 samples and the bench entry point
     (ROADMAP A.6): (a) rows 1, 9 and 5 at the fine level's S = 192 (R =
     16384), row 2 with a fine draw of N = 128 from S = 64 and row 7 at S =
     192, each against its plain version and timed with its share of the
     bound; the 64 + 128 step on 1024 rays against the plain versions and
     at batch 16384 (launches, ms/step, peak memory); a 1024-ray render
     against the plain versions; (b) ``hypernerf_tpu_torch.bench.main`` in
     this process for each of its twelve modes and ``--n_fine 128`` in
     ``flagship`` and ``render``: each JSON line printed with its mode, the
     value finite and positive, the mode's kernels launched and no plain
     version called.
 33. ``--precision 32`` (ROADMAP A.13.1, the flagship table), TF32 off: (b)
     the float32 kernels of rows 1, 9 and 5 against their float32 plain
     versions (row 1 at R = 8192, S = 128 and R = 16384, S = 128 and 192;
     rows 9 and 5 at R = 16384, S = 128 and 192), each beside the bf16
     kernel's error against the same float32 plain, timed with their share
     of the float32-exact bound and of the FFMA ceiling; (c) against the JAX
     level kernel's stored float32 numbers (tests/data/fused_f32_jax_ref
     .npz); (d) rows 2 and 7 on the float32 level's outputs; (e) the CLI's
     64 + 128 step in float32 at batch 16384 through ``make_train_step``
     (every kernel counted, no plain call; 1024 rays against the plain
     versions: loss 1e-5 relative, gradients relative L2 1e-2); (f) a
     504x378 float32 frame; (h) ``train.main`` with ``--precision 32`` as
     phase 25 runs bf16, ``eval --precision 32`` of its checkpoint and the
     plain trainer in float32: the training frames' and the val PSNR at
     step 36 beside phase 25's bf16 pair;
 34. the per-module path at ``--precision 32`` (ROADMAP A.13.1 sub-item 1),
     TF32 off: (a) the float32 template alone (row 8: R = 8192, S = 128;
     1 << 20 rows at S = 1; static at R = 8192, S = 64), each field alone
     (row 10, 8192 x 128 rows), each field alone backward (row 11, 16384 x
     128 rows) and kernel A at the static width (R = 16384, S = 64) against
     their float32 plain versions, timed with their share of the
     float32-exact bound and of the FFMA ceiling; (b) against the JAX
     kernels' stored float32 numbers (tests/data/fused_f32_modular_jax_ref
     .npz); (c) with their launches counted and no plain call: a float32
     ``static`` frame and train step, a ``split_glo`` train step, a
     flagship frame with ``return_points``, 1024 rays with a
     ``hyper_point`` override, ``query_sigma``, an ``occupancy`` frame
     (row 1 in float32) and train step with the refresh (rows 8 and 10)
     inside the window; (d) ``train.main --precision 32`` with
     ``--share_GLO False`` and with ``--use_occupancy_grid True``; (e)
     a float32 band flag of A.13.2 (``xyz_freq`` 8) refused on the card
     naming ROADMAP A.13 (no plain fallback);
 35. the screw warps at ``--precision 32`` (ROADMAP A.13.1 sub-item 2),
     TF32 off: (a) the float32 level forward with the SE(3) warp and the
     window row (R = 16384, S = 128) and the quaternion warp (R = 8192, S =
     64), kernel B with the trunk (R = 16384, S = 128 with the window row;
     quaternion S = 192), the SE(3) trunk alone (8192 and 16384 x 128 rows)
     and its backward (16384 x 128) against their float32 plain versions,
     timed with their share of both ceilings; (b) against the JAX kernels'
     stored float32 numbers (tests/data/fused_f32_screw_jax_ref.npz); (c)
     with their launches counted and no plain call: ``se3`` and
     ``quaternion`` frames, their 64 + 128 train steps, a windowed ``se3``
     step on 1024 rays against the plain versions, an ``se3`` train step
     with two GLO tables, an ``se3`` frame with ``return_points``,
     ``query_sigma``; (d) ``train.main --precision 32 --warp_field se3``
     and ``eval --precision 32`` of its checkpoint;
 36. the sheet tables' Nerfies layout, window rows and conditions at
     ``--precision 32`` (ROADMAP A.13.1 sub-item 3, first half), TF32 off:
     (a) the float32 level forward and kernel A with the Nerfies layout and
     its window row (``anneal`` at R = 16384, ``anneal_se3`` at R = 8192,
     S = 128) and with the conditions 47 + 8, 8 + 8 and 0 (R = 8192), the
     template alone in the Nerfies layout and with 47 + 8 (R = 8192, S =
     128) against their float32 plain versions, the Nerfies ones timed in
     turns with the flagship table's; the window probe (hyper_alpha 1.5
     -> 2.5 moves row 1); against the JAX kernels' stored float32 numbers
     (tests/data/fused_f32_nerfies_jax_ref.npz); (b) a field alone and its
     backward with a window row against plain, timed in turns with the
     same rows without; (c) with their launches counted and no plain call:
     an ``anneal_se3`` frame and 64 + 128 train step, a ``nerf_embed``
     step, ``query_sigma`` on ``anneal_se3``, ``train.main --precision 32
     --use_nerfies_embed --warp_field se3`` and ``eval``; (d) a float32
     band flag of A.13.2 (``hyper_freq`` 4) refused on the card, naming
     ROADMAP A.13;
 37. the plane tables at ``--precision 32`` (ROADMAP A.13.1 sub-item 3,
     second half), TF32 off: (a) the float32 level forward at every plane
     table code (3 to 8: ``plane``, ``plane_se3``, ``plane_quaternion``,
     ``plane_anneal``, ``plane_anneal_se3``, ``plane_anneal_quaternion``)
     at R = 16384, S = 128 and at codes 3 and 6 at S = 192, kernel A at
     codes 3 and 6 (S = 128 and 192), kernel B at codes 3 and 6 (S = 128)
     and the template alone in both plane layouts (R = 8192, S = 128)
     against their float32 plain versions (relative L2 1e-4, max|d| 1e-3
     of the largest entry, per output), each timed in turns with the
     flagship table's kernel on inputs of the same shape; against the JAX
     kernels' stored float32 numbers (tests/data/fused_f32_plane_jax_ref
     .npz: row 1 at every code, the levels' gradients at codes 3 and 6,
     the template alone in both layouts); (b) with their launches counted
     and no plain call: 504x378 frames of ``plane`` and
     ``plane_anneal_se3`` (fully annealed) and a ``plane`` frame with
     ``return_points``, 1024 rays of ``plane_anneal_se3`` against the
     plain versions; (c) the 64 + 128 train steps of ``plane`` and of
     ``plane_anneal_se3`` (from step 3750), each with a 1024-ray step
     against the plain versions, ``query_sigma`` on ``plane``; (d)
     ``train.main --precision 32 --slice_method axis_aligned_plane
     --use_nerfies_embed --warp_field se3`` and ``eval`` of its checkpoint;
 38. the Jacobians at ``--precision 32`` (ROADMAP A.13.1 sub-item 4), TF32
     off: (a) rows 14 to 17 in float32 (the translation warp's J and its
     backward; the SE(3) trunk's (w, v) with their point-tangents and
     their backward, the window row off and on) against their float32
     plain versions at 1001 and 262,144 points (the train step's: 16
     Jacobian samples a ray at batch 16384; relative L2 1e-4, max|d| 1e-3
     of the largest entry, per output), timed at 262,144 points with their
     share of both ceilings; (b) against the JAX kernels' stored float32
     numbers (tests/data/fused_f32_jacobian_jax_ref.npz, through the
     autograd Functions, J of both retractions); (c) with their launches
     counted and no plain call: the 64 + 128 train steps of ``elastic``,
     ``elastic_se3`` and ``elastic_quaternion`` (weight 0.01, K = 16) and
     of ``elastic_se3`` with the Nerfies encoding from step 3750 (its
     window rows live), each with a 1024-ray step against the plain
     versions; ``train.main --precision 32 --elastic_loss_weight 0.01
     --elastic_jacobian_samples 16 --warp_field se3 --use_nerfies_embed``
     and ``eval`` of its checkpoint.
Times come from CUDA events (kernels) or the host clock around work that
ends in a synchronize (frames, steps). A kernel's bound is the larger of
its matrix-product operations over the card's dense bf16 peak and its bytes
(each input read once, each output written once) over the memory rate.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
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
CARD = ''  # nvidia-smi's name and power limit, printed beside phase 25's times
TRAIN_RAYS, TRAIN_STEPS, WARMUP_STEPS = 16384, 5, 2
PLAIN_CHUNK = 2048
TIMES = {}  # figures a later phase prints beside its own


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


def level_bound(level, n_rays: int, samples: int, cond: int = 39):
    """(bound_ms, bound_by) of one level forward: every weight is one
    multiply-add per sample (the alpha head's condition columns included);
    bytes are the ray inputs (``cond`` bf16 condition columns a ray, rgb
    and alpha), the weights once, the output."""
    macs = sum(level_macs(level))
    p = n_rays * samples
    return bound(2.0 * macs * p,
                 4 * p + n_rays * (24 + 32 + 2 * cond) + 2 * macs + 16 * p)


# The level forward's times on this card before its redesign around
# wgmma and TMA (the mma.sync kernel; PERF.md, row 1), ms at R = 8192.
EARLIER_LEVEL_MS = {('translation', 64): 5.969, ('translation', 128): 11.919,
                    ('se3', 64): 6.136, ('se3', 128): 12.142,
                    ('quaternion', 64): 6.189, ('quaternion', 128): 12.128}
LEVEL_FWD_SOURCES = ('level_fwd.cuh', 'level_fwd_trans.cu',
                     'level_fwd_se3.cu', 'level_fwd_quat.cu',
                     'level_fwd_anneal.cu', 'fused_level.cu')
# Kernel B, the fields backward (`wgmma`, TMA, a 128-row block tile; one
# source per warp type).
FIELDS_BWD_SOURCES = ('fields_bwd.cuh', 'fields_bwd_trans.cu',
                      'fields_bwd_se3.cu', 'fields_bwd_quat.cu')
# The Jacobians' forwards: the level forward's block run on the warp field
# or the trunk with their tangent streams.
TANGENTS_FWD_SOURCES = ('tangents_fwd.cu', 'level_fwd.cuh')


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


# The compositing forward before its redesign (a thread per ray; PERF.md
# row 2), ms at R = CHUNK, S = 64, N = 64.
EARLIER_COMPOSITE_MS = 0.113


def composite_kernel_ms(packed, z, dirs, u) -> float:
    """CUDA-event ms of the compositing kernel alone: its C entry point on
    outputs allocated once. Since its redesign the kernel takes less time
    than the wrapper's host work a call (its checks, allocations and the
    ctypes call), so a loop of wrapper calls times the host."""
    import torch
    from hypernerf_tpu_torch.kernels import build
    r, s = z.shape
    n = 0 if u is None else u.shape[1]
    out = torch.empty((r, 6), device='cuda')
    weights = torch.empty((r, s), device='cuda')
    z_union = torch.empty((r, s + n), device='cuda') if n else None
    lib, stream = build.library(), torch.cuda.current_stream().cuda_stream

    def launch():
        build.check(lib.hn_fused_composite_fwd(
            packed.data_ptr(), z.data_ptr(), dirs.data_ptr(), None,
            None if u is None else u.data_ptr(), out.data_ptr(),
            weights.data_ptr(), None if z_union is None else
            z_union.data_ptr(), r, s, n, 0, 1, stream),
            'hn_fused_composite_fwd')
    return cuda_ms(launch, 50)


# The compositing backward before its redesign (a thread per ray; PERF.md
# row 7), ms at R = 16384 by S.
EARLIER_COMPOSITE_BWD_MS = {64: 0.108, 128: 0.201}


def composite_bwd_kernel_ms(packed, z, dirs, noise, d_outs, d_w) -> float:
    """The compositing backward kernel alone through its C entry point
    (without its wrapper's checks and allocations), ms."""
    import torch
    from hypernerf_tpu_torch.kernels import build
    r, s = z.shape
    outs = [torch.empty((r * s, 4), device='cuda'),
            torch.empty((r, s), device='cuda'),
            torch.empty((r, 1), device='cuda')]
    stream = torch.cuda.current_stream().cuda_stream
    lib = build.library()
    return cuda_ms(lambda: build.check(lib.hn_fused_composite_bwd(
        packed.data_ptr(), z.data_ptr(), dirs.data_ptr(), noise.data_ptr(),
        d_outs.data_ptr(), d_w.data_ptr(), *[t.data_ptr() for t in outs],
        r, s, 0, 1, stream), 'hn_fused_composite_bwd'), 20)


def composite_bwd_bound(n_rays: int, samples: int):
    """(bound_ms, bound_by) of the compositing backward with noise: no
    matrix product; bytes are packed, z, noise and d weights in and d
    packed, d z out per sample, the directions and d outs in and d |d| out
    per ray."""
    p = n_rays * samples
    return bound(0.0, p * (16 + 4 + 4 + 4 + 16 + 4) + n_rays * (12 + 24 + 4))


def composite_fwd_bound(n_rays: int, samples: int, n_fine: int):
    """(bound_ms, bound_by) of the compositing forward with a fine draw: no
    matrix product; bytes are packed and z per sample, the directions and
    the draws per ray in, and the per-ray outputs, the weights and z_union
    out."""
    return bound(0.0, n_rays * (samples * (16 + 4) + 12 + 4 * n_fine + 24
                                + 4 * samples + 4 * (samples + n_fine)))


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
    """(relative L2, max|d| / max|want|, max|d|) of two tensors (zeros for
    two empty ones: a zero-width condition's cotangent)."""
    if want.numel() == 0 and got.shape == want.shape:
        return 0.0, 0.0, 0.0
    diff = (got - want).float()
    return ((diff.norm() / want.norm().clamp_min(1e-30)).item(),
            (diff.abs().max() / want.abs().max().clamp_min(1e-30)).item(),
            diff.abs().max().item())


def check_grads(label, names, got, want, l2_tol=GRAD_L2, max_tol=GRAD_MAX,
                tag='[6]'):
    """Hold every tensor of ``got`` to ``want``; returns the worst
    (relative L2, max|d| over the largest entry, max|d|) over the tensors and
    prints the first two, with the output of the worst relative L2 and the
    norm of its ``want``."""
    import torch
    worst, worst_name, worst_norm = [0.0, 0.0, 0.0], None, 0.0
    for name, a, b in zip(names, got, want):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f'{label}: {name} {tuple(a.shape)} vs '
                                 f'{tuple(b.shape)} or not finite')
        errs = grad_errors(a, b)
        if errs[0] > l2_tol or errs[1] > max_tol:
            raise AssertionError(f'{label}: {name} relative L2 {errs[0]:.3e} '
                                 f'(tol {l2_tol}), max {errs[1]:.3e} of the '
                                 f'largest entry (tol {max_tol})')
        if errs[0] >= worst[0]:
            worst_name, worst_norm = name, b.float().norm().item()
        worst = [max(w, e) for w, e in zip(worst, errs)]
    phase(f'{tag} {label}: {len(names)} outputs, worst relative L2 '
          f'{worst[0]:.3e} at {worst_name} (norm {worst_norm:.3e}; tol '
          f'{l2_tol}), worst max|d| {worst[1]:.3e} of the largest entry (tol '
          f'{max_tol})')
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


def plain_forward(level, args, warp_scales=None, tmpl_scales=None,
                  alpha=None):
    """(out, raw_t) of the plain level forward, over chunks of PLAIN_CHUNK
    rays (``alpha``: the alpha condition, or None)."""
    import torch
    from hypernerf_tpu_torch.kernels import fused_level_plain
    parts = [fused_level_plain(level, *[a[r0:r1].contiguous() for a in args],
                               return_raw_t=True, warp_scales=warp_scales,
                               tmpl_scales=tmpl_scales,
                               alpha_cond=None if alpha is None
                               else alpha[r0:r1].contiguous())
             for r0, r1 in chunks(args[0].shape[0])]
    return tuple(torch.cat([p[i] for p in parts]) for i in range(2))


def plain_template_bwd(level, raw_t, rgb_cond, g, scales=None, alpha=None):
    """The plain template backward over chunks of PLAIN_CHUNK rays (the
    plain version keeps every activation of a chunk in device memory):
    [dx_t, d rgb_cond, 32 x dW/db] and, with an alpha condition ``alpha``,
    d alpha_cond last; per-sample and per-ray outputs concatenated, dW / db
    summed."""
    import torch
    from hypernerf_tpu_torch.kernels import fused_template_bwd_plain
    s = raw_t.shape[0] // rgb_cond.shape[0]
    parts, d_alpha = [], []
    for r0, r1 in chunks(rgb_cond.shape[0]):
        dx_t, d_cond, grads, d_a = fused_template_bwd_plain(
            level, raw_t[r0 * s:r1 * s], rgb_cond[r0:r1], g[r0 * s:r1 * s],
            scales, None if alpha is None else alpha[r0:r1])
        parts.append([dx_t, d_cond, *grads])
        d_alpha.append(d_a)
    out = ([torch.cat([p[i] for p in parts]) for i in range(2)]
           + [sum(p[i] for p in parts) for i in range(2, len(parts[0]))])
    return out + ([] if alpha is None else [torch.cat(d_alpha)])


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


def template_bwd_bound(level, n_rays: int, samples: int, raw: int = 8,
                       cond: int = 39):
    """(bound_ms, bound_by) of the template backward on n_rays x samples
    rows: the recompute, g W and g^T h each take one multiply-add per weight
    and row (the alpha head's condition columns included); bytes are the
    inputs and outputs once (raw_t, g, dx_t per row, ``raw`` fp32 columns
    each of raw_t and dx_t; the ``cond`` condition columns, bf16, and their
    fp32 cotangent per ray) and the weights and dW once. The function's
    work, not the stash's bytes."""
    t_macs = level_macs(level)[1]
    p = n_rays * samples
    return bound(6.0 * t_macs * p,
                 p * (8 * raw + 16) + n_rays * 6 * cond + 6 * t_macs)


def fields_bwd_bound(level, n_rays: int, samples: int, raw: int = 8):
    """(bound_ms, bound_by) of kernel B on n_rays x samples rows: the
    recompute, g W and g^T h each take one multiply-add per weight of the
    field layers and row; bytes are the inputs and outputs once (z, dx_t of
    ``raw`` fp32 columns, d z per row; the ray inputs and their cotangents
    per ray) and the weights and dW once."""
    f_macs = level_macs(level)[0]
    p = n_rays * samples
    return bound(6.0 * f_macs * p,
                 p * (8 + 4 * raw) + n_rays * (24 + 32 + 56) + 6 * f_macs)


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
            got_dx_t, d_cond, t_grads, _ = fused_template_bwd(lv, raw_t,
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
        # ways; S = 5 and 40 leave a ragged last chunk of 32 samples.
        c_errs, c_times = [], {}
        gen = torch.Generator().manual_seed(5)
        for r, s in ((37, 5), (37, 40), (512, 64), (TRAIN_RAYS, 64),
                     (TRAIN_RAYS, 128)):
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
                    composite_bwd_kernel_ms(packed, z, dirs, noise, d_outs,
                                            d_w),
                    cuda_ms(lambda: fused_composite_bwd_plain(
                        packed, z, dnorm, noise, d_outs, d_w)),
                    cuda_ms(lambda: fused_composite_bwd(
                        packed, z, dirs, noise, d_outs, d_w)),
                    composite_bwd_bound(r, s)[0])
                t = c_times[s]
                phase(f'[6] compositing backward R={r} S={s}: kernel '
                      f'{t[0]:.4f} ms ({t[3] / t[0]:.1%} of its bound '
                      f'{t[3]:.4f} ms; {EARLIER_COMPOSITE_BWD_MS[s]:.3f} ms '
                      f'before its redesign as a warp per ray, PERF.md), '
                      f'through the wrapper {t[2]:.4f} ms, plain '
                      f'{t[1]:.3f} ms')

    # Bounds at the train step's fine level (R = 16384, S = 128). A and B:
    # the recompute, g W and g^T h each take one multiply-add per weight and
    # sample. Bytes: inputs once, outputs once, the weights and dW once.
    p, r = TRAIN_RAYS * 128, TRAIN_RAYS
    a_ms, a_by = template_bwd_bound(level[128], r, 128)
    b_ms, b_by = fields_bwd_bound(level[128], r, 128)
    c_ms, c_by = composite_bwd_bound(r, 128)
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
             library_ms=None, wrapper_ms=c_times[128][2],
             ms_s64=c_times[64][0], bound_ms_s64=c_times[64][3])]


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
                 elastic_weight: float = 0.0, extra_params=None,
                 occupancy_grid=None, tols=None):
    """One step's loss and gradients on a small explicit batch from the same
    state and draws: the kernels, then the plain versions. Run on the seeded
    initial state, so the reading is the same from run to run (after train
    steps the state differs in its last bits, and the reading with it).
    With ``elastic_weight`` the loss adds the elastic term (the warp
    Jacobian, subsampled by the same draws); its value is printed and must
    be non-zero. ``extra_params``: the annealing alphas of the step;
    ``occupancy_grid``: the grid of a grid-trained model (the coarse draw's
    sorted uniforms then replace the jitter). ``tols``: (the loss's
    relative tolerance, the gradients' relative L2 over all parameters) in
    place of the bf16 rule's (STEP_LOSS_TOL absolute, STEP_GRAD_L2 both
    figures); the worst parameter keeps STEP_GRAD_L2.
    Returns the launches of the kernels' step."""
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
    if occupancy_grid is not None:
        draws['coarse_u'] = sorted_uniform(n, s, gen, device='cuda')
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
                    return_warp_jacobian=bool(elastic_weight),
                    extra_params=extra_params, occupancy_grid=occupancy_grid)
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
    loss_tol, grad_tol = ((STEP_LOSS_TOL, STEP_GRAD_L2) if tols is None else
                          (tols[0] * abs(loss_p), tols[1]))
    phase(f'{tag} one step on {n} rays, kernels vs plain versions: loss '
          f'{loss_k:.8f} vs {loss_p:.8f} (|d| {abs(loss_k - loss_p):.3e}, '
          f'tol {loss_tol:.3e}); gradients: relative L2 over all parameters '
          f'{total:.3e} (tol {grad_tol}), worst parameter {worst[0]:.3e} of '
          f'its scale at {worst[1]} (tol {STEP_GRAD_L2}){elastic}')
    TIMES[f'{tag} step'] = (abs(loss_k - loss_p) / abs(loss_p), total)
    if not abs(loss_k - loss_p) <= loss_tol or not total <= grad_tol or \
            not worst[0] <= STEP_GRAD_L2:
        raise AssertionError('train step: kernels and plain versions '
                             'disagree')
    if terms and not (math.isfinite(terms[0].item()) and terms[0].item() > 0):
        raise AssertionError(f'the elastic term is {terms[0].item()}')
    return launches


def kernel_wrappers():
    """({kernel name: wrapper with a ``launches`` count}, [plain versions
    with a ``calls`` count]) of all seventeen kernels."""
    from hypernerf_tpu_torch.kernels import counted
    wrappers, plains = counted()
    return wrappers, list(plains.values())


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
STEP_LAUNCHES['quaternion_split_glo'] = STEP_LAUNCHES['se3_split_glo']
STEP_LAUNCHES['se3'] = STEP_LAUNCHES['quaternion'] = STEP_LAUNCHES['flagship']
# The elastic loss adds the Jacobian kernels, once per level and step.
STEP_LAUNCHES['elastic'] = {**STEP_LAUNCHES['flagship'],
                            'fused_jacobian_fwd': 2, 'fused_jacobian_bwd': 2}
STEP_LAUNCHES['elastic_se3'] = STEP_LAUNCHES['elastic_quaternion'] = {
    **STEP_LAUNCHES['flagship'], 'fused_se3_jacobian_fwd': 2,
    'fused_se3_jacobian_bwd': 2}
# A path that is a configuration with overrides: (configuration, overrides).
PATHS = {'se3_split_glo': ('se3', dict(share_glo=False)),
         'quaternion_split_glo': ('quaternion', dict(share_glo=False))}


def train_path(config: str, tag: str, times=None, tols=None) -> dict:
    """The train step of ``config`` (a configuration, or a name of ``PATHS``)
    at full width (batch 16384, bf16, sigma noise, Adam with steplr) through
    ``make_train_step``; returns its launches over the timed steps. A
    configuration with the occupancy grid refreshes it before the first
    step (the one compared with the plain versions) and, inside the timed
    window, every ``occupancy_update_every`` steps from its first, as
    ``bench.py`` does; ``times``, a dict, receives the window's seconds a
    step and its number of refreshes, and its peak GiB. ``tols``:
    ``compare_step``'s."""
    import torch
    from hypernerf_tpu_torch.flagship import flagship_train_setup
    from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
    from hypernerf_tpu_torch.training.losses import mse_loss
    from hypernerf_tpu_torch.training.train_state import (TrainState,
                                                          compute_extra_params,
                                                          step_generator)
    from hypernerf_tpu_torch.configs import TrainConfig
    from hypernerf_tpu_torch.flagship import (TRAIN_CONFIGS,
                                              flagship_train_config)
    from hypernerf_tpu_torch.training.train_state import \
        make_occupancy_update
    base, overrides = PATHS.get(config, (config, {}))
    state, step_fn, all_rays, all_rgbs = flagship_train_setup(
        'cuda', seed=0, batch_size=TRAIN_RAYS, config=base, **overrides)
    elastic = TRAIN_CONFIGS.get(base, {}).get('elastic_loss_weight', 0.0)
    model = state.model
    cfg = model.config
    fixed = slice(0, 4096)
    # The alphas of the first step (the ramps of TrainConfig's defaults,
    # which flagship_train_setup keeps).
    extra = compute_extra_params(cfg, TrainConfig(), state.step)
    train_cfg = flagship_train_config(base)
    update = grid = None
    if state.occupancy is not None:
        # As bench.py: the grid is refreshed before the first step. The
        # comparison step and the fixed batch take the grid that step takes.
        update = make_occupancy_update(model, cfg, train_cfg)
        grid = update(state).clone()

    def fixed_loss():  # a deterministic render of a fixed batch
        with torch.no_grad():
            out = model(prepare_ray_dict(all_rays[fixed]),
                        return_weights=False, extra_params=extra,
                        occupancy_grid=grid)
            return mse_loss(out, all_rgbs[fixed]).item()

    before = fixed_loss()
    compare_step(model, all_rays, all_rgbs, tag, elastic, extra, grid,
                 tols)
    for _ in range(WARMUP_STEPS):
        step_fn(state, all_rays, all_rgbs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    refreshes = 0
    t0 = time.perf_counter()
    metrics = []
    for i in range(TRAIN_STEPS):
        if update is not None and i % train_cfg.occupancy_update_every == 0:
            update(state)
            refreshes += 1
        metrics.append(step_fn(state, all_rays, all_rgbs))
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / TRAIN_STEPS
    n_ids = min(train_cfg.occupancy_probe_ids, cfg.num_embeddings)
    want = {k: v * TRAIN_STEPS for k, v in STEP_LAUNCHES[config].items()}
    refresh_launches = (REFRESH_LAUNCHES_F32 if cfg.compute_dtype ==
                        'float32' else REFRESH_LAUNCHES)
    for k, v in refresh_launches.items():
        if refreshes:
            want[k] = want.get(k, 0) + v * n_ids * refreshes
    launches = read_counts(want, f'{config} train steps')
    if times is not None:
        times.update(secs=secs, refreshes=refreshes,
                     peak=torch.cuda.max_memory_allocated() / 2 ** 30)
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
    alphas = (f', from step {state.step - TRAIN_STEPS - WARMUP_STEPS} '
              f'(alphas {extra})' if extra else '')
    if refreshes:
        alphas += (f', the grid refreshed {refreshes} time(s) in the window '
                   f'({n_ids} ids a refresh)')
    phase(f'{tag} {config} train step (batch {TRAIN_RAYS}, '
          f'{cfg.num_coarse_samples}+{cfg.num_fine_samples}, full '
          f'widths, {cfg.compute_dtype}, noise_std {cfg.noise_std}, Adam lr '
          f'{state.optimizer.param_groups[0]["lr"]}{alphas}): '
          f'{secs * 1e3:.1f} '
          f'ms/step, {TRAIN_RAYS / secs:.0f} rays/s over {TRAIN_STEPS} steps '
          f'after {WARMUP_STEPS}; launches per step '
          + ', '.join(f'{k} {launches[k] // TRAIN_STEPS}'
                      for k in STEP_LAUNCHES[config])
          + (f' and in the window\'s refreshes '
             + ', '.join(f'{k} {v * n_ids * refreshes}'
                         for k, v in refresh_launches.items())
             if refreshes else '')
          + f'; no plain call; loss {losses[0]:.5f} -> '
          f'{losses[-1]:.5f}, psnr {psnrs[-1]:.2f}; fixed-batch loss '
          f'{before:.5f} -> {after:.5f}; {len(list(model.parameters()))} '
          f'parameters with finite non-zero gradients; peak memory '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB')
    return launches


def train_phase(kernels) -> None:
    """Phase 7: the flagship train step; fills in the train launches of its
    kernels' entries and keeps its seconds a step (TIMES)."""
    times = {}
    launches = train_path('flagship', '[7]', times)
    TIMES['flagship_step'] = times['secs']
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


def plain_template(tmpl, x_raw, rgb_cond, scales=None, alpha=None):
    """The plain template forward over chunks of condition rows (``alpha``:
    the alpha condition, or None)."""
    import torch
    from hypernerf_tpu_torch.kernels import fused_template_plain
    s = x_raw.shape[0] // rgb_cond.shape[0]
    step = max(1, PLAIN_CHUNK * ROWS_128 // s)
    return torch.cat([
        fused_template_plain(tmpl, x_raw[r0 * s:(r0 + step) * s],
                             rgb_cond[r0:r0 + step], scales,
                             None if alpha is None else alpha[r0:r0 + step])
        for r0 in range(0, rgb_cond.shape[0], step)])


# The per-module forward kernels (a field alone, the template alone, the
# SE(3) trunk alone): the level forward's stages run alone on its block.
MODULAR_FWD_SOURCES = ('modular_fwd.cu', 'template_fwd.cuh',
                       'template_fwd_anneal.cu', 'level_fwd.cuh')
# Their times before the redesign (the mma.sync kernels; PERF.md rows 8 and
# 10), ms: the warp field and the sheet at 8192 x 128 rows, the template at
# R = 8192, S = 128.
EARLIER_MODULAR_MS = {'warp': 1.690, 'sheet': 0.877, 'template': 8.802}
# A field alone backward: kernel B's block run on one field; the SE(3)
# trunk alone backward and the trunk's tangents backward run it too.
FIELD_BWD_SOURCES = ('fields_bwd_alone.cu', 'fields_bwd_alone.cuh',
                     'fields_bwd.cuh')
SE3_BWD_SOURCES = ('se3_bwd_alone.cu', 'fields_bwd_alone.cuh',
                   'fields_bwd.cuh')
SE3_TANGENTS_BWD_SOURCES = ('se3_tangents_bwd.cu', 'fields_bwd_alone.cuh',
                            'fields_bwd.cuh')
WARP_TANGENTS_BWD_SOURCES = ('warp_tangents_bwd.cu', 'fields_bwd_alone.cuh',
                             'fields_bwd.cuh')
# Its times before the redesign (the mma.sync kernel with 32-row tiles;
# PERF.md row 11), ms at 8192 x 128 and 16384 x 128 rows.
EARLIER_FIELD_BWD_MS = {('warp', 8192 * 128): 10.545,
                        ('warp', 16384 * 128): 20.645,
                        ('sheet', 8192 * 128): 4.075,
                        ('sheet', 16384 * 128): 8.000}


def modular_stage_plans(probe) -> None:
    """Phase 8: each per-module forward kernel's compiled plan (the stage's
    layers, tile, ring, column plan, weight loads) against its model
    (``fused_level.stage_plan``) over the module's own packed blob, and each
    field alone backward's (kernel B's block, ring and buffer plan of the
    field, its weight loads) against ``fused_level.field_bwd_plan``."""
    import importlib
    from hypernerf_tpu_torch.kernels import common
    from hypernerf_tpu_torch.kernels.fused_field import field_layers
    from hypernerf_tpu_torch.kernels.fused_mlp import template_layers
    fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
    template = probe.level('fine').template
    owners = {'warp': (probe.warp_field.mlp,
                       field_layers(probe.warp_field.mlp)),
              'sheet': (probe.hyper_sheet_mlp.mlp,
                        field_layers(probe.hyper_sheet_mlp.mlp)),
              'template': (template, template_layers(template, enc_pad=128))}
    loads = {}
    for stage, (owner, layers) in owners.items():
        shapes = common.pack_layers(owner, layers)[2]
        got = fl.compiled_stage_plan(stage)
        want = fl.stage_plan(stage, shapes)
        if got != want:
            raise AssertionError(f'{stage}: the compiled plan is not its '
                                 f'model: {got} vs {want}')
        loads[stage] = len(got['loads'])
    phase(f'[8] per-module plans (compiled = model): weight loads a step of '
          f'tiles {loads}')
    for stage in ('warp', 'sheet'):
        owner, layers = owners[stage]
        shapes = common.pack_layers(owner, layers)[2]
        got = fl.compiled_field_bwd_plan(stage)
        want = fl.field_bwd_plan(stage, shapes)
        if got != want:
            raise AssertionError(f'{stage}: the compiled field backward plan '
                                 f'is not its model: {got} vs {want}')
        phase(f'[8] {stage} field backward plan (compiled = model): kernel '
              f'B\'s block, {len(got["loads"])} weight loads a block tile, '
              f'spills {fl.field_bwd_spills(stage)}; computed from the plan, '
              f'not measured: '
              f'{fl.field_bwd_stream_bytes(stage, shapes, TRAIN_RAYS * 128):,}'
              f' bytes of weights streamed from L2 at {TRAIN_RAYS * 128} '
              f'rows')


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
    modular_stage_plans(probe)

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
            dx_t, d_cond, grads, _ = K.fused_template_bwd(t, x, cond, g)
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
            chained = K.fused_template(lv, raw_t, args[4])
            hold_level(chained, want, f'field + template kernels vs the '
                       f'level kernel R=512 S={s}: out', '[8]')
            # They run the level kernel's own stage functions on its block.
            same = (torch.equal(raw_t, want_raw_t), torch.equal(chained, want))
            phase(f'[8] chained kernels vs the level kernel R=512 S={s}: bit '
                  f'for bit (raw_t, out) {same}')
            if not all(same):
                raise AssertionError('the chained stage kernels differ from '
                                     'the level kernel')
            g = torch.randn(512 * s, 4, generator=gen).cuda()
            dx_t, _, _, _ = K.fused_template_bwd(lv, want_raw_t, args[4], g)
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
    macs = {name: sum(lin.weight.numel() for lin, _ in
                      field_layers(field.mlp))
            for name, field in fields.items()}
    t_macs = level_macs(probe.level('fine'))[1]
    p_r, p_t = CHUNK * 128, TRAIN_RAYS * 128
    f_bound = {name: bound(2.0 * m * p_r, p_r * (44 + 32) + 2 * m)
               for name, m in macs.items()}
    bwd_bound = {name: bound(6.0 * m * p_t, p_t * (44 + 32 + 44) + 6 * m)
                 for name, m in macs.items()}
    f_ms, f_by = f_bound['warp']
    b_ms, b_by = bwd_bound['warp']
    t_ms, t_by = bound(2.0 * t_macs * p_r,
                       p_r * (32 + 16) + CHUNK * 78 + 2 * t_macs)
    src = 'hypernerf_tpu_torch/kernels/csrc/'
    level_tol = (f'|d| <= {LEVEL_ATOL} + {LEVEL_RTOL} |plain|, mean |d| <= '
                 f'{LEVEL_MEAN}')
    warp_r, warp_t = times['warp', p_r], times['warp', p_t]
    sheet_r, sheet_t = times['sheet', p_r], times['sheet', p_t]
    for name, ms, (bms, _) in (
            ('warp field', warp_r['fwd'], f_bound['warp']),
            ('sheet', sheet_r['fwd'], f_bound['sheet']),
            ('template', times['flagship', CHUNK, 128][0], (t_ms, t_by))):
        earlier = EARLIER_MODULAR_MS[name.split()[0]]
        phase(f'[8] {name} forward at {p_r} rows: {ms:.3f} ms, '
              f'{100 * bms / ms:.1f} % of its bound {bms:.4f} ms; '
              f'{earlier:.3f} ms before the redesign (PERF.md)')
    for name in fields:
        for p in (p_r, p_t):
            ms = times[name, p]['bwd']
            bms = bound(6.0 * macs[name] * p, p * (44 + 32 + 44)
                        + 6 * macs[name])[0]
            phase(f'[8] {name} field backward at {p} rows: {ms:.3f} ms, '
                  f'{100 * bms / ms:.1f} % of its bound {bms:.4f} ms; '
                  f'{EARLIER_FIELD_BWD_MS[name, p]:.3f} ms before the '
                  f'redesign (PERF.md)')
    return [
        dict(name='fused_field_fwd', route='cuda',
             source=', '.join(src + f for f in MODULAR_FWD_SOURCES),
             replaces='hypernerf_tpu/ops/pallas/fused_field.py:495',
             max_abs_err=max(errs['field_fwd']), tolerance=level_tol,
             ms=warp_r['fwd'], plain_ms=warp_r['plain_fwd'], bound_ms=f_ms,
             bound_by=f_by, library_ms=None, shape=f'warp field, P={p_r}',
             warp_ms_train_rows=warp_t['fwd'], sheet_ms=sheet_r['fwd'],
             sheet_plain_ms=sheet_r['plain_fwd'],
             sheet_bound_ms=f_bound['sheet'][0],
             sheet_ms_train_rows=sheet_t['fwd']),
        dict(name='fused_field_bwd', route='cuda',
             source=', '.join(src + f for f in FIELD_BWD_SOURCES),
             replaces='hypernerf_tpu/ops/pallas/fused_field.py:532',
             **error_keys(errs['field_bwd']), ms=warp_t['bwd'],
             plain_ms=warp_t['plain_bwd'], bound_ms=b_ms, bound_by=b_by,
             library_ms=None, shape=f'warp field, P={p_t}',
             ms_8192x128_rows=warp_r['bwd'],
             sheet_ms=sheet_t['bwd'], sheet_plain_ms=sheet_t['plain_bwd'],
             sheet_bound_ms=bwd_bound['sheet'][0],
             sheet_ms_8192x128_rows=sheet_r['bwd']),
        dict(name='fused_template_fwd', route='cuda',
             source=', '.join(src + f for f in MODULAR_FWD_SOURCES),
             replaces='hypernerf_tpu/ops/pallas/fused_mlp.py:656',
             max_abs_err=max(errs['template_fwd']), tolerance=level_tol,
             ms=times['flagship', CHUNK, 128][0],
             plain_ms=times['flagship', CHUNK, 128][1], bound_ms=t_ms,
             bound_by=t_by, library_ms=None, shape=f'R={CHUNK} S=128',
             ms_s64=times['flagship', CHUNK, 64][0],
             ms_r16384=times['flagship', TRAIN_RAYS, 128][0],
             ms_r16384_s64=times['flagship', TRAIN_RAYS, 64][0],
             static_ms=times['static', CHUNK, 128][0],
             ms_one_row_per_ray_2_20_rows=times['flagship', 1 << 20, 1][0],
             static_template_bwd_ms=times['A', 'static'],
             template_bwd_errors=error_keys(errs['A']))]


QUERY_CALLS = 3  # timed query_sigma calls, after one at full size


def query_sigma_path(config: str, want: dict, tag: str,
                     **overrides) -> dict:
    """``query_sigma`` of ``config`` (with NerfConfig ``overrides``) on
    1 << 20 points of one frame id, one sample per row: the mean host time
    of QUERY_CALLS calls after one at that size (which makes its
    allocations), the launches of one call (``want``, checked), finite
    non-negative sigma that agrees with the plain versions on 4099 points;
    returns the launches of one call."""
    import torch
    from hypernerf_tpu_torch.flagship import flagship_model
    model = flagship_model('cuda', seed=0, config=config, **overrides)
    n = 1 << 20
    gen = torch.Generator(device='cuda').manual_seed(3)
    pts = torch.randn(n, 3, generator=gen, device='cuda') * 0.5
    ids = torch.full((n, 1), 3, dtype=torch.int64, device='cuda')
    with torch.no_grad():
        model.query_sigma(pts, ids)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(QUERY_CALLS):
            sigma = model.query_sigma(pts, ids)
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / QUERY_CALLS
        launches = read_counts({k: v * QUERY_CALLS for k, v in want.items()},
                               f'{config} query_sigma')
        with plain_versions():
            plain = model.query_sigma(pts[:4099], ids[:4099])
    diff = (sigma[:4099] - plain).abs()
    if sigma.shape != (n,) or not torch.isfinite(sigma).all() \
            or (sigma < 0).any() \
            or (diff > LEVEL_ATOL + LEVEL_RTOL * plain.abs()).any():
        raise AssertionError(f'{config} query_sigma: shape '
                             f'{tuple(sigma.shape)}, max|d| '
                             f'{diff.max().item():.3e}')
    phase(f'{tag} {config} query_sigma on {n} points: {secs * 1e3:.2f} ms '
          f'(mean of {QUERY_CALLS} calls after one); launches a call '
          f'{want}; vs the plain versions on 4099 points max|d| '
          f'{diff.max().item():.3e} (tol {LEVEL_ATOL}+{LEVEL_RTOL}|want|)')
    return {k: v // QUERY_CALLS for k, v in launches.items()}


def time_frames(renderer, frames, keep, want: dict, label: str,
                point_ch: int = 7):
    """(s/frame, launches): ``frames[1:]`` (N_FRAMES frames) rendered after
    the warm-up frame ``frames[0]`` (the first launches), timed together on
    the host clock to a synchronize, as phase 5 times them; raises unless
    the launches are ``want`` per frame and every frame's ``keep`` outputs
    are finite and of the frame's shape (a med_point of ``point_ch``
    channels), rgb as uint8."""
    import torch
    from hypernerf_tpu_torch.flagship import H, W
    renderer(frames[0])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    outs = [renderer(rays)['fine'] for rays in frames[1:]]
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / len(outs)
    launches = read_counts({k: v * len(outs) for k, v in want.items()},
                           label)
    shapes = {'rgb': (W * H, 3), 'depth': (W * H,), 'acc': (W * H,),
              'med_points': (W * H, 1, point_ch)}
    for fine in outs:
        for k in keep:
            v = torch.as_tensor(fine[k])
            if v.shape != shapes[k] or not torch.isfinite(v.float()).all():
                raise AssertionError(f'{label}: {k} {v.shape} not finite / '
                                     f'misshapen')
        if fine['rgb'].dtype.name != 'uint8':
            raise AssertionError(f'{label}: rgb {fine["rgb"].dtype}')
    return secs, launches


def modular_paths_phase(kernels) -> None:
    """Phase 9: the per-module path at full width on ``static`` and
    ``split_glo``; fills in the launches of the three kernels' entries."""
    import torch
    from hypernerf_tpu_torch.flagship import H, W, flagship_model, spiral_rays
    from hypernerf_tpu_torch.training.renderer import ImageRenderer
    chunks_per_frame = -(-W * H // CHUNK)
    frames = spiral_rays(range(0, 30 * (N_FRAMES + 1), 30))
    counts = {}
    for config in ('static', 'split_glo'):
        fields = 2 if config == 'split_glo' else 0
        model = flagship_model('cuda', seed=0, config=config)
        keep = ('rgb', 'depth', 'acc') + (
            ('med_points',) if fields else ())
        renderer = ImageRenderer(model, chunk=CHUNK, keep=keep,
                                 levels=('fine',), quantize=True)
        secs, launches = time_frames(
            renderer, frames, keep,
            {'fused_template_fwd': 2 * chunks_per_frame,
             'fused_field_fwd': 2 * fields * chunks_per_frame},
            f'{config} frame')
        phase(f'[9] {config}: rendered {N_FRAMES} frames {W}x{H} (64+64, '
              f'chunk {CHUNK}{", return_points" if fields else ""}): '
              f'{secs:.4f} s/frame; launches {launches} (= 2 levels x '
              f'{chunks_per_frame} chunks{" x 2 fields" if fields else ""} x '
              f'{N_FRAMES} frames); no level kernel, no plain call')
        counts[config, 'frame'] = launches
        del renderer, model
        torch.cuda.empty_cache()
        counts[config, 'train'] = train_path(config, '[9]')
        torch.cuda.empty_cache()

    counts['split_glo', 'query_sigma'] = query_sigma_path(
        'split_glo', {'fused_field_fwd': 2, 'fused_template_fwd': 1}, '[9]')
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


# The trunk forward's and backward's times before the redesign (the
# mma.sync kernels; PERF.md rows 12 and 13), ms at 8192 x 128 and 16384 x
# 128 rows.
EARLIER_SE3_FWD_MS = {8192 * 128: 2.014, 16384 * 128: 4.033}
EARLIER_SE3_BWD_MS = {8192 * 128: 12.385, 16384 * 128: 24.375}


def wv_of(field, x_raw, scales=None):
    """(P, 6) [w | v] of the trunk kernel."""
    import torch
    from hypernerf_tpu_torch.kernels import fused_se3_wv
    return torch.cat(fused_se3_wv(field, x_raw, scales), dim=-1)


def se3_kernel_phase():
    """Phase 10; returns the entries of the trunk's two kernels. The
    forward is the level forward's trunk stage run alone on its block: its
    compiled plan is held to ``fused_level.stage_plan('se3', ...)``; the
    backward is kernel B's block run on the trunk alone: its compiled plan
    is held to ``fused_level.field_bwd_plan('se3', ...)``."""
    import importlib
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
    fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
    shapes = common.pack_layers(field, layers)[2]
    got, want = fl.compiled_stage_plan('se3'), fl.stage_plan('se3', shapes)
    if got != want:
        raise AssertionError(f'se3: the compiled trunk stage plan is not its '
                             f'model: {got} vs {want}')
    phase(f'[10] trunk stage plan (compiled = model): {want["config"][1]} '
          f'tiles of {want["config"][6]} columns a step, '
          f'{len(want["loads"])} weight loads a step; computed from the '
          f'plan, not measured: '
          f'{fl.forward_stream_bytes(shapes, CHUNK * 128, 3):,} bytes of '
          f'weights streamed from L2 at {CHUNK * 128} rows')
    got = fl.compiled_field_bwd_plan('se3')
    want = fl.field_bwd_plan('se3', shapes)
    if got != want:
        raise AssertionError(f'se3: the compiled trunk backward plan is not '
                             f'its model: {got} vs {want}')
    phase(f'[10] trunk backward plan (compiled = model): kernel B\'s block, '
          f'{len(got["loads"])} weight loads a block tile, spills '
          f'{fl.field_bwd_spills("se3")}; computed from the plan, not '
          f'measured: '
          f'{fl.field_bwd_stream_bytes("se3", shapes, TRAIN_RAYS * 128):,} '
          f'bytes of weights streamed from L2 at {TRAIN_RAYS * 128} rows')

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
        # backward block tile's 128 rows.
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
    for p in (p_r, p_t):
        ms = times[p]['fwd']
        bms = bound(2.0 * macs * p, p * (44 + 32) + 2 * macs)[0]
        phase(f'[10] trunk forward at {p} rows: {ms:.3f} ms, '
              f'{100 * bms / ms:.1f} % of its bound {bms:.4f} ms; '
              f'{EARLIER_SE3_FWD_MS[p]:.3f} ms before the redesign (PERF.md)')
        ms = times[p]['bwd']
        bms = bound(6.0 * macs * p, p * (44 + 32 + 44) + 6 * macs)[0]
        phase(f'[10] trunk backward at {p} rows: {ms:.3f} ms, '
              f'{100 * bms / ms:.1f} % of its bound {bms:.4f} ms; '
              f'{EARLIER_SE3_BWD_MS[p]:.3f} ms before the redesign (PERF.md)')
    src = 'hypernerf_tpu_torch/kernels/csrc/'
    return [
        dict(name='fused_se3_fwd', route='cuda',
             source=', '.join(src + f for f in MODULAR_FWD_SOURCES),
             replaces='hypernerf_tpu/ops/pallas/fused_se3.py:374',
             max_abs_err=max(errs['fwd']),
             tolerance=f'|d| <= {LEVEL_ATOL} + {LEVEL_RTOL} |plain|, mean '
                       f'|d| <= {LEVEL_MEAN}',
             ms=times[p_r]['fwd'], plain_ms=times[p_r]['plain_fwd'],
             bound_ms=f_ms, bound_by=f_by, library_ms=None,
             shape=f'P={p_r}', macs_per_row=macs,
             ms_train_rows=times[p_t]['fwd']),
        dict(name='fused_se3_bwd', route='cuda',
             source=', '.join(src + f for f in SE3_BWD_SOURCES),
             replaces='hypernerf_tpu/ops/pallas/fused_se3.py:412',
             **error_keys(errs['bwd'], SE3_TRUNK_GRAD_L2),
             ms=times[p_t]['bwd'],
             plain_ms=times[p_t]['plain_bwd'], bound_ms=b_ms, bound_by=b_by,
             library_ms=None, shape=f'P={p_t}',
             ms_8192x128_rows=times[p_r]['bwd'])]


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
    frames = spiral_rays(range(0, 30 * (N_FRAMES + 1), 30))
    counts = {}
    per_module = {'fused_se3_fwd': per_frame, 'fused_field_fwd': per_frame,
                  'fused_template_fwd': per_frame}
    for label, config, return_points, want in (
            ('se3', 'se3', False,
             {'fused_level_fwd': per_frame, 'fused_composite_fwd': per_frame}),
            ('quaternion', 'quaternion', False,
             {'fused_level_fwd': per_frame, 'fused_composite_fwd': per_frame}),
            ('se3 return_points', 'se3', True, per_module),
            ('se3_split_glo', 'se3_split_glo', False, per_module)):
        base, overrides = PATHS.get(config, (config, {}))
        model = flagship_model('cuda', seed=0, config=base, **overrides)
        keep = ('rgb', 'depth', 'acc') + (
            ('med_points',) if return_points else ())
        renderer = ImageRenderer(model, chunk=CHUNK, keep=keep,
                                 levels=('fine',), quantize=True)
        secs, launches = time_frames(renderer, frames, keep, want,
                                     f'{label} frame')
        phase(f'[12] {label}: rendered {N_FRAMES} frames {W}x{H} (64+64, '
              f'chunk {CHUNK}): {secs:.4f} s/frame; launches {launches} (= 2 '
              f'levels x {chunks_per_frame} chunks x {N_FRAMES} frames); no '
              f'plain call')
        counts[label, 'frame'] = launches
        del renderer, model
        torch.cuda.empty_cache()
    for config in ('se3', 'quaternion', 'se3_split_glo',
                   'quaternion_split_glo'):
        counts[config, 'train'] = train_path(config, '[12]')
        torch.cuda.empty_cache()

    counts['se3', 'query_sigma'] = query_sigma_path(
        'se3', {'fused_se3_fwd': 1, 'fused_field_fwd': 1,
                'fused_template_fwd': 1}, '[12]')
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
# The Jacobians' kernels before their redesign (the mma.sync kernels;
# PERF.md rows 14 to 17), ms at JAC_POINTS points.
EARLIER_JAC_FWD_MS = {'translation': 1.726, 'se3': 2.129}
EARLIER_JAC_BWD_MS = {'translation': 11.224, 'se3': 12.376}


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


def jacobian_runs(field, trans: bool):
    """A warp's Jacobian kernels on its warp field (the translation
    warp's J, or the trunk's (w, v) with their tangents): (forward,
    backward, plain, plain backward, layers, output width, nonzero
    encoding columns of a tangent row). The four take (x, scales) or (x,
    g, scales); the translation warp ignores the window row. A tangent row
    along p_k is nonzero only in e_k and channel k's bands of posenc_orig
    (1 + 2 x 10 of its columns), or in channel k's bands of the trunk's
    encoding (2 x its degrees)."""
    from hypernerf_tpu_torch import kernels as K
    from hypernerf_tpu_torch.kernels.fused_field import field_layers
    from hypernerf_tpu_torch.kernels.fused_se3 import se3_layers
    if trans:
        mlp = field.mlp
        return (lambda x, sc=None: K.fused_warp_jacobian(
                    mlp, 10, x[:, :3], x[:, 3:]).reshape(-1, 9),
                lambda x, g, sc=None: K.fused_jacobian_bwd(mlp, 10, x, g),
                lambda x, sc=None: plain_jacobian(mlp, x),
                lambda x, g, sc=None: plain_jacobian_bwd(mlp, x, g),
                field_layers(mlp), 9, 1 + 2 * 10)
    return (lambda x, sc=None: tangents_of(field, x, sc),
            lambda x, g, sc=None: K.fused_se3_jacobian_bwd(field, x, g, sc),
            lambda x, sc=None: plain_tangents(field, x, sc),
            lambda x, g, sc=None: plain_tangents_bwd(field, x, g, sc),
            se3_layers(field), 24, 2 * (field.max_deg - field.min_deg))


def jacobian_bound(layers, points: int, width: int, backward: bool,
                   trunk: bool, nz: int, bound_of=bound,
                   weight_bytes: int = 2):
    """Rows 14 to 17 (``bound_of``: ``bound`` at bf16, ``f32_bound`` at
    float32): a multiply-add per weight and point in the primal block, and
    in each of the three tangent blocks per weight that meets a nonzero
    input: a tangent row is nonzero in only ``nz`` of the encoding's
    columns, so its products in layer 0 and the skip layer take those
    columns alone. The backward recomputes the four blocks and runs g W
    and t^T g on the tangent blocks (the translation warp: J reaches no
    other) or on all four (the trunk). Bytes: the raw rows (11 fp32), the
    output (``width`` fp32) once, the backward its cotangent and dx too,
    the weights (``weight_bytes`` each) once and the backward's dW
    (fp32)."""
    enc = layers[0][1][0]  # the encoding's input segment
    macs = sum(lin.weight.numel() for lin, _ in layers)
    tan = macs - sum(lin.out_features * (enc[0] - nz) * segs.count(enc)
                     for lin, segs in layers)
    blocks = macs + 3 * tan
    if not backward:
        return bound_of(2.0 * blocks * points,
                        points * (44 + 4 * width) + weight_bytes * macs)
    products = 2 * (blocks if trunk else 3 * tan)
    return bound_of(2.0 * (blocks + products) * points,
                    points * (44 + 4 * width + 44)
                    + (weight_bytes + 4) * macs)


def jacobian_phase(kind: str):
    """Phase 13 (``kind`` 'translation': kernels 14 and 15) or 14 ('se3':
    kernels 16 and 17, with and without a window row; kernels 14 and 16 are
    the level forward's block, 15 and 17 kernel B's, run on the warp field
    or the trunk with its tangent streams, each compiled plan held to
    ``fused_level.stage_plan`` / ``field_bwd_plan('warp_tangents' |
    'se3_tangents', ...)``): against
    the JAX kernels' stored numbers, the 1 % probe of layer 5, the plain
    versions at a ragged size and at the train step's 262,144 points
    (timed). Returns the two kernels' entries."""
    import importlib
    import torch
    from hypernerf_tpu_torch.flagship import (JACOBIAN_CASES, flagship_model,
                                              load_probe_weights,
                                              read_jacobian_reference)
    from hypernerf_tpu_torch.kernels import common
    from hypernerf_tpu_torch.kernels.fused_se3 import se3_encoding_scales
    tag = '[13]' if kind == 'translation' else '[14]'
    trans = kind == 'translation'
    probe = load_probe_weights(flagship_model(
        'cuda', config='elastic' if trans else 'elastic_se3'))
    field = probe.warp_field
    fwd, bwd, plain, plain_bwd, layers, width, nz = jacobian_runs(field,
                                                                  trans)
    if trans:
        mlp = field.mlp
        hidden5 = mlp.hidden(5)
        windows = (None,)
    else:
        hidden5 = field.trunk.hidden(5)
        windows = (None, se3_encoding_scales(field, WINDOW_ALPHA, 'cuda'))
    fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
    plan = 'warp_tangents' if trans else 'se3_tangents'
    shapes = common.pack_layers(mlp if trans else field, layers)[2]
    got = fl.compiled_field_bwd_plan(plan)
    want = fl.field_bwd_plan(plan, shapes)
    if got != want:
        raise AssertionError(f'{plan}: the compiled tangents backward plan '
                             f'is not its model: {got} vs {want}')
    streamed = fl.field_bwd_stream_bytes(plan, shapes, JAC_POINTS)
    phase(f'{tag} tangents backward plan (compiled = model): kernel B\'s '
          f'block, 32 points x 4 streams a block tile, '
          f'{len(got["loads"])} weight loads a block tile; computed from the '
          f'plan, not measured: {streamed:,} bytes of weights streamed from '
          f'L2 at {JAC_POINTS} points')
    got = fl.compiled_stage_plan(plan)
    want = fl.stage_plan(plan, shapes)
    if got != want:
        raise AssertionError(f'{plan}: the compiled tangents forward plan '
                             f'is not its model: {got} vs {want}')
    groups, streams, points = (got['config'][1], got['config'][8],
                               got['config'][9])
    streamed = fl.forward_stream_bytes(shapes, streams * JAC_POINTS, groups)
    phase(f'{tag} tangents forward plan (compiled = model): the level '
          f'forward\'s block, {groups} tiles of {points} points x {streams} '
          f'streams a step, {len(got["loads"])} weight loads a step; '
          f'computed from the plan, not measured: {streamed:,} bytes of '
          f'weights streamed from L2 at {JAC_POINTS} points')
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
        # 1001 points: a multiple of no tile (a step of 48 points
        # forward, a block tile of 32 backward).
        for p in (1001, JAC_POINTS):
            for scales in windows:
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

    # Bounds at the train step's points (jacobian_bound: the tangent
    # blocks' products over their nonzero encoding columns).
    macs = sum(lin.weight.numel() for lin, _ in layers)
    p = JAC_POINTS
    f_ms, f_by = jacobian_bound(layers, p, width, False, not trans, nz)
    b_ms, b_by = jacobian_bound(layers, p, width, True, not trans, nz)
    phase(f'{tag} tangents forward at {p} points: {times["fwd"]:.3f} ms, '
          f'{100 * f_ms / times["fwd"]:.1f} % of its bound {f_ms:.4f} ms; '
          f'{EARLIER_JAC_FWD_MS[kind]:.3f} ms before the redesign (PERF.md)')
    phase(f'{tag} tangents backward at {p} points: {times["bwd"]:.3f} ms, '
          f'{100 * b_ms / times["bwd"]:.1f} % of its bound {b_ms:.4f} ms; '
          f'{EARLIER_JAC_BWD_MS[kind]:.3f} ms before the redesign (PERF.md)')
    src = 'hypernerf_tpu_torch/kernels/csrc/'
    stem = 'fused_jacobian' if trans else 'fused_se3_jacobian'
    fwd_line, bwd_line = (269, 302) if trans else (286, 331)
    pallas = f'hypernerf_tpu/ops/pallas/{stem}.py'
    fwd_src = ', '.join(src + f for f in TANGENTS_FWD_SOURCES)
    bwd_src = ', '.join(src + f for f in (
        WARP_TANGENTS_BWD_SOURCES if trans else SE3_TANGENTS_BWD_SOURCES))
    return [
        dict(name=f'{stem}_fwd', route='cuda', source=fwd_src,
             replaces=f'{pallas}:{fwd_line}',
             **error_keys(errs['fwd'], JAC_L2), ms=times['fwd'],
             plain_ms=times['plain_fwd'], bound_ms=f_ms, bound_by=f_by,
             library_ms=None, shape=f'P={p}', macs_per_row=macs),
        dict(name=f'{stem}_bwd', route='cuda', source=bwd_src,
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
    global CARD
    CARD = smi
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
    seconds = sorted(build.nvcc_seconds(build.build_log()).items(),
                     key=lambda kv: -kv[1])
    phase(f'[2] nvcc seconds from the start of the build, one process per '
          f'source, all started together: '
          f'{", ".join(f"{n} {t:.1f}" for n, t in seconds)}')
    phase(f'[2] level forward (consumers raise their registers to 232 with '
          f'setmaxnreg): '
          f'{ptxas_lines(build.build_log(), LEVEL_FWD_SOURCES)}')
    phase(f'[2] fields backward, kernel B (the same): '
          f'{ptxas_lines(build.build_log(), FIELDS_BWD_SOURCES)}')
    phase(f'[2] per-module forwards (the same): '
          f'{ptxas_lines(build.build_log(), MODULAR_FWD_SOURCES)}')
    phase(f'[2] a field alone backward, on kernel B\'s block (the same): '
          f'{ptxas_lines(build.build_log(), FIELD_BWD_SOURCES)}')
    tangents = (SE3_BWD_SOURCES[:1] + SE3_TANGENTS_BWD_SOURCES[:1]
                + WARP_TANGENTS_BWD_SOURCES[:1])
    phase(f'[2] the SE(3) trunk alone backward, its tangents\' backward and '
          f'the translation Jacobian\'s backward, on kernel B\'s block (the '
          f'same): {ptxas_lines(build.build_log(), tangents)}')
    phase(f'[2] the Jacobians\' forwards, on the level forward\'s block (the '
          f'same): {ptxas_lines(build.build_log(), TANGENTS_FWD_SOURCES)}')
    phase(f'[2] the plane configuration\'s level forward, template alone '
          f'and kernel B (the same): '
          f'{ptxas_lines(build.build_log(), PLANE_SOURCES)}')
    phase(f'[2] the B.4 combinations\' level forwards, the Nerfies plane '
          f'template alone and kernel B without the sheet (the same): '
          f'{ptxas_lines(build.build_log(), B4_SOURCES)}')

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
                composite_kernel_ms(packed, z, dirs, u),
                cuda_ms(lambda: fused_composite_plain(packed, z, dirs, u)),
                cuda_ms(lambda: fused_composite(packed, z, dirs, u)))
            before = (f'; {EARLIER_COMPOSITE_MS:.3f} ms before the redesign '
                      f'(PERF.md)' if n else '')
            phase(f'[4] composite R={CHUNK} S={s} N={n}: kernel '
                  f'{ctimes[s][0]:.4f} ms, plain {ctimes[s][1]:.3f} ms, '
                  f'through the wrapper {ctimes[s][2]:.3f} ms{before}')
        b_ms, b_by = composite_fwd_bound(CHUNK, 64, 64)
        kernels.append(dict(
            name='fused_composite_fwd', route='cuda',
            source='hypernerf_tpu_torch/kernels/csrc/fused_composite.cu',
            replaces='hypernerf_tpu/ops/pallas/fused_composite.py:437',
            max_abs_err=max(errs), ms=ctimes[64][0],
            plain_ms=ctimes[64][1], bound_ms=b_ms, bound_by=b_by,
            library_ms=None, wrapper_ms=ctimes[64][2],
            ms_s128_n0=ctimes[128][0], plain_ms_s128_n0=ctimes[128][1]))

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
    anneal_kernel_phase(kernels)
    anneal_paths_phase(kernels)
    kernels += plane_kernel_phase(kernels)
    plane_paths_phase(kernels)
    occupancy_paths_phase(kernels)
    trainer_phase(kernels)
    condition_kernel_phase(kernels)
    condition_paths_phase(kernels)
    kernels += b4_kernel_phase(kernels)
    b4_paths_phase(kernels)
    data_parallel_phase()
    call_options_phase()
    fine128_phase(kernels)
    bench_phase()
    kernels += precision32_phase(kernels)
    kernels += precision32_modular_phase(kernels)
    kernels += precision32_screw_phase(kernels)
    kernels += precision32_nerfies_phase(kernels)
    kernels += precision32_plane_phase(kernels)
    kernels += precision32_jacobian_phase(kernels)
    if len(kernels) != 52:
        raise AssertionError(f'{len(kernels)} kernels in the line, want 52')
    phase(f'[24] chip_smoke.py: every phase passed in '
          f'{time.perf_counter() - T_START:.1f} s, the build included; '
          f'{CARD}')
    return finish(kernels)

# -- the anneal configuration (the Nerfies windowed template encoding) --------

# Launches per frame chunk and level on ``anneal``'s paths: the level
# kernels, or with ``return_points`` the per-module kernels (warp field and
# sheet, then the template).
STEP_LAUNCHES['anneal'] = STEP_LAUNCHES['flagship']
# Runs of the anneal level's backward against the stored JAX gradients.
ANNEAL_GRAD_RUNS = 3


def anneal_level_inputs(n_rays: int, samples: int, seed: int, nerf_alpha):
    """``level_inputs`` with the Nerfies condition (27 columns)."""
    import torch
    from hypernerf_tpu_torch.flagship import anneal_condition
    args = level_inputs(n_rays, samples, seed)
    args[4] = torch.from_numpy(anneal_condition(
        args[2].cpu().numpy(), nerf_alpha)).cuda()
    return args


def anneal_kernel_phase(kernels) -> None:
    """Phase 19's kernel checks, on the ``anneal`` configuration's probe
    weights at the alphas of ``flagship.ANNEAL_PROBE_STEP`` (hyper_alpha
    1.5 of 4 bands): the level forward (row 1), the template alone (row 8)
    and kernel A (row 9) at the Nerfies layout against the JAX kernels'
    stored numbers (outputs and gradients, kernel B chained as training
    runs it) and against their plain versions up to the render's and the
    train step's shapes, each timed beside the flagship layout's in the same
    call; adds those times to the entries of ``kernels``."""
    import torch
    from hypernerf_tpu_torch import kernels as K
    from hypernerf_tpu_torch.flagship import (ANNEAL_LEVEL_CASES,
                                              ANNEAL_TEMPLATE_CASES,
                                              LEVEL_INPUTS,
                                              anneal_extra_params,
                                              flagship_model,
                                              load_probe_weights,
                                              read_anneal_reference)
    from hypernerf_tpu_torch.kernels import common
    from hypernerf_tpu_torch.kernels.fused_level import (_launch_forward,
                                                         _level_params)
    from hypernerf_tpu_torch.kernels.fused_mlp import (template_layers,
                                                       template_scales)
    probe = load_probe_weights(flagship_model('cuda', config='anneal'))
    flag = load_probe_weights(flagship_model('cuda'))
    ep = anneal_extra_params()

    def scales(level, hyper_alpha=ep['hyper_alpha']):
        return template_scales(probe.template_of(level), ep['nerf_alpha'],
                               hyper_alpha, 'cuda')

    # The JAX kernels' numbers (tools/make_level_reference.py): the CUDA
    # kernels through their autograd Functions, as training runs them. The
    # level's backward runs ANNEAL_GRAD_RUNS times on each draw of inputs:
    # kernel B adds its dW with atomics, whose order varies from run to run.
    ref = read_anneal_reference()
    for case, (level, *_) in ANNEAL_LEVEL_CASES.items():
        arrays = {k: torch.from_numpy(v).cuda() for k, v in ref[case].items()}
        lv = probe.level(level)
        names = [f'd_{k}' for k in LEVEL_INPUTS] + [
            f'd{"wb"[i % 2]}{i // 2}' for i in range(60)]
        for run in range(ANNEAL_GRAD_RUNS):
            args = [arrays[k].detach().requires_grad_() for k in LEVEL_INPUTS]
            out = K.fused_level(lv, *args, None, scales(level))
            hold_level(out.detach(), arrays['out'],
                       f'anneal {case} vs the stored JAX output', '[19]')
            got = torch.autograd.grad(out, args + _level_params(lv),
                                      arrays['cotangent'])
            check_grads(f'anneal {case} backward (A + B), run {run + 1} of '
                        f'{ANNEAL_GRAD_RUNS}, vs the stored JAX gradients',
                        names, got, [arrays[n] for n in names], tag='[19]')
    for case, (level, *_) in ANNEAL_TEMPLATE_CASES.items():
        arrays = {k: torch.from_numpy(v).cuda() for k, v in ref[case].items()}
        t = probe.template_of(level)
        x = arrays['x_raw'].requires_grad_()
        cond = arrays['rgb_cond'].requires_grad_()
        out = K.fused_template(t, x, cond, scales(level))
        hold_level(out.detach(), arrays['out'],
                   f'anneal {case} (row 8) vs the stored JAX output', '[19]')
        layers = template_layers(t.template)
        got = torch.autograd.grad(out, [x, cond] + common.layer_params(
            layers), arrays['cotangent'])
        names = ['dx', 'd_rgb_cond'] + [f'd{"wb"[i % 2]}{i // 2}'
                                        for i in range(2 * len(layers))]
        check_grads(f'anneal {case} backward (A) vs the stored JAX '
                    f'gradients', names, got, [arrays[n] for n in names],
                    tag='[19]')

    errs = {'fwd': [], 'tmpl': [], 'A': []}
    times = {}
    with torch.no_grad():
        # The window is seen: the hyper bands' weights move the level's
        # output by more than the tolerance between hyper_alpha 1.5 and 2.5.
        args = anneal_level_inputs(512, 64, 0, ep['nerf_alpha'])
        lv = probe.level('coarse')
        moved = (plain_forward(lv, args, tmpl_scales=scales('coarse', 2.5))[0]
                 - plain_forward(lv, args, tmpl_scales=scales('coarse'))[0]
                 ).abs()
        phase(f'[19] probe: hyper_alpha 1.5 -> 2.5 moves the plain level by '
              f'max {moved.max():.3e} mean {moved.mean():.3e} (the check '
              f'allows {LEVEL_ATOL} + {LEVEL_RTOL}|want|, mean {LEVEL_MEAN})')
        if not moved.mean() > LEVEL_MEAN:
            raise AssertionError('the anneal check cannot see the window')

        gen = torch.Generator().manual_seed(19)
        for r, s in ((37, 13), (512, 64), (512, 128), (CHUNK, 64),
                     (CHUNK, 128), (TRAIN_RAYS, 128)):
            level = 'fine' if s == 128 else 'coarse'
            lv, sc = probe.level(level), scales(level)
            args = anneal_level_inputs(r, s, s + 3, ep['nerf_alpha'])
            g = torch.randn(r * s, 4, generator=gen).cuda()
            out, raw_t = _launch_forward(lv, *args, want_raw_t=True,
                                         tmpl_scales=sc)
            want_out, want_raw_t = plain_forward(lv, args, tmpl_scales=sc)
            errs['fwd'] += [
                hold_level(out, want_out, f'anneal level forward R={r} '
                           f'S={s} vs plain: out', '[19]'),
                hold_level(raw_t, want_raw_t, f'anneal level forward R={r} '
                           f'S={s} vs plain: raw_t', '[19]')]
            x = raw_t
            errs['tmpl'].append(hold_level(
                K.fused_template(lv, x, args[4], sc),
                plain_template(lv, x, args[4], sc),
                f'anneal template alone (row 8) R={r} S={s} vs plain',
                '[19]'))
            if r == CHUNK or r < 100:
                dx_t, d_cond, grads, _ = K.fused_template_bwd(
                    lv, x, args[4], g, sc)
                torch.cuda.synchronize()
                errs['A'].append(check_grads(
                    f'anneal template backward (A) R={r} S={s} vs plain',
                    TEMPLATE_GRAD_NAMES, [dx_t, d_cond, *grads],
                    plain_template_bwd(lv, x, args[4], g, sc), tag='[19]'))
                del dx_t, d_cond, grads
            if r == CHUNK:
                # Each layout's level forward and template alone, in turns.
                fl = flag.level(level)
                fargs = level_inputs(r, s, s + 3)
                times['fwd', s] = [
                    cuda_ms(lambda: K.fused_level(lv, *args, None, sc)),
                    cuda_ms(lambda: K.fused_level(fl, *fargs)),
                    cuda_ms(lambda: K.fused_level(fl, *fargs)),
                    cuda_ms(lambda: K.fused_level(lv, *args, None, sc))]
                times['tmpl', s] = [
                    cuda_ms(lambda: K.fused_template(lv, x, args[4], sc)),
                    cuda_ms(lambda: K.fused_template(fl, x, fargs[4])),
                    cuda_ms(lambda: K.fused_template(fl, x, fargs[4])),
                    cuda_ms(lambda: K.fused_template(lv, x, args[4], sc))]
                for key, what in (('fwd', 'level forward'),
                                  ('tmpl', 'template alone (row 8)')):
                    t = times[key, s]
                    b_ms = (level_bound(lv, r, s)[0] if key == 'fwd' else
                            template_fwd_bound(lv, r, s)[0])
                    times[key, s].append(b_ms)
                    phase(f'[19] anneal {what} R={r} S={s}: {t[0]:.3f}, '
                          f'{t[3]:.3f} ms ({b_ms / t[0]:.1%} of its bound '
                          f'{b_ms:.3f} ms); the flagship layout in turns '
                          f'{t[1]:.3f}, {t[2]:.3f} ms')
            if r == TRAIN_RAYS:
                fl = flag.level(level)
                fargs = level_inputs(r, s, s + 3)
                fraw = _launch_forward(fl, *fargs, want_raw_t=True)[1]
                times['A'] = [
                    cuda_ms(lambda: K.fused_template_bwd(lv, x, args[4], g,
                                                         sc), 3),
                    cuda_ms(lambda: K.fused_template_bwd(fl, fraw, fargs[4],
                                                         g), 3),
                    cuda_ms(lambda: K.fused_template_bwd(fl, fraw, fargs[4],
                                                         g), 3),
                    cuda_ms(lambda: K.fused_template_bwd(lv, x, args[4], g,
                                                         sc), 3),
                    template_bwd_bound(lv, r, s)[0]]
                t = times['A']
                phase(f'[19] anneal template backward (A) R={r} S={s}: '
                      f'{t[0]:.2f}, {t[3]:.2f} ms ({t[4] / t[0]:.1%} of its '
                      f'bound {t[4]:.3f} ms); the flagship layout in turns '
                      f'{t[1]:.2f}, {t[2]:.2f} ms')
                del fraw
            del out, raw_t, want_out, want_raw_t, x, g
            torch.cuda.empty_cache()
    for k in kernels:
        if k['name'] == 'fused_level_fwd':
            k.update(anneal_ms=times['fwd', 128][0],
                     anneal_ms_s64=times['fwd', 64][0],
                     anneal_bound_ms=times['fwd', 128][4],
                     anneal_max_abs_err=max(errs['fwd']))
        elif k['name'] == 'fused_template_fwd':
            k.update(anneal_ms=times['tmpl', 128][0],
                     anneal_ms_s64=times['tmpl', 64][0],
                     anneal_bound_ms=times['tmpl', 128][4],
                     anneal_max_abs_err=max(errs['tmpl']))
        elif k['name'] == 'fused_template_bwd':
            k.update(anneal_ms=times['A'][0], anneal_bound_ms=times['A'][4],
                     anneal_rel_l2_err=max(e[0] for e in errs['A']))


def template_fwd_bound(level, n_rays: int, samples: int, raw: int = 8,
                       cond: int = 39):
    """(bound_ms, bound_by) of the template alone on n_rays x samples rows:
    one multiply-add per weight and row (the alpha head's condition columns
    included); bytes are the raw rows (``raw`` fp32 columns) and the output
    per row, the ``cond`` bf16 condition columns per ray and the weights
    once."""
    t_macs = level_macs(level)[1]
    p = n_rays * samples
    return bound(2.0 * t_macs * p,
                 p * (4 * raw + 16) + n_rays * 2 * cond + 2 * t_macs)


def anneal_paths_phase(kernels) -> None:
    """Phases 19 (the frames) and 20: ``anneal`` at full width. Three
    504x378 frames through the level kernels after a warm-up, at the alphas
    ``eval`` renders a weight file at (fully annealed), a render of 1024
    rays against the plain versions, one frame with ``return_points`` (the
    per-module kernels: warp field, sheet, template alone), and the train
    step at batch 16384 from ``flagship.ANNEAL_PROBE_STEP`` (hyper_alpha
    1.5); fills in the launches of the kernels' entries."""
    import torch
    from hypernerf_tpu_torch.configs import TrainConfig
    from hypernerf_tpu_torch.eval import eval_extra_params
    from hypernerf_tpu_torch.flagship import H, W, flagship_model, spiral_rays
    from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
    from hypernerf_tpu_torch.training.renderer import ImageRenderer
    chunks_per_frame = -(-W * H // CHUNK)
    frames = spiral_rays(range(0, 30 * (N_FRAMES + 1), 30))
    model = flagship_model('cuda', seed=0, config='anneal')
    extra = eval_extra_params(model.config, TrainConfig())
    keep = ('rgb', 'depth', 'acc')
    renderer = ImageRenderer(model, chunk=CHUNK, keep=keep, levels=('fine',),
                             quantize=True, extra_params=extra)
    counts = {}
    secs, counts['frame'] = time_frames(
        renderer, frames, keep,
        {'fused_level_fwd': 2 * chunks_per_frame,
         'fused_composite_fwd': 2 * chunks_per_frame}, 'anneal frame')
    phase(f'[19] anneal: rendered {N_FRAMES} frames {W}x{H} (64+64, chunk '
          f'{CHUNK}, alphas {extra}): {secs:.4f} s/frame; launches '
          f'{counts["frame"]} (= 2 levels x {chunks_per_frame} chunks x '
          f'{N_FRAMES} frames); no plain call')
    small = torch.as_tensor(frames[0][::186][:1024]).cuda()
    with torch.no_grad():
        got = model(prepare_ray_dict(small),
                    extra_params=extra)['fine']['rgb']
        with plain_versions():
            want = model(prepare_ray_dict(small),
                         extra_params=extra)['fine']['rgb']
    diff = (got - want).abs()
    phase(f'[19] anneal render of 1024 rays, kernels vs plain: fine rgb '
          f'max|d| {diff.max().item():.3e} mean {diff.mean().item():.3e} '
          f'(tol {RENDER_ATOL}, mean {RENDER_MEAN})')
    if not torch.isfinite(got).all() or diff.max() > RENDER_ATOL \
            or diff.mean() > RENDER_MEAN:
        raise AssertionError('anneal render: kernels and plain versions '
                             'disagree')
    keep = keep + ('med_points',)
    renderer = ImageRenderer(model, chunk=CHUNK, keep=keep, levels=('fine',),
                             quantize=True, extra_params=extra)
    secs, counts['points'] = time_frames(
        renderer, frames[:2], keep,
        {'fused_template_fwd': 2 * chunks_per_frame,
         'fused_field_fwd': 4 * chunks_per_frame},
        'anneal return_points frame')
    phase(f'[19] anneal with return_points: 1 frame {W}x{H} after a '
          f'warm-up: {secs:.4f} s; launches {counts["points"]} (= 2 levels x '
          f'{chunks_per_frame} chunks, x 2 fields); no level kernel, no '
          f'plain call')
    del renderer, model
    torch.cuda.empty_cache()
    counts['train'] = train_path('anneal', '[20]')
    torch.cuda.empty_cache()
    for k in kernels:
        for path, launches in counts.items():
            if launches.get(k['name']):
                k[f'anneal_{path}_launches'] = launches[k['name']]


# -- the plane configuration (axis_aligned_plane slicing) --------------------

# Its kernels' sources: the level forward, the template alone and kernel B
# instantiated for the plane layout (no sheet, the GLO embedding as the hyper
# coordinates, a 192-column encoding); kernel A's passes take its widths.
PLANE_FWD_SOURCES = ('level_fwd_plane.cu', 'level_fwd.cuh', 'fused_level.cu')
PLANE_TMPL_SOURCES = ('template_fwd_plane.cu', 'template_fwd.cuh')
PLANE_B_SOURCES = ('fields_bwd_plane.cu', 'fields_bwd.cuh', 'fused_level.cu')
PLANE_SOURCES = ('level_fwd_plane.cu', 'template_fwd_plane.cu',
                 'fields_bwd_plane.cu')
STEP_LAUNCHES['plane'] = STEP_LAUNCHES['flagship']
# ``plane`` with two GLO tables: module by module, the warp field and the
# template alone at the plane layout (rows 10, 8; in training 11 and A).
STEP_LAUNCHES['plane_split_glo'] = {
    'fused_field_fwd': 2, 'fused_field_bwd': 2, 'fused_template_fwd': 2,
    'fused_template_bwd': 2}
PATHS['plane_split_glo'] = ('plane', dict(share_glo=False))
PLANE_GRAD_RUNS = 2  # runs of the level's backward against the stored JAX
PLANE_RAW = 16  # fp32 columns of the plane layout's raw_t and dx_t


def plane_kernel_phase(kernels) -> list:
    """Phase 21's kernel checks on the ``plane`` configuration's probe
    weights: the compiled plans of the level forward (row 1), the template
    alone (row 8) and kernel B (row 5) at the plane layout against their
    models in ``kernels/fused_level.py``; rows 1, 8, 9 (kernel A) and 5
    against the JAX kernels' stored numbers (the level's backward as
    training runs it, A then B) and against their plain versions up to the
    render's and the train step's shapes; each timed beside the flagship
    layout's kernel in the same call, in turns. Returns the four plane
    kernels' entries of the kernels line (launches filled in by the paths
    phase)."""
    import importlib
    import torch
    from hypernerf_tpu_torch import kernels as K
    from hypernerf_tpu_torch.flagship import (LEVEL_INPUTS, PLANE_LEVEL_CASES,
                                              PLANE_TEMPLATE_CASES,
                                              flagship_model,
                                              load_probe_weights,
                                              read_plane_reference)
    from hypernerf_tpu_torch.kernels import common
    fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
    from hypernerf_tpu_torch.kernels.fused_mlp import template_layers
    probe = load_probe_weights(flagship_model('cuda', config='plane'))
    flag = load_probe_weights(flagship_model('cuda'))
    shapes = fl.pack_level(probe.level('fine'))[2]
    for label, got, want in (
            ('level forward (row 1)', fl.compiled_forward_plan('plane'),
             fl.forward_plan('plane', shapes)),
            ('template alone (row 8)',
             fl.compiled_stage_plan('template_plane'),
             fl.stage_plan('template_plane',
                           shapes[common.PLANE_TEMPLATE_LAYERS])),
            ('kernel B (row 5)', fl.compiled_fields_bwd_plan('plane'),
             fl.fields_bwd_plan('plane', shapes))):
        if got != want:
            raise AssertionError(f'plane {label}: compiled plan {got} != '
                                 f'model {want}')
        phase(f'[21] plane {label} plan (compiled = model): config '
              f'{got["config"]}, {len(got["loads"])} weight loads a tile')

    # The JAX kernels' numbers (tools/make_level_reference.py --only
    # plane): the kernels through their autograd Functions, as training
    # runs them. Kernel B adds its dW with atomics, whose order varies from
    # run to run: PLANE_GRAD_RUNS runs of each draw.
    ref = read_plane_reference()
    names = [f'd_{k}' for k in LEVEL_INPUTS] + [
        f'd{"wb"[i % 2]}{i // 2}' for i in range(2 * len(shapes))]
    errs = {'fwd': [], 'tmpl': [], 'A': [], 'B': []}
    for case, (level, *_) in PLANE_LEVEL_CASES.items():
        arrays = {k: torch.from_numpy(v).cuda() for k, v in ref[case].items()}
        lv = probe.level(level)
        for run in range(PLANE_GRAD_RUNS):
            args = [arrays[k].detach().requires_grad_() for k in LEVEL_INPUTS]
            out = K.fused_level(lv, *args)
            errs['fwd'].append(hold_level(
                out.detach(), arrays['out'],
                f'plane {case} vs the stored JAX output', '[21]'))
            got = torch.autograd.grad(out, args + fl._level_params(lv),
                                      arrays['cotangent'])
            check_grads(f'plane {case} backward (A + B), run {run + 1} of '
                        f'{PLANE_GRAD_RUNS}, vs the stored JAX gradients',
                        names, got, [arrays[n] for n in names], tag='[21]')
    for case, (level, *_) in PLANE_TEMPLATE_CASES.items():
        arrays = {k: torch.from_numpy(v).cuda() for k, v in ref[case].items()}
        t = probe.template_of(level)
        x = arrays['x_raw'].requires_grad_()
        cond = arrays['rgb_cond'].requires_grad_()
        out = K.fused_template(t, x, cond)
        hold_level(out.detach(), arrays['out'],
                   f'plane {case} (row 8) vs the stored JAX output', '[21]')
        layers = template_layers(t.template)
        got = torch.autograd.grad(out, [x, cond] + common.layer_params(
            layers), arrays['cotangent'])
        tnames = ['dx', 'd_rgb_cond'] + [f'd{"wb"[i % 2]}{i // 2}'
                                         for i in range(2 * len(layers))]
        check_grads(f'plane {case} backward (A) vs the stored JAX '
                    f'gradients', tnames, got, [arrays[n] for n in tnames],
                    tag='[21]')

    times, bounds = {}, {}
    b_names = FIELDS_GRAD_NAMES[:4] + [f'd{"Wb"[i % 2]}{i // 2}'
                                       for i in range(14)]
    with torch.no_grad():
        gen = torch.Generator().manual_seed(21)
        for r, s in ((37, 13), (512, 64), (512, 128), (CHUNK, 64),
                     (CHUNK, 128), (TRAIN_RAYS, 64), (TRAIN_RAYS, 128)):
            level = 'fine' if s == 128 else 'coarse'
            lv, flv = probe.level(level), flag.level(level)
            args = level_inputs(r, s, s + 21)
            out, raw_t = fl._launch_forward(lv, *args, want_raw_t=True)
            want_out, want_raw_t = plain_forward(lv, args)
            errs['fwd'] += [
                hold_level(out, want_out, f'plane level forward R={r} S={s} '
                           f'vs plain: out', '[21]'),
                hold_level(raw_t, want_raw_t, f'plane level forward R={r} '
                           f'S={s} vs plain: raw_t', '[21]')]
            x = raw_t
            if r <= CHUNK:
                errs['tmpl'].append(hold_level(
                    K.fused_template(lv, x, args[4]),
                    plain_template(lv, x, args[4]),
                    f'plane template alone (row 8) R={r} S={s} vs plain',
                    '[21]'))
            g = torch.randn(r * s, 4, generator=gen).cuda()
            dx_t = torch.randn(r * s, PLANE_RAW, generator=gen).cuda()
            dx_t[:, 3 + 8:] = 0
            if r == CHUNK or r < 100:
                got_a = K.fused_template_bwd(lv, x, args[4], g)
                torch.cuda.synchronize()
                errs['A'].append(check_grads(
                    f'plane template backward (A) R={r} S={s} vs plain',
                    TEMPLATE_GRAD_NAMES, [got_a[0], got_a[1], *got_a[2]],
                    plain_template_bwd(lv, x, args[4], g), tag='[21]'))
                *rays, grads = K.fused_fields_bwd(lv, *args[:4], dx_t)
                errs['B'].append(check_grads(
                    f'plane fields backward (B) R={r} S={s} vs plain',
                    b_names, [*rays, *grads],
                    plain_fields_bwd(lv, args, dx_t), tag='[21]'))
                del got_a, rays, grads
            if r == CHUNK:
                # Each layout's level forward and template alone, in turns.
                fargs = level_inputs(r, s, s + 21)
                fraw = fl._launch_forward(flv, *fargs, want_raw_t=True)[1]
                times['fwd', s] = [
                    cuda_ms(lambda: K.fused_level(lv, *args)),
                    cuda_ms(lambda: K.fused_level(flv, *fargs)),
                    cuda_ms(lambda: K.fused_level(flv, *fargs)),
                    cuda_ms(lambda: K.fused_level(lv, *args))]
                times['tmpl', s] = [
                    cuda_ms(lambda: K.fused_template(lv, x, args[4])),
                    cuda_ms(lambda: K.fused_template(flv, fraw, fargs[4])),
                    cuda_ms(lambda: K.fused_template(flv, fraw, fargs[4])),
                    cuda_ms(lambda: K.fused_template(lv, x, args[4]))]
                times['plain_fwd', s] = cuda_ms(
                    lambda: plain_forward(lv, args), 2)
                times['plain_tmpl', s] = cuda_ms(
                    lambda: plain_template(lv, x, args[4]), 2)
                bounds['fwd', s] = level_bound(lv, r, s)
                bounds['tmpl', s] = template_fwd_bound(lv, r, s, PLANE_RAW)
                for key, what in (('fwd', 'level forward (row 1)'),
                                  ('tmpl', 'template alone (row 8)')):
                    t, b_ms = times[key, s], bounds[key, s][0]
                    phase(f'[21] plane {what} R={r} S={s}: {t[0]:.3f}, '
                          f'{t[3]:.3f} ms ({b_ms / t[0]:.1%} of its bound '
                          f'{b_ms:.3f} ms); the flagship layout in turns '
                          f'{t[1]:.3f}, {t[2]:.3f} ms; plain '
                          f'{times["plain_" + key, s]:.2f} ms')
                del fraw
            if r == TRAIN_RAYS:
                fargs = level_inputs(r, s, s + 21)
                fraw = fl._launch_forward(flv, *fargs, want_raw_t=True)[1]
                fdx = dx_t[:, :8].contiguous()
                fdx[:, 7] = 0
                times['B', s] = [
                    cuda_ms(lambda: K.fused_fields_bwd(lv, *args[:4], dx_t),
                            5),
                    cuda_ms(lambda: K.fused_fields_bwd(flv, *fargs[:4], fdx),
                            5),
                    cuda_ms(lambda: K.fused_fields_bwd(flv, *fargs[:4], fdx),
                            5),
                    cuda_ms(lambda: K.fused_fields_bwd(lv, *args[:4], dx_t),
                            5)]
                bounds['B', s] = fields_bwd_bound(lv, r, s, PLANE_RAW)
                if s == 128:
                    times['A'] = [
                        cuda_ms(lambda: K.fused_template_bwd(lv, x, args[4],
                                                             g), 3),
                        cuda_ms(lambda: K.fused_template_bwd(flv, fraw,
                                                             fargs[4], g), 3),
                        cuda_ms(lambda: K.fused_template_bwd(flv, fraw,
                                                             fargs[4], g), 3),
                        cuda_ms(lambda: K.fused_template_bwd(lv, x, args[4],
                                                             g), 3)]
                    bounds['A'] = template_bwd_bound(lv, r, s, PLANE_RAW)
                    times['plain_A'] = cuda_ms(
                        lambda: plain_template_bwd(lv, x, args[4], g), 1)
                    times['plain_B'] = cuda_ms(
                        lambda: plain_fields_bwd(lv, args, dx_t), 1)
                    t, b_ms = times['A'], bounds['A'][0]
                    phase(f'[21] plane template backward (A, row 9) R={r} '
                          f'S={s}: {t[0]:.2f}, {t[3]:.2f} ms '
                          f'({b_ms / t[0]:.1%} of its bound {b_ms:.3f} ms); '
                          f'the flagship layout in turns {t[1]:.2f}, '
                          f'{t[2]:.2f} ms; plain {times["plain_A"]:.1f} ms')
                t, b_ms = times['B', s], bounds['B', s][0]
                phase(f'[21] plane fields backward (B, row 5) R={r} S={s}: '
                      f'{t[0]:.3f}, {t[3]:.3f} ms ({b_ms / t[0]:.1%} of its '
                      f'bound {b_ms:.3f} ms); the flagship\'s kernel B in '
                      f'turns {t[1]:.3f}, {t[2]:.3f} ms'
                      + (f'; plain {times["plain_B"]:.1f} ms' if s == 128
                         else ''))
                del fraw, fdx
            del out, raw_t, want_out, want_raw_t, x, g, dx_t
            torch.cuda.empty_cache()
    csrc = 'hypernerf_tpu_torch/kernels/csrc/'

    def entry(name, sources, replaces, key, plain, err, **extra):
        t, (b_ms, b_by) = times[key], bounds[key]
        return dict(name=name, route='cuda',
                    source=', '.join(csrc + f for f in sources),
                    replaces=replaces, ms=min(t[0], t[3]),
                    plain_ms=times[plain], bound_ms=b_ms, bound_by=b_by,
                    library_ms=None, flagship_layout_ms=min(t[1], t[2]),
                    **err, **extra)
    return [
        entry('fused_level_fwd_plane', PLANE_FWD_SOURCES,
              'hypernerf_tpu/ops/pallas/fused_level.py:1322', ('fwd', 128),
              ('plain_fwd', 128), dict(max_abs_err=max(errs['fwd'])),
              ms_s64=min(times['fwd', 64][0], times['fwd', 64][3])),
        entry('fused_template_fwd_plane', PLANE_TMPL_SOURCES,
              'hypernerf_tpu/ops/pallas/fused_mlp.py:656', ('tmpl', 128),
              ('plain_tmpl', 128), dict(max_abs_err=max(errs['tmpl'])),
              ms_s64=min(times['tmpl', 64][0], times['tmpl', 64][3])),
        entry('fused_template_bwd_plane', TEMPLATE_BWD_SOURCES,
              'hypernerf_tpu/ops/pallas/fused_mlp.py:736', 'A', 'plain_A',
              error_keys(errs['A'])),
        entry('fused_fields_bwd_plane', PLANE_B_SOURCES,
              'hypernerf_tpu/ops/pallas/fused_level.py:846', ('B', 128),
              'plain_B', error_keys(errs['B']),
              ms_s64=min(times['B', 64][0], times['B', 64][3]))]


# The wrapper whose launches count each plane kernel on its paths.
PLANE_WRAPPERS = {'fused_level_fwd_plane': 'fused_level_fwd',
                  'fused_template_fwd_plane': 'fused_template_fwd',
                  'fused_template_bwd_plane': 'fused_template_bwd',
                  'fused_fields_bwd_plane': 'fused_fields_bwd'}


def plane_paths_phase(kernels) -> None:
    """Phases 21 (the frames) and 22: ``plane`` at full width. Three
    504x378 frames through the level kernels after a warm-up, a render of
    1024 rays against the plain versions, one frame with ``return_points``
    (the per-module kernels: the warp field alone, the template alone at the
    plane layout), ``query_sigma`` (the same two), and the train step at
    batch 16384 as phase 7 runs it, with one GLO table (the level kernels)
    and with two (module by module); fills in the launches of the plane
    kernels' entries (each path's counts set to 0 just before it and read
    just after)."""
    import torch
    from hypernerf_tpu_torch.flagship import H, W, flagship_model, spiral_rays
    from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
    from hypernerf_tpu_torch.training.renderer import ImageRenderer
    chunks_per_frame = -(-W * H // CHUNK)
    frames = spiral_rays(range(0, 30 * (N_FRAMES + 1), 30))
    model = flagship_model('cuda', seed=0, config='plane')
    keep = ('rgb', 'depth', 'acc')
    counts = {}
    renderer = ImageRenderer(model, chunk=CHUNK, keep=keep, levels=('fine',),
                             quantize=True)
    secs, counts['frame'] = time_frames(
        renderer, frames, keep,
        {'fused_level_fwd': 2 * chunks_per_frame,
         'fused_composite_fwd': 2 * chunks_per_frame}, 'plane frame')
    phase(f'[21] plane: rendered {N_FRAMES} frames {W}x{H} (64+64, chunk '
          f'{CHUNK}): {secs:.4f} s/frame; launches {counts["frame"]} (= 2 '
          f'levels x {chunks_per_frame} chunks x {N_FRAMES} frames); no '
          f'plain call')
    flag_secs = time_frames(
        ImageRenderer(flagship_model('cuda', seed=0), chunk=CHUNK, keep=keep,
                      levels=('fine',), quantize=True), frames, keep,
        {'fused_level_fwd': 2 * chunks_per_frame,
         'fused_composite_fwd': 2 * chunks_per_frame}, 'flagship frame')[0]
    phase(f'[21] the flagship\'s frames in the same call, after the '
          f'plane\'s: {flag_secs:.4f} s/frame')
    small = torch.as_tensor(frames[0][::186][:1024]).cuda()
    with torch.no_grad():
        got = model(prepare_ray_dict(small))['fine']['rgb']
        with plain_versions():
            want = model(prepare_ray_dict(small))['fine']['rgb']
    diff = (got - want).abs()
    phase(f'[21] plane render of 1024 rays, kernels vs plain: fine rgb '
          f'max|d| {diff.max().item():.3e} mean {diff.mean().item():.3e} '
          f'(tol {RENDER_ATOL}, mean {RENDER_MEAN})')
    if not torch.isfinite(got).all() or diff.max() > RENDER_ATOL \
            or diff.mean() > RENDER_MEAN:
        raise AssertionError('plane render: kernels and plain versions '
                             'disagree')
    keep = keep + ('med_points',)
    renderer = ImageRenderer(model, chunk=CHUNK, keep=keep, levels=('fine',),
                             quantize=True)
    secs, counts['points'] = time_frames(
        renderer, frames[:2], keep,
        {'fused_template_fwd': 2 * chunks_per_frame,
         'fused_field_fwd': 2 * chunks_per_frame},
        'plane return_points frame', point_ch=11)
    phase(f'[21] plane with return_points: 1 frame {W}x{H} after a warm-up: '
          f'{secs:.4f} s; launches {counts["points"]} (= 2 levels x '
          f'{chunks_per_frame} chunks: the warp field alone and the template '
          f'alone; no sheet); no level kernel, no plain call')
    del renderer, model
    torch.cuda.empty_cache()
    counts['query'] = query_sigma_path(
        'plane', {'fused_field_fwd': 1, 'fused_template_fwd': 1}, '[21]')
    counts['train'] = train_path('plane', '[22]')
    torch.cuda.empty_cache()
    counts['split_glo_train'] = train_path('plane_split_glo', '[22]')
    torch.cuda.empty_cache()
    for k in kernels:
        wrapper = PLANE_WRAPPERS.get(k['name'])
        if wrapper is None:
            continue
        for path, launches in counts.items():
            if launches.get(wrapper):
                k[f'{path}_launches'] = launches[wrapper]
        k['launches'] = sum(k.get(f'{path}_launches', 0)
                            for path in counts if path != 'query')


# -- the occupancy configuration (grid-guided coarse sampling, 32 + 32) -------

# A grid refresh's launches for each probed id: ``query_sigma``'s warp field
# and sheet alone and its template alone.
REFRESH_LAUNCHES = {'fused_field_fwd': 2, 'fused_template_fwd': 1}
REFRESH_LAUNCHES_F32 = {'fused_field_fwd_f32': 2, 'fused_template_fwd_f32': 1}
STEP_LAUNCHES['occupancy'] = STEP_LAUNCHES['flagship']
REFRESH_CALLS = 3  # timed refreshes, after one


def occupancy_kernel_phase(kernels) -> None:
    """Phase 23's kernel checks at the ``occupancy`` configuration's shapes
    (32 coarse samples a ray, 64 on the fine level), at the probe weights:
    the level forward (row 1) at R = 8192, S = 32 and 64 (and 37 x 32) and
    the compositing forward (row 2) at S = 32 with N = 0 (a ray's samples
    fill one warp's lanes), as the render and, with sigma noise, training
    launch them; kernels A, B and C at the train step's R = 16384, S = 32
    and 64 (and 37 x 32); each against its plain version, the S = 32 shapes
    timed. Adds those times and errors to the entries of ``kernels``."""
    import torch
    from hypernerf_tpu_torch.flagship import flagship_model, load_probe_weights
    from hypernerf_tpu_torch.kernels import (fused_composite_bwd,
                                             fused_composite_bwd_plain,
                                             fused_composite_plain,
                                             fused_fields_bwd, fused_level,
                                             fused_level_plain,
                                             fused_template_bwd)
    from hypernerf_tpu_torch.kernels.fused_level import _launch_forward
    probe = load_probe_weights(flagship_model('cuda', config='occupancy'))
    level = {32: probe.level('coarse'), 64: probe.level('fine')}
    entry = {k['name']: k for k in kernels}
    errs = {'fwd': [], 'comp': [], 'A': [], 'B': [], 'C': []}
    with torch.no_grad():
        for r, s in ((37, 32), (CHUNK, 32), (CHUNK, 64)):
            args = level_inputs(r, s, seed=s + 7)
            errs['fwd'].append(hold_level(
                fused_level(level[s], *args), fused_level_plain(level[s],
                                                                *args),
                f'occupancy level vs plain R={r} S={s}', '[23]'))
        args = level_inputs(CHUNK, 32, seed=39)
        ms = cuda_ms(lambda: fused_level(level[32], *args))
        plain_ms = cuda_ms(lambda: fused_level_plain(level[32], *args), 3)
        b_ms = level_bound(level[32], CHUNK, 32)[0]
        phase(f'[23] level R={CHUNK} S=32: kernel {ms:.3f} ms ({b_ms / ms:.1%}'
              f' of its bound {b_ms:.3f} ms), plain {plain_ms:.3f} ms')
        entry['fused_level_fwd'].update(ms_s32=ms, plain_ms_s32=plain_ms,
                                        bound_ms_s32=b_ms)
        for r, noise in ((37, False), (CHUNK, False), (TRAIN_RAYS, True)):
            packed, z, dirs, _ = composite_inputs(r, 32, 0, seed=r + 32,
                                                  linspace_u=True)
            n = (torch.randn(r, 32, generator=torch.Generator().manual_seed(
                r)).cuda() if noise else None)
            errs['comp'].append(check_composite(
                packed, z, dirs, None, f'R={r} S=32 N=0' + (' with noise'
                                                            if noise else ''),
                noise=n, tag='[23]'))
        packed, z, dirs, _ = composite_inputs(CHUNK, 32, 0, seed=3,
                                              linspace_u=True)
        c_ms = composite_kernel_ms(packed, z, dirs, None)
        c_plain = cuda_ms(lambda: fused_composite_plain(packed, z, dirs))
        c_bound = bound(0.0, CHUNK * (32 * (16 + 4) + 12 + 24 + 4 * 32))[0]
        phase(f'[23] composite R={CHUNK} S=32 N=0: kernel {c_ms:.4f} ms '
              f'({c_bound / c_ms:.1%} of its bound {c_bound:.4f} ms), plain '
              f'{c_plain:.3f} ms')
        entry['fused_composite_fwd'].update(ms_s32_n0=c_ms,
                                            plain_ms_s32_n0=c_plain,
                                            bound_ms_s32_n0=c_bound)

        # Kernels A and B on the forward's raw_t (A) and the plain A's dx_t
        # (B), kernel C with noise, as the occupancy step runs them.
        gen = torch.Generator().manual_seed(23)
        for r, s in ((37, 32), (TRAIN_RAYS, 32), (TRAIN_RAYS, 64)):
            lv = level[s]
            args = level_inputs(r, s, seed=s + 11)
            g = torch.randn(r * s, 4, generator=gen).cuda()
            out, raw_t = _launch_forward(lv, *args, want_raw_t=True)
            want_a = plain_template_bwd(lv, raw_t, args[4], g)
            got_dx_t, d_cond, t_grads, _ = fused_template_bwd(
                lv, raw_t, args[4], g)
            dx_t = want_a[0]
            got_b = fused_fields_bwd(lv, *args[:4], dx_t)
            got_b = [*got_b[:4], *got_b[4]]
            errs['A'].append(check_grads(
                f'occupancy template backward (A) vs plain R={r} S={s}',
                TEMPLATE_GRAD_NAMES, [got_dx_t, d_cond, *t_grads], want_a,
                tag='[23]'))
            errs['B'].append(check_grads(
                f'occupancy fields backward (B) vs plain R={r} S={s}',
                FIELDS_GRAD_NAMES, got_b, plain_fields_bwd(lv, args, dx_t),
                tag='[23]'))
            packed, z, dirs, _ = composite_inputs(r, s, 0, seed=r + s,
                                                  linspace_u=True)
            noise = torch.randn(r, s, generator=gen).cuda()
            d_outs = torch.randn(r, 6, generator=gen).cuda()
            d_w = (torch.randn(r, s, generator=gen) * 0.1).cuda()
            dnorm = torch.linalg.norm(dirs, dim=-1, keepdim=True)
            got = list(fused_composite_bwd(packed, z, dirs, noise, d_outs,
                                           d_w))
            want = list(fused_composite_bwd_plain(packed, z, dnorm, noise,
                                                  d_outs, d_w))
            cum = torch.cumsum(fused_composite_plain(
                packed, z, dirs, None, noise=noise)['weights'], dim=-1)
            edge = ((cum - 0.5).abs() < 1e-5).any(-1)
            got[1] = got[1].masked_fill(edge[:, None], 0.0)
            want[1] = want[1].masked_fill(edge[:, None], 0.0)
            errs['C'].append(check_grads(
                f'occupancy compositing backward (C) vs plain R={r} S={s} '
                f'({int(edge.sum())} rays on the median\'s edge)',
                ['d_packed', 'd_z', 'd_dnorm', 'd_noise'], got, want,
                COMPOSITE_GRAD_TOL, COMPOSITE_GRAD_TOL, tag='[23]'))
            if (r, s) != (TRAIN_RAYS, 32):
                del out, raw_t, want_a, dx_t
                continue
            t = dict(
                A=cuda_ms(lambda: fused_template_bwd(lv, raw_t, args[4], g),
                          3),
                B=cuda_ms(lambda: fused_fields_bwd(lv, *args[:4], dx_t), 3),
                C=composite_bwd_kernel_ms(packed, z, dirs, noise, d_outs,
                                          d_w),
                plain_A=cuda_ms(lambda: plain_template_bwd(lv, raw_t,
                                                           args[4], g), 1),
                plain_B=cuda_ms(lambda: plain_fields_bwd(lv, args, dx_t), 1),
                plain_C=cuda_ms(lambda: fused_composite_bwd_plain(
                    packed, z, dnorm, noise, d_outs, d_w)))
            bounds = dict(A=template_bwd_bound(lv, r, s)[0],
                          B=fields_bwd_bound(lv, r, s)[0],
                          C=composite_bwd_bound(r, s)[0])
            phase(f'[23] level backward R={r} S=32: ' + ', '.join(
                f'kernel {k} {t[k]:.3f} ms ({bounds[k] / t[k]:.1%} of its '
                f'bound {bounds[k]:.4f} ms; plain {t["plain_" + k]:.2f} ms)'
                for k in 'ABC'))
            for k, name in (('A', 'fused_template_bwd'),
                            ('B', 'fused_fields_bwd'),
                            ('C', 'fused_composite_bwd')):
                entry[name].update({'ms_s32': t[k],
                                    'plain_ms_s32': t['plain_' + k],
                                    'bound_ms_s32': bounds[k]})
            del out, raw_t, want_a, dx_t
            torch.cuda.empty_cache()
    for name, key in (('fused_level_fwd', 'fwd'),
                      ('fused_composite_fwd', 'comp')):
        entry[name]['max_abs_err'] = max(entry[name]['max_abs_err'],
                                         *errs[key])
    for name, key, tols in (
            ('fused_template_bwd', 'A', ()), ('fused_fields_bwd', 'B', ()),
            ('fused_composite_bwd', 'C', (COMPOSITE_GRAD_TOL,
                                          COMPOSITE_GRAD_TOL))):
        new = error_keys(errs[key], *tols)
        for k in ('max_abs_err', 'rel_l2_err', 'max_err_over_largest_entry'):
            entry[name][k] = max(entry[name][k], new[k])


def occupancy_refresh() -> dict:
    """Phase 23's grid refresh (``make_occupancy_update`` of the
    ``occupancy`` configuration: 4 ids x 262,144 jittered cell points
    through ``query_sigma``) from ``bench_grid``: against the same refresh
    through the plain versions on the same draws, and timed (the mean of
    REFRESH_CALLS after one); returns {'ms', 'launches'}."""
    import torch
    from hypernerf_tpu_torch.flagship import (bench_grid,
                                              flagship_train_config,
                                              flagship_train_setup)
    from hypernerf_tpu_torch.training.train_state import \
        make_occupancy_update
    state = flagship_train_setup('cuda', config='occupancy')[0]
    cfg, train_cfg = state.model.config, flagship_train_config('occupancy')
    update = make_occupancy_update(state.model, cfg, train_cfg)
    g = cfg.occupancy_resolution
    gen = torch.Generator(device='cuda').manual_seed(17)
    u = torch.rand((g ** 3, 3), generator=gen, device='cuda')
    ids = torch.randint(0, cfg.num_embeddings, (train_cfg.occupancy_probe_ids,),
                        generator=gen, device='cuda')
    reset_counts()
    got = update(state, u, ids).clone()
    n_ids = ids.shape[0]
    launches = read_counts({k: v * n_ids for k, v in
                            REFRESH_LAUNCHES.items()}, 'occupancy refresh')
    state.occupancy = bench_grid(cfg, 'cuda')
    with plain_versions():
        want = update(state, u, ids).clone()
    diff = (got - want).abs()
    bad = diff > LEVEL_ATOL + LEVEL_RTOL * want.abs()
    if got.shape != (g, g, g) or not torch.isfinite(got).all() \
            or bad.any() or diff.mean() > LEVEL_MEAN:
        raise AssertionError(f'occupancy refresh: kernels vs plain max|d| '
                             f'{diff.max().item():.3e} mean '
                             f'{diff.mean().item():.3e}, {int(bad.sum())} '
                             f'cells outside')
    fresh = (got > bench_grid(cfg, 'cuda') * train_cfg.occupancy_decay)
    update(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REFRESH_CALLS):
        update(state)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / REFRESH_CALLS * 1e3
    phase(f'[23] occupancy grid refresh (G={g}, {n_ids} ids x {g ** 3} cell '
          f'points through query_sigma): kernels vs plain versions on the '
          f'same draws max|d| {diff.max().item():.3e} mean '
          f'{diff.mean().item():.3e} (tol {LEVEL_ATOL}+{LEVEL_RTOL}|want|, '
          f'mean {LEVEL_MEAN}); {int(fresh.sum())} of {g ** 3} cells took '
          f'the new density; {ms:.2f} ms a refresh (mean of {REFRESH_CALLS} '
          f'after one); launches a refresh {launches}')
    del state
    torch.cuda.empty_cache()
    return {'ms': ms, 'launches': launches}


def occupancy_paths_phase(kernels) -> None:
    """Phase 23: ``occupancy`` (``bench.py --mode occupancy`` /
    ``render_occupancy``: the flagship at 32 + 32 with the grid) at full
    width. Its kernels at the configuration's shapes, the refresh against
    its plain version, three 504x378 frames through ``bench_grid`` (and the
    flagship's in the same call), 1024 rays against the plain versions, and
    the train step at batch 16384 with the refresh inside the timed window;
    the step's ms without the refresh and amortised over 16 steps as
    ``bench.py`` times it. Adds the occupancy paths' launches to the
    kernels' entries (each path's counts set to 0 just before it and read
    just after)."""
    import torch
    from hypernerf_tpu_torch.flagship import (H, W, bench_grid,
                                              flagship_model,
                                              flagship_train_config,
                                              spiral_rays)
    from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
    from hypernerf_tpu_torch.training.renderer import ImageRenderer
    occupancy_kernel_phase(kernels)
    refresh = occupancy_refresh()
    chunks_per_frame = -(-W * H // CHUNK)
    frames = spiral_rays(range(0, 30 * (N_FRAMES + 1), 30))
    model = flagship_model('cuda', seed=0, config='occupancy')
    grid = bench_grid(model.config, 'cuda')
    keep = ('rgb', 'depth', 'acc')
    frame_want = {'fused_level_fwd': 2 * chunks_per_frame,
                  'fused_composite_fwd': 2 * chunks_per_frame}
    secs, frame_launches = time_frames(
        ImageRenderer(model, chunk=CHUNK, keep=keep, levels=('fine',),
                      quantize=True, occupancy_grid=grid), frames, keep,
        frame_want, 'occupancy frame')
    flag_secs = time_frames(
        ImageRenderer(flagship_model('cuda', seed=0), chunk=CHUNK, keep=keep,
                      levels=('fine',), quantize=True), frames, keep,
        frame_want, 'flagship frame')[0]
    phase(f'[23] occupancy: rendered {N_FRAMES} frames {W}x{H} (32+32 '
          f'through the G={grid.shape[0]} grid, chunk {CHUNK}): '
          f'{secs:.4f} s/frame; launches {frame_launches} (= 2 levels x '
          f'{chunks_per_frame} chunks x {N_FRAMES} frames; the coarse '
          f'compositing draws no fine depths); no plain call; the '
          f'flagship\'s frames (64+64) in the same call {flag_secs:.4f} '
          f's/frame')
    small = torch.as_tensor(frames[0][::186][:1024]).cuda()
    with torch.no_grad():
        got = model(prepare_ray_dict(small), occupancy_grid=grid)
        without = model(prepare_ray_dict(small))['fine']['rgb']
        with plain_versions():
            want = model(prepare_ray_dict(small),
                         occupancy_grid=grid)['fine']['rgb']
    diff = (got['fine']['rgb'] - want).abs()
    moved = (got['fine']['rgb'] - without).abs().max().item()
    phase(f'[23] occupancy render of 1024 rays through the grid, kernels vs '
          f'plain: fine rgb max|d| {diff.max().item():.3e} mean '
          f'{diff.mean().item():.3e} (tol {RENDER_ATOL}, mean '
          f'{RENDER_MEAN}); the grid moves the render by max {moved:.3e}')
    if not torch.isfinite(got['fine']['rgb']).all() \
            or diff.max() > RENDER_ATOL or diff.mean() > RENDER_MEAN \
            or not moved > 0.0:
        raise AssertionError('occupancy render: kernels and plain versions '
                             'disagree, or the grid does not move it')
    del model
    torch.cuda.empty_cache()
    times = {}
    train = train_path('occupancy', '[23]', times)
    every = flagship_train_config('occupancy').occupancy_update_every
    step_ms = (times['secs'] * TRAIN_STEPS * 1e3
               - refresh['ms'] * times['refreshes']) / TRAIN_STEPS
    amortised = step_ms + refresh['ms'] / every
    phase(f'[23] occupancy step: {times["secs"] * 1e3:.1f} ms a step over '
          f'the window ({times["refreshes"]} refresh in {TRAIN_STEPS} '
          f'steps); without the refresh {step_ms:.1f} ms; the refresh '
          f'{refresh["ms"]:.2f} ms apart, amortised over {every} steps '
          f'{amortised:.1f} ms a step, {TRAIN_RAYS / amortised * 1e3:.0f} '
          f'rays/s (the flagship\'s step in phase 7 of this call)')
    torch.cuda.empty_cache()
    for k in kernels:
        for path, launches in (('frame', frame_launches), ('train', train),
                               ('refresh', refresh['launches'])):
            if launches.get(k['name']):
                k[f'occupancy_{path}_launches'] = launches[k['name']]


# -- the trainer and its entry point ------------------------------------------

# Phase 25: N steps of the flagship through ``python -m
# hypernerf_tpu_torch.train`` at batch 4096 on a scene of
# ``tools/make_synthetic_scene.py`` (32 steps an epoch: a checkpoint at 32,
# vals every 8 steps, the last at 32); the resume trains to 2 N. The val
# frame's GLO code is never trained, so its PSNR barely moves in N steps;
# the training frames' PSNR (``train_pose_psnr``) moves with every step and
# holds the kernels' training to the plain versions'. Its limit lies
# between the gaps of runs from the same weights and draws and the
# movement of N steps (``tools/trainer_spread.py``, PERF.md), and the
# untrained model must fail it.
SMOKE_STEPS = 36
SMOKE_BATCH = 4096
SMOKE_SCENE = dict(n_frames=8, width=160, height=120)
SMOKE_PSNR_TOL = 0.5  # dB, the kernels' val PSNR against the plain trainer's
POSE_PSNR_TOL = 1.0  # dB, the same for the training frames' mean PSNR
STEP_KERNELS = ('fused_level_fwd', 'fused_composite_fwd',
                'fused_template_bwd', 'fused_fields_bwd',
                'fused_composite_bwd')


def smoke_argv(scene: str, exp: str, steps: int, *extra) -> list:
    """``train.py``'s flags for the flagship (64 + 64, bf16, Adam with
    steplr) on the smoke scene: a val every quarter epoch, a checkpoint
    every epoch and at the end, a log line every 10 steps."""
    w, h = SMOKE_SCENE['width'], SMOKE_SCENE['height']
    return ['--root_dir', scene, '--dataset_name', 'llff', '--img_wh',
            str(w), str(h), '--N_samples', '64', '--N_importance', '64',
            '--batch_size', str(SMOKE_BATCH), '--max_steps', str(steps),
            '--optimizer', 'adam', '--lr', '5e-4', '--lr_scheduler',
            'steplr', '--log_every', '10', '--exp_name', exp, *extra]


def trainer_run(argv, label: str, start: int = 0, kernels=STEP_KERNELS,
                per_step=None, per_chunk=None, per_refresh=None):
    """``train.main(argv)`` from step ``start``, every count set to 0 just
    before it and read just after: two launches of each step kernel a
    step (``kernels``, in STEP_KERNELS' order: the float32 run's names in
    phase 33), the two forward kernels on every chunk and level of each
    val, no plain call. Another path gives its launches a step, a val
    chunk and an occupancy refresh (``per_step``, ``per_chunk``,
    ``per_refresh``: {kernel: launches}). Returns (the trainer, its
    launches)."""
    from hypernerf_tpu_torch import train as port_train
    reset_counts()
    trainer = port_train.main(argv)
    cfg = trainer.train_cfg
    every = max(1, int(trainer.steps_per_epoch * cfg.val_check_interval))
    vals = int(start == 0 and cfg.num_sanity_val_steps > 0) + sum(
        s % every == 0 for s in range(start + 1, trainer.total_steps + 1))
    refreshes = sum(s % cfg.occupancy_update_every == 0
                    for s in range(start, trainer.total_steps))
    n_ids = min(cfg.occupancy_probe_ids, trainer.nerf_cfg.num_embeddings)
    w, h = cfg.img_wh
    per_step = per_step or {k: 2 for k in kernels}
    per_chunk = per_chunk or {k: 2 for k in kernels[:2]}
    want = {}
    for k, v in per_step.items():
        want[k] = v * (trainer.total_steps - start)
    for k, v in per_chunk.items():
        want[k] = want.get(k, 0) + v * -(-w * h // cfg.chunk) * vals
    if trainer.nerf_cfg.use_occupancy_grid:
        for k, v in (per_refresh or {}).items():
            want[k] = want.get(k, 0) + v * n_ids * refreshes
    return trainer, read_counts(want, label)


def train_pose_psnr(trainer) -> float:
    """The mean over the training frames of each frame's PSNR (as ``eval``
    reads ``Mean PSNR`` on ``--split test_train``) of the trainer's model at
    its state's step, rendered through the kernels. Unlike the val frame,
    whose GLO code no step trains, it moves with every step."""
    import torch
    from hypernerf_tpu_torch.training.renderer import render_rays
    from hypernerf_tpu_torch.training.train_state import compute_extra_params
    w, h = trainer.train_cfg.img_wh
    out = render_rays(
        trainer.model, trainer.all_rays, chunk=CHUNK, keep=('rgb',),
        levels=('fine',),
        extra_params=compute_extra_params(trainer.nerf_cfg, trainer.train_cfg,
                                          trainer.state.step),
        occupancy_grid=trainer.state.occupancy, to_numpy=False)
    err = (out['fine']['rgb'] - trainer.all_rgbs) ** 2
    mse = err.reshape(-1, h * w * 3).mean(dim=1)
    return float((-10.0 * torch.log10(mse)).mean())


def steps_per_second(trainer, steps: int) -> float:
    """A fit's steps over its seconds outside its vals and checkpoints."""
    secs = trainer.seconds
    return steps / (secs['fit'] - secs['val'] - secs['checkpoint'])


def trainer_phase(kernels) -> None:
    """Phase 25: the trainer and its entry point on the card (the module
    docstring); adds the run's launches to the five step kernels'
    entries."""
    import io
    import os
    import tempfile

    import torch
    from hypernerf_tpu_torch import eval as port_eval
    from hypernerf_tpu_torch import train as port_train
    from hypernerf_tpu_torch.opt import configs_from_args, get_opts
    from hypernerf_tpu_torch.training import checkpoints
    from hypernerf_tpu_torch.training.trainer import Trainer
    t_phase = time.perf_counter()
    n = SMOKE_STEPS
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         'tools')
    sys.path.insert(0, tools)
    import make_synthetic_scene
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            scene = make_synthetic_scene.make_scene(
                os.path.join(tmp, 'scene'), **SMOKE_SCENE)
            phase(f'[25] scene: {SMOKE_SCENE["n_frames"]} frames '
                  f'{SMOKE_SCENE["width"]}x{SMOKE_SCENE["height"]} by '
                  f'tools/make_synthetic_scene.py in '
                  f'{time.perf_counter() - t0:.1f} s (host)')
            # The kernels: N steps, a sanity val, a val every quarter epoch.
            trainer, launches = trainer_run(smoke_argv(scene, 'smoke', n),
                                            'trainer (kernels)')
            steps_per_epoch = trainer.steps_per_epoch
            metrics = trainer.last_metrics
            ckpt_dir = os.path.join(tmp, 'ckpts', 'smoke')
            saved = sorted(int(s[5:]) for s in os.listdir(ckpt_dir)
                           if s.startswith('step_'))
            if saved != [steps_per_epoch, n] or not n > steps_per_epoch:
                raise AssertionError(f'checkpoints {saved}, want '
                                     f'[{steps_per_epoch}, {n}]')
            speed = steps_per_second(trainer, n)
            pose = train_pose_psnr(trainer)
            trainer.logger = None  # closed by train.main
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.validate(n)
            torch.cuda.synchronize()
            val_secs = time.perf_counter() - t0
            phase(f'[25] train.main: {n} steps (batch {SMOKE_BATCH}, '
                  f'{steps_per_epoch} steps an epoch, 64+64, bf16, Adam '
                  f'with steplr) in {trainer.seconds["fit"]:.2f} s of fit, '
                  f'{speed:.2f} steps/s outside its vals and checkpoints '
                  f'({trainer.seconds["val"]:.2f} s of vals, '
                  f'{trainer.seconds["checkpoint"]:.2f} s of checkpoints); '
                  f'one val {val_secs:.3f} s (it blocks the host); val psnr '
                  f'{metrics["val/psnr"]:.3f} loss {metrics["val/loss"]:.5f}'
                  f'; train loss {metrics["train/loss"]:.5f}; training '
                  f'frames\' psnr {pose:.3f}; checkpoints '
                  f'{saved}; launches {launches}; no plain call; {CARD}')
            for k in kernels:
                if launches.get(k['name']):
                    k['trainer_launches'] = launches[k['name']]
            del trainer
            torch.cuda.empty_cache()

            # Resume from the last checkpoint to 2 N.
            last = os.path.join(ckpt_dir, f'step_{n}')
            resumed, launches = trainer_run(
                smoke_argv(scene, 'smoke', 2 * n, '--ckpt_path', last),
                'trainer (resumed)', start=n)
            latest = checkpoints.latest_checkpoint(ckpt_dir)
            with open(os.path.join(ckpt_dir, 'manifest.json')) as f:
                manifest = json.load(f)
            if resumed.state.step != 2 * n or latest != os.path.join(
                    ckpt_dir, f'step_{2 * n}') or max(map(int, manifest)) \
                    != 2 * n or 'val/psnr' not in manifest[str(2 * n)]:
                raise AssertionError(f'resume: step {resumed.state.step}, '
                                     f'latest {latest}, manifest '
                                     f'{sorted(manifest, key=int)}')
            phase(f'[25] resumed from step {n} to {2 * n} '
                  f'({steps_per_second(resumed, n):.2f} steps/s, fit '
                  f'{resumed.seconds["fit"]:.2f} s): latest checkpoint and '
                  f'manifest at step {2 * n}, manifest steps '
                  f'{sorted(map(int, manifest))}; val psnr '
                  f'{resumed.last_metrics["val/psnr"]:.3f}; launches '
                  f'{launches}; {CARD}')
            del resumed
            torch.cuda.empty_cache()

            # Eval of the last checkpoint.
            reset_counts()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                port_eval.main(['--root_dir', scene, '--dataset_name',
                                'llff', '--img_wh', str(SMOKE_SCENE['width']),
                                str(SMOKE_SCENE['height']), '--split',
                                'test_train', '--ckpt_path', latest,
                                '--scene_name', 'smoke'])
            eval_secs = time.perf_counter() - t0
            pngs = [f for f in os.listdir(os.path.join(
                tmp, 'results', 'llff', 'smoke')) if f.endswith('.png')]
            mean = [ln for ln in out.getvalue().splitlines()
                    if ln.startswith('Mean PSNR')]
            chunks = -(-SMOKE_SCENE['width'] * SMOKE_SCENE['height']
                       // CHUNK)
            eval_launches = read_counts(
                {k: 2 * chunks * len(pngs) for k in STEP_KERNELS[:2]},
                'eval of the trainer\'s checkpoint')
            if not pngs or not mean:
                raise AssertionError(f'eval wrote {len(pngs)} PNGs; '
                                     f'{out.getvalue()[-500:]}')
            phase(f'[25] python -m hypernerf_tpu_torch.eval on step_{2 * n}: '
                  f'{len(pngs)} PNGs, {mean[0]}, {eval_secs:.2f} s; '
                  f'launches {eval_launches}; {CARD}')

            # The plain versions from the same weights and draws, the
            # kernels again, and the untrained model. The training frames
            # are rendered through the kernels for all four.
            reset_counts()
            with plain_versions():
                plain = port_train.main(smoke_argv(scene, 'plain', n))
            if any(fn.launches for fn in kernel_wrappers()[0].values()):
                raise AssertionError('the plain trainer launched a kernel')
            plain_pose = train_pose_psnr(plain)
            plain_metrics, plain_speed = (plain.last_metrics,
                                          steps_per_second(plain, n))
            del plain
            again, _ = trainer_run(smoke_argv(scene, 'again', n),
                                   'trainer (kernels, again)')
            again_pose = train_pose_psnr(again)
            again_metrics = again.last_metrics
            del again
            untrained = Trainer(*configs_from_args(get_opts(
                smoke_argv(scene, 'untrained', n))), 'cuda')
            untrained_pose = train_pose_psnr(untrained)
            del untrained
            torch.cuda.empty_cache()
            d_psnr = metrics['val/psnr'] - plain_metrics['val/psnr']
            d_pose = pose - plain_pose
            TIMES['trainer_bf16'] = dict(
                pose=pose, plain_pose=plain_pose, again_pose=again_pose,
                val=metrics['val/psnr'],
                plain_val=plain_metrics['val/psnr'], steps=speed,
                plain_steps=plain_speed)
            phase(f'[25] the same {n} steps through the plain versions: '
                  f'training frames\' psnr {plain_pose:.3f} against the '
                  f'kernels\' {pose:.3f} ({d_pose:+.3f} dB, tol '
                  f'{POSE_PSNR_TOL}; the kernels\' second run '
                  f'{again_pose:.3f}, {pose - again_pose:+.3f} dB; the '
                  f'untrained model {untrained_pose:.3f}, '
                  f'{untrained_pose - plain_pose:+.3f} dB, must fail the '
                  f'tol); val psnr {plain_metrics["val/psnr"]:.3f} against '
                  f'{metrics["val/psnr"]:.3f} ({d_psnr:+.3f} dB, tol '
                  f'{SMOKE_PSNR_TOL}; second run '
                  f'{again_metrics["val/psnr"]:.3f}); train loss at step {n} '
                  f'{plain_metrics["train/loss"]:.5f} against '
                  f'{metrics["train/loss"]:.5f} and '
                  f'{again_metrics["train/loss"]:.5f}; {plain_speed:.3f} '
                  f'steps/s against {speed:.2f}; {CARD}')
            if not abs(untrained_pose - plain_pose) > POSE_PSNR_TOL:
                raise AssertionError('trainer: the untrained model passes '
                                     'the training frames\' limit')
            if not (abs(d_pose) <= POSE_PSNR_TOL
                    and abs(d_psnr) <= SMOKE_PSNR_TOL) or not all(
                    math.isfinite(v) for v in metrics.values()):
                raise AssertionError('trainer: kernels and plain versions '
                                     'disagree')
        finally:
            os.chdir(cwd)
            sys.path.remove(tools)
    phase(f'[25] the trainer phase took {time.perf_counter() - t_phase:.1f} '
          f's; {CARD}')


# -- the use_nerf_embed conditions and use_viewdirs=False --------------------

# The template's condition cases on rows 1, 8 and 9: name -> (configuration,
# overrides, rgb condition width, alpha condition width). ``nerf_embed`` is
# the configuration; the others take the widths its kernels add: the nerf
# embedding alone as the rgb condition, no condition at all (a zero-width
# rgb condition), and the Nerfies layout's view directions with the
# embedding after them.
COND_CASES = {
    'nerf_embed': ('nerf_embed', {}, 47, 8),
    'embed_only': ('nerf_embed', dict(use_viewdirs=False), 8, 8),
    'no_viewdirs': ('flagship', dict(use_viewdirs=False), 0, 0),
    'anneal_embed': ('anneal', dict(use_nerf_embed=True,
                                    use_alpha_condition=True,
                                    use_rgb_condition=True), 35, 8)}
STEP_LAUNCHES['nerf_embed'] = STEP_LAUNCHES['flagship']
STEP_LAUNCHES['no_viewdirs'] = STEP_LAUNCHES['flagship']
STEP_LAUNCHES['anneal_embed'] = STEP_LAUNCHES['flagship']
STEP_LAUNCHES['static_embed'] = STEP_LAUNCHES['static']
PATHS['no_viewdirs'] = ('flagship', dict(use_viewdirs=False))
PATHS['anneal_embed'] = COND_CASES['anneal_embed'][:2]
PATHS['static_embed'] = ('static', dict(use_nerf_embed=True,
                                        use_rgb_condition=True,
                                        use_alpha_condition=True))
COND_GRAD_RUNS = 2  # runs of the level's backward against the stored JAX
COND_TRAIN_STEPS = 8  # steps of the entry point with the three flags


def cond_model(case: str, seed=None):
    """The probe model of a ``COND_CASES`` case on the card (seeded init
    with ``seed``)."""
    from hypernerf_tpu_torch.flagship import flagship_model, load_probe_weights
    config, over, *_ = COND_CASES[case]
    if seed is not None:
        return flagship_model('cuda', seed=seed, config=config, **over)
    return load_probe_weights(flagship_model('cuda', config=config, **over))


def cond_inputs(case: str, n_rays: int, samples: int, seed: int):
    """(``level_inputs`` with the case's rgb condition, its alpha condition
    or None, its template window rows of each level or None): the view
    directions' encoding (the Nerfies one at the probe step's
    ``nerf_alpha``) unless the case has none, then the ray's GLO code as
    the nerf embedding."""
    import torch
    from hypernerf_tpu_torch.flagship import (anneal_condition,
                                              anneal_extra_params)
    config, over, rgb_w, alpha_w = COND_CASES[case]
    args = level_inputs(n_rays, samples, seed)
    view = args[4]
    if config == 'anneal':
        view = torch.from_numpy(anneal_condition(
            args[2].cpu().numpy(), anneal_extra_params()['nerf_alpha'])).cuda()
    if not over.get('use_viewdirs', True):
        view = view[:, :0]
    embed = args[3] if rgb_w > view.shape[1] else args[3][:, :0]
    args[4] = torch.cat([view, embed], dim=1).contiguous()
    if args[4].shape[1] != rgb_w:
        raise AssertionError(f'{case}: rgb condition {args[4].shape}')
    return args, (args[3].clone() if alpha_w else None)


def cond_scales(case: str, model, level: str):
    """The template's window row of a Nerfies case at the probe step's
    alphas, else None."""
    from hypernerf_tpu_torch.flagship import anneal_extra_params
    from hypernerf_tpu_torch.kernels.fused_mlp import template_scales
    if COND_CASES[case][0] != 'anneal':
        return None
    ep = anneal_extra_params()
    return template_scales(model.template_of(level), ep['nerf_alpha'],
                           ep['hyper_alpha'], 'cuda')


def condition_kernel_phase(kernels) -> None:
    """Phase 26's kernel checks: rows 1, 8 and 9 (the level forward, the
    template alone and kernel A) with the ``use_nerf_embed`` alpha
    condition (the alpha head on [bottleneck | embedding]) and each new rgb
    condition width (47, 8 and 0 in the flagship's layout, 35 in the
    Nerfies one) at the probe weights: against the JAX kernels' stored
    outputs and gradients (tests/data, the level's backward A then B as
    training runs it) and against their plain versions up to the render's
    and the train step's shapes, each timed beside the flagship's kernel
    (the view directions alone, no alpha condition) in turns; adds those
    numbers to the three kernels' entries."""
    import torch
    from hypernerf_tpu_torch import kernels as K
    from hypernerf_tpu_torch.flagship import (CONDITION_LEVEL_CASES,
                                              CONDITION_TEMPLATE_CASES,
                                              LEVEL_INPUTS, flagship_model,
                                              load_probe_weights,
                                              read_condition_reference)
    from hypernerf_tpu_torch.kernels import common
    from hypernerf_tpu_torch.kernels.fused_level import (_launch_forward,
                                                         _level_params)
    from hypernerf_tpu_torch.kernels.fused_mlp import template_layers
    entry = {k['name']: k for k in kernels}
    ref = read_condition_reference()
    probe = cond_model('nerf_embed')
    for case, (level, *_) in CONDITION_LEVEL_CASES.items():
        a = {k: torch.from_numpy(v).cuda() for k, v in ref[case].items()}
        lv = probe.level(level)
        params = _level_params(lv)
        names = [f'd_{k}' for k in LEVEL_INPUTS] + ['d_alpha_cond'] + [
            f'd{"wb"[i % 2]}{i // 2}' for i in range(len(params))]
        for run in range(COND_GRAD_RUNS):
            args = [a[k].detach().requires_grad_() for k in LEVEL_INPUTS]
            ac = a['alpha_cond'].detach().requires_grad_()
            out = K.fused_level(lv, *args, alpha_cond=ac)
            hold_level(out.detach(), a['out'], f'nerf_embed {case} vs the '
                       f'stored JAX output', '[26]')
            got = torch.autograd.grad(out, args + [ac] + params,
                                      a['cotangent'])
            keep = [i for i, n in enumerate(names) if n in a]
            check_grads(f'nerf_embed {case} backward (A + B), run {run + 1} '
                        f'of {COND_GRAD_RUNS}, vs the stored JAX gradients '
                        f'(every input, d alpha_cond, every db, the alpha '
                        f'head\'s and rgb layer 0\'s dW)',
                        [names[i] for i in keep], [got[i] for i in keep],
                        [a[names[i]] for i in keep], tag='[26]')
    for case, (level, *_) in CONDITION_TEMPLATE_CASES.items():
        a = {k: torch.from_numpy(v).cuda() for k, v in ref[case].items()}
        t = probe.template_of(level)
        ins = [a[k].detach().requires_grad_() for k in ('x_raw', 'rgb_cond',
                                                         'alpha_cond')]
        out = K.fused_template(t, ins[0], ins[1], alpha_cond=ins[2])
        hold_level(out.detach(), a['out'], f'nerf_embed {case} (row 8) vs '
                   f'the stored JAX output', '[26]')
        layers = template_layers(t.template)
        got = torch.autograd.grad(out, ins + common.layer_params(layers),
                                  a['cotangent'])
        names = ['dx', 'd_rgb_cond', 'd_alpha_cond'] + [
            f'd{"wb"[i % 2]}{i // 2}' for i in range(2 * len(layers))]
        keep = [i for i, n in enumerate(names) if n in a]
        check_grads(f'nerf_embed {case} backward (A) vs the stored JAX '
                    f'gradients', [names[i] for i in keep],
                    [got[i] for i in keep], [a[names[i]] for i in keep],
                    tag='[26]')

    flag = load_probe_weights(flagship_model('cuda'))
    a_names = TEMPLATE_GRAD_NAMES + ['d_alpha_cond']
    gen = torch.Generator().manual_seed(26)
    with torch.no_grad():
        # The alpha condition is seen: a shift of it moves sigma alone, by
        # more than the level check's tolerance.
        lv = probe.level('coarse')
        args, alpha = cond_inputs('nerf_embed', 512, 64, 5)
        base = plain_forward(lv, args, alpha=alpha)[0]
        moved = plain_forward(lv, args, alpha=alpha + 0.05)[0] - base
        phase(f'[26] probe: 0.05 on the alpha condition moves the plain '
              f'level\'s raw sigma by mean {moved[:, 3].abs().mean():.3e} '
              f'and its rgb logits by max {moved[:, :3].abs().max():.1e}')
        if not moved[:, 3].abs().mean() > LEVEL_MEAN or \
                moved[:, :3].abs().max() != 0:
            raise AssertionError('the alpha condition check cannot see it')
        for case, (_, _, rgb_w, alpha_w) in COND_CASES.items():
            model = probe if case == 'nerf_embed' else cond_model(case)
            errs = {'fwd': [], 'tmpl': [], 'A': []}
            times, bounds = {}, {}
            for r, s in ((37, 13), (CHUNK, 128), (TRAIN_RAYS, 128)):
                level = 'fine' if s == 128 else 'coarse'
                lv = model.level(level)
                sc = cond_scales(case, model, level)
                args, alpha = cond_inputs(case, r, s, s + 26)
                out, raw_t = _launch_forward(lv, *args, want_raw_t=True,
                                             tmpl_scales=sc, alpha_cond=alpha)
                if r <= CHUNK:
                    want_out, want_raw_t = plain_forward(
                        lv, args, tmpl_scales=sc, alpha=alpha)
                    errs['fwd'] += [
                        hold_level(out, want_out, f'{case} level forward '
                                   f'R={r} S={s} vs plain: out', '[26]'),
                        hold_level(raw_t, want_raw_t, f'{case} level forward '
                                   f'R={r} S={s} vs plain: raw_t', '[26]')]
                    errs['tmpl'].append(hold_level(
                        K.fused_template(lv, raw_t, args[4], sc,
                                         alpha_cond=alpha),
                        plain_template(lv, raw_t, args[4], sc, alpha),
                        f'{case} template alone (row 8) R={r} S={s} vs '
                        f'plain', '[26]'))
                    del want_out, want_raw_t
                if r != CHUNK:
                    g = torch.randn(r * s, 4, generator=gen).cuda()
                    got = K.fused_template_bwd(lv, raw_t, args[4], g, sc,
                                               alpha)
                    got = [got[0], got[1], *got[2]] + (
                        [got[3]] if alpha is not None else [])
                    want = plain_template_bwd(lv, raw_t, args[4], g, sc,
                                              alpha)
                    # A zero-width condition has an empty cotangent.
                    trip = [(n, x, y) for n, x, y in zip(a_names, got, want)
                            if y.numel()]
                    errs['A'].append(check_grads(
                        f'{case} template backward (A) R={r} S={s} vs plain',
                        *zip(*trip), tag='[26]'))
                    del got, want
                # Timed in turns with the flagship's kernel (39 columns, no
                # alpha condition) on inputs of the same size.
                flv = flag.level(level)
                fargs = level_inputs(r, s, s + 26)
                fraw = _launch_forward(flv, *fargs, want_raw_t=True)[1]
                if r == CHUNK:
                    times['fwd'] = [
                        cuda_ms(lambda: K.fused_level(
                            lv, *args, None, sc, alpha_cond=alpha)),
                        cuda_ms(lambda: K.fused_level(flv, *fargs)),
                        cuda_ms(lambda: K.fused_level(flv, *fargs)),
                        cuda_ms(lambda: K.fused_level(
                            lv, *args, None, sc, alpha_cond=alpha))]
                    times['tmpl'] = [
                        cuda_ms(lambda: K.fused_template(
                            lv, raw_t, args[4], sc, alpha_cond=alpha)),
                        cuda_ms(lambda: K.fused_template(flv, fraw,
                                                         fargs[4])),
                        cuda_ms(lambda: K.fused_template(flv, fraw,
                                                         fargs[4])),
                        cuda_ms(lambda: K.fused_template(
                            lv, raw_t, args[4], sc, alpha_cond=alpha))]
                    times['plain_fwd'] = cuda_ms(
                        lambda: plain_forward(lv, args, tmpl_scales=sc,
                                              alpha=alpha), 2)
                    times['plain_tmpl'] = cuda_ms(
                        lambda: plain_template(lv, raw_t, args[4], sc,
                                               alpha), 2)
                    width = rgb_w + alpha_w
                    bounds['fwd'] = level_bound(lv, r, s, width)
                    bounds['tmpl'] = template_fwd_bound(lv, r, s, cond=width)
                if r == TRAIN_RAYS:
                    g = torch.randn(r * s, 4, generator=gen).cuda()
                    times['A'] = [
                        cuda_ms(lambda: K.fused_template_bwd(
                            lv, raw_t, args[4], g, sc, alpha), 3),
                        cuda_ms(lambda: K.fused_template_bwd(
                            flv, fraw, fargs[4], g), 3),
                        cuda_ms(lambda: K.fused_template_bwd(
                            flv, fraw, fargs[4], g), 3),
                        cuda_ms(lambda: K.fused_template_bwd(
                            lv, raw_t, args[4], g, sc, alpha), 3)]
                    times['plain_A'] = cuda_ms(
                        lambda: plain_template_bwd(lv, raw_t, args[4], g, sc,
                                                   alpha), 1)
                    bounds['A'] = template_bwd_bound(
                        lv, r, s, cond=rgb_w + alpha_w)
                del out, raw_t, fraw
                torch.cuda.empty_cache()
            rows = {'fwd': ('level forward (row 1)', 'fused_level_fwd',
                            CHUNK),
                    'tmpl': ('template alone (row 8)', 'fused_template_fwd',
                             CHUNK),
                    'A': ('template backward (A, row 9)',
                          'fused_template_bwd', TRAIN_RAYS)}
            for key, (what, name, r) in rows.items():
                t, (b_ms, b_by) = times[key], bounds[key]
                phase(f'[26] {case} (rgb condition {rgb_w}, alpha condition '
                      f'{alpha_w}) {what} R={r} S=128: {t[0]:.3f}, '
                      f'{t[3]:.3f} ms ({b_ms / min(t[0], t[3]):.1%} of its '
                      f'bound {b_ms:.3f} ms, {b_by}); the flagship\'s in '
                      f'turns {t[1]:.3f}, {t[2]:.3f} ms; plain '
                      f'{times["plain_" + key]:.2f} ms; {CARD}')
                e = entry[name]
                e[f'ms_{case}'] = min(t[0], t[3])
                e[f'flagship_ms_{case}'] = min(t[1], t[2])
                e[f'plain_ms_{case}'] = times['plain_' + key]
                e[f'bound_ms_{case}'] = b_ms
                if key == 'A':
                    new = error_keys(errs['A'])
                    for k in ('max_abs_err', 'rel_l2_err',
                              'max_err_over_largest_entry'):
                        e[k] = max(e[k], new[k])
                else:
                    e['max_abs_err'] = max(e['max_abs_err'], *errs[key])
            del model
            torch.cuda.empty_cache()


def condition_paths_phase(kernels) -> None:
    """Phases 26 (the paths) and 27: ``nerf_embed`` at full width through
    the entry points: three 504x378 frames through the level kernels after
    a warm-up (and the flagship's in the same call), 1024 rays against the
    plain versions, a frame with ``return_points`` (the template alone on
    the per-module path), ``query_sigma`` (whose density takes the id's
    alpha condition) and the train step at batch 16384 as phase 7 runs it
    (a 1024-ray step against the plain versions: the loss and every
    gradient, the GLO table's with the conditions' share); one frame and
    one step each of ``use_viewdirs=False`` without an embedding (a
    zero-width rgb condition on the level kernels), of the static model
    with its own nerf table (module by module) and of ``anneal`` with the
    embedding (35 columns); then ``python -m hypernerf_tpu_torch.train
    --use_nerf_embedding --use_alpha_condition --use_rgb_condition`` for
    COND_TRAIN_STEPS steps on a synthetic scene, and the same steps
    through the plain versions. Fills in the launches of the kernels'
    entries (each path's counts set to 0 just before it and read just
    after)."""
    import os
    import tempfile

    import torch
    from hypernerf_tpu_torch.configs import TrainConfig
    from hypernerf_tpu_torch.eval import eval_extra_params
    from hypernerf_tpu_torch.flagship import H, W, flagship_model, spiral_rays
    from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
    from hypernerf_tpu_torch.training.renderer import ImageRenderer
    chunks_per_frame = -(-W * H // CHUNK)
    frames = spiral_rays(range(0, 30 * (N_FRAMES + 1), 30))
    keep = ('rgb', 'depth', 'acc')
    level_frame = {'fused_level_fwd': 2 * chunks_per_frame,
                   'fused_composite_fwd': 2 * chunks_per_frame}
    counts = {}
    model = flagship_model('cuda', seed=0, config='nerf_embed')
    renderer = ImageRenderer(model, chunk=CHUNK, keep=keep,
                             levels=('fine',), quantize=True)
    secs, counts['frame'] = time_frames(renderer, frames, keep, level_frame,
                                        'nerf_embed frame')
    flag_secs = time_frames(
        ImageRenderer(flagship_model('cuda', seed=0), chunk=CHUNK, keep=keep,
                      levels=('fine',), quantize=True), frames, keep,
        level_frame, 'flagship frame')[0]
    phase(f'[26] nerf_embed: rendered {N_FRAMES} frames {W}x{H} (64+64, '
          f'chunk {CHUNK}): {secs:.4f} s/frame, the flagship\'s in the same '
          f'call {flag_secs:.4f} s/frame; launches {counts["frame"]} (= 2 '
          f'levels x {chunks_per_frame} chunks x {N_FRAMES} frames); no '
          f'plain call; {CARD}')
    small = torch.as_tensor(frames[0][::186][:1024]).cuda()
    with torch.no_grad():
        got = model(prepare_ray_dict(small))['fine']['rgb']
        with plain_versions():
            want = model(prepare_ray_dict(small))['fine']['rgb']
    diff = (got - want).abs()
    phase(f'[26] nerf_embed render of 1024 rays, kernels vs plain: fine rgb '
          f'max|d| {diff.max().item():.3e} mean {diff.mean().item():.3e} '
          f'(tol {RENDER_ATOL}, mean {RENDER_MEAN})')
    if not torch.isfinite(got).all() or diff.max() > RENDER_ATOL \
            or diff.mean() > RENDER_MEAN:
        raise AssertionError('nerf_embed render: kernels and plain versions '
                             'disagree')
    pkeep = keep + ('med_points',)
    renderer = ImageRenderer(model, chunk=CHUNK, keep=pkeep,
                             levels=('fine',), quantize=True)
    secs, counts['points'] = time_frames(
        renderer, frames[:2], pkeep,
        {'fused_template_fwd': 2 * chunks_per_frame,
         'fused_field_fwd': 4 * chunks_per_frame},
        'nerf_embed return_points frame')
    phase(f'[26] nerf_embed with return_points: 1 frame {W}x{H} after a '
          f'warm-up: {secs:.4f} s; launches {counts["points"]} (the warp '
          f'field and the sheet alone, the template alone with both '
          f'conditions); no level kernel, no plain call')
    del renderer, model
    torch.cuda.empty_cache()
    counts['query'] = query_sigma_path(
        'nerf_embed', {'fused_field_fwd': 2, 'fused_template_fwd': 1},
        '[26]')
    train_times = {}
    counts['train'] = train_path('nerf_embed', '[27]', train_times)
    torch.cuda.empty_cache()

    # The other cases: one frame and one step each.
    for config, base, over, want in (
            ('no_viewdirs', 'flagship', dict(use_viewdirs=False),
             level_frame),
            ('static_embed', 'static', PATHS['static_embed'][1],
             {'fused_template_fwd': 2 * chunks_per_frame}),
            ('anneal_embed', 'anneal', PATHS['anneal_embed'][1],
             level_frame)):
        model = flagship_model('cuda', seed=0, config=base, **over)
        extra = (eval_extra_params(model.config, TrainConfig())
                 if base == 'anneal' else None)
        renderer = ImageRenderer(model, chunk=CHUNK, keep=keep,
                                 levels=('fine',), quantize=True,
                                 extra_params=extra)
        secs, counts[f'{config}_frame'] = time_frames(
            renderer, frames[:2], keep, want, f'{config} frame')
        with torch.no_grad():
            got = model(prepare_ray_dict(small),
                        extra_params=extra)['fine']['rgb']
            with plain_versions():
                ref = model(prepare_ray_dict(small),
                            extra_params=extra)['fine']['rgb']
        diff = (got - ref).abs()
        phase(f'[27] {config}: 1 frame {W}x{H} after a warm-up: {secs:.4f} '
              f's; launches {counts[f"{config}_frame"]}; 1024 rays against '
              f'the plain versions: fine rgb max|d| {diff.max().item():.3e} '
              f'mean {diff.mean().item():.3e} (tol {RENDER_ATOL}, mean '
              f'{RENDER_MEAN})')
        if not torch.isfinite(got).all() or diff.max() > RENDER_ATOL \
                or diff.mean() > RENDER_MEAN:
            raise AssertionError(f'{config} render: kernels and plain '
                                 f'versions disagree')
        del renderer, model
        torch.cuda.empty_cache()
        counts[f'{config}_train'] = train_path(config, '[27]')
        torch.cuda.empty_cache()

    # The entry point with the three flags, kernels then plain versions.
    from hypernerf_tpu_torch import train as port_train
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         'tools')
    sys.path.insert(0, tools)
    import make_synthetic_scene
    cwd = os.getcwd()
    flags = ('--use_nerf_embedding', '--use_alpha_condition',
             '--use_rgb_condition')
    n = COND_TRAIN_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            scene = make_synthetic_scene.make_scene(
                os.path.join(tmp, 'scene'), **SMOKE_SCENE)
            trainer, counts['cli'] = trainer_run(
                smoke_argv(scene, 'cond', n, *flags), 'trainer with the '
                'three condition flags (kernels)')
            t = trainer.model.nerf_coarse
            if (t.alpha_head.in_features, t.rgb_branch.hidden_0.in_features)\
                    != (136, 175):
                raise AssertionError('the entry point built no conditions')
            metrics, speed = trainer.last_metrics, steps_per_second(trainer,
                                                                     n)
            del trainer
            reset_counts()
            with plain_versions():
                plain = port_train.main(smoke_argv(scene, 'cond_plain', n,
                                                   *flags))
            if any(fn.launches for fn in kernel_wrappers()[0].values()):
                raise AssertionError('the plain trainer launched a kernel')
            plain_metrics = plain.last_metrics
            del plain
        finally:
            os.chdir(cwd)
            sys.path.remove(tools)
    d_psnr = metrics['val/psnr'] - plain_metrics['val/psnr']
    phase(f'[27] python -m hypernerf_tpu_torch.train {" ".join(flags)}: {n} '
          f'steps (batch {SMOKE_BATCH}, 64+64, bf16) at {speed:.2f} steps/s; '
          f'launches {counts["cli"]}; val psnr {metrics["val/psnr"]:.3f} '
          f'against the plain versions\' {plain_metrics["val/psnr"]:.3f} '
          f'({d_psnr:+.3f} dB, tol {SMOKE_PSNR_TOL}); train loss '
          f'{metrics["train/loss"]:.5f} against '
          f'{plain_metrics["train/loss"]:.5f}; {CARD}')
    if not abs(d_psnr) <= SMOKE_PSNR_TOL or not all(
            math.isfinite(v) for v in metrics.values()):
        raise AssertionError('the entry point with the conditions: kernels '
                             'and plain versions disagree')
    for k in kernels:
        for path, launches in counts.items():
            if launches.get(k['name']):
                k[f'nerf_embed_{path}_launches'] = launches[k['name']]
    phase(f'[27] nerf_embed train step {train_times["secs"] * 1e3:.1f} '
          f'ms/step against the flagship\'s {TIMES["flagship_step"] * 1e3:.1f}'
          f' ms/step (phase 7 of this call); {CARD}')


# -- the warp x slicing x encoding combinations (ROADMAP B.4) ---------------

# Each combination, the existing configuration its kernels are timed beside
# in turns (the one it shares the most with: the table's warp and slicing,
# or the template's layout) and the sources of its new instantiations.
B4_COUNTERPARTS = {'anneal_se3': 'se3', 'anneal_quaternion': 'quaternion',
                   'plane_se3': 'plane', 'plane_quaternion': 'plane',
                   'plane_anneal': 'anneal', 'plane_anneal_se3': 'se3',
                   'plane_anneal_quaternion': 'quaternion'}
B4_FWD_SOURCES = {'anneal_se3': 'level_fwd_anneal_screw.cu',
                  'anneal_quaternion': 'level_fwd_anneal_screw.cu',
                  'plane_se3': 'level_fwd_plane_screw.cu',
                  'plane_quaternion': 'level_fwd_plane_screw.cu',
                  'plane_anneal': 'level_fwd_nerf_plane.cu',
                  'plane_anneal_se3': 'level_fwd_nerf_plane_screw.cu',
                  'plane_anneal_quaternion': 'level_fwd_nerf_plane_screw.cu'}
B4_SOURCES = ('level_fwd_anneal_screw.cu', 'level_fwd_plane_screw.cu',
              'level_fwd_nerf_plane.cu', 'level_fwd_nerf_plane_screw.cu',
              'fields_bwd_plane_screw.cu')
# The two combinations that take kernel B's new instantiations (the screw
# warps without a sheet; the plane_anneal_* ones share them), and the
# Nerfies plane layout's template alone and kernel A (plane_anneal's).
B4_B_CONFIGS = ('plane_se3', 'plane_quaternion')
B4_TMPL_CONFIG = 'plane_anneal'
B4_PAPER = ('anneal_se3', 'plane_anneal_se3')
for _c in B4_COUNTERPARTS:
    STEP_LAUNCHES[_c] = STEP_LAUNCHES['flagship']


def b4_names(config: str) -> dict:
    """The kernels line's names of a combination's new instantiations."""
    out = {'fwd': f'fused_level_fwd_{config}'}
    if config in B4_B_CONFIGS:
        out['B'] = f'fused_fields_bwd_{config}'
    if config == B4_TMPL_CONFIG:
        out.update(tmpl='fused_template_fwd_nerfies_plane',
                   A='fused_template_bwd_nerfies_plane')
    return out


def b4_kernel_phase(kernels) -> list:
    """Phase 28's kernel checks of the seven combinations at their probe
    weights and the alphas of ``flagship.b4_extra_params`` (both window rows
    in one call where the level has both): the compiled plans of the new
    tables and of the Nerfies plane template alone against their models;
    rows 1, 5, 8 and 9 against the JAX kernels' stored numbers
    (``tests/data/fused_b4_jax_ref.npz``) and against their plain versions,
    the forward at 37 x 13 and R = 8192, S = 128, the backward kernels at
    37 x 13 and, for the new instantiations, at R = 16384, S = 128; each new
    instantiation timed beside its counterpart's kernel (B4_COUNTERPARTS)
    in turns at R = 8192 and 16384, S = 128, with the share of its bound.
    Returns the new instantiations' entries of the kernels line (launches
    filled in by the paths phase)."""
    import importlib
    import torch
    import torch.nn.functional as F
    from hypernerf_tpu_torch import kernels as K
    from hypernerf_tpu_torch.flagship import (B4_LEVEL_CASES,
                                              B4_TEMPLATE_CASES, LEVEL_INPUTS,
                                              anneal_condition,
                                              b4_extra_params, b4_grad_layers,
                                              flagship_model,
                                              load_probe_weights,
                                              read_b4_reference)
    from hypernerf_tpu_torch.kernels import common
    from hypernerf_tpu_torch.kernels.fused_mlp import (cond_width, raw_pad,
                                                       template_layers)
    fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
    t_start = time.perf_counter()
    probes, rows = {}, {}
    for config in (*B4_COUNTERPARTS, *set(B4_COUNTERPARTS.values())):
        probes[config] = load_probe_weights(flagship_model('cuda',
                                                           config=config))
        extra = (b4_extra_params(config) if config in B4_COUNTERPARTS
                 else {'warp_alpha': WINDOW_ALPHA} if 'se3' in config
                 or 'quaternion' in config else {})
        rows[config] = probes[config].window_rows(extra, 'cuda')
    tables = set()
    for config in B4_COUNTERPARTS:
        lv = probes[config].level('fine')
        table, shapes = fl.level_table(lv), fl.pack_level(lv)[2]
        if table in tables:
            continue
        tables.add(table)
        for label, got, want in (
                ('level forward (row 1)', fl.compiled_forward_plan(table),
                 fl.forward_plan(table, shapes)),
                ('kernel B (row 5)', fl.compiled_fields_bwd_plan(table),
                 fl.fields_bwd_plan(table, shapes))):
            if got != want:
                raise AssertionError(f'{table} {label}: compiled plan {got} '
                                     f'!= model {want}')
    shapes = fl.pack_level(probes[B4_TMPL_CONFIG].level('fine'))[2]
    got = fl.compiled_stage_plan('template_nerfies_plane')
    if got != fl.stage_plan('template_nerfies_plane',
                            shapes[common.PLANE_TEMPLATE_LAYERS]):
        raise AssertionError(f'template_nerfies_plane: compiled plan {got}')
    phase(f'[28] plans (compiled = model) of the tables '
          f'{sorted(tables)} (the level forward and kernel B) and of the '
          f'Nerfies plane template alone')

    # The JAX kernels' numbers (tools/make_level_reference.py --only b4),
    # through the autograd Functions as training runs them: the forward
    # with both window rows, then A, then B.
    ref = read_b4_reference()
    errs = {n: [] for c in B4_COUNTERPARTS for n in b4_names(c).values()}
    for case, (config, level, *_) in B4_LEVEL_CASES.items():
        arrays = {k: torch.from_numpy(v).cuda() for k, v in ref[case].items()}
        lv = probes[config].level(level)
        args = [arrays[k].requires_grad_() for k in LEVEL_INPUTS]
        out = K.fused_level(lv, *args, *rows[config])
        errs[b4_names(config)['fwd']].append(hold_level(
            out.detach(), arrays['out'], f'{case} vs the stored JAX output',
            '[28]', SE3_LEVEL_ATOL))
        params = fl._level_params(lv)
        got = torch.autograd.grad(out, args + params, arrays['cotangent'])
        names = [f'd_{k}' for k in LEVEL_INPUTS] + [
            f'd{"wb"[i % 2]}{i // 2}' for i in range(len(params))]
        kept = [(n, g) for n, g in zip(names, got) if n in arrays]
        check_grads(f'{case} backward (A + B) vs the stored JAX gradients '
                    f'(every input, every db, dW of layers '
                    f'{b4_grad_layers(case)})', [n for n, _ in kept],
                    [g for _, g in kept], [arrays[n] for n, _ in kept],
                    l2_tol=SE3_LEVEL_GRAD_L2, tag='[28]')
    for case, (config, level, *_) in B4_TEMPLATE_CASES.items():
        arrays = {k: torch.from_numpy(v).cuda() for k, v in ref[case].items()}
        t = probes[config].template_of(level)
        x = arrays['x_raw'].requires_grad_()
        cond = arrays['rgb_cond'].requires_grad_()
        out = K.fused_template(t, x, cond, rows[config][1])
        errs['fused_template_fwd_nerfies_plane'].append(hold_level(
            out.detach(), arrays['out'], f'{case} (row 8) vs the stored JAX '
            f'output', '[28]'))
        layers = template_layers(t.template)
        got = torch.autograd.grad(out, [x, cond] + common.layer_params(
            layers), arrays['cotangent'])
        names = ['dx', 'd_rgb_cond'] + [f'd{"wb"[i % 2]}{i // 2}'
                                        for i in range(2 * len(layers))]
        kept = [(n, g) for n, g in zip(names, got) if n in arrays]
        errs['fused_template_bwd_nerfies_plane'].append(check_grads(
            f'{case} backward (A) vs the stored JAX gradients',
            [n for n, _ in kept], [g for _, g in kept],
            [arrays[n] for n, _ in kept], tag='[28]'))

    times, bounds = {}, {}
    gen = torch.Generator().manual_seed(28)
    with torch.no_grad():
        for config, other in B4_COUNTERPARTS.items():
            new = b4_names(config)
            lv, olv = probes[config].level('fine'), probes[other].level('fine')
            ws, ts = rows[config]
            ows, ots = rows[other]
            raw = raw_pad(lv)
            cw, ocw = cond_width(lv), cond_width(olv)
            screw = lv.warp.kind != 'translation'
            atol = SE3_LEVEL_ATOL if screw else LEVEL_ATOL
            for r, s in ((37, 13), (CHUNK, 128), (TRAIN_RAYS, 128)):
                args = level_inputs(r, s, s + 28)
                if cw != 39:  # the Nerfies condition
                    args[4] = torch.from_numpy(anneal_condition(
                        args[2].cpu().numpy(), 10.0)).cuda()
                if r <= CHUNK:
                    out, raw_t = fl._launch_forward(lv, *args, True, ws, ts)
                    want_out, want_raw_t = plain_forward(lv, args, ws, ts)
                    errs[new['fwd']] += [
                        hold_level(out, want_out, f'{config} level forward '
                                   f'R={r} S={s} vs plain: out', '[28]',
                                   atol),
                        hold_level(raw_t, want_raw_t, f'{config} level '
                                   f'forward R={r} S={s} vs plain: raw_t',
                                   '[28]')]
                    if 'tmpl' in new:
                        errs[new['tmpl']].append(hold_level(
                            K.fused_template(lv, raw_t, args[4], ts),
                            plain_template(lv, raw_t, args[4], ts),
                            f'{config} template alone (row 8) R={r} S={s} '
                            f'vs plain', '[28]'))
                    del out, want_out, want_raw_t
                else:
                    raw_t = fl._launch_forward(lv, *args, True, ws, ts)[1]
                g = torch.randn(r * s, 4, generator=gen).cuda()
                dx_t = F.pad(torch.randn(r * s, 3 + 8 if raw == 16 else 7,
                                         generator=gen),
                             (0, raw - (11 if raw == 16 else 7))).cuda()
                if r < 100 or (r == TRAIN_RAYS and 'A' in new):
                    got = K.fused_template_bwd(lv, raw_t, args[4], g, ts)
                    torch.cuda.synchronize()
                    worst = check_grads(
                        f'{config} template backward (A) R={r} S={s} vs '
                        f'plain', TEMPLATE_GRAD_NAMES,
                        [got[0], got[1], *got[2]],
                        plain_template_bwd(lv, raw_t, args[4], g, ts),
                        tag='[28]')
                    if 'A' in new:
                        errs[new['A']].append(worst)
                    del got
                if r < 100 or (r == TRAIN_RAYS and 'B' in new):
                    *rays, grads = K.fused_fields_bwd(lv, *args[:4], dx_t,
                                                      ws)
                    n_b = 4 + len(grads)
                    worst = check_grads(
                        f'{config} fields backward (B) R={r} S={s} vs plain',
                        SE3_FIELDS_GRAD_NAMES[:n_b], [*rays, *grads],
                        plain_fields_bwd(lv, args, dx_t, ws), tag='[28]')
                    if 'B' in new:
                        errs[new['B']].append(worst)
                    del rays, grads
                if r < 100:
                    continue
                # The counterpart's kernels on its own inputs, in turns.
                oargs = level_inputs(r, s, s + 28)
                if ocw != 39:
                    oargs[4] = torch.from_numpy(anneal_condition(
                        oargs[2].cpu().numpy(), 10.0)).cuda()
                oraw = fl._launch_forward(olv, *oargs, True, ows, ots)[1]
                times[new['fwd'], r] = [
                    cuda_ms(lambda: K.fused_level(lv, *args, ws, ts)),
                    cuda_ms(lambda: K.fused_level(olv, *oargs, ows, ots)),
                    cuda_ms(lambda: K.fused_level(olv, *oargs, ows, ots)),
                    cuda_ms(lambda: K.fused_level(lv, *args, ws, ts))]
                bounds[new['fwd'], r] = level_bound(lv, r, s, cw)
                todo = [('fwd', 'level forward (row 1)')]
                if r == CHUNK:
                    times['plain', new['fwd']] = cuda_ms(
                        lambda: plain_forward(lv, args, ws, ts), 2)
                if 'tmpl' in new:
                    times[new['tmpl'], r] = [
                        cuda_ms(lambda: K.fused_template(lv, raw_t, args[4],
                                                         ts)),
                        cuda_ms(lambda: K.fused_template(olv, oraw, oargs[4],
                                                         ots)),
                        cuda_ms(lambda: K.fused_template(olv, oraw, oargs[4],
                                                         ots)),
                        cuda_ms(lambda: K.fused_template(lv, raw_t, args[4],
                                                         ts))]
                    bounds[new['tmpl'], r] = template_fwd_bound(lv, r, s, raw,
                                                                cw)
                    todo.append(('tmpl', 'template alone (row 8)'))
                    if r == CHUNK:
                        times['plain', new['tmpl']] = cuda_ms(
                            lambda: plain_template(lv, raw_t, args[4], ts), 2)
                if r == TRAIN_RAYS and 'A' in new:
                    times[new['A'], r] = [
                        cuda_ms(lambda: K.fused_template_bwd(
                            lv, raw_t, args[4], g, ts), 3),
                        cuda_ms(lambda: K.fused_template_bwd(
                            olv, oraw, oargs[4], g, ots), 3),
                        cuda_ms(lambda: K.fused_template_bwd(
                            olv, oraw, oargs[4], g, ots), 3),
                        cuda_ms(lambda: K.fused_template_bwd(
                            lv, raw_t, args[4], g, ts), 3)]
                    bounds[new['A'], r] = template_bwd_bound(lv, r, s, raw,
                                                             cw)
                    times['plain', new['A']] = cuda_ms(
                        lambda: plain_template_bwd(lv, raw_t, args[4], g, ts),
                        1)
                    todo.append(('A', 'template backward (A, row 9)'))
                if r == TRAIN_RAYS and 'B' in new:
                    odx = torch.zeros(r * s, raw_pad(olv), device='cuda')
                    odx[:, :dx_t.shape[1]] = dx_t[:, :odx.shape[1]]
                    times[new['B'], r] = [
                        cuda_ms(lambda: K.fused_fields_bwd(
                            lv, *args[:4], dx_t, ws), 5),
                        cuda_ms(lambda: K.fused_fields_bwd(
                            olv, *oargs[:4], odx, ows), 5),
                        cuda_ms(lambda: K.fused_fields_bwd(
                            olv, *oargs[:4], odx, ows), 5),
                        cuda_ms(lambda: K.fused_fields_bwd(
                            lv, *args[:4], dx_t, ws), 5)]
                    bounds[new['B'], r] = fields_bwd_bound(lv, r, s, raw)
                    times['plain', new['B']] = cuda_ms(
                        lambda: plain_fields_bwd(lv, args, dx_t, ws), 1)
                    todo.append(('B', 'fields backward (B, row 5)'))
                for key, what in todo:
                    t, b_ms = times[new[key], r], bounds[new[key], r][0]
                    phase(f'[28] {config} {what} R={r} S={s}: {t[0]:.3f}, '
                          f'{t[3]:.3f} ms ({b_ms / min(t[0], t[3]):.1%} of '
                          f'its bound {b_ms:.3f} ms); {other}\'s in turns '
                          f'{t[1]:.3f}, {t[2]:.3f} ms')
                del raw_t, g, dx_t, oargs, oraw
                torch.cuda.empty_cache()
    csrc = 'hypernerf_tpu_torch/kernels/csrc/'
    sources = {'fwd': lambda c: (B4_FWD_SOURCES[c], 'level_fwd.cuh',
                                 'fused_level.cu'),
               'tmpl': lambda c: ('level_fwd_nerf_plane.cu',
                                  'template_fwd_plane.cu',
                                  'template_fwd.cuh'),
               'A': lambda c: TEMPLATE_BWD_SOURCES,
               'B': lambda c: ('fields_bwd_plane_screw.cu', 'fields_bwd.cuh',
                               'fused_level.cu')}
    replaces = {'fwd': 'fused_level.py:1322', 'tmpl': 'fused_mlp.py:656',
                'A': 'fused_mlp.py:736', 'B': 'fused_level.py:846'}
    entries = []
    for config, other in B4_COUNTERPARTS.items():
        for key, name in b4_names(config).items():
            r = TRAIN_RAYS if key in ('A', 'B') else CHUNK
            t = times[name, r]
            err = (dict(max_abs_err=max(errs[name])) if key in ('fwd', 'tmpl')
                   else error_keys(errs[name]))
            entry = dict(
                name=name, route='cuda',
                source=', '.join(csrc + f for f in sources[key](config)),
                replaces='hypernerf_tpu/ops/pallas/' + replaces[key],
                ms=min(t[0], t[3]), plain_ms=times['plain', name],
                bound_ms=bounds[name, r][0], bound_by=bounds[name, r][1],
                library_ms=None, counterpart=other,
                counterpart_ms=min(t[1], t[2]), rays=r, samples=128, **err)
            if key in ('fwd', 'tmpl'):
                t2 = times[name, TRAIN_RAYS]
                entry.update(ms_r16384=min(t2[0], t2[3]),
                             counterpart_ms_r16384=min(t2[1], t2[2]))
            entries.append(entry)
    phase(f'[28] the kernel checks of the seven combinations took '
          f'{time.perf_counter() - t_start:.1f} s; {CARD}')
    return entries


def b4_paths_phase(kernels) -> None:
    """Phase 29: the combinations through the entry points at full width.
    For the paper's two models (``anneal_se3``, ``plane_anneal_se3``): three
    504x378 frames through the level kernels after a warm-up, at the alphas
    ``eval`` renders a weight file at, beside the flagship's frames in the
    same call, and the train step at batch 16384 (64 + 64) from
    ``flagship.ANNEAL_PROBE_STEP`` (every window partly on) beside phase 7's
    flagship step; a ``return_points`` frame (the trunk, the template alone
    in the Nerfies plane layout) and ``query_sigma`` of ``plane_anneal_se3``;
    for the other five, the train step's 1024-ray check against the plain
    versions (the kernels' step counted). Fills in the launches of the new
    instantiations' entries (each path's counts set to 0 just before it and
    read just after)."""
    import torch
    from hypernerf_tpu_torch.configs import TrainConfig
    from hypernerf_tpu_torch.eval import eval_extra_params
    from hypernerf_tpu_torch.flagship import (H, W, b4_extra_params,
                                              flagship_model, spiral_rays,
                                              synthetic_train_rays)
    from hypernerf_tpu_torch.training.renderer import ImageRenderer
    t_start = time.perf_counter()
    chunks_per_frame = -(-W * H // CHUNK)
    frames = spiral_rays(range(0, 30 * (N_FRAMES + 1), 30))
    keep = ('rgb', 'depth', 'acc')
    level_frame = {'fused_level_fwd': 2 * chunks_per_frame,
                   'fused_composite_fwd': 2 * chunks_per_frame}
    counts = {c: {} for c in B4_COUNTERPARTS}
    flag_secs = time_frames(
        ImageRenderer(flagship_model('cuda', seed=0), chunk=CHUNK, keep=keep,
                      levels=('fine',), quantize=True), frames, keep,
        level_frame, 'flagship frame')[0]
    for config in B4_PAPER:
        model = flagship_model('cuda', seed=0, config=config)
        extra = eval_extra_params(model.config, TrainConfig())
        secs, counts[config]['frame'] = time_frames(
            ImageRenderer(model, chunk=CHUNK, keep=keep, levels=('fine',),
                          quantize=True, extra_params=extra),
            frames, keep, level_frame, f'{config} frame')
        phase(f'[29] {config}: rendered {N_FRAMES} frames {W}x{H} (64+64, '
              f'chunk {CHUNK}, alphas {extra}): {secs:.4f} s/frame, the '
              f'flagship\'s in the same call {flag_secs:.4f} s/frame; '
              f'launches {counts[config]["frame"]}; no plain call; {CARD}')
        if config == 'plane_anneal_se3':
            pkeep = keep + ('med_points',)
            secs, counts[config]['points'] = time_frames(
                ImageRenderer(model, chunk=CHUNK, keep=pkeep,
                              levels=('fine',), quantize=True,
                              extra_params=extra), frames[:2], pkeep,
                {'fused_se3_fwd': 2 * chunks_per_frame,
                 'fused_template_fwd': 2 * chunks_per_frame},
                f'{config} return_points frame', point_ch=11)
            phase(f'[29] {config} with return_points: 1 frame {W}x{H} after '
                  f'a warm-up: {secs:.4f} s; launches '
                  f'{counts[config]["points"]} (the trunk alone, the '
                  f'template alone in the Nerfies plane layout); no level '
                  f'kernel, no plain call')
            counts[config]['query'] = query_sigma_path(
                config, {'fused_se3_fwd': 1, 'fused_template_fwd': 1},
                '[29]')
        del model
        torch.cuda.empty_cache()
        times = {}
        counts[config]['train'] = train_path(config, '[29]', times)
        phase(f'[29] {config} train step {times["secs"] * 1e3:.1f} ms/step '
              f'against the flagship\'s {TIMES["flagship_step"] * 1e3:.1f} '
              f'ms/step (phase 7 of this call); {CARD}')
        torch.cuda.empty_cache()
    for config in B4_COUNTERPARTS:
        if config in B4_PAPER:
            continue
        model = flagship_model('cuda', seed=0, config=config).train()
        rays, rgbs = [torch.from_numpy(a).cuda()
                      for a in synthetic_train_rays(1024)]
        counts[config]['step_check'] = compare_step(
            model, rays, rgbs, '[29]',
            extra_params=b4_extra_params(config))
        phase(f'[29] {config}: the kernels\' step on 1024 rays launched '
              f'{counts[config]["step_check"]}')
        del model
        torch.cuda.empty_cache()
    wrapper = {'fwd': 'fused_level_fwd', 'tmpl': 'fused_template_fwd',
               'A': 'fused_template_bwd', 'B': 'fused_fields_bwd'}
    by_name = {k['name']: k for k in kernels}
    for config in B4_COUNTERPARTS:
        # A new instantiation runs on its own combination's paths; kernel
        # B's plane screw pair and the Nerfies plane template and kernel A
        # also on the paths of the combinations that share them.
        users = {'fwd': [config]}
        if config in B4_B_CONFIGS:
            users['B'] = [c for c in B4_COUNTERPARTS if c.startswith('plane')
                          and c.endswith(config.split('_')[1])]
        if config == B4_TMPL_CONFIG:
            users['tmpl'] = users['A'] = [c for c in B4_COUNTERPARTS
                                          if c.startswith('plane_anneal')]
        for key, name in b4_names(config).items():
            k = by_name[name]
            for user in users[key]:
                for path, launches in counts[user].items():
                    if launches.get(wrapper[key]):
                        k[f'{user}_{path}_launches'] = launches[wrapper[key]]
            k['launches'] = sum(v for f, v in k.items()
                                if f.endswith('_launches')
                                and not f.endswith('query_launches'))
    phase(f'[29] the paths of the seven combinations took '
          f'{time.perf_counter() - t_start:.1f} s')


# -- data-parallel training (ROADMAP A.12) and the call options (A.4) ---------

DP_STEPS, DP_WARMUP = 5, 2  # timed steps of a data-parallel window, after
DP_SMALL = 1024  # rays of the explicit batch held to the single process
DP_ZERO_STEPS = 3  # ZeRO-1 steps of the two ranks before their checkpoint
DP_CLI_STEPS = 8
DP_SCENE = dict(n_frames=3, width=80, height=60)


def dp_join(backend=None):
    """Join the launch of the environment (``parallel.distributed``); the
    rank's ``parallel.DataParallel`` context."""
    import torch
    from hypernerf_tpu_torch.parallel import distributed
    from hypernerf_tpu_torch.parallel.mesh import create_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not distributed.maybe_initialize_distributed(backend):
        raise AssertionError('no launch in the environment')
    return create_mesh()


def dp_draws(n: int, cfg, seed: int = 11) -> dict:
    """A train step's draws for ``n`` rays of the global batch."""
    import torch
    from hypernerf_tpu_torch.ops.sampling import sorted_uniform
    gen = torch.Generator(device='cuda').manual_seed(seed)
    s, nf = cfg.num_coarse_samples, cfg.num_fine_samples
    return {'t_rand': torch.rand(n, s, generator=gen, device='cuda'),
            'fine_u': sorted_uniform(n, nf, gen, device='cuda'),
            'noise_coarse': torch.randn(n, s, generator=gen, device='cuda'),
            'noise_fine': torch.randn(n, s + nf, generator=gen,
                                      device='cuda')}


def dp_compare_step(mesh):
    """One step on an explicit global batch of ``DP_SMALL`` rays through the
    data-parallel step (each rank its rows, then the all-reduce), from the
    seeded flagship weights with fixed draws, and on rank 0 the same step in
    one process on the whole batch: (loss, single-process loss, gradient
    errors) on rank 0, None elsewhere. Collective."""
    from hypernerf_tpu_torch.flagship import (flagship_train_config,
                                              flagship_train_setup)
    from hypernerf_tpu_torch.training.train_state import make_train_step

    def one(step_mesh):
        state, _, rays, rgbs = flagship_train_setup(
            'cuda', seed=0, batch_size=DP_SMALL, n_rays=DP_SMALL,
            mesh=step_mesh)
        model = state.model
        step_fn = make_train_step(
            model, state.optimizer, model.config,
            flagship_train_config('flagship', DP_SMALL), 'cuda',
            explicit_batch=True, mesh=step_mesh)
        loss = step_fn(state, rays, rgbs,
                       draws=dp_draws(DP_SMALL, model.config))['loss']
        return loss.item(), {k: p.grad.clone()
                             for k, p in model.named_parameters()}

    loss, grads = one(mesh)
    if mesh.rank:
        return None
    loss_one, grads_one = one(None)
    return loss, loss_one, step_grad_errors(grads, grads_one)


def dp_window(mesh, shard: bool) -> dict:
    """The flagship step at batch ``TRAIN_RAYS`` (global) through the
    data-parallel step over ``mesh`` (None: one process, no process group):
    ``DP_STEPS`` timed after ``DP_WARMUP``, the launches counted over the
    timed steps (2 of each step kernel a step on this rank, no plain call).
    Returns its ms/step, the fp32 gradient bytes a step all-reduces and the
    optimizer state bytes this rank holds."""
    import torch
    from hypernerf_tpu_torch.flagship import flagship_train_setup
    from hypernerf_tpu_torch.training.optimizers import moment_bytes
    state, step_fn, rays, rgbs = flagship_train_setup(
        'cuda', seed=0, batch_size=TRAIN_RAYS, mesh=mesh,
        train_overrides=dict(shard_optimizer_state=shard))
    for _ in range(DP_WARMUP):
        step_fn(state, rays, rgbs)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    losses = [step_fn(state, rays, rgbs)['loss'] for _ in range(DP_STEPS)]
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / DP_STEPS
    read_counts({k: v * DP_STEPS
                 for k, v in STEP_LAUNCHES['flagship'].items()},
                f'data-parallel step (shard {shard})')
    losses = [x.item() for x in losses]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f'data-parallel losses {losses}')
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    return dict(ms=secs * 1e3, optimizer=type(state.optimizer).__name__,
                grad_bytes=sum(g.numel() * 4 for g in grads),
                moment_bytes=moment_bytes(state.optimizer),
                loss=losses[-1])


def dp_world_rank(result_path: str) -> None:
    """Phase 30 (a), in each rank of a world of every card over NCCL: the
    single-process step, the data-parallel step with ZeRO-1 off and on, the
    single-process step again (in turns, each from the seeded weights), and
    the explicit-batch check. Rank 0 writes the numbers to
    ``result_path``."""
    import torch
    from hypernerf_tpu_torch.parallel import distributed
    mesh = dp_join('nccl')
    try:
        out = dict(world=mesh.world_size, backend='nccl')
        out['single'] = dp_window(None, False)
        out['dp'] = dp_window(mesh, False)
        out['dp_zero'] = dp_window(mesh, True)
        out['single_again'] = dp_window(None, False)
        out['compare'] = dp_compare_step(mesh)
    finally:
        distributed.shutdown()
    if mesh.rank == 0:
        out['peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(result_path, 'w') as f:
            json.dump(out, f)


def dp_zero_groups(model):
    """The model's parameters as ZeRO-1's three groups, and the hyper-sheet
    MLP's parameters (one module, packed once for both levels): the largest
    parameter, then the sheet's, then the rest. ZeRO's greedy split gives
    the first to rank 0 and, as the sheet's weights weigh less than it, the
    whole sheet to rank 1. At the one-group split every packed module has a
    parameter that each rank updates itself, which re-keys its blob anyway;
    here rank 0 updates none of the sheet's, so without the version bump its
    cached sheet blob would stay stale and the blob check would fail."""
    params = list(model.parameters())
    big = max(params, key=lambda p: p.numel())
    sheet = list(model.level('coarse').hyper.mlp.parameters())
    taken = {id(big)} | {id(p) for p in sheet}
    return [{'params': [big]}, {'params': sheet},
            {'params': [p for p in params if id(p) not in taken]}], sheet


def dp_two_ranks(result_path: str, backend: str) -> None:
    """Phase 30 (b), in each of two ranks: the split global batch against
    one process; ZeRO-1 over ``dp_zero_groups`` (rank 1 owns the whole
    hyper sheet): ``DP_ZERO_STEPS`` steps, a checkpoint saved over the two
    ranks and a step, the checkpoint restored on both ranks (each rank's
    share of the moments back bit for bit) and that step again; every
    parameter's version moved at each step, the ranks' parameters are equal
    bit for bit and each rank's cached level blobs equal a fresh pack of
    its parameters (hazard 1); a 504x378 frame over the two ranks against
    the one-rank frame. Rank 0 writes the numbers."""
    import copy
    import os

    import torch
    from hypernerf_tpu_torch.flagship import (flagship_model,
                                              flagship_train_config,
                                              flagship_train_setup,
                                              spiral_rays)
    from hypernerf_tpu_torch.kernels.fused_level import pack_level
    from hypernerf_tpu_torch.parallel import distributed
    from hypernerf_tpu_torch.parallel.mesh import barrier, gather_rows
    from hypernerf_tpu_torch.training import checkpoints
    from hypernerf_tpu_torch.training.optimizers import (get_optimizer,
                                                         moment_bytes)
    from hypernerf_tpu_torch.training.renderer import ImageRenderer
    from hypernerf_tpu_torch.training.train_state import make_train_step
    mesh = dp_join(backend)
    try:
        out = dict(world=mesh.world_size, backend=backend,
                   device=str(mesh.device))
        out['compare'] = dp_compare_step(mesh)
        state, _, rays, rgbs = flagship_train_setup(
            'cuda', seed=0, batch_size=TRAIN_RAYS, mesh=mesh)
        model = state.model
        train_cfg = flagship_train_config(
            'flagship', TRAIN_RAYS, dict(shard_optimizer_state=True))
        groups, sheet = dp_zero_groups(model)
        state.optimizer, schedule = get_optimizer(train_cfg, groups, 1000,
                                                  mesh=mesh)
        owners = {state.optimizer._param_to_rank[p] for p in sheet}
        out['sheet_params'] = sum(p.numel() for p in sheet)
        if owners != {1}:
            raise AssertionError(f'the sheet\'s parameters on ranks '
                                 f'{owners}, not on rank 1 alone')
        step_fn = make_train_step(model, state.optimizer, model.config,
                                  train_cfg, 'cuda', schedule=schedule,
                                  mesh=mesh)
        params = list(model.parameters())
        moved = []

        def zero_step():
            before = [p._version for p in params]
            loss = step_fn(state, rays, rgbs)['loss'].item()
            moved.append(all(p._version > v for p, v in zip(params, before)))
            return loss

        def flat():
            return torch.cat([p.detach().reshape(1, -1) for p in params], 1)

        def share():
            local = state.optimizer.optim.state
            return {i: {k: v.cpu().clone() for k, v in local[p].items()}
                    for i, p in enumerate(params) if p in local}

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_ZERO_STEPS):
            zero_step()
        torch.cuda.synchronize()
        out['zero_ms'] = (time.perf_counter() - t0) / DP_ZERO_STEPS * 1e3
        ckpt = checkpoints.save_checkpoint(
            os.path.join(os.path.dirname(result_path), 'zero_ckpt'),
            state.step, state)
        saved, p_saved = share(), flat()
        loss_next = zero_step()
        p_next = flat()
        barrier(mesh)  # rank 0's file is written
        checkpoints.restore_checkpoint(ckpt, state)
        restored = share()
        out['moments_restored'] = sorted(saved) == sorted(restored) and all(
            sorted(saved[i]) == sorted(restored[i])
            and all(torch.equal(v, restored[i][k])
                    for k, v in saved[i].items()) for i in saved)
        loss_again = zero_step()
        update = (p_next - p_saved).norm()
        out['resume'] = (loss_next, loss_again,
                         float((flat() - p_next).norm() / update))
        (rows,) = gather_rows(mesh, [flat()])
        out['params_equal'] = all(torch.equal(rows[0], r) for r in rows[1:])
        fresh = copy.deepcopy(model)  # new storage: a cache key never met
        blobs_equal = True
        for name in ('coarse', 'fine'):
            w, b, _ = pack_level(model.level(name))
            w2, b2, _ = pack_level(fresh.level(name))
            blobs_equal &= torch.equal(w, w2) and torch.equal(b, b2)
        if not (all(moved) and out['moments_restored']
                and out['params_equal'] and blobs_equal):
            raise AssertionError(f'rank {mesh.rank}: versions moved at each '
                                 f'ZeRO-1 step {moved}, moments restored '
                                 f'{out["moments_restored"]}, parameters '
                                 f'equal {out["params_equal"]}, cached level '
                                 f'blobs equal a fresh pack {blobs_equal}')
        out['moment_bytes'] = [int(x) for x in gather_rows(mesh, [
            torch.tensor([moment_bytes(state.optimizer)],
                         device=mesh.device)])[0].tolist()]
        del state, step_fn, fresh
        frame = spiral_rays([0])[0]
        render_model = flagship_model('cuda', seed=0)
        keep = ('rgb', 'depth', 'acc')
        sharded = ImageRenderer(render_model, chunk=CHUNK, keep=keep,
                                levels=('fine',), mesh=mesh)
        sharded(frame)  # the first launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sharded(frame)['fine']
        torch.cuda.synchronize()
        out['frame_s'] = time.perf_counter() - t0
        if mesh.rank == 0:
            want = ImageRenderer(render_model, chunk=CHUNK, keep=keep,
                                 levels=('fine',))(frame)['fine']
            diff = abs(got['rgb'] - want['rgb'])
            out['frame_rgb_max'] = float(diff.max())
            out['frame_rgb_mean'] = float(diff.mean())
            out['frame_depth_max'] = float(abs(got['depth']
                                               - want['depth']).max())
    finally:
        distributed.shutdown()
    if mesh.rank == 0:
        with open(result_path, 'w') as f:
            json.dump(out, f)


def data_parallel_phase() -> None:
    """Phase 30: data-parallel training on the card (ROADMAP A.12).
    (a) A world of every card over NCCL (one rank on a one-card machine,
    in this process; else one process a card): the flagship step at batch
    16384 through the data-parallel step, ZeRO-1 off and on, in turns with
    the single-process step, the launches counted, and one explicit-batch
    step held to the single process. (b) Two ranks (NCCL over two cards,
    else gloo with both on cuda:0): the split batch against one process,
    ZeRO-1 (rank 1 owning the whole hyper sheet) through a checkpoint saved
    and restored on both ranks, its versions, parameters and cached level
    blobs, a frame over the ranks. (c) ``train.main`` with ``--num_devices 1
    --shard_optimizer_state`` for 8 steps, resumed in one process."""
    import os
    import tempfile

    import torch
    from hypernerf_tpu_torch.flagship import H, W
    from hypernerf_tpu_torch.parallel import distributed
    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        # (a)
        path = os.path.join(tmp, 'world.json')
        if cards == 1:
            os.environ.update(HYPERNERF_COORDINATOR=f'localhost:'
                              f'{distributed.free_port()}',
                              HYPERNERF_NUM_PROCESSES='1',
                              HYPERNERF_PROCESS_ID='0', LOCAL_RANK='0')
            try:
                dp_world_rank(path)
            finally:
                for var in ('HYPERNERF_COORDINATOR', 'HYPERNERF_NUM_PROCESSES',
                            'HYPERNERF_PROCESS_ID', 'LOCAL_RANK'):
                    os.environ.pop(var, None)
        else:
            distributed.spawn(dp_world_rank, cards, (path,))
        with open(path) as f:
            a = json.load(f)
        loss, loss_one, (total, worst) = a['compare']
        sync = (a['dp']['ms'] - (a['single']['ms'] + a['single_again']['ms'])
                / 2)
        phase(f'[30] (a) world of {a["world"]} over NCCL ({CARD}): the '
              f'flagship step at batch {TRAIN_RAYS} (64+64, bf16, Adam), '
              f'{DP_STEPS} steps after {DP_WARMUP} in turns: single process '
              f'{a["single"]["ms"]:.2f} ms, data-parallel '
              f'{a["dp"]["ms"]:.2f} ms, with ZeRO-1 '
              f'{a["dp_zero"]["ms"]:.2f} ms ({a["dp_zero"]["optimizer"]}), '
              f'single process again {a["single_again"]["ms"]:.2f} ms: the '
              f'sync {sync:+.2f} ms a step; launches a step per rank: each '
              f'step kernel 2, no plain call; fp32 gradient bytes '
              f'all-reduced a step {a["dp"]["grad_bytes"]:,}; optimizer '
              f'state bytes on rank 0 {a["dp"]["moment_bytes"]:,} '
              f'(ZeRO-1 {a["dp_zero"]["moment_bytes"]:,}); peak '
              f'{a["peak_gib"]:.2f} GiB')
        phase(f'[30] (a) one step on {DP_SMALL} rays, data-parallel vs '
              f'single process: loss {loss:.6f} vs {loss_one:.6f} (tol '
              f'{STEP_LOSS_TOL}); gradients relative L2 {total:.3e}, worst '
              f'{worst[0]:.3e} at {worst[1]} (tol {STEP_GRAD_L2})')
        if not abs(loss - loss_one) <= STEP_LOSS_TOL or \
                not max(total, worst[0]) <= STEP_GRAD_L2:
            raise AssertionError('data-parallel step and single process '
                                 'disagree')
        # (b)
        path = os.path.join(tmp, 'two.json')
        backend = 'nccl' if cards >= 2 else 'gloo'
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        distributed.spawn(dp_two_ranks, 2, (path, backend),
                          local_ranks=(0, 1) if cards >= 2 else (0, 0))
        with open(path) as f:
            b = json.load(f)
        loss, loss_one, (total, worst) = b['compare']
        where = ('two cards' if cards >= 2 else
                 'both on cuda:0 (NCCL refuses two ranks on one device); its '
                 'times are no speed figure')
        loss_next, loss_again, resume_l2 = b['resume']
        phase(f'[30] (b) two ranks over {backend}, {where}: '
              f'{time.perf_counter() - t0:.1f} s with the processes\' start; '
              f'the split batch of {DP_SMALL} rays vs one process: loss '
              f'{loss:.6f} vs {loss_one:.6f}, gradients relative L2 '
              f'{total:.3e}, worst {worst[0]:.3e} at {worst[1]}; ZeRO-1 with '
              f'the hyper sheet\'s {b["sheet_params"]:,} parameters wholly on '
              f'rank 1 (rank 0 updates none of a packed module\'s '
              f'parameters): {DP_ZERO_STEPS} steps '
              f'({b["zero_ms"]:.1f} ms a step), a checkpoint saved over the '
              f'ranks and restored on both (each rank\'s share of the moments '
              f'back bit for bit), the step after it taken before and after '
              f'the restore: loss {loss_next:.6f} vs {loss_again:.6f}, '
              f'parameters apart by {resume_l2:.3e} of the update (tol '
              f'{STEP_GRAD_L2}); every parameter\'s version moved at each '
              f'step on each rank, the ranks\' parameters equal bit for bit, '
              f'each rank\'s cached level blobs equal a fresh pack (rank 0\'s '
              f'sheet blob would be stale without the bump); optimizer state '
              f'bytes per rank {b["moment_bytes"]}; a {W}x{H} frame over the '
              f'two ranks '
              f'({b["frame_s"]:.3f} s) vs one rank: fine rgb max|d| '
              f'{b["frame_rgb_max"]:.3e} mean {b["frame_rgb_mean"]:.3e} '
              f'(tol {RENDER_ATOL}, mean {RENDER_MEAN}), depth max|d| '
              f'{b["frame_depth_max"]:.3e}')
        if not abs(loss - loss_one) <= STEP_LOSS_TOL or \
                not max(total, worst[0]) <= STEP_GRAD_L2:
            raise AssertionError('two ranks and one process disagree')
        if not abs(loss_next - loss_again) <= STEP_LOSS_TOL or \
                not resume_l2 <= STEP_GRAD_L2:
            raise AssertionError('the step after the restored ZeRO-1 '
                                 'checkpoint is not the step before it')
        if not (b['frame_rgb_max'] <= RENDER_ATOL
                and b['frame_rgb_mean'] <= RENDER_MEAN):
            raise AssertionError('the frame over two ranks is not the '
                                 'one-rank frame')
        # (c)
        dp_cli(tmp)
    phase(f'[30] data-parallel training took '
          f'{time.perf_counter() - t_phase:.1f} s')


def dp_cli(tmp: str) -> None:
    """Phase 30 (c): ``train.main`` with ``--num_devices 1
    --shard_optimizer_state`` (one rank started as a process of its own)
    for ``DP_CLI_STEPS`` steps on a small scene, then a single-process run
    that resumes from its checkpoint for one step (launches counted)."""
    import os
    from hypernerf_tpu_torch import train as port_train
    from hypernerf_tpu_torch.training import checkpoints
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), 'tools'))
    import make_synthetic_scene
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        scene = make_synthetic_scene.make_scene(os.path.join(tmp, 'scene'),
                                                **DP_SCENE)
        size = ['--img_wh', str(DP_SCENE['width']), str(DP_SCENE['height']),
                '--val_check_interval', '1.0']
        t0 = time.perf_counter()
        out = port_train.main(smoke_argv(
            scene, 'dp', DP_CLI_STEPS, '--num_devices', '1',
            '--shard_optimizer_state', *size))
        secs = time.perf_counter() - t0
        ckpt = checkpoints.latest_checkpoint(os.path.join(tmp, 'ckpts', 'dp'))
        if out is not None or ckpt is None or \
                checkpoints.checkpoint_step(ckpt) != DP_CLI_STEPS:
            raise AssertionError(f'the launch returned {out}, checkpoint '
                                 f'{ckpt}')
        trainer, launches = trainer_run(smoke_argv(
            scene, 'dp_resumed', DP_CLI_STEPS + 1, '--ckpt_path', ckpt,
            *size), 'resume of the launch\'s checkpoint',
            start=DP_CLI_STEPS)
        if trainer.state.step != DP_CLI_STEPS + 1:
            raise AssertionError(f'resumed at {trainer.state.step}')
        phase(f'[30] (c) train.main --num_devices 1 --shard_optimizer_state: '
              f'{DP_CLI_STEPS} steps on {DP_SCENE["n_frames"]} frames '
              f'{DP_SCENE["width"]}x{DP_SCENE["height"]} in {secs:.1f} s '
              f'with the rank\'s start; checkpoint step {DP_CLI_STEPS} '
              f'resumed in one process to step {trainer.state.step}, '
              f'launches {launches}')
    finally:
        os.chdir(cwd)


def call_options_phase() -> None:
    """Phase 31 (ROADMAP A.4): a 504x378 flagship frame with ``near`` /
    ``far`` overrides and ``use_sample_at_infinity=False`` through the level
    kernels (launches counted) against the plain versions; the same frame
    without the options (the options must move it); a frame with
    ``metadata_encoded`` (the GLO table's rows of the ids) against the ids'
    frame."""
    import torch
    from hypernerf_tpu_torch.flagship import H, W, flagship_model, spiral_rays
    from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
    t_phase = time.perf_counter()
    model = flagship_model('cuda', seed=0)
    rays = torch.as_tensor(spiral_rays([0])[0]).cuda()
    options = dict(near=0.05, far=0.9, use_sample_at_infinity=False)

    @torch.no_grad()
    def frame(encoded: bool = False, **kw):
        outs = []
        for start in range(0, rays.shape[0], CHUNK):
            rd = prepare_ray_dict(rays[start:start + CHUNK])
            if encoded:  # the table's rows of the ids, read from metadata
                rd['metadata']['encoded_warp'] = model.encode_warp_embed(
                    rd['metadata'])
            outs.append(model(rd, return_weights=False,
                              metadata_encoded=encoded, **kw)['fine']['rgb'])
        return torch.cat(outs)

    chunks = -(-rays.shape[0] // CHUNK)
    reset_counts()
    got = frame(**options)
    torch.cuda.synchronize()
    read_counts({'fused_level_fwd': 2 * chunks,
                 'fused_composite_fwd': 2 * chunks}, 'call options frame')
    with plain_versions():
        want = frame(**options)
    default = frame()
    diff = (got - want).abs()
    moved = (got - default).abs().max().item()
    encoded = frame(encoded=True)
    enc_diff = (encoded - default).abs().max().item()
    phase(f'[31] a {W}x{H} frame with near {options["near"]}, far '
          f'{options["far"]}, use_sample_at_infinity False (the coarse level '
          f'keeps the config\'s): level kernels vs plain versions fine rgb '
          f'max|d| {diff.max().item():.3e} mean {diff.mean().item():.3e} '
          f'(tol {RENDER_ATOL}, mean {RENDER_MEAN}); the options move the '
          f'frame by max {moved:.3e}; launches 2 of each forward kernel a '
          f'chunk ({chunks} chunks), no plain call; metadata_encoded vs the '
          f'ids\' frame max|d| {enc_diff:.3e}; '
          f'{time.perf_counter() - t_phase:.1f} s')
    if not torch.isfinite(got).all() or diff.max() > RENDER_ATOL or \
            diff.mean() > RENDER_MEAN:
        raise AssertionError('call options: kernels and plain versions '
                             'disagree')
    if not moved > RENDER_ATOL:
        raise AssertionError('the call options did not move the frame')
    if enc_diff != 0.0:
        raise AssertionError('the metadata_encoded frame is not the ids\' '
                             'frame')


# -- 64 + 128 samples and the bench entry point (phase 32) -------------------

# The train CLI's default sample count (--N_importance 128): the fine level
# at S = 192, the coarse compositing with a fine draw of N = 128.
FINE128 = dict(num_fine_samples=128)
S192 = 64 + 128
PATHS['flagship_fine128'] = ('flagship', FINE128)
STEP_LAUNCHES['flagship_fine128'] = STEP_LAUNCHES['flagship']
# python -m hypernerf_tpu_torch.bench runs of phase 32 (b): (mode, --n_fine).
BENCH_RUNS = tuple((m, None) for m in (
    'flagship', 'se3', 'quaternion', 'anneal', 'occupancy', 'static', 'plane',
    'elastic', 'elastic_se3', 'elastic_quaternion', 'render',
    'render_occupancy')) + (('flagship', 128), ('render', 128))


def fine128_phase(kernels) -> None:
    """Phase 32 (a): 64 + 128 samples on the card. Rows 1, 9, 5 at the fine
    level's S = 192 (R = 16384: the train step's and the render's chunk at
    ``--render_chunk 16384``), row 2 with a fine draw of N = 128 from S =
    64 and row 7 at S = 192, each against its plain version and timed
    (their ``*_s192`` keys in the line); the 64 + 128 step on 1024 rays
    against the plain versions and the full-batch step (``train_path``:
    launches, ms/step, peak memory); a 1024-ray render against the plain
    versions."""
    import torch
    from hypernerf_tpu_torch.flagship import (flagship_model,
                                              load_probe_weights,
                                              spiral_rays)
    from hypernerf_tpu_torch.kernels import (fused_composite_bwd,
                                             fused_composite_bwd_plain,
                                             fused_composite_plain,
                                             fused_fields_bwd, fused_level,
                                             fused_template_bwd)
    from hypernerf_tpu_torch.kernels.fused_level import _launch_forward
    from hypernerf_tpu_torch.kernels.fused_mlp import chunk_plan
    from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    r, s = TRAIN_RAYS, S192
    lv = load_probe_weights(flagship_model('cuda', **FINE128)).level('fine')
    entry = {k['name']: k for k in kernels}
    with torch.no_grad():
        args = level_inputs(r, s, seed=s)
        g = torch.randn(r * s, 4, generator=torch.Generator().manual_seed(
            s)).cuda()
        out, raw_t = _launch_forward(lv, *args, want_raw_t=True)
        want_out, want_raw_t = plain_forward(lv, args)
        err1 = max(hold_level(out, want_out, f'level forward vs plain R={r} '
                              f'S={s}: out', '[32]'),
                   hold_level(raw_t, want_raw_t, f'level forward vs plain '
                              f'R={r} S={s}: raw_t', '[32]'))
        del out, want_out, want_raw_t
        t1 = (cuda_ms(lambda: fused_level(lv, *args)),
              cuda_ms(lambda: plain_forward(lv, args), 1))
        want_a = plain_template_bwd(lv, raw_t, args[4], g)
        got_a = fused_template_bwd(lv, raw_t, args[4], g)
        dx_t = want_a[0]
        got_b = fused_fields_bwd(lv, *args[:4], dx_t)
        err9 = check_grads(f'template backward (A) vs plain R={r} S={s}',
                           TEMPLATE_GRAD_NAMES,
                           [got_a[0], got_a[1], *got_a[2]], want_a,
                           tag='[32]')
        err5 = check_grads(f'fields backward (B) vs plain R={r} S={s}',
                           FIELDS_GRAD_NAMES, [*got_b[:4], *got_b[4]],
                           plain_fields_bwd(lv, args, dx_t), tag='[32]')
        del got_a, got_b, want_a
        t9 = (cuda_ms(lambda: fused_template_bwd(lv, raw_t, args[4], g), 3),
              cuda_ms(lambda: plain_template_bwd(lv, raw_t, args[4], g), 1))
        t5 = (cuda_ms(lambda: fused_fields_bwd(lv, *args[:4], dx_t), 3),
              cuda_ms(lambda: plain_fields_bwd(lv, args, dx_t), 1))
        del raw_t, dx_t, args, g
        torch.cuda.empty_cache()

        # Row 2: the coarse level's compositing with the fine draw, noise on
        # and sorted draws as training launches it, and timed alone.
        packed, z, dirs, u = composite_inputs(r, 64, 128, seed=s + 1,
                                              linspace_u=False)
        noise = torch.randn(r, 64, generator=torch.Generator().manual_seed(
            s + 1)).cuda()
        err2 = check_composite(packed, z, dirs, u, f'forward with noise R={r}'
                               f' S=64 N=128 u=sorted', noise=noise,
                               tag='[32]')
        err2 = max(err2, check_composite(packed, z, dirs, u, f'R={r} S=64 '
                                         f'N=128 u=sorted', tag='[32]'))
        t2 = (composite_kernel_ms(packed, z, dirs, u),
              cuda_ms(lambda: fused_composite_plain(packed, z, dirs, u), 3))

        # Row 7 at S = 192, noise on (d z leaves out the rays whose weight
        # sum passes within 1e-5 of 0.5: the median may pick the neighbour).
        gen = torch.Generator().manual_seed(s + 2)
        packed, z, dirs, _ = composite_inputs(r, s, 0, seed=s + 2,
                                              linspace_u=True)
        noise = torch.randn(r, s, generator=gen).cuda()
        d_outs = torch.randn(r, 6, generator=gen).cuda()
        d_w = (torch.randn(r, s, generator=gen) * 0.1).cuda()
        dnorm = torch.linalg.norm(dirs, dim=-1, keepdim=True)
        got = list(fused_composite_bwd(packed, z, dirs, noise, d_outs, d_w))
        want = list(fused_composite_bwd_plain(packed, z, dnorm, noise,
                                              d_outs, d_w))
        cum = torch.cumsum(fused_composite_plain(
            packed, z, dirs, None, noise=noise)['weights'], dim=-1)
        edge = ((cum - 0.5).abs() < 1e-5).any(-1)
        got[1] = got[1].masked_fill(edge[:, None], 0.0)
        want[1] = want[1].masked_fill(edge[:, None], 0.0)
        err7 = check_grads(f'compositing backward (C) vs plain R={r} S={s} '
                           f'({int(edge.sum())} rays on the median\'s edge)',
                           ['d_packed', 'd_z', 'd_dnorm', 'd_noise'], got,
                           want, COMPOSITE_GRAD_TOL, COMPOSITE_GRAD_TOL,
                           tag='[32]')
        t7 = (composite_bwd_kernel_ms(packed, z, dirs, noise, d_outs, d_w),
              cuda_ms(lambda: fused_composite_bwd_plain(
                  packed, z, dnorm, noise, d_outs, d_w)))
        del packed, z, dirs, u, noise, d_outs, d_w, got, want

    rows = {'fused_level_fwd': (t1, level_bound(lv, r, s), err1),
            'fused_template_bwd': (t9, template_bwd_bound(lv, r, s), err9[2]),
            'fused_fields_bwd': (t5, fields_bwd_bound(lv, r, s), err5[2]),
            'fused_composite_fwd': (t2, composite_fwd_bound(r, 64, 128),
                                    err2),
            'fused_composite_bwd': (t7, composite_bwd_bound(r, s), err7[2])}
    for name, ((ms, plain_ms), (b_ms, b_by), err) in rows.items():
        entry[name].update({'ms_s192': ms, 'plain_ms_s192': plain_ms,
                            'bound_ms_s192': b_ms, 'bound_by_s192': b_by})
        entry[name]['max_abs_err'] = max(entry[name]['max_abs_err'], err)
        phase(f'[32] {name} at 64 + 128 (R={r}, '
              + ('S=64 N=128' if name == 'fused_composite_fwd' else f'S={s}')
              + f'): kernel {ms:.4f} ms ({b_ms / ms:.1%} of its bound '
              f'{b_ms:.4f} ms, {b_by}), plain {plain_ms:.3f} ms; {CARD}')
    plan = chunk_plan(r * s, s)
    phase(f'[32] kernel A at R={r} S={s}: {len(plan)} chunks of whole rays, '
          f'{(plan[0][1] - plan[0][0]) // s} rays each, the last '
          f'{(plan[-1][1] - plan[-1][0]) // s}')
    del lv

    # The step on 1024 rays against the plain versions, then the
    # full-batch step (launches, ms/step, peak memory).
    times = {}
    train_path('flagship_fine128', '[32]', times)
    TIMES['fine128_step'] = times
    torch.cuda.empty_cache()

    # A render of 1024 rays at 64 + 128 against the plain versions.
    model = flagship_model('cuda', seed=0, **FINE128)
    small = torch.as_tensor(spiral_rays([0])[0][::186][:1024]).cuda()
    with torch.no_grad():
        got = model(prepare_ray_dict(small))['fine']['rgb']
        with plain_versions():
            want = model(prepare_ray_dict(small))['fine']['rgb']
    diff = (got - want).abs()
    if not torch.isfinite(got).all() or diff.max() > RENDER_ATOL \
            or diff.mean() > RENDER_MEAN:
        raise AssertionError(f'64 + 128 render kernels vs plain: max '
                             f'{diff.max().item():.3e} mean '
                             f'{diff.mean().item():.3e}')
    phase(f'[32] render of 1024 rays at 64 + 128, kernels vs plain: fine rgb '
          f'max|d| {diff.max().item():.3e} mean {diff.mean().item():.3e} '
          f'(tol {RENDER_ATOL}, mean {RENDER_MEAN}); phase (a) '
          f'{time.perf_counter() - t_phase:.1f} s')


def bench_phase() -> None:
    """Phase 32 (b): ``hypernerf_tpu_torch.bench.main`` in this process for
    each of the twelve modes at their defaults and with ``--n_fine 128`` in
    a train mode and a render mode: each JSON line printed with its mode,
    its value finite and positive, the mode's kernels launched and no plain
    version called."""
    import contextlib
    import io
    from hypernerf_tpu_torch import bench
    t_phase = time.perf_counter()
    wrappers, plains = kernel_wrappers()
    for mode, n_fine in BENCH_RUNS:
        argv = ['--mode', mode] + ([] if n_fine is None
                                   else ['--n_fine', str(n_fine)])
        reset_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            bench.main(argv)
        lines = out.getvalue().strip().splitlines()
        line = json.loads(lines[-1])
        launches = {k: fn.launches for k, fn in wrappers.items()
                    if fn.launches}
        plain_calls = [fn.calls for fn in plains]
        missing = [k for k in bench.MODE_KERNELS[mode] if k not in launches]
        if any(plain_calls) or missing or not (
                math.isfinite(line['value']) and line['value'] > 0):
            raise AssertionError(f'bench {" ".join(argv)}: {line}; launches '
                                 f'{launches}, missing {missing}; plain '
                                 f'calls {plain_calls}')
        label = ' '.join(argv)
        phase(f'[32] bench {label}: {lines[0]} ({time.perf_counter() - t0:.1f}'
              f' s)')
        print(f'[32] bench {label} JSON: {json.dumps(line)}', flush=True)
    phase(f'[32] bench: {len(BENCH_RUNS)} runs of python -m '
          f'hypernerf_tpu_torch.bench in {time.perf_counter() - t_phase:.1f} '
          f's; {CARD}')


# -- --precision 32 (ROADMAP A.13.1): the float32 kernels of rows 1, 9, 5 ----

# The train CLI's --precision 32 at its other defaults (64 + 128 samples).
F32 = dict(compute_dtype='float32')
F32_FINE128 = dict(FINE128, **F32)
PATHS['flagship_f32'] = ('flagship', F32_FINE128)
STEP_LAUNCHES['flagship_f32'] = {
    'fused_level_fwd_f32': 2, 'fused_composite_fwd': 2,
    'fused_template_bwd_f32': 2, 'fused_fields_bwd_f32': 2,
    'fused_composite_bwd': 2}
F32_STEP_KERNELS = tuple(STEP_LAUNCHES['flagship_f32'])
F32_SOURCES = ('f32_level.cu', 'f32_steps.cu')
CSRC_DIR = 'hypernerf_tpu_torch/kernels/csrc/'
# name -> (its source, the TPU kernel it replaces at float32).
F32_ROWS = {
    'fused_level_fwd_f32': (CSRC_DIR + 'f32_level.cu',
                            'hypernerf_tpu/ops/pallas/fused_level.py:1322'),
    'fused_template_bwd_f32': (CSRC_DIR + 'f32_steps.cu',
                               'hypernerf_tpu/ops/pallas/fused_mlp.py:736'),
    'fused_fields_bwd_f32': (CSRC_DIR + 'f32_steps.cu',
                             'hypernerf_tpu/ops/pallas/fused_level.py:846')}
# The least time of float32-exact products on an H100 SXM: three TF32
# products at the dense 495 TFLOP/s; the FFMA pipes' peak beside it.
F32_PEAK_FLOPS, FFMA_PEAK_FLOPS = 165e12, 66.9e12
# Kernel vs plain, both float32 on the card with TF32 off: the same
# arithmetic in another summation order, which the 2^9 posenc band
# amplifies where it moves a warped point (measured on an H100: the level
# 1.5e-7 relative, gradients up to 2.4e-6). Allowed: the level's output and
# raw_t relative L2 1e-4 and max|d| 1e-3, and at most a tenth of the bf16
# kernel's error against the same float32 plain (1.4e-2 there); rows 9 and
# 5 relative L2 1e-2 per output (the repo's float32 full-width bound, a
# ReLU that falls on the other side) and 5e-2 of the largest entry, and
# their worst at most a tenth of the bf16 kernel's (0.16 and 0.13 there).
F32_OUT_L2, F32_OUT_MAX = 1e-4, 1e-3
F32_GRAD_L2, F32_GRAD_MAX = 1e-2, 5e-2
# The 1024-ray float32 step, kernels vs plain: the loss relative 1e-5, the
# gradients relative L2 1e-2 over all parameters.
F32_STEP_TOLS = (1e-5, 1e-2)
# Against tests/data/fused_f32_jax_ref.npz: outputs 1e-4 of the largest
# entry, gradients F32_GRAD_L2 / F32_GRAD_MAX (tests/test_torch_plane.py's
# float32 rule; the CPU's plain level reads 8.8e-5 and 7.8e-3).
F32_REF_OUT = 1e-4


def f32_bound(flops: float, nbytes: float):
    """(bound_ms, bound_by, the FFMA ceiling's ms): float32-exact products
    at F32_PEAK_FLOPS or the bytes at the memory rate, and the operations
    at the FFMA peak."""
    ops_ms, bytes_ms = flops / F32_PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return ((ops_ms, 'operations') if ops_ms >= bytes_ms else
            (bytes_ms, 'bytes')) + (flops / FFMA_PEAK_FLOPS * 1e3,)


def f32_level_bound(level, n_rays: int, samples: int, cond: int = 39):
    """Row 1 at float32: a multiply-add per weight and sample; bytes the
    ray inputs (fp32: z per sample, origin, direction, embedding and
    condition per ray), the weights once, the output."""
    macs = sum(level_macs(level))
    p = n_rays * samples
    return f32_bound(2.0 * macs * p,
                     4 * p + 4 * n_rays * (14 + cond) + 4 * macs + 16 * p)


def f32_template_bwd_bound(level, n_rays: int, samples: int,
                           cond: int = 39, raw: int = 8):
    """Kernel A at float32: the recompute, g W and g^T h a multiply-add per
    weight and row each; bytes raw_t (``raw`` fp32), g and dx_t per row,
    the condition and its cotangent per ray, the weights and dW once."""
    t_macs = level_macs(level)[1]
    p = n_rays * samples
    return f32_bound(6.0 * t_macs * p,
                     p * (8 * raw + 16) + 8 * n_rays * cond + 8 * t_macs)


def f32_fields_bwd_bound(level, n_rays: int, samples: int, raw: int = 8):
    """Kernel B at float32: the same per weight of the field layers; bytes
    z, dx_t (``raw`` fp32) and d z per row, the ray inputs and their
    cotangents per ray, the weights and dW once."""
    f_macs = level_macs(level)[0]
    p = n_rays * samples
    return f32_bound(6.0 * f_macs * p,
                     p * (4 + 4 * raw + 4) + 8 * n_rays * 14 + 8 * f_macs)


def f32_rows_phase(model, bf16) -> dict:
    """Phase 33 (b): rows 1, 9 and 5 at float32 against their plain
    versions (row 1 at R = 8192, S = 128 and R = 16384, S = 128 and 192;
    rows 9 and 5 at R = 16384, S = 128 and 192), each beside the bf16
    kernel's error against the same float32 plain, and timed. Returns
    {name: {shape key: (ms, plain ms, bound, error)}}."""
    import torch
    from hypernerf_tpu_torch.kernels import (fused_fields_bwd, fused_level,
                                             fused_template_bwd)
    from hypernerf_tpu_torch.kernels.fused_level import _launch_forward
    lv, lb = model.level('fine'), bf16.level('fine')
    rows = {name: {} for name in F32_ROWS}
    for r, s in ((8192, 128), (16384, 128), (TRAIN_RAYS, S192)):
        key = f'R{r}_S{s}'
        with torch.no_grad():
            args = level_inputs(r, s, seed=s + r // 1024)
            out, raw_t = _launch_forward(lv, *args, want_raw_t=True)
            want, want_raw = plain_forward(lv, args)
            e_out, e_raw, e_bf = ((e[0], e[2]) for e in (
                grad_errors(out, want), grad_errors(raw_t, want_raw),
                grad_errors(fused_level(lb, *args), want)))
            del out, raw_t
            ok = (max(e_out[0], e_raw[0]) <= F32_OUT_L2
                  and max(e_out[1], e_raw[1]) <= F32_OUT_MAX
                  and e_out[0] <= 0.1 * e_bf[0] and e_out[1] <= 0.1 * e_bf[1])
            t1 = (cuda_ms(lambda: fused_level(lv, *args), 3),
                  cuda_ms(lambda: plain_forward(lv, args), 1))
            b1 = f32_level_bound(lv, r, s)
            phase(f'[33] row 1 float32 R={r} S={s}: out relative L2 '
                  f'{e_out[0]:.3e} max|d| {e_out[1]:.3e}, raw_t '
                  f'{e_raw[0]:.3e} / {e_raw[1]:.3e} (tol {F32_OUT_L2} / '
                  f'{F32_OUT_MAX}); the bf16 kernel against the same float32 '
                  f'plain {e_bf[0]:.3e} / {e_bf[1]:.3e} (the float32 error at '
                  f'most a tenth of it); kernel {t1[0]:.3f} ms, plain '
                  f'{t1[1]:.3f} ms; bound {b1[0]:.3f} ms ({b1[1]}, '
                  f'{b1[0] / t1[0]:.1%}), FFMA ceiling {b1[2]:.3f} ms '
                  f'({b1[2] / t1[0]:.1%}); {CARD}')
            if not ok:
                raise AssertionError('row 1 float32: the kernel disagrees')
            rows['fused_level_fwd_f32'][key] = (*t1, b1, e_out[1])
            if r != TRAIN_RAYS:
                del args, want, want_raw
                continue
            g = torch.randn(r * s, 4, generator=torch.Generator().manual_seed(
                s)).cuda()
            want_a = plain_template_bwd(lv, want_raw, args[4], g)
            got_a = fused_template_bwd(lv, want_raw, args[4], g)
            err9 = check_grads(f'row 9 (kernel A) float32 vs plain R={r} '
                               f'S={s}', TEMPLATE_GRAD_NAMES,
                               [got_a[0], got_a[1], *got_a[2]], want_a,
                               F32_GRAD_L2, F32_GRAD_MAX, tag='[33]')
            del got_a
            got_bf = fused_template_bwd(lb, want_raw, args[4], g)
            bf9 = max(grad_errors(a, b)[0] for a, b in zip(
                [got_bf[0], got_bf[1], *got_bf[2]], want_a))
            del got_bf
            dx_t = want_a[0]
            want_b = plain_fields_bwd(lv, args, dx_t)
            got_b = fused_fields_bwd(lv, *args[:4], dx_t)
            err5 = check_grads(f'row 5 (kernel B) float32 vs plain R={r} '
                               f'S={s}', FIELDS_GRAD_NAMES,
                               [*got_b[:4], *got_b[4]], want_b, F32_GRAD_L2,
                               F32_GRAD_MAX, tag='[33]')
            got_bf = fused_fields_bwd(lb, *args[:4], dx_t)
            bf5 = max(grad_errors(a, b)[0] for a, b in zip(
                [*got_bf[:4], *got_bf[4]], want_b))
            del got_b, got_bf, want_b
            t9 = (cuda_ms(lambda: fused_template_bwd(lv, want_raw, args[4],
                                                     g), 1),
                  cuda_ms(lambda: plain_template_bwd(lv, want_raw, args[4],
                                                     g), 1))
            t5 = (cuda_ms(lambda: fused_fields_bwd(lv, *args[:4], dx_t), 1),
                  cuda_ms(lambda: plain_fields_bwd(lv, args, dx_t), 1))
            for name, t, b, err, bf in (
                    ('fused_template_bwd_f32', t9,
                     f32_template_bwd_bound(lv, r, s), err9, bf9),
                    ('fused_fields_bwd_f32', t5,
                     f32_fields_bwd_bound(lv, r, s), err5, bf5)):
                phase(f'[33] {name} R={r} S={s}: kernel {t[0]:.3f} ms, plain '
                      f'{t[1]:.3f} ms; bound {b[0]:.3f} ms ({b[1]}, '
                      f'{b[0] / t[0]:.1%}), FFMA ceiling {b[2]:.3f} ms '
                      f'({b[2] / t[0]:.1%}); worst relative L2 {err[0]:.3e} '
                      f'against the bf16 kernel\'s {bf:.3e} against the '
                      f'same float32 plain (at most a tenth of it); {CARD}')
                if err[0] > 0.1 * bf:
                    raise AssertionError(f'{name} float32: the kernel is no '
                                         f'closer to plain than a tenth of '
                                         f'the bf16 kernel')
                rows[name][key] = (*t, b, err[2])
            del args, want, want_raw, g, want_a, dx_t
        torch.cuda.empty_cache()
    # Rows 9 and 5 at S = 128 (timed; held to plain at S = 192 above).
    r, s = 16384, 128
    with torch.no_grad():
        args = level_inputs(r, s, seed=7)
        _, raw_t = _launch_forward(lv, *args, want_raw_t=True)
        g = torch.randn(r * s, 4, generator=torch.Generator().manual_seed(
            7)).cuda()
        dx_t = fused_template_bwd(lv, raw_t, args[4], g)[0]
        t9 = (cuda_ms(lambda: fused_template_bwd(lv, raw_t, args[4], g), 1),
              cuda_ms(lambda: plain_template_bwd(lv, raw_t, args[4], g), 1))
        t5 = (cuda_ms(lambda: fused_fields_bwd(lv, *args[:4], dx_t), 1),
              cuda_ms(lambda: plain_fields_bwd(lv, args, dx_t), 1))
        for name, t, b in (('fused_template_bwd_f32', t9,
                            f32_template_bwd_bound(lv, r, s)),
                           ('fused_fields_bwd_f32', t5,
                            f32_fields_bwd_bound(lv, r, s))):
            phase(f'[33] {name} R={r} S={s}: kernel {t[0]:.3f} ms, plain '
                  f'{t[1]:.3f} ms; bound {b[0]:.3f} ms ({b[1]}, '
                  f'{b[0] / t[0]:.1%}), FFMA ceiling {b[2]:.3f} ms '
                  f'({b[2] / t[0]:.1%}); {CARD}')
            rows[name][f'R{r}_S{s}'] = (*t, b, 0.0)
        del args, raw_t, g, dx_t
    torch.cuda.empty_cache()
    return rows


def f32_reference_phase(model) -> None:
    """Phase 33 (c): rows 1, 9 and 5 (the level, then its backward, A then
    B, through the autograd Function) against the JAX level kernel's stored
    float32 numbers (tests/data/fused_f32_jax_ref.npz)."""
    import numpy as np
    import torch
    from hypernerf_tpu_torch.flagship import (F32_GRAD_LAYERS, LEVEL_INPUTS,
                                              read_f32_reference)
    from hypernerf_tpu_torch.kernels import fused_level
    from hypernerf_tpu_torch.kernels.fused_level import level_layers
    ref = read_f32_reference()['level']
    lv = model.level('fine')
    model.zero_grad(set_to_none=True)
    args = [torch.tensor(ref[k]).cuda().requires_grad_(True)
            for k in LEVEL_INPUTS]
    out = fused_level(lv, *args)
    want = torch.tensor(ref['out']).cuda()
    out_err = ((out - want).abs().max() / want.abs().max()).item()
    out.backward(torch.tensor(ref['cotangent']).cuda())
    names, got, wants = [], [], []
    for k, a in zip(LEVEL_INPUTS, args):
        names.append(f'd_{k}')
        got.append(a.grad)
    for l, (lin, _) in enumerate(level_layers(lv)):
        names.append(f'db{l}')
        got.append(lin.bias.grad)
        if l in F32_GRAD_LAYERS:
            names.append(f'dw{l}')
            got.append(lin.weight.grad)
    wants = [torch.tensor(np.asarray(ref[n])).cuda() for n in names]
    model.zero_grad(set_to_none=True)
    phase(f'[33] rows 1, 9, 5 float32 against the stored JAX numbers '
          f'(64 x 128, the probe weights): outputs max|d| {out_err:.3e} of '
          f'the largest entry (tol {F32_REF_OUT})')
    check_grads('rows 9 + 5 float32 against the stored JAX gradients', names,
                got, wants, F32_GRAD_L2, F32_GRAD_MAX, tag='[33]')
    if not out_err <= F32_REF_OUT:
        raise AssertionError('row 1 float32 against the stored JAX outputs')


def f32_composite_phase(model) -> None:
    """Phase 33 (d): rows 2 and 7 on the float32 level's outputs (R =
    16384: the coarse level at S = 64 with a fine draw of N = 128, noise on;
    the backward at S = 192) against their plain versions."""
    import torch
    from hypernerf_tpu_torch.kernels import (fused_composite_bwd,
                                             fused_composite_bwd_plain,
                                             fused_composite_plain,
                                             fused_level)
    r = TRAIN_RAYS
    lv = model.level('fine')
    gen = torch.Generator().manual_seed(33)
    with torch.no_grad():
        args = level_inputs(r, 64, seed=64)
        packed = fused_level(lv, *args)
        u = torch.sort(torch.rand(r, 128, generator=gen), -1)[0].cuda()
        noise = torch.randn(r, 64, generator=gen).cuda()
        err2 = check_composite(packed, args[0], args[2], u, f'forward on the '
                               f'float32 level\'s output R={r} S=64 N=128 '
                               f'u=sorted', noise=noise, tag='[33]')
        args = level_inputs(r, S192, seed=65)
        packed = fused_level(lv, *args)
        z, dirs = args[0], args[2]
        noise = torch.randn(r, S192, generator=gen).cuda()
        d_outs = torch.randn(r, 6, generator=gen).cuda()
        d_w = (torch.randn(r, S192, generator=gen) * 0.1).cuda()
        dnorm = torch.linalg.norm(dirs, dim=-1, keepdim=True)
        got = list(fused_composite_bwd(packed, z, dirs, noise, d_outs, d_w))
        want = list(fused_composite_bwd_plain(packed, z, dnorm, noise,
                                              d_outs, d_w))
        cum = torch.cumsum(fused_composite_plain(
            packed, z, dirs, None, noise=noise)['weights'], dim=-1)
        edge = ((cum - 0.5).abs() < 1e-5).any(-1)
        got[1] = got[1].masked_fill(edge[:, None], 0.0)
        want[1] = want[1].masked_fill(edge[:, None], 0.0)
        err7 = check_grads(f'compositing backward on the float32 level\'s '
                           f'output R={r} S={S192} ({int(edge.sum())} rays '
                           f'on the median\'s edge)',
                           ['d_packed', 'd_z', 'd_dnorm', 'd_noise'], got,
                           want, COMPOSITE_GRAD_TOL, COMPOSITE_GRAD_TOL,
                           tag='[33]')
    phase(f'[33] rows 2 and 7 on the float32 level: forward max|d| '
          f'{err2:.3e}, backward worst relative L2 {err7[0]:.3e}')


def f32_render_phase() -> float:
    """Phase 33 (f): one 504x378 float32 frame (64 + 128, chunk 16384,
    seeded init) through the renderer ``eval`` uses: the float32 level and
    the compositing kernels on every chunk and level, no plain call.
    Returns its seconds."""
    import torch
    from hypernerf_tpu_torch.flagship import H, W, flagship_model, spiral_rays
    from hypernerf_tpu_torch.training.renderer import ImageRenderer
    chunk = 16384
    model = flagship_model('cuda', seed=0, **F32_FINE128)
    renderer = ImageRenderer(model, chunk=chunk, keep=('rgb', 'depth',
                                                       'acc'),
                             levels=('fine',), quantize=True)
    frame = spiral_rays([30])[0]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = renderer(frame)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    chunks = -(-W * H // chunk)
    launches = read_counts({'fused_level_fwd_f32': 2 * chunks,
                            'fused_composite_fwd': 2 * chunks},
                           'a float32 frame')
    if out['fine']['rgb'].shape != (W * H, 3):
        raise AssertionError(f'float32 frame: {out["fine"]["rgb"].shape}')
    phase(f'[33] a float32 frame {W}x{H} (64+128, chunk {chunk}, the first '
          f'at this chunk): {secs:.3f} s; launches {launches}; no plain '
          f'call; {CARD}')
    return secs


def f32_refusals_phase(refused=None, tag='[34]') -> None:
    """Phase 34 (e) (and 36 (d)): float32 configurations and paths that the
    float32 kernels do not cover (``refused``, default F32_REFUSED) refuse
    on the card, naming ROADMAP A.13 (no plain fallback)."""
    import torch
    from hypernerf_tpu_torch.flagship import flagship_model, spiral_rays
    from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
    rays = torch.as_tensor(spiral_rays([0])[0][:64]).cuda()
    said = []
    for label, config, overrides, call in refused or F32_REFUSED:
        model = flagship_model('cuda', config=config, **overrides, **F32)
        try:
            with torch.no_grad():
                model(prepare_ray_dict(rays), **call)
        except NotImplementedError as e:
            item = re.search(r'ROADMAP item A\.13\b', str(e))
            if item is None:
                raise
            said.append(f'{label}: {item.group(0)}')
        else:
            raise AssertionError(f'float32 {label} ran on the card')
        del model
    torch.cuda.empty_cache()
    phase(f'{tag} float32 refused on the card, naming ROADMAP A.13: '
          + '; '.join(said))


def f32_trainer_phase() -> dict:
    """Phase 33 (h): ``train.main([... '--precision', '32'])`` as phase 25
    runs the bf16 trainer (36 steps at batch 4096, 64 + 64, on an 8-frame
    160x120 scene in a temporary directory) with its launches counted,
    ``eval --precision 32`` of its checkpoint, and the same 36 steps through
    the plain versions: the training frames' PSNR at step 36 and the val
    PSNR of both, beside phase 25's bf16 pair. Returns the figures."""
    import io
    import os
    import tempfile

    import torch
    from hypernerf_tpu_torch import eval as port_eval
    from hypernerf_tpu_torch import train as port_train
    t_phase = time.perf_counter()
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         'tools')
    sys.path.insert(0, tools)
    import make_synthetic_scene
    cwd = os.getcwd()
    n = SMOKE_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            scene = make_synthetic_scene.make_scene(
                os.path.join(tmp, 'scene'), **SMOKE_SCENE)
            argv = smoke_argv(scene, 'f32', n, '--precision', '32')
            trainer, launches = trainer_run(argv, 'float32 trainer (kernels)',
                                            kernels=F32_STEP_KERNELS)
            if trainer.nerf_cfg.compute_dtype != 'float32':
                raise AssertionError('--precision 32 did not reach the model')
            pose, metrics = train_pose_psnr(trainer), trainer.last_metrics
            speed = steps_per_second(trainer, n)
            del trainer
            latest = os.path.join(tmp, 'ckpts', 'f32', f'step_{n}')
            reset_counts()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                port_eval.main(['--root_dir', scene, '--dataset_name',
                                'llff', '--img_wh', str(SMOKE_SCENE['width']),
                                str(SMOKE_SCENE['height']), '--split',
                                'test_train', '--ckpt_path', latest,
                                '--precision', '32', '--scene_name', 'f32'])
            pngs = [f for f in os.listdir(os.path.join(
                tmp, 'results', 'llff', 'f32')) if f.endswith('.png')]
            mean = [ln for ln in out.getvalue().splitlines()
                    if ln.startswith('Mean PSNR')]
            chunks = -(-SMOKE_SCENE['width'] * SMOKE_SCENE['height']
                       // CHUNK)
            eval_launches = read_counts(
                {k: 2 * chunks * len(pngs) for k in F32_STEP_KERNELS[:2]},
                'eval --precision 32 of the float32 checkpoint')
            if not pngs or not mean:
                raise AssertionError(f'eval wrote {len(pngs)} PNGs')
            reset_counts()
            with plain_versions():
                plain = port_train.main(smoke_argv(scene, 'f32_plain', n,
                                                   '--precision', '32'))
            if any(fn.launches for fn in kernel_wrappers()[0].values()):
                raise AssertionError('the plain trainer launched a kernel')
            plain_pose, plain_metrics = (train_pose_psnr(plain),
                                         plain.last_metrics)
            plain_speed = steps_per_second(plain, n)
            del plain
            torch.cuda.empty_cache()
        finally:
            os.chdir(cwd)
            sys.path.remove(tools)
    bf = TIMES.get('trainer_bf16', {})
    nan = float('nan')
    d_pose = pose - plain_pose
    d_val = metrics['val/psnr'] - plain_metrics['val/psnr']
    phase(f'[33] train.main --precision 32: {n} steps (batch {SMOKE_BATCH}, '
          f'64+64) at {speed:.2f} steps/s (plain {plain_speed:.3f}); '
          f'launches {launches}; eval --precision 32 of step_{n}: '
          f'{len(pngs)} PNGs, {mean[0]}, launches {eval_launches}; at step '
          f'{n} the training frames\' psnr: kernels {pose:.3f}, plain '
          f'{plain_pose:.3f} ({d_pose:+.3f} dB, tol {POSE_PSNR_TOL}); val '
          f'psnr {metrics["val/psnr"]:.3f} against '
          f'{plain_metrics["val/psnr"]:.3f} ({d_val:+.3f} dB, tol '
          f'{SMOKE_PSNR_TOL}); phase 25\'s bf16 pair: kernels '
          f'{bf.get("pose", nan):.3f}, plain {bf.get("plain_pose", nan):.3f} '
          f'({bf.get("pose", nan) - bf.get("plain_pose", nan):+.3f} dB; '
          f'its second kernels run {bf.get("again_pose", nan):.3f}); '
          f'{time.perf_counter() - t_phase:.1f} s; {CARD}')
    if not (abs(d_pose) <= POSE_PSNR_TOL and abs(d_val) <= SMOKE_PSNR_TOL) \
            or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError('float32 trainer: kernels and plain versions '
                             'disagree')
    return dict(pose=pose, plain_pose=plain_pose, launches=launches)


def precision32_phase(kernels) -> list:
    """Phase 33: ``--precision 32`` on the card (ROADMAP A.13.1, the
    flagship table): TF32 off; (b) rows 1, 9, 5 at float32 against their
    plain versions and timed, each beside the bf16 kernel's error against
    the same float32 plain; (c) against the stored float32 JAX numbers;
    (d) rows 2 and 7 on the float32 level's outputs; (e) the CLI's 64 +
    128 train step at float32 through ``make_train_step`` (every kernel
    counted, no plain call; 1024 rays against the plain versions); (f) a
    float32 frame; (h) ``train.main`` and ``eval`` with ``--precision 32``
    beside the plain trainer (the refusals, once (g), are phase 34's (e)).
    Returns the three float32 kernels' entries of the line."""
    import torch
    from hypernerf_tpu_torch.flagship import flagship_model, load_probe_weights
    from hypernerf_tpu_torch.kernels import build
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase(f'[33] float32: torch.backends.cuda.matmul.allow_tf32 = '
          f'{torch.backends.cuda.matmul.allow_tf32}, '
          f'torch.backends.cudnn.allow_tf32 = '
          f'{torch.backends.cudnn.allow_tf32}; ptxas (FFMA products, no '
          f'tensor cores): {ptxas_lines(build.build_log(), F32_SOURCES)}')
    torch.cuda.empty_cache()
    model = load_probe_weights(flagship_model('cuda', **F32_FINE128))
    bf16 = load_probe_weights(flagship_model('cuda', **FINE128))
    rows = f32_rows_phase(model, bf16)
    del bf16
    f32_reference_phase(model)
    f32_composite_phase(model)
    del model
    torch.cuda.empty_cache()
    times = {}
    launches = train_path('flagship_f32', '[33]', times, F32_STEP_TOLS)
    bf = TIMES.get('fine128_step', {})
    phase(f'[33] the 64 + 128 step at float32: {times["secs"] * 1e3:.1f} '
          f'ms/step, {TRAIN_RAYS / times["secs"]:.0f} rays/s, peak '
          f'{times["peak"]:.2f} GiB; bf16 (phase 32 (a)) '
          f'{bf.get("secs", float("nan")) * 1e3:.1f} ms/step, peak '
          f'{bf.get("peak", float("nan")):.2f} GiB; {CARD}')
    torch.cuda.empty_cache()
    frame = f32_render_phase()
    trained = f32_trainer_phase()
    out = []
    for name, (source, replaces) in F32_ROWS.items():
        main = rows[name][f'R{TRAIN_RAYS}_S128']
        s192 = rows[name][f'R{TRAIN_RAYS}_S{S192}']
        entry = dict(name=name, route='cuda', source=source,
                     replaces=replaces, launches=launches[name],
                     trainer_launches=trained['launches'][name],
                     max_abs_err=max(v[3] for v in rows[name].values()),
                     ms=main[0], plain_ms=main[1], bound_ms=main[2][0],
                     bound_by=main[2][1], library_ms=None,
                     ffma_ceiling_ms=main[2][2], shape=f'R={TRAIN_RAYS} S=128',
                     ms_s192=s192[0], plain_ms_s192=s192[1],
                     bound_ms_s192=s192[2][0], dtype='float32',
                     tolerance=(
                         f'relative L2 <= {F32_OUT_L2}, max|d| <= '
                         f'{F32_OUT_MAX}' if name == 'fused_level_fwd_f32'
                         else f'relative L2 <= {F32_GRAD_L2} per output')
                     + ', at most a tenth of the bf16 kernel\'s error')
        if name == 'fused_level_fwd_f32':
            r8 = rows[name]['R8192_S128']
            entry.update(ms_r8192=r8[0], plain_ms_r8192=r8[1],
                         bound_ms_r8192=r8[2][0])
        out.append(entry)
    TIMES['f32'] = dict(step=times, frame=frame, trainer=trained)
    phase(f'[33] the --precision 32 phase took '
          f'{time.perf_counter() - t_phase:.1f} s; {CARD}')
    return out


# -- the per-module path at --precision 32 (A.13.1 sub-item 1, phase 34) -----

# name -> (its source, the TPU kernel it replaces at float32). Kernel A at
# the static template's width is fused_template_bwd_f32's entry.
F32_MODULAR_ROWS = {
    'fused_template_fwd_f32': (CSRC_DIR + 'f32_level.cu',
                               'hypernerf_tpu/ops/pallas/fused_mlp.py:656'),
    'fused_field_fwd_f32': (CSRC_DIR + 'f32_level.cu',
                            'hypernerf_tpu/ops/pallas/fused_field.py:495'),
    'fused_field_bwd_f32': (CSRC_DIR + 'f32_steps.cu',
                            'hypernerf_tpu/ops/pallas/fused_field.py:532')}
PATHS.update(static_f32=('static', F32), split_glo_f32=('split_glo', F32),
             occupancy_f32=('occupancy', F32))
STEP_LAUNCHES['static_f32'] = {'fused_template_fwd_f32': 2,
                               'fused_template_bwd_f32': 2}
STEP_LAUNCHES['split_glo_f32'] = {
    'fused_field_fwd_f32': 4, 'fused_field_bwd_f32': 4,
    'fused_template_fwd_f32': 2, 'fused_template_bwd_f32': 2}
STEP_LAUNCHES['occupancy_f32'] = STEP_LAUNCHES['flagship_f32']
# Launches a frame chunk on the per-module path at float32: the template
# alone on each level, and each field alone (warp, sheet) on each level.
F32_CHUNK_LAUNCHES = {'static': {'fused_template_fwd_f32': 2},
                      'return_points': {'fused_template_fwd_f32': 2,
                                        'fused_field_fwd_f32': 4}}
F32_CLI_STEPS = 8  # steps of each train.main run of phase 34 (d)
# Float32 configurations and paths still refused on the card (A.13.2, the
# posenc band flags): (label, configuration, NerfConfig overrides, call
# keywords). The Jacobians run since phase 38's port.
F32_REFUSED = (('xyz_freq 8', 'flagship', dict(xyz_freq=8), {}),)


def template_macs(tmpl) -> int:
    """Multiply-adds a row of the template alone: one per weight."""
    from hypernerf_tpu_torch.kernels.fused_mlp import template_layers
    return sum(lin.weight.numel() for lin, _ in template_layers(
        tmpl.template))


def field_macs(mlp) -> int:
    """Multiply-adds a row of a field alone: one per weight."""
    from hypernerf_tpu_torch.kernels.fused_field import field_layers
    return sum(lin.weight.numel() for lin, _ in field_layers(mlp))


def f32_template_bound(tmpl, rows: int, samples: int, cond: int = 39,
                       raw: int = 8):
    """Row 8 at float32: a multiply-add per weight and row; bytes the raw
    rows (``raw`` fp32) and the output (4) per row, the condition per
    condition row, the weights once."""
    macs = template_macs(tmpl)
    return f32_bound(2.0 * macs * rows, rows * (4 * raw + 16)
                     + 4 * (rows // samples) * cond + 4 * macs)


def f32_field_bound(mlp, rows: int):
    """Row 10 at float32: a multiply-add per weight and row; bytes the raw
    rows (11 fp32) and the output (8) per row, the weights once."""
    macs = field_macs(mlp)
    return f32_bound(2.0 * macs * rows, rows * (44 + 32) + 4 * macs)


def f32_field_bwd_bound(mlp, rows: int):
    """Row 11 at float32: the recompute, g W and g^T h, a multiply-add per
    weight and row each; bytes the raw rows and the cotangent in, dx_raw
    out, the weights and dW once."""
    macs = field_macs(mlp)
    return f32_bound(6.0 * macs * rows, rows * (44 + 32 + 44) + 8 * macs)


def f32_static_bwd_bound(tmpl, n_rays: int, samples: int, cond: int = 39):
    """Kernel A at float32 on the static template: as
    ``f32_template_bwd_bound``, on its own weights."""
    macs = template_macs(tmpl)
    p = n_rays * samples
    return f32_bound(6.0 * macs * p,
                     p * (32 + 16 + 32) + 8 * n_rays * cond + 8 * macs)


def f32_modular_kernels(model, static) -> dict:
    """Phase 34 (a): rows 8, 10 and 11 and kernel A at the static width at
    float32 against their plain versions (TF32 off), and timed: row 8 on
    the flagship template at R = 8192, S = 128, at 1 << 20 rows of S = 1
    (query_sigma) and on the static template at R = 8192, S = 64; row 10
    on the warp field and the sheet at 8192 x 128 rows; row 11 on both at
    16384 x 128 rows; kernel A on the static template at R = 16384, S = 64.
    Returns {name: {shape: (ms, plain ms, bound, max|d|)}}."""
    import torch
    from hypernerf_tpu_torch.kernels import (fused_field, fused_field_bwd,
                                             fused_template,
                                             fused_template_bwd)
    from hypernerf_tpu_torch.kernels.fused_field import field_layers
    rows = {name: {} for name in F32_MODULAR_ROWS}
    rows['static_bwd'] = {}
    tmpl, stmpl = model.template_of('fine'), static.template_of('coarse')

    def report(name, key, label, errs, t, b, tol):
        phase(f'[34] {label}: relative L2 {errs[0]:.3e}, max|d| '
              f'{errs[1]:.3e} of the largest entry (tol {tol}); kernel '
              f'{t[0]:.3f} ms, plain {t[1]:.3f} ms; bound {b[0]:.3f} ms '
              f'({b[1]}, {b[0] / t[0]:.1%}), FFMA ceiling {b[2]:.3f} ms '
              f'({b[2] / t[0]:.1%}); {CARD}')
        rows[name][key] = (*t, b, errs[2])

    with torch.no_grad():
        for key, t_, r, s, static_ in (('R8192_S128', tmpl, 8192, 128, False),
                                       ('S1', tmpl, 1 << 20, 1, False),
                                       ('static_R8192_S64', stmpl, 8192, 64,
                                        True)):
            x, cond = template_rows(r, s, seed=34 + s, static=static_)
            errs = grad_errors(fused_template(t_, x, cond),
                               plain_template(t_, x, cond))
            if errs[0] > F32_OUT_L2 or errs[1] > F32_OUT_MAX:
                raise AssertionError(f'row 8 float32 {key}: {errs}')
            t = (cuda_ms(lambda: fused_template(t_, x, cond), 3),
                 cuda_ms(lambda: plain_template(t_, x, cond), 1))
            report('fused_template_fwd_f32', key,
                   f'row 8 float32 {key} ({r * s} rows)', errs, t,
                   f32_template_bound(t_, r * s, s),
                   f'{F32_OUT_L2} / {F32_OUT_MAX}')
            del x, cond
        for field in ('warp_field', 'hyper_sheet_mlp'):
            mlp, n_freq = getattr(model, field).mlp, getattr(model,
                                                             field).n_freq
            x = field_rows(8192 * 128, seed=341)
            errs = grad_errors(fused_field(mlp, n_freq, x),
                               plain_field(mlp, n_freq, x))
            if errs[0] > F32_OUT_L2 or errs[1] > F32_OUT_MAX:
                raise AssertionError(f'row 10 float32 {field}: {errs}')
            t = (cuda_ms(lambda: fused_field(mlp, n_freq, x), 3),
                 cuda_ms(lambda: plain_field(mlp, n_freq, x), 1))
            report('fused_field_fwd_f32', field,
                   f'row 10 float32 {field} (8192 x 128 rows)', errs, t,
                   f32_field_bound(mlp, x.shape[0]),
                   f'{F32_OUT_L2} / {F32_OUT_MAX}')
            x = field_rows(16384 * 128, seed=342)
            g = torch.randn(x.shape[0], 8, generator=torch.Generator(
                device='cuda').manual_seed(342), device='cuda')
            dx, grads = fused_field_bwd(mlp, n_freq, x, g)
            names = ['dx_raw'] + [f'{k}{i}' for i in range(len(
                field_layers(mlp))) for k in ('dW', 'db')]
            worst = check_grads(f'row 11 float32 {field} vs plain (16384 x '
                                f'128 rows)', names, [dx, *grads],
                                plain_field_bwd(mlp, n_freq, x, g),
                                F32_GRAD_L2, F32_GRAD_MAX, tag='[34]')
            del dx, grads
            t = (cuda_ms(lambda: fused_field_bwd(mlp, n_freq, x, g), 1),
                 cuda_ms(lambda: plain_field_bwd(mlp, n_freq, x, g), 1))
            report('fused_field_bwd_f32', field,
                   f'row 11 float32 {field} (16384 x 128 rows)', worst, t,
                   f32_field_bwd_bound(mlp, x.shape[0]),
                   f'{F32_GRAD_L2} / {F32_GRAD_MAX}')
            del x, g
        r, s = TRAIN_RAYS, 64
        x, cond = template_rows(r, s, seed=343, static=True)
        g = torch.randn(r * s, 4, generator=torch.Generator(
            device='cuda').manual_seed(343), device='cuda')
        got = fused_template_bwd(stmpl, x, cond, g)
        worst = check_grads(f'row 9 (kernel A) float32 at the static width '
                            f'vs plain R={r} S={s}', TEMPLATE_GRAD_NAMES,
                            [got[0], got[1], *got[2]],
                            plain_template_bwd(stmpl, x, cond, g),
                            F32_GRAD_L2, F32_GRAD_MAX, tag='[34]')
        del got
        t = (cuda_ms(lambda: fused_template_bwd(stmpl, x, cond, g), 1),
             cuda_ms(lambda: plain_template_bwd(stmpl, x, cond, g), 1))
        report('static_bwd', f'R{r}_S{s}', f'row 9 (kernel A) float32 at '
               f'the static width R={r} S={s}', worst, t,
               f32_static_bwd_bound(stmpl, r, s),
               f'{F32_GRAD_L2} / {F32_GRAD_MAX}')
        del x, cond, g
    torch.cuda.empty_cache()
    return rows


def f32_modular_reference(models) -> None:
    """Phase 34 (b): rows 8, 10, 11 and kernel A at the static width
    against the JAX kernels' stored float32 numbers
    (tests/data/fused_f32_modular_jax_ref.npz): outputs within
    F32_REF_OUT of the largest entry, gradients F32_GRAD_L2 /
    F32_GRAD_MAX."""
    import torch
    from hypernerf_tpu_torch.flagship import (F32_MODULAR_CASES,
                                              read_f32_modular_reference)
    from hypernerf_tpu_torch.kernels import (fused_field, fused_field_bwd,
                                             fused_template,
                                             fused_template_bwd)
    worst = 0.0
    for case, ref in read_f32_modular_reference().items():
        kind, config, module, *_ = F32_MODULAR_CASES[case]
        model = models[config]
        x = torch.tensor(ref['x_raw']).cuda()
        cot = torch.tensor(ref['cotangent']).cuda()
        want_out = torch.tensor(ref['out']).cuda()
        with torch.no_grad():
            if kind == 'field':
                field = getattr(model, module)
                out = fused_field(field.mlp, field.n_freq, x)
                dx, grads = fused_field_bwd(field.mlp, field.n_freq, x, cot)
                got = {'dx': dx}
            else:
                tmpl = model.template_of(module)
                cond = torch.tensor(ref['rgb_cond']).cuda()
                out = fused_template(tmpl, x, cond)
                dx, d_cond, grads, _ = fused_template_bwd(tmpl, x, cond, cot)
                got = {'dx': dx[:, :ref['dx'].shape[1]], 'd_rgb_cond': d_cond}
        for i in range(0, len(grads), 2):
            got.update({f'dw{i // 2}': grads[i], f'db{i // 2}': grads[i + 1]})
        names = [k for k in got if k in ref]  # dW of some layers alone
        err = ((out - want_out).abs().max()
               / want_out.abs().max()).item()
        worst = max(worst, err)
        if not err <= F32_REF_OUT:
            raise AssertionError(f'{case} float32 against the stored JAX '
                                 f'outputs: {err:.3e}')
        check_grads(f'{case} float32 against the stored JAX gradients',
                    names, [got[n] for n in names],
                    [torch.tensor(ref[n]).cuda() for n in names],
                    F32_GRAD_L2, F32_GRAD_MAX, tag='[34]')
    phase(f'[34] rows 8, 10, 11 and kernel A at the static width against '
          f'the stored JAX float32 numbers: outputs max|d| {worst:.3e} of '
          f'the largest entry at worst (tol {F32_REF_OUT})')


def f32_modular_paths() -> dict:
    """Phase 34 (c): the per-module paths at float32 with their launches:
    a static frame and train step, a split_glo train step, a flagship
    frame with ``return_points``, 1024 rays with a ``hyper_point``
    override, query_sigma, and ``occupancy``'s frame (row 1 at float32)
    and train step with the refresh (rows 8 and 10) inside the window.
    Returns {path: launches}."""
    import torch
    from hypernerf_tpu_torch.flagship import (H, W, bench_grid,
                                              flagship_model, spiral_rays)
    from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
    from hypernerf_tpu_torch.training.renderer import ImageRenderer
    chunks_per_frame = -(-W * H // CHUNK)
    frames = spiral_rays([0, 30])  # a warm-up frame, then one timed
    counts = {}

    def frame(config, want_chunk, keep, label, **kw):
        grid = kw.pop('grid', None)
        model = flagship_model('cuda', seed=0, config=config, **F32)
        if grid is not None:
            grid = bench_grid(model.config, 'cuda')
        secs, launches = time_frames(
            ImageRenderer(model, chunk=CHUNK, keep=keep, levels=('fine',),
                          quantize=True, occupancy_grid=grid), frames, keep,
            {k: v * chunks_per_frame for k, v in want_chunk.items()}, label)
        phase(f'[34] {label}: {secs:.3f} s/frame ({W}x{H}, '
              f'{model.config.num_coarse_samples}+'
              f'{model.config.num_fine_samples}, chunk {CHUNK}); launches '
              f'{launches}; no plain call; {CARD}')
        counts[label] = launches
        del model
        torch.cuda.empty_cache()

    keep = ('rgb', 'depth', 'acc')
    frame('static', F32_CHUNK_LAUNCHES['static'], keep,
          'static float32 frame')
    counts['static train'] = train_path('static_f32', '[34]',
                                        tols=F32_STEP_TOLS)
    torch.cuda.empty_cache()
    counts['split_glo train'] = train_path('split_glo_f32', '[34]',
                                           tols=F32_STEP_TOLS)
    torch.cuda.empty_cache()
    frame('flagship', F32_CHUNK_LAUNCHES['return_points'],
          keep + ('med_points',), 'flagship float32 frame with '
          'return_points')
    model = flagship_model('cuda', seed=0, **F32)
    small = torch.as_tensor(frames[0][::186][:1024]).cuda()
    hyper = torch.randn(1024, 4, generator=torch.Generator(
        device='cuda').manual_seed(34), device='cuda') * 0.3
    rd = prepare_ray_dict(small)
    rd['metadata'] = {**rd['metadata'], 'hyper_point': hyper}
    with torch.no_grad():
        reset_counts()
        got = model(rd)['fine']['rgb']
        counts['hyper_point'] = read_counts(
            {'fused_field_fwd_f32': 2, 'fused_template_fwd_f32': 2},
            'float32 hyper_point override')
        with plain_versions():
            want = model(rd)['fine']['rgb']
    diff = (got - want).abs().max().item()
    phase(f'[34] flagship float32, 1024 rays with a hyper_point override: '
          f'launches {counts["hyper_point"]} (the warp field and the '
          f'template on each level, no sheet); fine rgb vs plain max|d| '
          f'{diff:.3e} (tol {RENDER_ATOL})')
    if not diff <= RENDER_ATOL:
        raise AssertionError('float32 hyper_point: kernels vs plain')
    del model
    counts['query_sigma'] = query_sigma_path(
        'flagship', {'fused_field_fwd_f32': 2, 'fused_template_fwd_f32': 1},
        '[34]', **F32)
    frame('occupancy', {'fused_level_fwd_f32': 2, 'fused_composite_fwd': 2},
          keep, 'occupancy float32 frame', grid=True)
    times = {}
    counts['occupancy train'] = train_path('occupancy_f32', '[34]', times,
                                           F32_STEP_TOLS)
    phase(f'[34] occupancy float32 step: {times["secs"] * 1e3:.1f} ms a '
          f'step over the window ({times["refreshes"]} refresh in '
          f'{TRAIN_STEPS} steps); peak {times["peak"]:.2f} GiB; {CARD}')
    TIMES['f32_modular'] = dict(occupancy_step=times)
    torch.cuda.empty_cache()
    return counts


def f32_cli_phase() -> dict:
    """Phase 34 (d): ``train.main([... '--precision', '32'])`` for
    F32_CLI_STEPS steps at batch 4096 (64 + 64) on phase 25's scene, once
    with ``--share_GLO False`` (the per-module path: rows 10, 11, 8 and 9)
    and once with ``--use_occupancy_grid True`` (the level's float32 rows,
    the refresh's rows 8 and 10), every launch counted, no plain call, the
    losses finite. Returns {run: launches}."""
    import os
    import tempfile
    t_phase = time.perf_counter()
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         'tools')
    sys.path.insert(0, tools)
    import make_synthetic_scene
    cwd = os.getcwd()
    n, out = F32_CLI_STEPS, {}
    split = STEP_LAUNCHES['split_glo_f32']
    runs = {
        'share_GLO False': (('--share_GLO', 'False'), split,
                            {'fused_field_fwd_f32': 4,
                             'fused_template_fwd_f32': 2}, None),
        'use_occupancy_grid True': (
            ('--use_occupancy_grid', 'True'), None, None,
            REFRESH_LAUNCHES_F32)}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            scene = make_synthetic_scene.make_scene(
                os.path.join(tmp, 'scene'), **SMOKE_SCENE)
            for i, (label, (flags, step, chunk, refresh)) in enumerate(
                    runs.items()):
                argv = smoke_argv(scene, f'f32_cli{i}', n, '--precision',
                                  '32', *flags)
                trainer, launches = trainer_run(
                    argv, f'train.main --precision 32 {label}',
                    kernels=F32_STEP_KERNELS, per_step=step,
                    per_chunk=chunk, per_refresh=refresh)
                metrics = trainer.last_metrics
                if trainer.nerf_cfg.compute_dtype != 'float32' or not all(
                        math.isfinite(v) for v in metrics.values()):
                    raise AssertionError(f'train.main --precision 32 '
                                         f'{label}: {metrics}')
                phase(f'[34] train.main --precision 32 {" ".join(flags)}: '
                      f'{n} steps (batch {SMOKE_BATCH}, 64+64) at '
                      f'{steps_per_second(trainer, n):.2f} steps/s; '
                      f'launches {launches}; loss '
                      f'{metrics.get("train/loss", float("nan")):.5f}, val '
                      f'psnr {metrics.get("val/psnr", float("nan")):.3f}; no '
                      f'plain call; {CARD}')
                out[label] = launches
                del trainer
        finally:
            os.chdir(cwd)
            sys.path.remove(tools)
    phase(f'[34] (d) took {time.perf_counter() - t_phase:.1f} s')
    return out


def precision32_modular_phase(kernels) -> list:
    """Phase 34: the per-module path at ``--precision 32`` (ROADMAP A.13.1
    sub-item 1): TF32 off; (a) rows 8, 10, 11 and kernel A at the static
    width against their plain versions, timed; (b) against the stored JAX
    float32 numbers; (c) the paths at float32 with their launches
    (``static``, ``split_glo``, ``return_points``, a ``hyper_point``
    override, ``query_sigma``, ``occupancy``); (d) ``train.main
    --precision 32`` with ``--share_GLO False`` and with
    ``--use_occupancy_grid True``; (e) what float32 still refuses. Returns
    the three new kernels' entries of the line and adds kernel A's static
    figures to ``fused_template_bwd_f32``'s."""
    import torch
    from hypernerf_tpu_torch.flagship import flagship_model, load_probe_weights
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    models = {c: load_probe_weights(flagship_model('cuda', config=c, **F32))
              for c in ('flagship', 'static')}
    rows = f32_modular_kernels(models['flagship'], models['static'])
    f32_modular_reference(models)
    del models
    torch.cuda.empty_cache()
    counts = f32_modular_paths()
    cli = f32_cli_phase()
    f32_refusals_phase()
    out = []
    main_path = {'fused_template_fwd_f32': 'static train',
                 'fused_field_fwd_f32': 'split_glo train',
                 'fused_field_bwd_f32': 'split_glo train'}
    main_key = {'fused_template_fwd_f32': 'R8192_S128',
                'fused_field_fwd_f32': 'warp_field',
                'fused_field_bwd_f32': 'warp_field'}
    for name, (source, replaces) in F32_MODULAR_ROWS.items():
        main = rows[name][main_key[name]]
        entry = dict(name=name, route='cuda', source=source,
                     replaces=replaces,
                     launches=counts[main_path[name]][name],
                     max_abs_err=max(v[3] for v in rows[name].values()),
                     ms=main[0], plain_ms=main[1], bound_ms=main[2][0],
                     bound_by=main[2][1], library_ms=None,
                     ffma_ceiling_ms=main[2][2], dtype='float32',
                     shape=main_key[name],
                     launches_by_path={
                         path: c[name] for path, c in
                         list(counts.items()) + list(cli.items())
                         if c.get(name)})
        for key, v in rows[name].items():
            if key != main_key[name]:
                entry.update({f'ms_{key}': v[0], f'plain_ms_{key}': v[1],
                              f'bound_ms_{key}': v[2][0]})
        out.append(entry)
    static = rows['static_bwd'][f'R{TRAIN_RAYS}_S64']
    for k in kernels:
        if k['name'] == 'fused_template_bwd_f32':
            k.update(ms_static_R16384_S64=static[0],
                     plain_ms_static_R16384_S64=static[1],
                     bound_ms_static_R16384_S64=static[2][0],
                     static_train_launches=counts['static train'][k['name']],
                     max_abs_err=max(k['max_abs_err'], static[3]))
    phase(f'[34] the per-module --precision 32 phase took '
          f'{time.perf_counter() - t_phase:.1f} s; {CARD}')
    return out


# -- the screw warps at --precision 32 (A.13.1 sub-item 2, phase 35) ---------

# name -> (its source, the TPU kernel it replaces at float32). Rows 1 and 5
# at table codes 1 and 2 are the float32 level forward's and kernel B's
# variants: their launches count under those wrappers' own counters
# (F32_SCREW_COUNTER), read from the screw paths' runs.
F32_SCREW_ROWS = {
    'fused_level_fwd_f32_screw': (
        CSRC_DIR + 'f32_level.cu',
        'hypernerf_tpu/ops/pallas/fused_level.py:1322'),
    'fused_fields_bwd_f32_screw': (
        CSRC_DIR + 'f32_steps.cu',
        'hypernerf_tpu/ops/pallas/fused_level.py:846'),
    'fused_se3_fwd_f32': (CSRC_DIR + 'f32_level.cu',
                          'hypernerf_tpu/ops/pallas/fused_se3.py:374'),
    'fused_se3_bwd_f32': (CSRC_DIR + 'f32_steps.cu',
                          'hypernerf_tpu/ops/pallas/fused_se3.py:412')}
F32_SCREW_COUNTER = {'fused_level_fwd_f32_screw': 'fused_level_fwd_f32',
                     'fused_fields_bwd_f32_screw': 'fused_fields_bwd_f32',
                     'fused_se3_fwd_f32': 'fused_se3_fwd_f32',
                     'fused_se3_bwd_f32': 'fused_se3_bwd_f32'}
PATHS.update(se3_f32=('se3', F32_FINE128),
             quaternion_f32=('quaternion', F32_FINE128),
             se3_split_glo_f32=('se3', dict(share_glo=False, **F32)))
STEP_LAUNCHES['se3_f32'] = STEP_LAUNCHES['flagship_f32']
STEP_LAUNCHES['quaternion_f32'] = STEP_LAUNCHES['flagship_f32']
STEP_LAUNCHES['se3_split_glo_f32'] = {
    'fused_se3_fwd_f32': 2, 'fused_se3_bwd_f32': 2, 'fused_field_fwd_f32': 2,
    'fused_field_bwd_f32': 2, 'fused_template_fwd_f32': 2,
    'fused_template_bwd_f32': 2}
# Launches a frame chunk: the level (and compositing) kernels on each
# level; with return_points the trunk, the sheet and the template alone.
F32_SCREW_CHUNK = {'level': {'fused_level_fwd_f32': 2,
                             'fused_composite_fwd': 2},
                   'return_points': {'fused_se3_fwd_f32': 2,
                                     'fused_field_fwd_f32': 2,
                                     'fused_template_fwd_f32': 2}}
# Kernel vs plain, both float32 on the card with TF32 off, the same inputs
# (kernel B and row 13 the same cotangents): the same arithmetic in other
# summation orders (phases 33 and 34 measured at most 2.4e-6). Allowed per
# output: relative L2 1e-4 and max|d| 1e-3 of the largest entry, for all
# four rows.
F32_SCREW_L2, F32_SCREW_MAX = 1e-4, 1e-3
# Against tests/data/fused_f32_screw_jax_ref.npz: outputs F32_REF_OUT of
# the largest entry; the trunk's gradients F32_GRAD_L2 / F32_GRAD_MAX; a
# level's gradients relative L2 5e-2: two float32 forwards round the
# warped point apart, which moves the template's backward at its 2^9 band
# (and can flip a near-zero ReLU) by up to 1.8e-2 on the trunk's heads' db
# in float64 arithmetic alone (tests/test_torch_precision32_screw.py's
# floor); 1e-2 + 2 x 1.8e-2 < 5e-2.
F32_SCREW_REF_L2 = 5e-2
F32_SCREW_CLI_STEPS = 8  # steps of the train.main run of phase 35 (d)


def se3_row_bound(field, rows: int, backward: bool):
    """Row 12 (or 13, ``backward``) at float32: a multiply-add per weight
    and row (the recompute, g W and g^T h: three); bytes the raw rows (11
    fp32) and the output [w | v | 0 0] (8) per row (and dx_raw out), the
    weights once (and dW)."""
    from hypernerf_tpu_torch.kernels.fused_se3 import se3_layers
    macs = sum(lin.weight.numel() for lin, _ in se3_layers(field))
    if backward:
        return f32_bound(6.0 * macs * rows, rows * (44 + 32 + 44) + 8 * macs)
    return f32_bound(2.0 * macs * rows, rows * (44 + 32) + 4 * macs)


def f32_screw_kernels(models) -> dict:
    """Phase 35 (a): rows 1 and 5 at table codes 1 and 2 and rows 12 and 13
    at float32 against their plain versions (TF32 off, the same inputs),
    and timed: row 1 on ``se3`` at R = 16384, S = 128 with the window row
    and on ``quaternion`` at R = 8192, S = 64 without; row 5 on ``se3`` at
    R = 16384, S = 128 with it and on ``quaternion`` at S = 192 without;
    row 12 at 8192 x 128 rows (with the window row) and 16384 x 128; row
    13 at 16384 x 128 with it. Returns {name: {shape: (ms, plain ms,
    bound, max|d|)}}."""
    import torch
    from hypernerf_tpu_torch.kernels import (fused_fields_bwd, fused_level,
                                             fused_se3_bwd, fused_se3_wv)
    from hypernerf_tpu_torch.kernels.fused_level import _launch_forward
    from hypernerf_tpu_torch.kernels.fused_se3 import (se3_encoding_scales,
                                                       se3_layers)
    rows = {name: {} for name in F32_SCREW_ROWS}
    tol = f'{F32_SCREW_L2} / {F32_SCREW_MAX}'

    def report(name, key, label, errs, t, b):
        phase(f'[35] {label}: worst relative L2 {errs[0]:.3e}, max|d| '
              f'{errs[1]:.3e} of the largest entry (tol {tol}); kernel '
              f'{t[0]:.3f} ms, plain {t[1]:.3f} ms; bound {b[0]:.3f} ms '
              f'({b[1]}, {b[0] / t[0]:.1%}), FFMA ceiling {b[2]:.3f} ms '
              f'({b[2] / t[0]:.1%}); {CARD}')
        if errs[0] > F32_SCREW_L2 or errs[1] > F32_SCREW_MAX:
            raise AssertionError(f'{name} {key}: the kernel disagrees with '
                                 f'plain: {errs}')
        rows[name][key] = (*t, b, errs[2])

    def window(field, alpha):
        return None if alpha is None else se3_encoding_scales(field, alpha,
                                                              'cuda')

    with torch.no_grad():
        for kind, r, s, alpha in (('se3', TRAIN_RAYS, 128, WINDOW_ALPHA),
                                  ('quaternion', 8192, 64, None)):
            lv = models[kind].level('fine')
            ws = window(lv.warp, alpha)
            args = level_inputs(r, s, seed=35 + s)
            out, raw_t = _launch_forward(lv, *args, want_raw_t=True,
                                         warp_scales=ws)
            want, want_raw = plain_forward(lv, args, ws)
            e = [grad_errors(out, want), grad_errors(raw_t, want_raw)]
            errs = tuple(max(x[i] for x in e) for i in range(3))
            del out, raw_t, want_raw
            t = (cuda_ms(lambda: fused_level(lv, *args, warp_scales=ws), 3),
                 cuda_ms(lambda: plain_forward(lv, args, ws), 1))
            report('fused_level_fwd_f32_screw', f'{kind}_R{r}_S{s}',
                   f'row 1 float32 {kind} R={r} S={s} (window '
                   f'{alpha}): out and raw_t', errs, t,
                   f32_level_bound(lv, r, s))
            del args, want
        for kind, s, alpha in (('se3', 128, WINDOW_ALPHA),
                               ('quaternion', S192, None)):
            lv = models[kind].level('fine')
            ws = window(lv.warp, alpha)
            r = TRAIN_RAYS
            args = level_inputs(r, s, seed=351 + s)
            dx_t = torch.randn(r * s, 8, generator=torch.Generator(
                device='cuda').manual_seed(s), device='cuda')
            dx_t[:, 7] = 0.0
            got = fused_fields_bwd(lv, *args[:4], dx_t, ws)
            worst = check_grads(f'row 5 (kernel B) float32 {kind} vs plain '
                                f'R={r} S={s} (window {alpha})',
                                SE3_FIELDS_GRAD_NAMES, [*got[:4], *got[4]],
                                plain_fields_bwd(lv, args, dx_t, ws),
                                F32_SCREW_L2, F32_SCREW_MAX, tag='[35]')
            del got
            t = (cuda_ms(lambda: fused_fields_bwd(lv, *args[:4], dx_t, ws),
                         1),
                 cuda_ms(lambda: plain_fields_bwd(lv, args, dx_t, ws), 1))
            report('fused_fields_bwd_f32_screw', f'{kind}_R{r}_S{s}',
                   f'row 5 (kernel B) float32 {kind} R={r} S={s}', worst, t,
                   f32_fields_bwd_bound(lv, r, s))
            del args, dx_t
        field = models['se3'].warp_field
        ws = window(field, WINDOW_ALPHA)
        for p, alpha in ((8192 * 128, WINDOW_ALPHA), (16384 * 128, None)):
            x = field_rows(p, seed=352)
            wsp = ws if alpha is not None else None
            errs = grad_errors(wv_of(field, x, wsp), plain_se3(field, x, wsp))
            t = (cuda_ms(lambda: fused_se3_wv(field, x, wsp), 3),
                 cuda_ms(lambda: plain_se3(field, x, wsp), 1))
            report('fused_se3_fwd_f32', f'P{p}',
                   f'row 12 float32 trunk alone P={p} (window {alpha})',
                   errs, t, se3_row_bound(field, p, False))
            del x
        p = 16384 * 128
        x = field_rows(p, seed=353)
        g = torch.randn(p, 8, generator=torch.Generator(
            device='cuda').manual_seed(353), device='cuda')
        g[:, 6:] = 0.0
        dx, grads = fused_se3_bwd(field, x, g, ws)
        names = ['dx_raw'] + [f'{k}{i}' for i in range(len(se3_layers(field)))
                              for k in ('dW', 'db')]
        worst = check_grads(f'row 13 float32 trunk alone backward vs plain '
                            f'P={p} (window {WINDOW_ALPHA})', names,
                            [dx, *grads], plain_se3_bwd(field, x, g, ws),
                            F32_SCREW_L2, F32_SCREW_MAX, tag='[35]')
        del dx, grads
        t = (cuda_ms(lambda: fused_se3_bwd(field, x, g, ws), 1),
             cuda_ms(lambda: plain_se3_bwd(field, x, g, ws), 1))
        report('fused_se3_bwd_f32', f'P{p}', f'row 13 float32 trunk alone '
               f'backward P={p}', worst, t, se3_row_bound(field, p, True))
        del x, g
    torch.cuda.empty_cache()
    return rows


def f32_screw_reference() -> None:
    """Phase 35 (b): rows 1 and 5 (the level through its autograd
    Function: the level forward, then kernel A and kernel B) and rows 12
    and 13 against the JAX kernels' stored float32 numbers
    (tests/data/fused_f32_screw_jax_ref.npz): outputs within F32_REF_OUT of
    the largest entry; gradients F32_GRAD_L2 (the trunk alone) or
    F32_SCREW_REF_L2 (a level), and F32_GRAD_MAX."""
    import torch
    from hypernerf_tpu_torch.flagship import (F32_SCREW_GRAD_LAYERS,
                                              F32_SCREW_LEVEL_CASES,
                                              F32_SCREW_TRUNK_CASES,
                                              F32_SCREW_TRUNK_DW,
                                              LEVEL_INPUTS, f32_screw_model,
                                              read_f32_screw_reference)
    from hypernerf_tpu_torch.kernels import (fused_level, fused_se3_bwd,
                                             fused_se3_wv)
    from hypernerf_tpu_torch.kernels.fused_level import level_layers
    from hypernerf_tpu_torch.kernels.fused_se3 import se3_encoding_scales
    ref = read_f32_screw_reference()
    worst = 0.0
    for case, (config, level, _, _, alpha, _, heads) in \
            F32_SCREW_LEVEL_CASES.items():
        arrays = ref[case]
        model = f32_screw_model(config, heads, 'cuda')
        lv = model.level(level)
        ws = None if alpha is None else se3_encoding_scales(lv.warp, alpha,
                                                            'cuda')
        args = [torch.tensor(arrays[k]).cuda().requires_grad_(True)
                for k in LEVEL_INPUTS]
        out = fused_level(lv, *args, warp_scales=ws)
        want = torch.tensor(arrays['out']).cuda()
        err = ((out - want).abs().max() / want.abs().max()).item()
        worst = max(worst, err)
        out.backward(torch.tensor(arrays['cotangent']).cuda())
        names, got = [], []
        for k, a in zip(LEVEL_INPUTS, args):
            names.append(f'd_{k}')
            got.append(a.grad)
        for l, (lin, _) in enumerate(level_layers(lv)):
            names.append(f'db{l}')
            got.append(lin.bias.grad)
            if l in F32_SCREW_GRAD_LAYERS:
                names.append(f'dw{l}')
                got.append(lin.weight.grad)
        check_grads(f'{case} float32 against the stored JAX gradients',
                    names, got, [torch.tensor(arrays[n]).cuda()
                                 for n in names],
                    F32_SCREW_REF_L2, F32_GRAD_MAX, tag='[35]')
        if not err <= F32_REF_OUT:
            raise AssertionError(f'{case} float32 against the stored JAX '
                                 f'outputs: {err:.3e}')
        del model, out, args
    for case, (_, alpha, _, heads) in F32_SCREW_TRUNK_CASES.items():
        arrays = ref[case]
        field = f32_screw_model('se3', heads, 'cuda').warp_field
        ws = None if alpha is None else se3_encoding_scales(field, alpha,
                                                            'cuda')
        x = torch.tensor(arrays['x_raw']).cuda()
        with torch.no_grad():
            out = torch.cat(fused_se3_wv(field, x, ws), -1)
            dx, grads = fused_se3_bwd(field, x, torch.tensor(
                arrays['cotangent']).cuda(), ws)
        want = torch.tensor(arrays['out']).cuda()
        err = ((out - want).abs().max() / want.abs().max()).item()
        worst = max(worst, err)
        names, got = ['dx'], [dx]
        for l in range(9):
            names.append(f'db{l}')
            got.append(grads[2 * l + 1])
            if l in F32_SCREW_TRUNK_DW:
                names.append(f'dw{l}')
                got.append(grads[2 * l])
        check_grads(f'{case} float32 against the stored JAX gradients',
                    names, got, [torch.tensor(arrays[n]).cuda()
                                 for n in names],
                    F32_GRAD_L2, F32_GRAD_MAX, tag='[35]')
        if not err <= F32_REF_OUT:
            raise AssertionError(f'{case} float32 against the stored JAX '
                                 f'outputs: {err:.3e}')
    torch.cuda.empty_cache()
    phase(f'[35] rows 1, 5, 12, 13 against the stored JAX float32 numbers: '
          f'outputs max|d| {worst:.3e} of the largest entry at worst (tol '
          f'{F32_REF_OUT})')


def f32_screw_paths() -> dict:
    """Phase 35 (c): the screw warps' paths at float32 with their launches
    and no plain call: an ``se3`` and a ``quaternion`` frame (64 + 64); the
    CLI's 64 + 128 train step of each through ``make_train_step``
    (``compute_extra_params`` gives no warp_alpha with the posenc_orig
    template, so the step's window row is off, as in the JAX package); one
    step on 1024 rays of the ``se3`` model with ``warp_alpha`` set (the
    window row live), kernels vs plain; an ``se3`` train step with
    ``share_glo=False`` (rows 12 and 13, 10 and 11, 8 and A, the retraction
    in tensor code); a ``return_points`` frame and ``query_sigma`` on
    ``se3``. Returns {path: launches}."""
    import torch
    from hypernerf_tpu_torch.flagship import (H, W, flagship_model,
                                              flagship_train_setup,
                                              spiral_rays)
    from hypernerf_tpu_torch.training.renderer import ImageRenderer
    chunks_per_frame = -(-W * H // CHUNK)
    frames = spiral_rays([0, 30])  # a warm-up frame, then one timed
    keep = ('rgb', 'depth', 'acc')
    counts = {}
    for kind, return_points in (('se3', False), ('quaternion', False),
                                ('se3', True)):
        model = flagship_model('cuda', seed=0, config=kind, **F32)
        k = keep + (('med_points',) if return_points else ())
        label = f'{kind} float32 frame' + (' with return_points'
                                           if return_points else '')
        per = F32_SCREW_CHUNK['return_points' if return_points else 'level']
        secs, launches = time_frames(
            ImageRenderer(model, chunk=CHUNK, keep=k, levels=('fine',),
                          quantize=True), frames, k,
            {n: v * chunks_per_frame for n, v in per.items()}, label)
        phase(f'[35] {label}: {secs:.3f} s/frame ({W}x{H}, 64+64, chunk '
              f'{CHUNK}); launches {launches}; no plain call; {CARD}')
        counts[label] = launches
        del model
        torch.cuda.empty_cache()
    for path in ('se3_f32', 'quaternion_f32'):
        times = {}
        counts[f'{path} train'] = train_path(path, '[35]', times,
                                             F32_STEP_TOLS)
        TIMES[f'{path}_step'] = times
        flagship = TIMES.get('f32', {}).get('step', {}).get('secs',
                                                            float('nan'))
        phase(f'[35] {path} 64 + 128 step: {times["secs"] * 1e3:.1f} '
              f'ms/step, peak {times["peak"]:.2f} GiB; the flagship\'s at '
              f'float32 (phase 33) {flagship * 1e3:.1f} ms/step; {CARD}')
        torch.cuda.empty_cache()
    state, _, all_rays, all_rgbs = flagship_train_setup(
        'cuda', seed=0, batch_size=TRAIN_RAYS, config='se3', **F32_FINE128)
    counts['se3 windowed step'] = compare_step(
        state.model, all_rays, all_rgbs, '[35] se3 float32 warp_alpha '
        f'{WINDOW_ALPHA}:', extra_params={'warp_alpha': WINDOW_ALPHA},
        tols=F32_STEP_TOLS)
    want = {k: 2 for k in F32_STEP_KERNELS}
    if counts['se3 windowed step'] != want:
        raise AssertionError(f'the windowed se3 step launched '
                             f'{counts["se3 windowed step"]}, want {want}')
    del state, all_rays, all_rgbs
    torch.cuda.empty_cache()
    counts['se3_split_glo train'] = train_path('se3_split_glo_f32', '[35]',
                                               tols=F32_STEP_TOLS)
    torch.cuda.empty_cache()
    counts['se3 query_sigma'] = query_sigma_path(
        'se3', {'fused_se3_fwd_f32': 1, 'fused_field_fwd_f32': 1,
                'fused_template_fwd_f32': 1}, '[35]', **F32)
    torch.cuda.empty_cache()
    return counts


def f32_train_eval(tag: str, exp: str, flags, want: dict,
                   per_step=None) -> dict:
    """``train.main([... '--precision', '32', *flags])`` for
    F32_SCREW_CLI_STEPS steps at batch 4096 (64 + 64) on phase 25's scene,
    every launch counted (``per_step``: {kernel: launches a step}, default
    two of each float32 step kernel), no plain call, the losses finite, the
    run's NerfConfig holding ``want`` (fields and values); then ``eval
    --precision 32`` of its checkpoint (the level kernels on every chunk of
    every frame). Returns {run: launches}."""
    import io
    import os
    import tempfile

    from hypernerf_tpu_torch import eval as port_eval
    t_phase = time.perf_counter()
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         'tools')
    sys.path.insert(0, tools)
    import make_synthetic_scene
    cwd = os.getcwd()
    n, out = F32_SCREW_CLI_STEPS, {}
    label = 'train.main --precision 32 ' + ' '.join(flags)
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            scene = make_synthetic_scene.make_scene(
                os.path.join(tmp, 'scene'), **SMOKE_SCENE)
            argv = smoke_argv(scene, exp, n, '--precision', '32', *flags)
            trainer, launches = trainer_run(argv, label,
                                            kernels=F32_STEP_KERNELS,
                                            per_step=per_step)
            metrics = trainer.last_metrics
            cfg = trainer.nerf_cfg
            if cfg.compute_dtype != 'float32' or any(
                    getattr(cfg, k) != v for k, v in want.items()) \
                    or not all(math.isfinite(v) for v in metrics.values()):
                raise AssertionError(f'{label}: {metrics}')
            speed = steps_per_second(trainer, n)
            del trainer
            out['train.main'] = launches
            reset_counts()
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                port_eval.main(['--root_dir', scene, '--dataset_name',
                                'llff', '--img_wh', str(SMOKE_SCENE['width']),
                                str(SMOKE_SCENE['height']), '--split',
                                'test_train', '--ckpt_path',
                                os.path.join(tmp, 'ckpts', exp, f'step_{n}'),
                                '--precision', '32', '--scene_name', exp])
            pngs = [f for f in os.listdir(os.path.join(
                tmp, 'results', 'llff', exp)) if f.endswith('.png')]
            mean = [ln for ln in text.getvalue().splitlines()
                    if ln.startswith('Mean PSNR')]
            chunks = -(-SMOKE_SCENE['width'] * SMOKE_SCENE['height']
                       // CHUNK)
            out['eval'] = read_counts(
                {k: 2 * chunks * len(pngs) for k in F32_STEP_KERNELS[:2]},
                f'eval --precision 32 of the float32 {exp} checkpoint')
            if not pngs or not mean:
                raise AssertionError(f'eval wrote {len(pngs)} PNGs')
        finally:
            os.chdir(cwd)
            sys.path.remove(tools)
    phase(f'{tag} {label}: {n} steps (batch {SMOKE_BATCH}, 64+64) at '
          f'{speed:.2f} steps/s; launches {out["train.main"]}; loss '
          f'{metrics.get("train/loss", float("nan")):.5f}, val psnr '
          f'{metrics.get("val/psnr", float("nan")):.3f}; eval --precision '
          f'32 of step_{n}: {len(pngs)} PNGs, {mean[0]}, launches '
          f'{out["eval"]}; no plain call; '
          f'{time.perf_counter() - t_phase:.1f} s; {CARD}')
    return out


def f32_screw_cli_phase() -> dict:
    """Phase 35 (d): ``train.main([... '--precision', '32', '--warp_field',
    'se3'])`` and ``eval --precision 32`` of its checkpoint
    (``f32_train_eval``). Returns {run: launches}."""
    return f32_train_eval('[35]', 'f32_se3', ('--warp_field', 'se3'),
                          dict(warp_field_type='se3'))


def precision32_screw_phase(kernels) -> list:
    """Phase 35: the screw warps at ``--precision 32`` (ROADMAP A.13.1
    sub-item 2): TF32 off; (a) rows 1 and 5 at table codes 1 and 2 and rows
    12 and 13 against their plain versions, timed; (b) against the stored
    JAX float32 numbers; (c) the screw paths at float32 with their
    launches; (d) ``train.main --precision 32 --warp_field se3`` and
    ``eval`` of its checkpoint. Returns the four entries of the line."""
    import torch
    from hypernerf_tpu_torch.flagship import flagship_model, load_probe_weights
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    models = {c: load_probe_weights(flagship_model('cuda', config=c,
                                                   **F32_FINE128))
              for c in ('se3', 'quaternion')}
    rows = f32_screw_kernels(models)
    del models
    torch.cuda.empty_cache()
    f32_screw_reference()
    counts = f32_screw_paths()
    cli = f32_screw_cli_phase()
    main_path = {'fused_level_fwd_f32_screw': 'se3_f32 train',
                 'fused_fields_bwd_f32_screw': 'se3_f32 train',
                 'fused_se3_fwd_f32': 'se3_split_glo train',
                 'fused_se3_bwd_f32': 'se3_split_glo train'}
    main_key = {'fused_level_fwd_f32_screw': f'se3_R{TRAIN_RAYS}_S128',
                'fused_fields_bwd_f32_screw': f'se3_R{TRAIN_RAYS}_S128',
                'fused_se3_fwd_f32': f'P{8192 * 128}',
                'fused_se3_bwd_f32': f'P{16384 * 128}'}
    out = []
    for name, (source, replaces) in F32_SCREW_ROWS.items():
        main = rows[name][main_key[name]]
        counter = F32_SCREW_COUNTER[name]
        entry = dict(name=name, route='cuda', source=source,
                     replaces=replaces,
                     launches=counts[main_path[name]][counter],
                     max_abs_err=max(v[3] for v in rows[name].values()),
                     ms=main[0], plain_ms=main[1], bound_ms=main[2][0],
                     bound_by=main[2][1], library_ms=None,
                     ffma_ceiling_ms=main[2][2], dtype='float32',
                     shape=main_key[name],
                     tolerance=f'relative L2 <= {F32_SCREW_L2}, max|d| <= '
                               f'{F32_SCREW_MAX} of the largest entry',
                     launches_by_path={
                         path: c[counter] for path, c in
                         list(counts.items()) + list(cli.items())
                         if c.get(counter)})
        for key, v in rows[name].items():
            if key != main_key[name]:
                entry.update({f'ms_{key}': v[0], f'plain_ms_{key}': v[1],
                              f'bound_ms_{key}': v[2][0]})
        out.append(entry)
    phase(f'[35] the screw --precision 32 phase took '
          f'{time.perf_counter() - t_phase:.1f} s; {CARD}')
    return out


# -- the Nerfies layout, window rows and conditions at --precision 32 ------
# (A.13.1 sub-item 3, first half; phase 36)

# name -> (its source, the TPU kernel it replaces at float32, the counter its
# launches count under, the path whose launches the line reports): rows 1,
# 8 and 9 in the Nerfies layout with the template's window row, and rows 1
# and 9 with the use_nerf_embed conditions (47 rgb columns and the alpha
# condition), variants of the float32 kernels of phases 33 and 34.
F32_NERFIES_ROWS = {
    'fused_level_fwd_f32_nerfies': (
        CSRC_DIR + 'f32_level.cu',
        'hypernerf_tpu/ops/pallas/fused_level.py:1322',
        'fused_level_fwd_f32', 'anneal_se3_f32 train'),
    'fused_template_fwd_f32_nerfies': (
        CSRC_DIR + 'f32_level.cu', 'hypernerf_tpu/ops/pallas/fused_mlp.py:656',
        'fused_template_fwd_f32', 'anneal_se3 query_sigma'),
    'fused_template_bwd_f32_nerfies': (
        CSRC_DIR + 'f32_steps.cu', 'hypernerf_tpu/ops/pallas/fused_mlp.py:736',
        'fused_template_bwd_f32', 'anneal_se3_f32 train'),
    'fused_level_fwd_f32_conditions': (
        CSRC_DIR + 'f32_level.cu',
        'hypernerf_tpu/ops/pallas/fused_level.py:1322',
        'fused_level_fwd_f32', 'nerf_embed_f32 train'),
    'fused_template_bwd_f32_conditions': (
        CSRC_DIR + 'f32_steps.cu', 'hypernerf_tpu/ops/pallas/fused_mlp.py:736',
        'fused_template_bwd_f32', 'nerf_embed_f32 train')}
PATHS.update(anneal_se3_f32=('anneal_se3', F32_FINE128),
             nerf_embed_f32=('nerf_embed', F32_FINE128))
STEP_LAUNCHES['anneal_se3_f32'] = STEP_LAUNCHES['flagship_f32']
STEP_LAUNCHES['nerf_embed_f32'] = STEP_LAUNCHES['flagship_f32']
# Phase 36 (a)'s variants: name -> (configuration, NerfConfig overrides, R):
# the Nerfies layout at table codes 0 and 1 (a 27-column condition), the
# conditions 47 + 8 (the alpha condition), 8 + 8 and 0 + 0 at code 0.
F32_NERFIES_VARIANTS = {
    'anneal': ('anneal', {}, TRAIN_RAYS),
    'anneal_se3': ('anneal_se3', {}, 8192),
    'nerf_embed': ('nerf_embed', {}, 8192),
    'embed_only': ('nerf_embed', dict(use_viewdirs=False), 8192),
    'no_viewdirs': ('flagship', dict(use_viewdirs=False), 8192)}
# Against tests/data/fused_f32_nerfies_jax_ref.npz: outputs F32_REF_OUT of
# the largest entry; a template's or a field's gradients F32_GRAD_L2 and
# F32_GRAD_MAX; a level's gradients flow back through its float32 raw_t,
# whose rounding the template's 2^9 band amplifies (a near-zero ReLU
# flips), so each is held to F32_GRAD_L2 plus twice its floor in relative
# L2, at most F32_NERFIES_REF_L2, and to F32_GRAD_MAX plus twice its floor
# in max|d| of the largest entry, the floor measured here on the card: the
# plain backward fed the kernel's raw_t against the same fed the raw_t of
# float64 glue (tests/test_torch_precision32_nerfies.py's rule, there with
# the plain forward's raw_t).
F32_NERFIES_REF_L2 = 5e-2
# The window probe: hyper_alpha 1.5 -> 2.5 moves row 1's output by more than
# a hundred times the kernel's tolerance against plain (17.8 % relative L2
# in the plain level at the probe weights, on the CPU).
F32_WINDOW_MOVE = 100 * F32_OUT_L2


def f32_nerfies_level_inputs(model, n_rays: int, samples: int, seed: int,
                             nerf_alpha):
    """The level's inputs on the card (``flagship.probe_inputs``) with the
    model's conditions (``flagship.f32_nerfies_conditions``): ([z, o, d,
    embed, rgb condition], the alpha condition or None)."""
    import torch
    from hypernerf_tpu_torch.flagship import (f32_nerfies_conditions,
                                              probe_inputs)
    arrays = probe_inputs(n_rays, samples, seed)
    alpha, arrays['rgb_cond'] = f32_nerfies_conditions(
        model, arrays['directions'], arrays['embed'], nerf_alpha)
    return ([torch.from_numpy(v).cuda() for v in arrays.values()],
            None if alpha is None else torch.from_numpy(alpha).cuda())


def f32_nerfies_windows(level, extra):
    """(the trunk's window row or None, the template's or None) of a level
    at the alphas ``extra`` (no trunk window without a ``warp_alpha``), on
    the card."""
    from hypernerf_tpu_torch.kernels.fused_mlp import template_scales
    from hypernerf_tpu_torch.kernels.fused_se3 import se3_encoding_scales
    tmpl = template_scales(level, extra.get('nerf_alpha'),
                           extra.get('hyper_alpha'), 'cuda')
    if level.warp.kind == 'translation' or 'warp_alpha' not in extra:
        return None, tmpl
    return se3_encoding_scales(level.warp, extra['warp_alpha'], 'cuda'), tmpl


def f32_nerfies_kernels(models, extra) -> dict:
    """Phase 36 (a): rows 1 and 9 of each F32_NERFIES_VARIANTS level at S =
    128 (the alphas ``extra``: the window rows mid-ramp) and row 8 in the
    Nerfies layout and with the 47 + 8 conditions (R = 8192, S = 128)
    against their float32 plain versions (rows 1 and 8 within F32_OUT_L2 /
    F32_OUT_MAX, row 9 F32_GRAD_L2 / F32_GRAD_MAX: phase 33's limits),
    timed; the Nerfies rows in turns with the flagship table's kernel on
    inputs of the same shape (this, flagship, flagship, this); the window
    probe. Returns {name: {shape: (ms, plain ms, bound, max|d|, turns)}}."""
    import torch
    from hypernerf_tpu_torch.kernels import (fused_level, fused_template,
                                             fused_template_bwd)
    from hypernerf_tpu_torch.kernels.fused_level import _launch_forward
    from hypernerf_tpu_torch.kernels.fused_mlp import cond_width
    rows = {name: {} for name in F32_NERFIES_ROWS}
    flag = models['flagship'].level('fine')

    def report(name, key, label, errs, t, b, tol, turns=None):
        beside = '' if turns is None else (
            f'; in turns with the flagship table\'s ({turns[1]:.3f}, '
            f'{turns[2]:.3f} between {turns[0]:.3f}, {turns[3]:.3f})')
        phase(f'[36] {label}: worst relative L2 {errs[0]:.3e}, max|d| '
              f'{errs[1]:.3e} of the largest entry (tol {tol[0]} / '
              f'{tol[1]}); kernel {t[0]:.3f} ms, plain {t[1]:.3f} ms; bound '
              f'{b[0]:.3f} ms ({b[1]}, {b[0] / t[0]:.1%}), FFMA ceiling '
              f'{b[2]:.3f} ms ({b[2] / t[0]:.1%}){beside}; {CARD}')
        if errs[0] > tol[0] or errs[1] > tol[1]:
            raise AssertionError(f'{label}: the kernel disagrees with plain: '
                                 f'{errs}')
        if name is not None:
            rows[name][key] = (*t, b, errs[2], turns)

    def in_turns(this, that, iters):
        return [cuda_ms(f, iters) for f in (this, that, that, this)]

    with torch.no_grad():
        for variant, (config, _, r) in F32_NERFIES_VARIANTS.items():
            s, model = 128, models[variant]
            lv = model.level('fine')
            ws, ts = f32_nerfies_windows(lv, extra)
            args, alpha = f32_nerfies_level_inputs(model, r, s, 36 + r // 4096,
                                                   extra['nerf_alpha'])
            kw = dict(warp_scales=ws, tmpl_scales=ts, alpha_cond=alpha)
            out, raw_t = _launch_forward(lv, *args, want_raw_t=True, **kw)
            want, want_raw = plain_forward(lv, args, ws, ts, alpha)
            e = [grad_errors(out, want), grad_errors(raw_t, want_raw)]
            errs = tuple(max(x[i] for x in e) for i in range(3))
            del out, raw_t
            nerfies = ts is not None
            name = (None if variant in ('embed_only', 'no_viewdirs') else
                    'fused_level_fwd_f32_' + ('nerfies' if nerfies
                                              else 'conditions'))
            key = f'{variant}_R{r}_S{s}'
            fwd = lambda: fused_level(lv, *args, **kw)
            t1 = (cuda_ms(fwd, 3), cuda_ms(
                lambda: plain_forward(lv, args, ws, ts, alpha), 1))
            turns = None
            cw = cond_width(lv)
            if variant == 'anneal':
                fargs = level_inputs(r, s, seed=36 + r // 4096)
                turns = in_turns(fwd, lambda: fused_level(flag, *fargs), 3)
                # The window is seen: hyper_alpha 1.5 -> 2.5 moves row 1.
                wider = f32_nerfies_windows(lv, {**extra,
                                                 'hyper_alpha': 2.5})[1]
                moved = grad_errors(fused_level(lv, *args, tmpl_scales=wider),
                                    fused_level(lv, *args, tmpl_scales=ts))[0]
                phase(f'[36] window probe: hyper_alpha {extra["hyper_alpha"]}'
                      f' -> 2.5 moves row 1\'s output by relative L2 '
                      f'{moved:.3e} (must exceed {F32_WINDOW_MOVE})')
                if not moved > F32_WINDOW_MOVE:
                    raise AssertionError('row 1 float32 cannot see the '
                                         'template\'s window row')
            report(name, key, f'row 1 float32 {variant} R={r} S={s} '
                   f'(condition {cw} + {0 if alpha is None else 8}, window '
                   f'{"on" if nerfies else "none"}): out and raw_t', errs,
                   t1, f32_level_bound(lv, r, s, cw),
                   (F32_OUT_L2, F32_OUT_MAX), turns)
            g = torch.randn(r * s, 4, generator=torch.Generator(
                device='cuda').manual_seed(36), device='cuda')
            got = fused_template_bwd(lv, want_raw, args[4], g, ts, alpha)
            names = TEMPLATE_GRAD_NAMES + (['d_alpha_cond'] if alpha
                                           is not None else [])
            worst = check_grads(
                f'row 9 (kernel A) float32 {variant} vs plain R={r} S={s}',
                names, [got[0], got[1], *got[2]] + (
                    [got[3]] if alpha is not None else []),
                plain_template_bwd(lv, want_raw, args[4], g, ts, alpha),
                F32_GRAD_L2, F32_GRAD_MAX, tag='[36]')
            del got
            bwd = lambda: fused_template_bwd(lv, want_raw, args[4], g, ts,
                                             alpha)
            t9 = (cuda_ms(bwd, 1), cuda_ms(lambda: plain_template_bwd(
                lv, want_raw, args[4], g, ts, alpha), 1))
            turns = None
            if variant == 'anneal':
                _, f_raw = _launch_forward(flag, *fargs, want_raw_t=True)
                turns = in_turns(bwd, lambda: fused_template_bwd(
                    flag, f_raw, fargs[4], g), 1)
                del fargs, f_raw
            name = (None if name is None else
                    name.replace('level_fwd', 'template_bwd'))
            report(name, key, f'row 9 (kernel A) float32 {variant} R={r} '
                   f'S={s}', worst, t9, f32_template_bwd_bound(lv, r, s, cw),
                   (F32_GRAD_L2, F32_GRAD_MAX), turns)
            del args, want, want_raw, g
            torch.cuda.empty_cache()
        # Row 8: the template alone in the Nerfies layout and with the
        # 47 + 8 conditions, in turns with the flagship's.
        r, s = 8192, 128
        fx, fcond = template_rows(r, s, seed=361, static=False)
        for variant in ('anneal', 'nerf_embed'):
            model = models[variant]
            tmpl = model.template_of('fine')
            ts = f32_nerfies_windows(model.level('fine'), extra)[1]
            (_, _, _, _, cond), alpha = f32_nerfies_level_inputs(
                model, r, 1, 362, extra['nerf_alpha'])
            x = fx
            got = fused_template(tmpl, x, cond, ts, alpha)
            errs = grad_errors(got, plain_template(tmpl, x, cond, ts, alpha))
            fwd = lambda: fused_template(tmpl, x, cond, ts, alpha)
            t8 = (cuda_ms(fwd, 3), cuda_ms(lambda: plain_template(
                tmpl, x, cond, ts, alpha), 1))
            turns = in_turns(fwd, lambda: fused_template(
                models['flagship'].template_of('fine'), fx, fcond), 3)
            report('fused_template_fwd_f32_nerfies' if variant == 'anneal'
                   else None, f'{variant}_R{r}_S{s}',
                   f'row 8 float32 template alone {variant} R={r} S={s} '
                   f'(condition {cond.shape[1]} + '
                   f'{0 if alpha is None else 8})', errs, t8,
                   f32_template_bound(tmpl, r * s, s, cond.shape[1]),
                   (F32_OUT_L2, F32_OUT_MAX), turns)
        del fx, fcond
    torch.cuda.empty_cache()
    return rows


def f32_window_fields(model) -> dict:
    """Phase 36 (b): rows 10 and 11 with a window row (the warp field at
    warp alpha 4.5 of its 10 bands, the sheet at 3.5 of its 7) against
    their float32 plain versions, row 10 on 8192 x 128 rows, row 11 on
    16384 x 128, timed in turns with the same rows without a window.
    Returns {row: {field: (ms, plain ms, bound, max|d|, turns)}}."""
    import torch
    from hypernerf_tpu_torch.kernels import fused_field, fused_field_bwd
    from hypernerf_tpu_torch.kernels.fused_field import encoding_scales
    out = {'10': {}, '11': {}}
    with torch.no_grad():
        for field, alpha in (('warp_field', 4.5), ('hyper_sheet_mlp', 3.5)):
            f = getattr(model, field)
            row = encoding_scales(f.n_freq, 8, alpha, 'cuda')
            x = field_rows(8192 * 128, seed=363)
            errs = grad_errors(fused_field(f.mlp, f.n_freq, x, row),
                               plain_field(f.mlp, f.n_freq, x, row))
            fwd = lambda: fused_field(f.mlp, f.n_freq, x, row)
            t = (cuda_ms(fwd, 3), cuda_ms(
                lambda: plain_field(f.mlp, f.n_freq, x, row), 1))
            turns = [cuda_ms(fn, 3) for fn in (
                fwd, lambda: fused_field(f.mlp, f.n_freq, x),
                lambda: fused_field(f.mlp, f.n_freq, x), fwd)]
            b = f32_field_bound(f.mlp, x.shape[0])
            phase(f'[36] row 10 float32 {field} alone with a window row '
                  f'(alpha {alpha}) on {x.shape[0]} rows: relative L2 '
                  f'{errs[0]:.3e}, max|d| {errs[1]:.3e} (tol {F32_OUT_L2} / '
                  f'{F32_OUT_MAX}); kernel {t[0]:.3f} ms, plain {t[1]:.3f} '
                  f'ms; bound {b[0]:.3f} ms ({b[1]}); without the window in '
                  f'turns {turns[1]:.3f}, {turns[2]:.3f} between '
                  f'{turns[0]:.3f}, {turns[3]:.3f}; {CARD}')
            if errs[0] > F32_OUT_L2 or errs[1] > F32_OUT_MAX:
                raise AssertionError(f'row 10 windowed {field}: {errs}')
            out['10'][field] = (*t, b, errs[2], turns)
            x = field_rows(16384 * 128, seed=364)
            g = torch.randn(x.shape[0], 8, generator=torch.Generator(
                device='cuda').manual_seed(364), device='cuda')
            dx, grads = fused_field_bwd(f.mlp, f.n_freq, x, g, row)
            from hypernerf_tpu_torch.kernels.fused_field import field_layers
            names = ['dx_raw'] + [f'{k}{i}' for i in range(
                len(field_layers(f.mlp))) for k in ('dW', 'db')]
            worst = check_grads(
                f'row 11 float32 {field} alone backward with a window row '
                f'vs plain on {x.shape[0]} rows', names, [dx, *grads],
                plain_field_bwd(f.mlp, f.n_freq, x, g, row), F32_GRAD_L2,
                F32_GRAD_MAX, tag='[36]')
            del dx, grads
            bwd = lambda: fused_field_bwd(f.mlp, f.n_freq, x, g, row)
            t = (cuda_ms(bwd, 1), cuda_ms(
                lambda: plain_field_bwd(f.mlp, f.n_freq, x, g, row), 1))
            turns = [cuda_ms(fn, 1) for fn in (
                bwd, lambda: fused_field_bwd(f.mlp, f.n_freq, x, g),
                lambda: fused_field_bwd(f.mlp, f.n_freq, x, g), bwd)]
            b = f32_field_bwd_bound(f.mlp, x.shape[0])
            phase(f'[36] row 11 float32 {field} backward with the window: '
                  f'kernel {t[0]:.3f} ms, plain {t[1]:.3f} ms; bound '
                  f'{b[0]:.3f} ms ({b[1]}); without the window in turns '
                  f'{turns[1]:.3f}, {turns[2]:.3f} between {turns[0]:.3f}, '
                  f'{turns[3]:.3f}; {CARD}')
            out['11'][field] = (*t, b, worst[2], turns)
            del x, g
    torch.cuda.empty_cache()
    return out


def f32_level_floor(model, level_name, extra, cuda, raw_t):
    """{gradient name: (relative L2, max|d| of the largest entry)} by
    which the plain level's gradients of a stored level case (``model``'s
    level ``level_name`` at the alphas ``extra``) move when its backward is
    fed ``raw_t`` (the kernel's) instead of the raw_t of its forward with
    float64 arithmetic outside the MLPs."""
    import torch
    from hypernerf_tpu_torch.flagship import LEVEL_INPUTS
    from hypernerf_tpu_torch.kernels import (fused_fields_bwd_plain,
                                             fused_level_plain,
                                             fused_template_bwd_plain)
    lv = model.double().level(level_name)
    ws, ts = (None if t is None else t.double()
              for t in f32_nerfies_windows(lv, extra))
    args = [cuda[k].double() for k in LEVEL_INPUTS]
    alpha = cuda.get('alpha_cond')
    alpha = None if alpha is None else alpha.double()
    cot = cuda['cotangent'].double()

    def grads(raw):
        dx_t, d_cond, t_grads, d_alpha = fused_template_bwd_plain(
            lv, raw, args[4], cot, ts, alpha)
        *rays, f_grads = fused_fields_bwd_plain(lv, *args[:4], dx_t, ws)
        out = dict(zip([f'd_{k}' for k in LEVEL_INPUTS[:4]], rays))
        out['d_rgb_cond'] = d_cond
        if d_alpha is not None:
            out['d_alpha_cond'] = d_alpha
        for l, (dw, db) in enumerate(zip(*[iter(f_grads + t_grads)] * 2)):
            out.update({f'dw{l}': dw, f'db{l}': db})
        return out

    with torch.no_grad():
        exact = grads(fused_level_plain(
            lv, *args, return_raw_t=True, warp_scales=ws, tmpl_scales=ts,
            alpha_cond=alpha)[1])
        rounded = grads(raw_t.double())
    return {k: grad_errors(rounded[k], v)[:2] for k, v in exact.items()}


def f32_nerfies_reference() -> None:
    """Phase 36 (a), the stored numbers: rows 1, 9 and 5 (a level through
    its autograd Function: the level forward, then kernels A and B), rows 8
    and 9 (the template alone through its Function) and rows 10 and 11 (a
    field alone with its window row) against the JAX kernels' float32
    numbers (tests/data/fused_f32_nerfies_jax_ref.npz): outputs within
    F32_REF_OUT of the largest entry; gradients F32_NERFIES_REF_L2 (a
    level) or F32_GRAD_L2 and F32_GRAD_MAX."""
    import torch
    from hypernerf_tpu_torch.flagship import (F32_NERFIES_FIELD_CASES,
                                              F32_NERFIES_LEVEL_CASES,
                                              F32_NERFIES_TEMPLATE_CASES,
                                              LEVEL_INPUTS,
                                              f32_nerfies_extra,
                                              f32_nerfies_grad_layers,
                                              f32_nerfies_model,
                                              read_f32_nerfies_reference)
    from hypernerf_tpu_torch.kernels import (common, fused_field,
                                             fused_level, fused_template)
    from hypernerf_tpu_torch.kernels.fused_field import (encoding_scales,
                                                         field_layers)
    from hypernerf_tpu_torch.kernels.fused_level import (_launch_forward,
                                                         level_layers)
    from hypernerf_tpu_torch.kernels.fused_mlp import (template_layers,
                                                       template_scales)
    worst, floors = 0.0, {}
    for case, arrays in read_f32_nerfies_reference().items():
        model = f32_nerfies_model(case, 'cuda')
        cuda = {k: torch.tensor(v).cuda() for k, v in arrays.items()}
        keep = f32_nerfies_grad_layers(case)
        if case in F32_NERFIES_FIELD_CASES:
            _, _, module, _, alpha, _ = F32_NERFIES_FIELD_CASES[case]
            f = getattr(model, module)
            x = cuda['x_raw'].requires_grad_(True)
            out = fused_field(f.mlp, f.n_freq, x, encoding_scales(
                f.n_freq, 8, alpha, 'cuda'))
            layers = field_layers(f.mlp)
            names, inputs, floor = ['dx'], [x], None
            cot = cuda['cotangent'][:, :out.shape[1]]
        elif case in F32_NERFIES_LEVEL_CASES:
            lv = model.level(F32_NERFIES_LEVEL_CASES[case][2])
            ws, ts = f32_nerfies_windows(lv, f32_nerfies_extra(case))
            names = [f'd_{k}' for k in LEVEL_INPUTS]
            inputs = [cuda[k].requires_grad_(True) for k in LEVEL_INPUTS]
            alpha = cuda.get('alpha_cond')
            if alpha is not None:
                names.append('d_alpha_cond')
                inputs.append(alpha.requires_grad_(True))
            out = fused_level(lv, *inputs[:5], warp_scales=ws,
                              tmpl_scales=ts, alpha_cond=alpha)
            layers = level_layers(lv)
            with torch.no_grad():
                raw_t = _launch_forward(lv, *inputs[:5], want_raw_t=True,
                                        warp_scales=ws, tmpl_scales=ts,
                                        alpha_cond=alpha)[1]
            floor = f32_level_floor(
                f32_nerfies_model(case, 'cuda'),
                F32_NERFIES_LEVEL_CASES[case][2], f32_nerfies_extra(case),
                cuda, raw_t)
            cot = cuda['cotangent']
        else:
            tmpl = model.template_of(F32_NERFIES_TEMPLATE_CASES[case][2])
            ep = f32_nerfies_extra(case)
            ts = template_scales(tmpl, ep.get('nerf_alpha'),
                                 ep.get('hyper_alpha'), 'cuda')
            names = ['dx', 'd_rgb_cond']
            inputs = [cuda['x_raw'].requires_grad_(True),
                      cuda['rgb_cond'].requires_grad_(True)]
            alpha = cuda.get('alpha_cond')
            if alpha is not None:
                names.append('d_alpha_cond')
                inputs.append(alpha.requires_grad_(True))
            out = fused_template(tmpl, *inputs[:2], ts, alpha)
            layers = template_layers(tmpl.template)
            cot, floor = cuda['cotangent'], None
        err = ((out.detach() - cuda['out']).abs().max()
               / cuda['out'].abs().max()).item()
        worst = max(worst, err)
        params = common.layer_params(layers)
        got = list(torch.autograd.grad(out, inputs + params, cot))
        want_names, want_got = list(names), got[:len(inputs)]
        for l in range(len(layers)):
            want_names.append(f'db{l}')
            want_got.append(got[len(inputs) + 2 * l + 1])
            if l in keep:
                want_names.append(f'dw{l}')
                want_got.append(got[len(inputs) + 2 * l])
        label = f'{case} float32 against the stored JAX gradients'
        if floor is None:
            check_grads(label, want_names, want_got,
                        [cuda[n] for n in want_names], F32_GRAD_L2,
                        F32_GRAD_MAX, tag='[36]')
        else:
            hold_floored(label, want_names, want_got,
                         [cuda[n] for n in want_names], floor)
            floors[case] = max(v[0] for v in floor.values())
        if not err <= F32_REF_OUT:
            raise AssertionError(f'{case} float32 against the stored JAX '
                                 f'outputs: {err:.3e}')
        del model, out, inputs, got
    torch.cuda.empty_cache()
    phase(f'[36] rows 1, 5, 8, 9, 10, 11 against the stored JAX float32 '
          f'numbers of the Nerfies layout, window rows and conditions: '
          f'outputs max|d| {worst:.3e} of the largest entry at worst (tol '
          f'{F32_REF_OUT}); the levels\' raw_t floors (relative L2, worst '
          f'gradient) ' + ', '.join(f'{c} {v:.3e}' for c, v in
                                     floors.items()))


def hold_floored(label, names, got, want, floor, tag='[36]'):
    """Hold each gradient of a level to its stored JAX value within
    F32_GRAD_L2 + 2 floor (at most F32_NERFIES_REF_L2) in relative L2 and
    F32_GRAD_MAX + 2 floor in max|d| of the largest entry, ``floor`` its
    ``f32_level_floor``; prints the worst against its limit."""
    import torch
    worst = (0.0, None, 0.0)
    for name, a, b in zip(names, got, want):
        l2, mx, _ = grad_errors(a, b)
        f2, fm = floor[name]
        lim = (min(F32_GRAD_L2 + 2 * f2, F32_NERFIES_REF_L2),
               F32_GRAD_MAX + 2 * fm)
        if not (l2 <= lim[0] and mx <= lim[1]
                and torch.isfinite(a).all()):
            raise AssertionError(f'{label}: {name} relative L2 {l2:.3e} '
                                 f'(limit {lim[0]:.3e}, floor {f2:.3e}), max '
                                 f'{mx:.3e} (limit {lim[1]:.3e}, floor '
                                 f'{fm:.3e})')
        if l2 / lim[0] > worst[0]:
            worst = (l2 / lim[0], name, l2)
    phase(f'{tag} {label}: {len(names)} outputs, worst relative L2 '
          f'{worst[2]:.3e} at {worst[1]} ({worst[0]:.0%} of its limit, '
          f'F32_GRAD_L2 + 2 x its raw_t floor)')


def f32_nerfies_paths() -> dict:
    """Phase 36 (c): at full width, with their launches and no plain call:
    an ``anneal_se3`` float32 frame (64 + 64, fully annealed) and its 64 +
    128 train step (from ANNEAL_PROBE_STEP: the window rows mid-ramp; rows
    1, 9 in the Nerfies layout, B with the trunk, kernels vs plain on 1024
    rays), a ``nerf_embed`` 64 + 128 step (rows 1 and 9 with both
    conditions), ``query_sigma`` on ``anneal_se3`` (row 8 in the Nerfies
    layout). Returns {path: launches}."""
    import torch
    from hypernerf_tpu_torch.flagship import W, H, flagship_model, spiral_rays
    from hypernerf_tpu_torch.training.renderer import ImageRenderer
    counts = {}
    frames = spiral_rays([0, 30])  # a warm-up frame, then one timed
    keep = ('rgb', 'depth', 'acc')
    model = flagship_model('cuda', seed=0, config='anneal_se3', **F32)
    chunks_per_frame = -(-W * H // CHUNK)
    secs, counts['anneal_se3 frame'] = time_frames(
        ImageRenderer(model, chunk=CHUNK, keep=keep, levels=('fine',),
                      quantize=True), frames, keep,
        {n: v * chunks_per_frame
         for n, v in F32_SCREW_CHUNK['level'].items()},
        'anneal_se3 float32 frame')
    phase(f'[36] anneal_se3 float32 frame: {secs:.3f} s/frame ({W}x{H}, '
          f'64+64, chunk {CHUNK}, fully annealed); launches '
          f'{counts["anneal_se3 frame"]}; no plain call; {CARD}')
    del model
    torch.cuda.empty_cache()
    for path in ('anneal_se3_f32', 'nerf_embed_f32'):
        times = {}
        counts[f'{path} train'] = train_path(path, '[36]', times,
                                             F32_STEP_TOLS)
        TIMES[f'{path}_step'] = times
        flagship = TIMES.get('f32', {}).get('step', {}).get('secs',
                                                            float('nan'))
        phase(f'[36] {path} 64 + 128 step: {times["secs"] * 1e3:.1f} '
              f'ms/step, peak {times["peak"]:.2f} GiB; the flagship\'s at '
              f'float32 (phase 33) {flagship * 1e3:.1f} ms/step; {CARD}')
        torch.cuda.empty_cache()
    counts['anneal_se3 query_sigma'] = query_sigma_path(
        'anneal_se3', {'fused_se3_fwd_f32': 1, 'fused_field_fwd_f32': 1,
                       'fused_template_fwd_f32': 1}, '[36]', **F32)
    torch.cuda.empty_cache()
    return counts


# Phase 36 (d): what float32 still refuses on the card: a band flag of
# A.13.2 (the Jacobians, A.13.1 sub-item 4, run since phase 38's port).
F32_STILL_REFUSED = (('hyper_freq 4', 'flagship', dict(hyper_freq=4), {}),)


def precision32_nerfies_phase(kernels) -> list:
    """Phase 36: the sheet tables' Nerfies layout, window rows and
    conditions at ``--precision 32`` (ROADMAP A.13.1 sub-item 3, first
    half): TF32 off; (a) rows 1, 8 and 9 in the Nerfies layout (table
    codes 0 and 1) and with the condition widths 47 + 8, 8 + 8 and 0
    against their plain versions, timed, the window probe, and against the
    stored JAX numbers; (b) rows 10 and 11 with a window row; (c) an
    ``anneal_se3`` frame and 64 + 128 step, a ``nerf_embed`` step,
    ``query_sigma``, then ``train.main --precision 32 --use_nerfies_embed
    --warp_field se3`` and ``eval``; (d) every path's launches counted with
    no plain call (in (c)), and a band flag of A.13.2 refused on the card
    naming ROADMAP A.13. Returns the five entries of the line."""
    import torch
    from hypernerf_tpu_torch.flagship import (anneal_extra_params,
                                              flagship_model,
                                              load_probe_weights)
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    extra = anneal_extra_params()
    models = {'flagship': load_probe_weights(flagship_model(
        'cuda', **F32_FINE128))}
    for variant, (config, over, _) in F32_NERFIES_VARIANTS.items():
        models[variant] = load_probe_weights(flagship_model(
            'cuda', config=config, **over, **F32_FINE128))
    rows = f32_nerfies_kernels(models, extra)
    fields = f32_window_fields(models['flagship'])
    del models
    torch.cuda.empty_cache()
    f32_nerfies_reference()
    counts = f32_nerfies_paths()
    cli = f32_train_eval('[36]', 'f32_anneal_se3', (
        '--use_nerfies_embed', '--warp_field', 'se3'), dict(
        warp_field_type='se3', use_original_embed=False))
    f32_refusals_phase(F32_STILL_REFUSED, '[36]')
    main_key = {'fused_level_fwd_f32_nerfies': f'anneal_R{TRAIN_RAYS}_S128',
                'fused_template_fwd_f32_nerfies': 'anneal_R8192_S128',
                'fused_template_bwd_f32_nerfies': f'anneal_R{TRAIN_RAYS}_S128',
                'fused_level_fwd_f32_conditions': 'nerf_embed_R8192_S128',
                'fused_template_bwd_f32_conditions': 'nerf_embed_R8192_S128'}
    out = []
    # The paths of each variant: the Nerfies layout's (anneal_se3 and the
    # CLI's --use_nerfies_embed run), the conditions' (nerf_embed).
    paths = {'nerfies': {**{p: c for p, c in counts.items()
                            if p.startswith('anneal_se3')}, **cli},
             'conditions': {p: c for p, c in counts.items()
                            if p.startswith('nerf_embed')}}
    for name, (source, replaces, counter, path) in F32_NERFIES_ROWS.items():
        main = rows[name][main_key[name]]
        entry = dict(name=name, route='cuda', source=source,
                     replaces=replaces, launches=counts[path][counter],
                     max_abs_err=max(v[3] for v in rows[name].values()),
                     ms=main[0], plain_ms=main[1], bound_ms=main[2][0],
                     bound_by=main[2][1], library_ms=None,
                     ffma_ceiling_ms=main[2][2], dtype='float32',
                     shape=main_key[name],
                     launches_by_path={
                         p: c[counter] for p, c in
                         paths[name.rsplit('_', 1)[1]].items()
                         if c.get(counter)})
        if main[4] is not None:
            entry['flagship_ms_in_turns'] = main[4][1:3]
        for key, v in rows[name].items():
            if key != main_key[name]:
                entry.update({f'ms_{key}': v[0], f'plain_ms_{key}': v[1],
                              f'bound_ms_{key}': v[2][0]})
        if name == 'fused_template_fwd_f32_nerfies':
            for row, by_field in fields.items():
                for field, v in by_field.items():
                    entry[f'row{row}_window_{field}_ms'] = v[0]
        out.append(entry)
    phase(f'[36] the Nerfies-layout --precision 32 phase took '
          f'{time.perf_counter() - t_phase:.1f} s; {CARD}')
    return out


# -- the plane tables at --precision 32 (A.13.1 sub-item 3, second half;
# phase 37) ----------------------------------------------------------------

# name -> (its source, the TPU kernel it replaces at float32, the counter its
# launches count under, the path whose launches the line reports): rows 1,
# 5, 8 and 9 on the plane tables (table codes 3 to 8, axis_aligned_plane:
# no sheet, the ray's 8 GLO coordinates as the hyper coordinates), variants
# of the float32 kernels of phases 33 to 36.
F32_PLANE_ROWS = {
    'fused_level_fwd_f32_plane': (
        CSRC_DIR + 'f32_level.cu',
        'hypernerf_tpu/ops/pallas/fused_level.py:1322',
        'fused_level_fwd_f32', 'plane_anneal_se3_f32 train'),
    'fused_fields_bwd_f32_plane': (
        CSRC_DIR + 'f32_steps.cu',
        'hypernerf_tpu/ops/pallas/fused_level.py:846',
        'fused_fields_bwd_f32', 'plane_anneal_se3_f32 train'),
    'fused_template_fwd_f32_plane': (
        CSRC_DIR + 'f32_level.cu', 'hypernerf_tpu/ops/pallas/fused_mlp.py:656',
        'fused_template_fwd_f32', 'plane return_points frame'),
    'fused_template_bwd_f32_plane': (
        CSRC_DIR + 'f32_steps.cu', 'hypernerf_tpu/ops/pallas/fused_mlp.py:736',
        'fused_template_bwd_f32', 'plane_anneal_se3_f32 train')}
PATHS.update(plane_f32=('plane', F32_FINE128),
             plane_anneal_se3_f32=('plane_anneal_se3', F32_FINE128))
STEP_LAUNCHES['plane_f32'] = STEP_LAUNCHES['flagship_f32']
STEP_LAUNCHES['plane_anneal_se3_f32'] = STEP_LAUNCHES['flagship_f32']
# The six plane configurations and their table codes (common.TABLE_CODES):
# the posenc_orig plane layout (3 to 5) and the Nerfies one (6 to 8), each
# after the translation, SE(3) and quaternion warp.
F32_PLANE_CONFIGS = {'plane': 3, 'plane_se3': 4, 'plane_quaternion': 5,
                     'plane_anneal': 6, 'plane_anneal_se3': 7,
                     'plane_anneal_quaternion': 8}
# Kernel vs plain, both float32 on the card with TF32 off: rows 1, 5, 8
# and 9 at the plane tables per output within phase 35's relative L2 1e-4
# and max|d| 1e-3 of the largest entry (F32_SCREW_L2 / F32_SCREW_MAX).
# Against tests/data/fused_f32_plane_jax_ref.npz: outputs F32_REF_OUT of
# the largest entry, a template's gradients F32_GRAD_L2 / F32_GRAD_MAX, a
# level's phase 36's rule (F32_GRAD_L2 plus twice the raw_t floor the card
# measures, at most F32_NERFIES_REF_L2; hold_floored).
F32_PLANE_CLI_FLAGS = ('--slice_method', 'axis_aligned_plane',
                       '--use_nerfies_embed', '--warp_field', 'se3')


def f32_plane_template_rows(model, rows: int, samples: int, seed: int,
                            nerf_alpha):
    """A plane template's raw rows on the card, (rows, 16) [points | the
    rows' embedding as its 8 hyper coordinates | 0] (``field_rows``), and
    the model's rgb condition of rows / samples rays."""
    import torch
    x = torch.nn.functional.pad(field_rows(rows, seed), (0, 5)).contiguous()
    args, _ = f32_nerfies_level_inputs(model, rows // samples, 1, seed + 1,
                                       nerf_alpha)
    return x, args[4]


def f32_plane_kernels(models, extra) -> dict:
    """Phase 37 (a): rows 1, 5, 8 and 9 on the plane tables against their
    float32 plain versions (TF32 off, the same inputs; F32_SCREW_L2 /
    F32_SCREW_MAX per output) at the alphas ``extra`` (the window rows
    mid-ramp), timed, each in turns with the flagship table's float32
    kernel on inputs of the same shape (this, flagship, flagship, this):
    row 1 at every plane code at R = 16384, S = 128 and at codes 3 and 6
    at S = 192; rows 9 and 5 at codes 3 and 6 at S = 128 (row 9 at S = 192
    too); row 8 in both plane layouts at R = 8192, S = 128. Returns {name:
    {shape: (ms, plain ms, bound, max|d|, turns)}}."""
    import torch
    from hypernerf_tpu_torch.kernels import (fused_fields_bwd, fused_level,
                                             fused_template,
                                             fused_template_bwd)
    from hypernerf_tpu_torch.kernels.fused_level import _launch_forward
    from hypernerf_tpu_torch.kernels.fused_mlp import cond_width
    rows = {name: {} for name in F32_PLANE_ROWS}
    flag = models['flagship'].level('fine')
    tol = (F32_SCREW_L2, F32_SCREW_MAX)

    def report(name, key, label, errs, t, b, turns):
        phase(f'[37] {label}: worst relative L2 {errs[0]:.3e}, max|d| '
              f'{errs[1]:.3e} of the largest entry (tol {tol[0]} / '
              f'{tol[1]}); kernel {t[0]:.3f} ms, plain {t[1]:.3f} ms; bound '
              f'{b[0]:.3f} ms ({b[1]}, {b[0] / t[0]:.1%}), FFMA ceiling '
              f'{b[2]:.3f} ms ({b[2] / t[0]:.1%}); in turns with the '
              f'flagship table\'s ({turns[1]:.3f}, {turns[2]:.3f} between '
              f'{turns[0]:.3f}, {turns[3]:.3f}); {CARD}')
        if errs[0] > tol[0] or errs[1] > tol[1]:
            raise AssertionError(f'{label}: the kernel disagrees with plain: '
                                 f'{errs}')
        rows[name][key] = (*t, b, errs[2], turns)

    def in_turns(this, that, iters):
        return [cuda_ms(f, iters) for f in (this, that, that, this)]

    r = TRAIN_RAYS
    with torch.no_grad():
        shapes = [(c, 128) for c in F32_PLANE_CONFIGS] + [
            ('plane', S192), ('plane_anneal', S192)]
        for config, s in shapes:
            lv = models[config].level('fine')
            ws, ts = f32_nerfies_windows(lv, extra)
            args, _ = f32_nerfies_level_inputs(models[config], r, s,
                                               37 + s, extra['nerf_alpha'])
            kw = dict(warp_scales=ws, tmpl_scales=ts)
            out, raw_t = _launch_forward(lv, *args, want_raw_t=True, **kw)
            want, want_raw = plain_forward(lv, args, ws, ts)
            e = [grad_errors(out, want), grad_errors(raw_t, want_raw)]
            errs = tuple(max(x[i] for x in e) for i in range(3))
            if raw_t.shape[1] != 16 or not torch.equal(
                    raw_t[:, 3:11], args[3].repeat_interleave(s, 0)):
                raise AssertionError(f'row 1 {config}: raw_t is not [warped '
                                     f'| the embedding | 0]')
            del out, raw_t
            fargs = level_inputs(r, s, seed=37 + s)
            fwd = lambda: fused_level(lv, *args, **kw)
            t = (cuda_ms(fwd, 3), cuda_ms(
                lambda: plain_forward(lv, args, ws, ts), 1))
            turns = in_turns(fwd, lambda: fused_level(flag, *fargs), 3)
            code = F32_PLANE_CONFIGS[config]
            report('fused_level_fwd_f32_plane', f'{config}_R{r}_S{s}',
                   f'row 1 float32 {config} (code {code}) R={r} S={s}: out '
                   f'and raw_t', errs, t,
                   f32_level_bound(lv, r, s, cond_width(lv)), turns)
            if code not in (3, 6):
                del args, want, want_raw, fargs
                continue
            g = torch.randn(r * s, 4, generator=torch.Generator(
                device='cuda').manual_seed(37), device='cuda')
            got = fused_template_bwd(lv, want_raw, args[4], g, ts)
            worst = check_grads(
                f'row 9 (kernel A) float32 {config} vs plain R={r} S={s}',
                TEMPLATE_GRAD_NAMES, [got[0], got[1], *got[2]],
                plain_template_bwd(lv, want_raw, args[4], g, ts), *tol,
                tag='[37]')
            dx_t = got[0]
            del got
            bwd = lambda: fused_template_bwd(lv, want_raw, args[4], g, ts)
            t = (cuda_ms(bwd, 1), cuda_ms(lambda: plain_template_bwd(
                lv, want_raw, args[4], g, ts), 1))
            _, f_raw = _launch_forward(flag, *fargs, want_raw_t=True)
            turns = in_turns(bwd, lambda: fused_template_bwd(
                flag, f_raw, fargs[4], g), 1)
            report('fused_template_bwd_f32_plane', f'{config}_R{r}_S{s}',
                   f'row 9 (kernel A) float32 {config} R={r} S={s} (a '
                   f'{"176" if code == 3 else "128"}-column encoding stash)',
                   worst, t, f32_template_bwd_bound(lv, r, s,
                                                    cond_width(lv), 16),
                   turns)
            if s == 128:
                got = fused_fields_bwd(lv, *args[:4], dx_t, ws)
                names = FIELDS_GRAD_NAMES[:4] + [
                    f'd{"Wb"[i % 2]}{i // 2}' for i in range(14)]
                worst = check_grads(
                    f'row 5 (kernel B) float32 {config} vs plain R={r} '
                    f'S={s} (no sheet)', names, [*got[:4], *got[4]],
                    plain_fields_bwd(lv, args, dx_t, ws), *tol, tag='[37]')
                del got
                fbwd = lambda: fused_fields_bwd(lv, *args[:4], dx_t, ws)
                t = (cuda_ms(fbwd, 1), cuda_ms(
                    lambda: plain_fields_bwd(lv, args, dx_t, ws), 1))
                f_dx = fused_template_bwd(flag, f_raw, fargs[4], g)[0]
                turns = in_turns(fbwd, lambda: fused_fields_bwd(
                    flag, *fargs[:4], f_dx), 1)
                report('fused_fields_bwd_f32_plane', f'{config}_R{r}_S{s}',
                       f'row 5 (kernel B) float32 {config} R={r} S={s}',
                       worst, t, f32_fields_bwd_bound(lv, r, s, 16), turns)
                del f_dx
            del args, want, want_raw, fargs, f_raw, g, dx_t
            torch.cuda.empty_cache()
        r, s = 8192, 128
        fx, fcond = template_rows(r, s, seed=371, static=False)
        for config in ('plane', 'plane_anneal'):
            model = models[config]
            tmpl = model.template_of('fine')
            ts = f32_nerfies_windows(model.level('fine'), extra)[1]
            x, cond = f32_plane_template_rows(model, r * s, s, 372,
                                              extra['nerf_alpha'])
            errs = grad_errors(fused_template(tmpl, x, cond, ts),
                               plain_template(tmpl, x, cond, ts))
            fwd = lambda: fused_template(tmpl, x, cond, ts)
            t = (cuda_ms(fwd, 3), cuda_ms(lambda: plain_template(
                tmpl, x, cond, ts), 1))
            turns = in_turns(fwd, lambda: fused_template(
                models['flagship'].template_of('fine'), fx, fcond), 3)
            report('fused_template_fwd_f32_plane', f'{config}_R{r}_S{s}',
                   f'row 8 float32 template alone {config} R={r} S={s} '
                   f'(x_raw of 16 columns, condition {cond.shape[1]})',
                   errs, t, f32_template_bound(tmpl, r * s, s,
                                               cond.shape[1], 16), turns)
            del x, cond
        del fx, fcond
    torch.cuda.empty_cache()
    return rows


def f32_plane_reference() -> None:
    """Phase 37 (a), the stored numbers: the plane levels through their
    autograd Function (rows 1, 9 and 5) at codes 3 and 6, the level
    forward alone at codes 4, 5, 7 and 8, and the template alone through
    its Function (rows 8 and 9) in both plane layouts, against the JAX
    kernels' float32 numbers (tests/data/fused_f32_plane_jax_ref.npz):
    outputs within F32_REF_OUT of the largest entry; a template's gradients
    F32_GRAD_L2 and F32_GRAD_MAX, a level's hold_floored (phase 36's
    rule)."""
    import torch
    from hypernerf_tpu_torch.flagship import (F32_PLANE_LEVEL_CASES,
                                              F32_PLANE_TEMPLATE_CASES,
                                              LEVEL_INPUTS, f32_plane_extra,
                                              f32_plane_grad_layers,
                                              f32_plane_model,
                                              read_f32_plane_reference)
    from hypernerf_tpu_torch.kernels import (common, fused_level,
                                             fused_template)
    from hypernerf_tpu_torch.kernels.fused_level import (_launch_forward,
                                                         level_layers)
    from hypernerf_tpu_torch.kernels.fused_mlp import template_layers
    worst, floors = 0.0, {}
    for case, arrays in read_f32_plane_reference().items():
        model = f32_plane_model(case, 'cuda')
        extra = f32_plane_extra(case)
        cuda = {k: torch.tensor(v).cuda() for k, v in arrays.items()}
        keep = f32_plane_grad_layers(case)
        floor = None
        if case in F32_PLANE_LEVEL_CASES:
            level_name, grads = (F32_PLANE_LEVEL_CASES[case][1],
                                 F32_PLANE_LEVEL_CASES[case][-1])
            lv = model.level(level_name)
            ws, ts = f32_nerfies_windows(lv, extra)
            names = [f'd_{k}' for k in LEVEL_INPUTS]
            inputs = [cuda[k].requires_grad_(grads) for k in LEVEL_INPUTS]
            out = fused_level(lv, *inputs, warp_scales=ws, tmpl_scales=ts)
            layers = level_layers(lv)
            if grads:
                with torch.no_grad():
                    raw_t = _launch_forward(lv, *inputs, want_raw_t=True,
                                            warp_scales=ws,
                                            tmpl_scales=ts)[1]
                floor = f32_level_floor(f32_plane_model(case, 'cuda'),
                                        level_name, extra, cuda, raw_t)
        else:
            tmpl = model.template_of(F32_PLANE_TEMPLATE_CASES[case][1])
            ts = f32_nerfies_windows(model.level('fine'), extra)[1]
            names = ['dx', 'd_rgb_cond']
            inputs = [cuda['x_raw'].requires_grad_(True),
                      cuda['rgb_cond'].requires_grad_(True)]
            out = fused_template(tmpl, *inputs, ts)
            layers, grads = template_layers(tmpl.template), True
        err = ((out.detach() - cuda['out']).abs().max()
               / cuda['out'].abs().max()).item()
        worst = max(worst, err)
        if not err <= F32_REF_OUT:
            raise AssertionError(f'{case} float32 against the stored JAX '
                                 f'outputs: {err:.3e}')
        if grads:
            params = common.layer_params(layers)
            got = list(torch.autograd.grad(out, inputs + params,
                                           cuda['cotangent']))
            want_names, want_got = list(names), got[:len(inputs)]
            for l in range(len(layers)):
                want_names.append(f'db{l}')
                want_got.append(got[len(inputs) + 2 * l + 1])
                if l in keep:
                    want_names.append(f'dw{l}')
                    want_got.append(got[len(inputs) + 2 * l])
            label = f'{case} float32 against the stored JAX gradients'
            if floor is None:
                check_grads(label, want_names, want_got,
                            [cuda[n] for n in want_names], F32_GRAD_L2,
                            F32_GRAD_MAX, tag='[37]')
            else:
                hold_floored(label, want_names, want_got,
                             [cuda[n] for n in want_names], floor, '[37]')
                floors[case] = max(v[0] for v in floor.values())
            del got
        del model, out, inputs
    torch.cuda.empty_cache()
    phase(f'[37] rows 1, 5, 8, 9 against the stored JAX float32 numbers of '
          f'the plane tables (row 1 at codes 3 to 8): outputs max|d| '
          f'{worst:.3e} of the largest entry at worst (tol {F32_REF_OUT}); '
          f'the levels\' raw_t floors (relative L2, worst gradient) '
          + ', '.join(f'{c} {v:.3e}' for c, v in floors.items()))


def f32_plane_paths() -> dict:
    """Phase 37 (b) and (c): at full width, with their launches and no plain
    call: a 504x378 frame (64 + 64, chunk CHUNK, fully annealed) of
    ``plane`` and of ``plane_anneal_se3``, a render of 1024 rays of the
    latter against the plain versions, a ``plane`` frame with
    ``return_points`` (the warp field alone and the template alone); the
    64 + 128 train step of ``plane`` and of ``plane_anneal_se3`` (from
    ANNEAL_PROBE_STEP, its window rows mid-ramp; each with one step on 1024
    rays against the plain versions); ``query_sigma`` on ``plane``.
    Returns {path: launches}."""
    import torch
    from hypernerf_tpu_torch.flagship import W, H, flagship_model, spiral_rays
    from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
    from hypernerf_tpu_torch.training.renderer import ImageRenderer
    counts = {}
    frames = spiral_rays([0, 30])  # a warm-up frame, then one timed
    keep = ('rgb', 'depth', 'acc')
    chunks_per_frame = -(-W * H // CHUNK)
    for config, return_points in (('plane', False),
                                  ('plane_anneal_se3', False),
                                  ('plane', True)):
        model = flagship_model('cuda', seed=0, config=config, **F32)
        k = keep + (('med_points',) if return_points else ())
        label = f'{config} frame' + (' with return_points' if return_points
                                     else '')
        key = (f'{config} return_points frame' if return_points
               else f'{config} frame')
        per = ({'fused_field_fwd_f32': 2, 'fused_template_fwd_f32': 2}
               if return_points else F32_SCREW_CHUNK['level'])
        secs, counts[key] = time_frames(
            ImageRenderer(model, chunk=CHUNK, keep=k, levels=('fine',),
                          quantize=True), frames, k,
            {n: v * chunks_per_frame for n, v in per.items()},
            f'{label} float32', point_ch=11)
        annealed = ', fully annealed' if 'anneal' in config else ''
        phase(f'[37] {label} float32: {secs:.3f} s/frame ({W}x{H}, 64+64, '
              f'chunk {CHUNK}{annealed}); launches {counts[key]}; no plain '
              f'call; {CARD}')
        if config == 'plane_anneal_se3':
            small = torch.as_tensor(frames[0][::186][:1024]).cuda()
            with torch.no_grad():
                got = model(prepare_ray_dict(small))['fine']['rgb']
                with plain_versions():
                    want = model(prepare_ray_dict(small))['fine']['rgb']
            errs = grad_errors(got, want)
            phase(f'[37] {config} float32 render of 1024 rays, kernels vs '
                  f'plain: fine rgb relative L2 {errs[0]:.3e}, max|d| '
                  f'{errs[2]:.3e} (tol {F32_OUT_L2} / {F32_OUT_MAX} of the '
                  f'largest entry)')
            if not torch.isfinite(got).all() or errs[0] > F32_OUT_L2 \
                    or errs[1] > F32_OUT_MAX:
                raise AssertionError(f'{config} float32 render: kernels and '
                                     f'plain versions disagree')
        del model
        torch.cuda.empty_cache()
    for path in ('plane_f32', 'plane_anneal_se3_f32'):
        times = {}
        counts[f'{path} train'] = train_path(path, '[37]', times,
                                             F32_STEP_TOLS)
        TIMES[f'{path}_step'] = times
        flagship = TIMES.get('f32', {}).get('step', {}).get('secs',
                                                            float('nan'))
        phase(f'[37] {path} 64 + 128 step: {times["secs"] * 1e3:.1f} '
              f'ms/step, peak {times["peak"]:.2f} GiB; the flagship\'s at '
              f'float32 (phase 33) {flagship * 1e3:.1f} ms/step; {CARD}')
        torch.cuda.empty_cache()
    counts['plane query_sigma'] = query_sigma_path(
        'plane', {'fused_field_fwd_f32': 1, 'fused_template_fwd_f32': 1},
        '[37]', **F32)
    torch.cuda.empty_cache()
    return counts


def precision32_plane_phase(kernels) -> list:
    """Phase 37: the plane tables at ``--precision 32`` (ROADMAP A.13.1
    sub-item 3, second half): TF32 off; (a) rows 1, 5, 8 and 9 at table
    codes 3 to 8 against their plain versions, timed in turns with the
    flagship table's, and against the stored JAX numbers; (b) ``plane`` and
    ``plane_anneal_se3`` frames and a ``return_points`` frame; (c) their 64
    + 128 train steps and ``query_sigma``, every path's launches counted
    with no plain call; (d) ``train.main --precision 32 --slice_method
    axis_aligned_plane --use_nerfies_embed --warp_field se3`` and ``eval``
    of its checkpoint. Returns the four entries of the line."""
    import torch
    from hypernerf_tpu_torch.flagship import (anneal_extra_params,
                                              flagship_model,
                                              load_probe_weights)
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    extra = anneal_extra_params()
    models = {c: load_probe_weights(flagship_model('cuda', config=c,
                                                   **F32_FINE128))
              for c in ('flagship', *F32_PLANE_CONFIGS)}
    rows = f32_plane_kernels(models, extra)
    del models
    torch.cuda.empty_cache()
    f32_plane_reference()
    counts = f32_plane_paths()
    cli = f32_train_eval('[37]', 'f32_plane_anneal_se3', F32_PLANE_CLI_FLAGS,
                         dict(hyper_slice_method='axis_aligned_plane',
                              warp_field_type='se3',
                              use_original_embed=False))
    main_key = {'fused_level_fwd_f32_plane': f'plane_R{TRAIN_RAYS}_S128',
                'fused_fields_bwd_f32_plane': f'plane_R{TRAIN_RAYS}_S128',
                'fused_template_fwd_f32_plane': 'plane_R8192_S128',
                'fused_template_bwd_f32_plane': f'plane_R{TRAIN_RAYS}_S128'}
    paths = {**counts, **{f'cli {k}': v for k, v in cli.items()}}
    out = []
    for name, (source, replaces, counter, path) in F32_PLANE_ROWS.items():
        main = rows[name][main_key[name]]
        entry = dict(name=name, route='cuda', source=source,
                     replaces=replaces, launches=counts[path][counter],
                     max_abs_err=max(v[3] for v in rows[name].values()),
                     ms=main[0], plain_ms=main[1], bound_ms=main[2][0],
                     bound_by=main[2][1], library_ms=None,
                     ffma_ceiling_ms=main[2][2], dtype='float32',
                     shape=main_key[name],
                     flagship_ms_in_turns=main[4][1:3],
                     tolerance=f'relative L2 <= {F32_SCREW_L2}, max|d| <= '
                               f'{F32_SCREW_MAX} of the largest entry',
                     launches_by_path={p: c[counter] for p, c in
                                       paths.items() if c.get(counter)})
        for key, v in rows[name].items():
            if key != main_key[name]:
                entry.update({f'ms_{key}': v[0], f'plain_ms_{key}': v[1],
                              f'bound_ms_{key}': v[2][0],
                              f'flagship_ms_in_turns_{key}': v[4][1:3]})
        out.append(entry)
    phase(f'[37] the plane-table --precision 32 phase took '
          f'{time.perf_counter() - t_phase:.1f} s; {CARD}')
    return out


# -- the Jacobians at --precision 32 (A.13.1 sub-item 4, phase 38) ----------

# name -> (its sources, the TPU kernel it replaces at float32, the path
# whose launches the line reports): rows 14 to 17 in float32, the elastic
# loss's Jacobians; each counts its launches under its own name.
F32_JAC_ROWS = {
    'fused_jacobian_fwd_f32': (
        CSRC_DIR + 'f32_tangents.cu, ' + CSRC_DIR + 'f32_chain.cuh',
        'hypernerf_tpu/ops/pallas/fused_jacobian.py:269', 'elastic_f32'),
    'fused_jacobian_bwd_f32': (
        CSRC_DIR + 'f32_tangents.cu, ' + CSRC_DIR + 'f32_steps.cu',
        'hypernerf_tpu/ops/pallas/fused_jacobian.py:302', 'elastic_f32'),
    'fused_se3_jacobian_fwd_f32': (
        CSRC_DIR + 'f32_tangents.cu, ' + CSRC_DIR + 'f32_chain.cuh',
        'hypernerf_tpu/ops/pallas/fused_se3_jacobian.py:286',
        'elastic_se3_f32'),
    'fused_se3_jacobian_bwd_f32': (
        CSRC_DIR + 'f32_tangents.cu, ' + CSRC_DIR + 'f32_steps.cu',
        'hypernerf_tpu/ops/pallas/fused_se3_jacobian.py:331',
        'elastic_se3_f32')}
# Each one's row in the table of TPU kernels (PERF.md section 6).
ROW_OF = {'fused_jacobian_fwd_f32': 14, 'fused_jacobian_bwd_f32': 15,
          'fused_se3_jacobian_fwd_f32': 16, 'fused_se3_jacobian_bwd_f32': 17}
PATHS.update(elastic_f32=('elastic', F32_FINE128),
             elastic_se3_f32=('elastic_se3', F32_FINE128),
             elastic_quaternion_f32=('elastic_quaternion', F32_FINE128))
STEP_LAUNCHES['elastic_f32'] = {**STEP_LAUNCHES['flagship_f32'],
                                'fused_jacobian_fwd_f32': 2,
                                'fused_jacobian_bwd_f32': 2}
STEP_LAUNCHES['elastic_se3_f32'] = {**STEP_LAUNCHES['flagship_f32'],
                                    'fused_se3_jacobian_fwd_f32': 2,
                                    'fused_se3_jacobian_bwd_f32': 2}
STEP_LAUNCHES['elastic_quaternion_f32'] = STEP_LAUNCHES['elastic_se3_f32']
STEP_LAUNCHES['elastic_se3_nerfies_f32'] = STEP_LAUNCHES['elastic_se3_f32']
# Kernel vs plain, both float32 on the card with TF32 off: rows 14 to 17
# per output within phase 35's relative L2 1e-4 and max|d| 1e-3 of the
# largest entry (F32_SCREW_L2 / F32_SCREW_MAX). Against
# tests/data/fused_f32_jacobian_jax_ref.npz: every output and gradient
# relative L2 F32_JAC_REF_L2, the CPU test's bound for the plain versions
# (tests/test_torch_precision32_jacobian.py; measured there 4.1e-7).
F32_JAC_REF_L2 = 1e-4
F32_JAC_CLI_FLAGS = ('--elastic_loss_weight', '0.01',
                     '--elastic_jacobian_samples', '16', '--warp_field',
                     'se3', '--use_nerfies_embed')


def f32_jacobian_kernels(models) -> dict:
    """Phase 38 (a): rows 14 to 17 at float32 against their plain versions
    (TF32 off, the same inputs and cotangents; F32_SCREW_L2 / F32_SCREW_MAX
    per output) at 1001 points (a multiple of no tile) and at JAC_POINTS,
    rows 16 and 17 with the trunk's window row off and on; timed at
    JAC_POINTS (the plain versions in chunks of JAC_CHUNK points). Returns
    {name: {key: (ms, plain ms, bound, max|d|)}}."""
    import torch
    from hypernerf_tpu_torch.kernels.fused_se3 import se3_encoding_scales
    rows = {name: {} for name in F32_JAC_ROWS}
    tol = (F32_SCREW_L2, F32_SCREW_MAX)
    field = models['elastic_se3'].warp_field
    gen = torch.Generator(device='cuda').manual_seed(38)
    runs = {
        'fused_jacobian': (
            *jacobian_runs(models['elastic'].warp_field, True), (None,)),
        'fused_se3_jacobian': (
            *jacobian_runs(field, False),
            (None, se3_encoding_scales(field, WINDOW_ALPHA, 'cuda')))}

    def check(label, got, want):
        errs = [grad_errors(a, b) for a, b in zip(got, want)]
        worst = tuple(max(e[i] for e in errs) for i in range(3))
        if worst[0] > tol[0] or worst[1] > tol[1]:
            raise AssertionError(f'{label}: the kernel disagrees with plain: '
                                 f'{worst}')
        return worst

    with torch.no_grad():
        for stem, (fwd, bwd, plain, plain_bwd, layers, width, nz,
                   windows) in runs.items():
            trunk = stem != 'fused_jacobian'
            for p in (1001, JAC_POINTS):
                x = field_rows(p, seed=38 + p % 97)
                g = torch.randn(p, width, generator=gen, device='cuda')
                for sc in windows:
                    window = 'off' if sc is None else 'on'
                    key = f'P{p}' + (f'_window_{window}' if trunk else '')
                    e_f = check(f'{stem} forward {key}', [fwd(x, sc)],
                                [plain(x, sc)])
                    dx, grads = bwd(x, g, sc)
                    e_b = check(f'{stem} backward {key}', [dx, *grads],
                                plain_bwd(x, g, sc))
                    del dx, grads
                    t = {}
                    if p == JAC_POINTS:
                        t = dict(fwd=cuda_ms(lambda: fwd(x, sc), 5),
                                 plain_fwd=cuda_ms(lambda: plain(x, sc), 2),
                                 bwd=cuda_ms(lambda: bwd(x, g, sc), 3),
                                 plain_bwd=cuda_ms(
                                     lambda: plain_bwd(x, g, sc), 1))
                    for half, errs in (('fwd', e_f), ('bwd', e_b)):
                        name = f'{stem}_{half}_f32'
                        b = jacobian_bound(layers, p, width, half == 'bwd',
                                           trunk, nz, f32_bound, 4)
                        ms = t.get(half, float('nan'))
                        plain_ms = t.get(f'plain_{half}', float('nan'))
                        rows[name][key] = (ms, plain_ms, b, errs[2])
                        timed = (f'; kernel {ms:.3f} ms, plain '
                                 f'{plain_ms:.3f} ms; bound {b[0]:.3f} ms '
                                 f'({b[1]}, {b[0] / ms:.1%}), FFMA ceiling '
                                 f'{b[2]:.3f} ms ({b[2] / ms:.1%}); {CARD}'
                                 if t else '')
                        phase(f'[38] row {ROW_OF[name]} float32 {key}: worst '
                              f'relative L2 {errs[0]:.3e}, max|d| '
                              f'{errs[1]:.3e} of the largest entry (tol '
                              f'{tol[0]} / {tol[1]}){timed}')
                del x, g
                torch.cuda.empty_cache()
    return rows


def f32_jacobian_reference() -> None:
    """Phase 38 (b): rows 14 to 17 through their autograd Functions, as
    training runs them, against the JAX kernels' stored float32 numbers
    (tests/data/fused_f32_jacobian_jax_ref.npz): the output, dx and every
    dW / db, and for the trunk the side channel's J of both retractions
    from the kernel's tangents; relative L2 F32_JAC_REF_L2 each."""
    import torch
    from hypernerf_tpu_torch import kernels as K
    from hypernerf_tpu_torch.flagship import (F32_JACOBIAN_CASES,
                                              F32_JACOBIAN_REFERENCE,
                                              f32_jacobian_model,
                                              read_jacobian_reference)
    from hypernerf_tpu_torch.kernels import common
    from hypernerf_tpu_torch.kernels.fused_field import field_layers
    from hypernerf_tpu_torch.kernels.fused_se3 import (se3_encoding_scales,
                                                       se3_layers)
    from hypernerf_tpu_torch.ops import quaternion, rigid_body
    worst = {}
    for case, arrays in read_jacobian_reference(
            F32_JACOBIAN_REFERENCE, F32_JACOBIAN_CASES).items():
        config, _, alpha, _ = F32_JACOBIAN_CASES[case]
        field = f32_jacobian_model(case, 'cuda').warp_field
        cuda = {k: torch.from_numpy(v).cuda() for k, v in arrays.items()}
        x = cuda['x_raw'].requires_grad_()
        if config == 'flagship':
            layers = field_layers(field.mlp)
            out = K.fused_warp_jacobian(field.mlp, 10, x[:, :3],
                                        x[:, 3:]).reshape(-1, 9)
            jacs = {}
        else:
            layers = se3_layers(field)
            scales = (None if alpha is None else
                      se3_encoding_scales(field, alpha, 'cuda'))
            out = tangents_of(field, x, scales)
            p = out.shape[0]
            with torch.no_grad():
                w, v, dw, dv = (out[:, :3], out[:, 3:6],
                                out[:, 6:15].reshape(p, 3, 3),
                                out[:, 15:].reshape(p, 3, 3))
                jacs = {f'jac_{kind}': rigid_body.retraction_jacobian(
                    bwd, w, v, x[:, :3].detach(), dw, dv).reshape(p, 9)
                    for kind, bwd in (('se3', rigid_body.se3_warp_vec_bwd),
                                      ('quaternion',
                                       quaternion.quat_warp_vec_bwd))}
        params = common.layer_params(layers)
        got = torch.autograd.grad(out, [x] + params, cuda['cotangent'])
        names = ['dx'] + [f'd{"wb"[i % 2]}{i // 2}' for i in
                          range(len(params))]
        got = dict(zip(names, got), out=out.detach(), **jacs)
        errs = {k: grad_errors(v.double(), cuda[k].double())[0]
                for k, v in got.items()}
        name = max(errs, key=errs.get)
        worst[case] = (errs[name], name)
        if errs[name] > F32_JAC_REF_L2:
            raise AssertionError(f'{case} float32 against the stored JAX '
                                 f'numbers: {name} {errs[name]:.3e}')
        del field, cuda, x, out, got
    torch.cuda.empty_cache()
    phase('[38] rows 14 to 17 against the stored JAX float32 numbers, '
          'through the autograd Functions (output, dx, every dW / db, J of '
          'both retractions): worst relative L2 ' + ', '.join(
              f'{c} {e:.3e} at {n}' for c, (e, n) in worst.items())
          + f' (tol {F32_JAC_REF_L2})')


def f32_jacobian_paths() -> dict:
    """Phase 38 (c): the 64 + 128 train steps of ``elastic``,
    ``elastic_se3``, ``elastic_quaternion`` and ``elastic_se3`` with the
    Nerfies encoding from ANNEAL_PROBE_STEP (its trunk's and template's
    window rows live) at batch 16384, elastic weight 0.01, K = 16, each
    with its launches counted (two of each Jacobian kernel a step), no
    plain call, and a 1024-ray step against the plain versions (loss 1e-5
    relative, gradients relative L2 1e-2: F32_STEP_TOLS). Returns {path:
    launches}."""
    import torch
    from hypernerf_tpu_torch.flagship import ANNEAL_PROBE_STEP
    # The Nerfies paper's setting: the elastic loss on the SE(3) warp with
    # the annealed encoding, from the step where its window rows are live.
    PATHS['elastic_se3_nerfies_f32'] = ('elastic_se3', dict(
        use_original_embed=False, start_step=ANNEAL_PROBE_STEP,
        **F32_FINE128))
    counts = {}
    for path in ('elastic_f32', 'elastic_se3_f32', 'elastic_quaternion_f32',
                 'elastic_se3_nerfies_f32'):
        times = {}
        counts[path] = train_path(path, '[38]', times, F32_STEP_TOLS)
        TIMES[f'{path}_step'] = times
        flagship = TIMES.get('f32', {}).get('step', {}).get('secs',
                                                            float('nan'))
        phase(f'[38] {path} 64 + 128 step: {times["secs"] * 1e3:.1f} '
              f'ms/step, peak {times["peak"]:.2f} GiB; the flagship\'s at '
              f'float32 (phase 33) {flagship * 1e3:.1f} ms/step; {CARD}')
        torch.cuda.empty_cache()
    return counts


def precision32_jacobian_phase(kernels) -> list:
    """Phase 38: the Jacobians at ``--precision 32`` (ROADMAP A.13.1
    sub-item 4): TF32 off; (a) rows 14 to 17 against their plain versions,
    timed; (b) against the stored JAX numbers; (c) the elastic train steps
    with their launches, then ``train.main --precision 32
    --elastic_loss_weight 0.01 --elastic_jacobian_samples 16 --warp_field
    se3 --use_nerfies_embed`` and ``eval`` of its checkpoint. Returns the
    four entries of the line."""
    import torch
    from hypernerf_tpu_torch.flagship import flagship_model, load_probe_weights
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    models = {c: load_probe_weights(flagship_model('cuda', config=c, **F32))
              for c in ('elastic', 'elastic_se3')}
    rows = f32_jacobian_kernels(models)
    del models
    torch.cuda.empty_cache()
    f32_jacobian_reference()
    counts = f32_jacobian_paths()
    cli = f32_train_eval(
        '[38]', 'f32_elastic_se3', F32_JAC_CLI_FLAGS,
        dict(warp_field_type='se3', use_original_embed=False,
             elastic_jacobian_samples=16),
        per_step=STEP_LAUNCHES['elastic_se3_f32'])
    paths = {**counts, **{f'cli {k}': v for k, v in cli.items()}}
    out = []
    for name, (source, replaces, path) in F32_JAC_ROWS.items():
        key = f'P{JAC_POINTS}' + ('_window_off' if 'se3' in name else '')
        main = rows[name][key]
        entry = dict(name=name, route='cuda', source=source,
                     replaces=replaces, launches=counts[path][name],
                     max_abs_err=max(v[3] for v in rows[name].values()),
                     ms=main[0], plain_ms=main[1], bound_ms=main[2][0],
                     bound_by=main[2][1], library_ms=None,
                     ffma_ceiling_ms=main[2][2], dtype='float32',
                     shape=key,
                     tolerance=f'relative L2 <= {F32_SCREW_L2}, max|d| <= '
                               f'{F32_SCREW_MAX} of the largest entry',
                     launches_by_path={p: c[name] for p, c in paths.items()
                                       if c.get(name)})
        for k, v in rows[name].items():
            if k != key and not math.isnan(v[0]):
                entry.update({f'ms_{k}': v[0], f'plain_ms_{k}': v[1],
                              f'bound_ms_{k}': v[2][0]})
        out.append(entry)
    phase(f'[38] the Jacobian --precision 32 phase took '
          f'{time.perf_counter() - t_phase:.1f} s; {CARD}')
    return out


def finish(kernels) -> int:
    """Phase 24: the kernels' line and the result line."""
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
