#!/usr/bin/env python
"""Write the JAX kernels' outputs and gradients for the flagship at the probe
weights, the references against which ``chip_smoke.py`` holds the CUDA
kernels on a card that has no JAX.

  python tools/make_level_reference.py \
      [--out tests/data/fused_level_jax_ref.npz] \
      [--grads_out tests/data/fused_jax_grads.npz] \
      [--modular_out tests/data/fused_modular_jax_ref.npz] \
      [--se3_out tests/data/fused_se3_jax_ref.npz] \
      [--jacobian_out tests/data/fused_jacobian_jax_ref.npz] \
      [--anneal_out tests/data/fused_anneal_jax_ref.npz] \
      [--plane_out tests/data/fused_plane_jax_ref.npz] \
      [--conditions_out tests/data/fused_conditions_jax_ref.npz] \
      [--b4_out tests/data/fused_b4_jax_ref.npz] \
      [--f32_out tests/data/fused_f32_jax_ref.npz] \
      [--f32_modular_out tests/data/fused_f32_modular_jax_ref.npz] \
      [--f32_screw_out tests/data/fused_f32_screw_jax_ref.npz] \
      [--f32_nerfies_out tests/data/fused_f32_nerfies_jax_ref.npz] \
      [--f32_plane_out tests/data/fused_f32_plane_jax_ref.npz] \
      [--f32_jacobian_out tests/data/fused_f32_jacobian_jax_ref.npz] \
      [--only se3|jacobian|anneal|plane|conditions|b4|f32|f32_modular|
              f32_screw|f32_nerfies|f32_plane|f32_jacobian]

The weights are ``hypernerf_tpu_torch.flagship.load_probe_weights`` (numpy,
seed 0), which the card redraws bit for bit; the inputs
(``flagship.probe_inputs``, ``flagship.composite_probe_inputs``) are stored
in the files beside the outputs. The outputs come from ``hypernerf_tpu``'s
``fused_level`` (the TPU kernel) in Pallas interpret mode on the CPU, in
bf16 as the flagship runs. The gradients file holds, for a fixed numpy
cotangent, the gradients of the level kernel (its default pipelined backward
schedule: every ray input, and dW / db of all 30 layers) and of the
compositing kernel (``_fused_bwd``, with noise), also in interpret mode.
``tests/test_torch_fused_level.py`` recomputes both files and checks them.
The modular file holds the same for a module alone
(``flagship.MODULAR_REFERENCE_CASES``): ``fused_field_mlp`` on the warp field
and on the hyper sheet, with and without a window row, and ``fused_nerf_mlp``
with its in-kernel encoding on [xyz | hyper], on xyz alone (the static
template) and with one condition row per sample; outputs, and for the stored
cotangent the input gradients and dW / db of every layer.
``tests/test_torch_fused_field.py`` and ``tests/test_torch_fused_mlp.py``
recompute and check it.
The SE(3) file holds the SE(3) kernels' numbers at the probe weights of the
``se3`` and ``quaternion`` configurations (``flagship.SE3_TRUNK_CASES``,
``flagship.SE3_LEVEL_CASES``): ``fused_se3_wv`` (the trunk alone: [w | v],
and for the stored cotangent dx and dW / db of its nine layers), with and
without the ``warp_alpha`` window, and the level kernel with the SE(3) and the
quaternion warp (outputs, and the gradients of every ray input and of all 32
layers). ``tests/test_torch_fused_se3.py`` and
``tests/test_torch_fused_level.py`` recompute and check it. ``--only se3``
writes that file alone.
The Jacobian file holds the warp-Jacobian kernels' numbers at the probe
weights (``flagship.JACOBIAN_CASES``): ``fused_warp_jacobian`` on the
flagship's warp field (J, and for the stored cotangent dx and dW / db of its
seven layers) and ``fused_se3_wv_tangents`` on the ``se3`` configuration's
trunk, with and without the ``warp_alpha`` window ([w | v | dw | dv], dx and
dW / db of its nine layers, and J of the SE(3) and of the quaternion warp
through the side channel's retraction JVP, ``fused_se3_warp_jacobian``). ``tests/test_torch_fused_jacobian.py``
recomputes and checks it. ``--only jacobian`` writes that file alone.
The anneal file holds the numbers of the ``anneal`` configuration (the
Nerfies template encoding) at its probe weights and at the annealing alphas
of ``flagship.ANNEAL_PROBE_STEP`` (hyper_alpha 1.5 of 4 bands): the level
kernel with its template window row (``flagship.ANNEAL_LEVEL_CASES``:
outputs, and for the stored cotangent the gradients of every ray input and
of all 30 layers) and ``fused_nerf_mlp`` with its windowed in-kernel
encoding (``flagship.ANNEAL_TEMPLATE_CASES``: outputs, dx, d rgb_cond and
dW / db of its 16 layers). ``tests/test_torch_anneal.py`` recomputes and
checks it. ``--only anneal`` writes that file alone.
The plane file holds the numbers of the ``plane`` configuration
(axis_aligned_plane: no sheet, the GLO embedding as the hyper coordinates,
a 167-column template encoding) at its probe weights: the level kernel
(``flagship.PLANE_LEVEL_CASES``: outputs, and for the stored cotangent the
gradients of every ray input and of all 23 layers) and ``fused_nerf_mlp``
with ``in_ch`` 167 (``flagship.PLANE_TEMPLATE_CASES``: outputs, dx, d
rgb_cond and dW / db of its 16 layers), in bf16, and the first level case
again in float32 (``flagship.PLANE_F32_CASES``).
``tests/test_torch_plane.py`` recomputes and checks it. ``--only plane``
writes that file alone.
The conditions file holds the numbers of the ``nerf_embed`` configuration
(the ``use_nerf_embed`` alpha and rgb conditions) at its probe weights: the
level kernel with ``alpha_cond_ch`` 8 and a 47-column rgb condition
(``flagship.CONDITION_LEVEL_CASES``) and ``fused_nerf_mlp`` with both
conditions (``flagship.CONDITION_TEMPLATE_CASES``): outputs, and for the
stored cotangent the gradients of every input and of the layers in
``flagship.CONDITION_GRAD_LAYERS`` and every bias, in bf16.
``tests/test_torch_conditions.py`` recomputes and checks it. ``--only
conditions`` writes that file alone.
The B.4 file holds the numbers of the warp x slicing x encoding
combinations at their probe weights: the level kernel of ``anneal_se3``,
``plane_se3``, ``plane_anneal_se3`` and ``plane_quaternion``
(``flagship.B4_LEVEL_CASES``, at ``flagship.b4_extra_params``' alphas:
outputs, and for the stored cotangent the gradients of every ray input,
every bias and the weights of ``flagship.b4_grad_layers``) and
``fused_nerf_mlp`` in the Nerfies plane layout (8 hyper coordinates over
degrees 0..4, ``flagship.B4_TEMPLATE_CASES``), in bf16.
``tests/test_torch_b4.py`` recomputes and checks it. ``--only b4`` writes
that file alone (about a minute).
The float32 file holds the level kernel of the flagship at
``compute_dtype='float32'`` (the train CLI's ``--precision 32``) at the
probe weights (``flagship.F32_LEVEL_CASES``: 64 rays x 128 samples, full
width): outputs, and for the stored cotangent the gradients of every ray
input, every bias and the weights of ``flagship.F32_GRAD_LAYERS``.
``tests/test_torch_precision32.py`` recomputes it for a few rays and holds
the plain float32 level to it. ``--only f32`` writes that file alone.
The float32 per-module file holds the JAX field and template kernels
(``fused_field_mlp``, ``fused_nerf_mlp``) at ``compute_dtype='float32'`` at
the probe weights (``flagship.F32_MODULAR_CASES``: the warp field and the
sheet on 300 rows, the flagship template at 4 x 64 and 100 x 1 rows, the
static template at 4 x 64, full width): outputs, and for the stored
cotangent the gradients of the raw rows, the condition, every bias and
the weights of every field layer and of
``flagship.F32_MODULAR_TEMPLATE_DW``'s template layers.
``tests/test_torch_precision32_modular.py`` recomputes its sheet case and
holds the plain float32 versions to it; ``chip_smoke.py`` phase 34 holds
rows 8, 10, 11 and kernel A at the static width to it. ``--only
f32_modular`` writes that file alone (about 40 s).
The float32 screw-warp file holds the JAX level kernel with the SE(3) and
the quaternion warp and the JAX SE(3) trunk kernel at
``compute_dtype='float32'`` (``flagship.F32_SCREW_LEVEL_CASES``: an
``se3`` level with a window row, a ``quaternion`` level, an ``se3`` level
whose heads are redrawn at the init's scale, small rotation vectors;
``F32_SCREW_TRUNK_CASES``: the trunk on 500 rows without and with a window
row; full width): outputs, and for the stored cotangent the gradients of
the inputs, every bias and the weights of ``F32_SCREW_GRAD_LAYERS`` (a
level) or ``F32_SCREW_TRUNK_DW`` (the trunk).
``tests/test_torch_precision32_screw.py`` recomputes one case and holds
the plain float32 versions to it; ``chip_smoke.py`` phase 35 holds rows
1, 5, 12 and 13 to it. ``--only f32_screw`` writes that file alone.
The float32 Nerfies-layout file holds the JAX level kernel, template kernel
and field kernel at ``compute_dtype='float32'`` on the sheet tables' other
layouts and conditions (``flagship.F32_NERFIES_LEVEL_CASES``: ``anneal``,
``anneal_se3``, ``nerf_embed``, its 8-column condition without view
directions; ``F32_NERFIES_TEMPLATE_CASES``:
the Nerfies template with a 27-column condition and with 35 + the alpha
condition, the posenc_orig one with 47 + the alpha condition;
``F32_NERFIES_FIELD_CASES``: the warp field and the sheet with a window
row), at the alphas of ``flagship.ANNEAL_PROBE_STEP``, full width:
outputs, and for the stored cotangent the gradients of the inputs, every
bias and the weights of ``f32_nerfies_grad_layers``.
``tests/test_torch_precision32_nerfies.py`` recomputes one case and holds
the plain float32 versions to it; ``chip_smoke.py`` phase 36 holds rows
1, 8, 9, 10 and 11 to it. ``--only f32_nerfies`` writes that file alone.

``tests/data/fused_f32_plane_jax_ref.npz`` holds the JAX level and
template kernels at ``compute_dtype='float32'`` on the plane tables
(``flagship.F32_PLANE_LEVEL_CASES``: the level's outputs at table codes 3
to 8 and its gradients at codes 3 and 6; ``F32_PLANE_TEMPLATE_CASES``: the
template alone in each plane layout, outputs and gradients), at the alphas
of ``flagship.ANNEAL_PROBE_STEP``, full width: dW of
``f32_plane_grad_layers`` and every bias.
``tests/test_torch_precision32_plane.py`` recomputes one case and holds
the plain float32 versions to it; ``chip_smoke.py`` phase 37 holds rows
1, 5, 8 and 9 to it. ``--only f32_plane`` writes that file alone.

``tests/data/fused_f32_jacobian_jax_ref.npz`` holds the JAX Jacobian
kernels (``fused_warp_jacobian``, ``fused_se3_wv_tangents``) at
``compute_dtype='float32'`` on ``flagship.F32_JACOBIAN_CASES`` (the
translation warp, the SE(3) trunk without and with its window row, 300
rows each, full width): outputs, and for the stored cotangent 'dx', every
dW / db and the side channel's J of both retractions.
``tests/test_torch_precision32_jacobian.py`` recomputes it and holds the
plain float32 versions to it; ``chip_smoke.py`` phase 38 holds rows 14 to
17 to it. ``--only f32_jacobian`` writes that file alone.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def probe_model():
    from hypernerf_tpu_torch.flagship import flagship_model, load_probe_weights
    return load_probe_weights(flagship_model('cpu'))


def _jax_level_fn(model, level: str, inputs, warp_alpha=None,
                  tmpl_alphas=(None, None), **spec_kw):
    """(fn, args): ``fn(*args)`` is the JAX level kernel's packed output
    with the weights of ``model``'s ``level``; args are the five ray inputs
    in ``LEVEL_INPUTS`` order (and 'alpha_cond' where ``inputs`` has one:
    the alpha condition), then the warp, hyper and template (W, b) pair
    lists. The warp type and the template encoding are the model's;
    ``warp_alpha`` windows the SE(3) / quaternion trunk's encoding (None: a
    row of ones, as the JAX model threads it), ``tmpl_alphas`` (nerf_alpha,
    hyper_alpha) the Nerfies template encoding's bands. ``spec_kw``
    overrides fields of the spec (the backward schedule)."""
    import jax.numpy as jnp

    from hypernerf_tpu.ops.pallas.fused_field import (encoding_scales,
                                                      mlp_params_to_list)
    from hypernerf_tpu.ops.pallas.fused_se3 import se3_params_to_list
    from hypernerf_tpu.ops.pallas.fused_level import (FusedLevelSpec,
                                                      fused_level)
    from hypernerf_tpu.ops.pallas.fused_mlp import nerf_mlp_params_to_list
    from hypernerf_tpu_torch.convert import params_to_jax
    from hypernerf_tpu_torch.flagship import LEVEL_INPUTS

    params = params_to_jax(model.state_dict())
    cfg = model.config
    r, s = inputs['z_vals'].shape
    screw = cfg.warp_field_type != 'translation'
    plane = cfg.hyper_slice_method == 'axis_aligned_plane'
    spec = FusedLevelSpec(
        embed_ch=cfg.glo_dim, warp_type=cfg.warp_field_type,
        se3_min_deg=cfg.warp_min_deg, se3_max_deg=cfg.warp_max_deg,
        warp_windowed=screw, warp_depth=cfg.warp_depth,
        warp_width=cfg.warp_width, warp_freq=cfg.warp_freq,
        hyper_depth=cfg.hyper_sheet_depth, hyper_width=cfg.hyper_sheet_width,
        hyper_sheet_freq=cfg.hyper_sheet_freq,
        slice_method=cfg.hyper_slice_method,
        hyper_out=cfg.glo_dim if plane else cfg.hyper_slice_out_dim,
        xyz_freq=cfg.xyz_freq,
        hyper_freq=cfg.hyper_freq,
        use_original_embed=cfg.use_original_embed,
        spatial_min_deg=cfg.spatial_point_min_deg,
        spatial_max_deg=cfg.spatial_point_max_deg,
        hyper_min_deg=cfg.hyper_point_min_deg,
        hyper_max_deg=cfg.hyper_point_max_deg, trunk_depth=cfg.trunk_depth,
        trunk_width=cfg.trunk_width, rgb_depth=cfg.rgb_branch_depth,
        rgb_width=cfg.rgb_branch_width,
        rgb_cond_ch=inputs['rgb_cond'].shape[1],
        alpha_cond_ch=(inputs['alpha_cond'].shape[1] if 'alpha_cond' in inputs
                       else 0),
        skips=tuple(cfg.skips), tile=512, bwd_tile=256, interpret=True,
        compute_dtype=cfg.compute_dtype, cond_samples=s,
        pipelined_bwd=cfg.pallas_pipelined_bwd)._replace(**spec_kw)
    warp_scales = tmpl_scales = None
    if screw:
        warp_scales = encoding_scales(
            spec.warp_fs.enc_segments,
            [None if warp_alpha is None else jnp.float32(warp_alpha), None])
    if not cfg.use_original_embed:
        tmpl_scales = encoding_scales(
            spec.tmpl_enc_segments,
            [None if a is None else jnp.float32(a) for a in tmpl_alphas])

    def fn(z_vals, origins, directions, embed, rgb_cond, *rest):
        alpha_cond = rest[0] if spec.alpha_cond_ch else None
        warp, hyper, tmpl = rest[-3:]
        return fused_level(spec, None, embed, rgb_cond, alpha_cond, warp,
                           hyper, tmpl, tmpl_enc_scales=tmpl_scales,
                           warp_enc_scales=warp_scales,
                           origins=origins, directions=directions,
                           z_vals=z_vals, return_packed=True)[:, :4]

    as_jnp = lambda pairs: [(jnp.asarray(w), jnp.asarray(b))
                            for w, b in pairs]
    names = LEVEL_INPUTS + (('alpha_cond',) if spec.alpha_cond_ch else ())
    args = [jnp.asarray(inputs[k]) for k in names] + [
        as_jnp(se3_params_to_list(params['warp_field']) if screw else
               mlp_params_to_list(params['warp_field']['mlp'])),
        [] if plane else
        as_jnp(mlp_params_to_list(params['hyper_sheet_mlp']['mlp'])),
        as_jnp(nerf_mlp_params_to_list(params[f'nerf_{level}']))]
    return fn, args


def jax_level(model, level: str, inputs, warp_alpha=None,
              tmpl_alphas=(None, None)) -> 'np.ndarray':
    """(R * S, 4) [rgb logits | raw sigma] of the JAX level kernel with the
    weights of ``model``'s ``level`` ('coarse' or 'fine')."""
    import jax
    import numpy as np
    fn, args = _jax_level_fn(model, level, inputs, warp_alpha, tmpl_alphas)
    return np.asarray(jax.device_get(fn(*args)))


def jax_level_grads(model, level: str, inputs, cotangent, warp_alpha=None,
                    tmpl_alphas=(None, None), **spec_kw) -> dict:
    """Gradients of sum(level output * cotangent) through the JAX level
    kernel's own backward: {'d_<input>'} for the five ray inputs (and the
    alpha condition where ``inputs`` has one) and {'dw<l>', 'db<l>'} for
    the level's layers (30, 32 with the SE(3) / quaternion warp, 23 in the
    plane configuration) in kernel order, dW as (out, in)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    fn, args = _jax_level_fn(model, level, inputs, warp_alpha, tmpl_alphas,
                             **spec_kw)
    from hypernerf_tpu_torch.flagship import LEVEL_INPUTS

    def loss(*a):
        return jnp.sum(fn(*a) * jnp.asarray(cotangent))

    names = LEVEL_INPUTS + (('alpha_cond',) if 'alpha_cond' in inputs
                            else ())
    n_in = len(names)
    g = jax.device_get(jax.grad(loss, argnums=tuple(range(n_in + 3)))(
        *args))
    return _level_grads(names, g)


def _level_grads(names, g) -> dict:
    """{'d_<input>', 'dw<l>' as (out, in), 'db<l>'} of the cotangents ``g``
    of the ray inputs ``names`` and of the three (W, b) pair lists."""
    import numpy as np
    n_in = len(names)
    out = {f'd_{k}': np.asarray(v, np.float32)
           for k, v in zip(names, g[:n_in])}
    pairs = [p for group in g[n_in:] for p in group]
    for layer, (dw, db) in enumerate(pairs):
        out[f'dw{layer}'] = np.asarray(dw, np.float32).T.copy()
        out[f'db{layer}'] = np.asarray(db, np.float32)
    return out


def jax_level_vjp(model, level: str, inputs, cotangent, warp_alpha=None,
                  tmpl_alphas=(None, None)) -> dict:
    """``jax_level``'s output ('out') and ``jax_level_grads``' gradients from
    one jitted ``jax.vjp`` of the JAX level kernel (one compile, where eager
    dispatch of the interpret-mode kernel takes several times as long)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from hypernerf_tpu_torch.flagship import LEVEL_INPUTS
    fn, args = _jax_level_fn(model, level, inputs, warp_alpha, tmpl_alphas)

    def both(*a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(jnp.asarray(cotangent))

    out, g = jax.device_get(jax.jit(both)(*args))
    names = LEVEL_INPUTS + (('alpha_cond',) if 'alpha_cond' in inputs
                            else ())
    return {'out': np.asarray(out, np.float32), **_level_grads(names, g)}


def jax_composite_grads(inputs, cot_outs, cot_weights) -> dict:
    """Gradients of the JAX compositing kernel (``_fused_bwd``, interpret
    mode, sample at infinity, no white background) for the cotangents of
    [rgb | depth | med_depth | acc] (R, 6) and of the weights (R, S)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hypernerf_tpu.ops.pallas.fused_composite import (CompositeSpec,
                                                          fused_composite)
    r, s = inputs['z_vals'].shape
    spec = CompositeSpec(samples=s, rays_per_tile=8, has_noise=True,
                         interpret=True)

    def loss(packed, z_vals, directions, noise):
        pk8 = jnp.concatenate([packed, jnp.zeros_like(packed)], -1)
        out = fused_composite(spec, pk8, z_vals, directions, noise)
        outs = jnp.concatenate(
            [out['rgb'], out['depth'][:, None], out['med_depth'][:, None],
             out['acc'][:, None]], -1)
        return (jnp.sum(outs * jnp.asarray(cot_outs))
                + jnp.sum(out['weights'] * jnp.asarray(cot_weights)))

    names = ('packed', 'z_vals', 'directions', 'noise')
    g = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *[jnp.asarray(inputs[k]) for k in names])
    return {f'd_{k}': np.asarray(v, np.float32) for k, v in zip(names, g)}


def probe_models() -> dict:
    """The probe model of each configuration the modular cases name."""
    from hypernerf_tpu_torch.flagship import (MODULAR_REFERENCE_CASES,
                                              flagship_model,
                                              load_probe_weights)
    return {config: load_probe_weights(flagship_model('cpu', config=config))
            for config in {c[1] for c in MODULAR_REFERENCE_CASES.values()}}


def jax_modular(model, case: str, inputs, cases=None) -> dict:
    """The JAX kernel's numbers for one modular case (of
    ``MODULAR_REFERENCE_CASES``, or of ``cases``, a table of its form):
    'out', and for sum(out * cotangent) 'dx' (and 'd_rgb_cond' of a
    template), 'dw<l>' as (out, in) and 'db<l>' of every layer of the
    module in kernel order, at the model's compute dtype."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hypernerf_tpu.ops.pallas.fused_field import (FusedFieldSpec,
                                                      encoding_scales,
                                                      fused_field_mlp,
                                                      mlp_params_to_list)
    from hypernerf_tpu.ops.pallas.fused_mlp import (FusedMLPSpec,
                                                    fused_nerf_mlp,
                                                    nerf_mlp_params_to_list)
    from hypernerf_tpu_torch.convert import params_to_jax
    from hypernerf_tpu_torch.flagship import MODULAR_REFERENCE_CASES

    kind, _, module, rows, per, _ = (cases or MODULAR_REFERENCE_CASES)[case]
    cfg = model.config
    params = params_to_jax(model.state_dict())
    as_jnp = lambda pairs: [(jnp.asarray(w), jnp.asarray(b))
                            for w, b in pairs]
    cot = jnp.asarray(inputs['cotangent'])
    if kind == 'field':
        warp = module == 'warp_field'
        n_freq = cfg.warp_freq if warp else cfg.hyper_sheet_freq
        out_ch = 3 if warp else cfg.hyper_slice_out_dim
        spec = FusedFieldSpec(
            segments=((3, n_freq), (cfg.glo_dim, 0)),
            depth=cfg.warp_depth if warp else cfg.hyper_sheet_depth,
            width=cfg.warp_width if warp else cfg.hyper_sheet_width,
            out_ch=out_ch, skips=tuple(cfg.skips), tile=256, bwd_tile=128,
            compute_dtype=cfg.compute_dtype, windowed=per is not None,
            interpret=True)
        scales = None if per is None else encoding_scales(
            spec.segments, [jnp.float32(per), None])

        def fn(x_raw, pairs):
            return fused_field_mlp(spec, x_raw, pairs, enc_scales=scales)

        args = [jnp.asarray(inputs['x_raw']),
                as_jnp(mlp_params_to_list(params[module]['mlp']))]
        cot = cot[:, :out_ch]
    else:
        hyper = cfg.hyper_slice_out_dim if cfg.has_hyper else 0
        segments = ((3, cfg.xyz_freq),) + (
            ((hyper, cfg.hyper_freq),) if hyper else ())
        spec = FusedMLPSpec(
            in_ch=sum(c * (1 + 2 * f) for c, f in segments),
            trunk_depth=cfg.trunk_depth, trunk_width=cfg.trunk_width,
            rgb_depth=cfg.rgb_branch_depth, rgb_width=cfg.rgb_branch_width,
            skips=tuple(cfg.skips), rgb_cond_ch=inputs['rgb_cond'].shape[1],
            tile=256, bwd_tile=128, compute_dtype=cfg.compute_dtype,
            enc_segments=segments, cond_samples=per if per > 1 else 0,
            interpret=True)

        def fn(x_raw, rgb_cond, pairs):
            out = fused_nerf_mlp(spec, x_raw[:, :3 + hyper], rgb_cond, None,
                                 pairs)
            return jnp.concatenate([out['rgb'], out['alpha']], -1)

        args = [jnp.asarray(inputs['x_raw']), jnp.asarray(inputs['rgb_cond']),
                as_jnp(nerf_mlp_params_to_list(params[f'nerf_{module}']))]

    def loss(*a):
        return jnp.sum(fn(*a) * cot)

    g = jax.device_get(jax.grad(loss, argnums=tuple(range(len(args))))(*args))
    res = {'out': np.asarray(jax.device_get(fn(*args)), np.float32),
           'dx': np.asarray(g[0], np.float32)}
    if kind == 'template':
        res['d_rgb_cond'] = np.asarray(g[1], np.float32)
    for layer, (dw, db) in enumerate(g[-1]):
        res[f'dw{layer}'] = np.asarray(dw, np.float32).T.copy()
        res[f'db{layer}'] = np.asarray(db, np.float32)
    return res


def jax_se3_trunk(model, inputs, warp_alpha=None, **spec_kw) -> dict:
    """The JAX SE(3) trunk kernel's numbers (``fused_se3_wv``, interpret
    mode) on ``model``'s warp field: 'out' (P, 6) [w | v], and for
    sum(out * cotangent[:, :6]) 'dx', 'dw<l>' as (out, in) and 'db<l>' of the
    nine layers in kernel order."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hypernerf_tpu.ops.pallas.fused_field import encoding_scales
    from hypernerf_tpu.ops.pallas.fused_se3 import (FusedSE3Spec,
                                                    fused_se3_wv,
                                                    se3_params_to_list)
    from hypernerf_tpu_torch.convert import params_to_jax

    cfg = model.config
    field = model.warp_field
    params = params_to_jax(field.state_dict())
    spec = FusedSE3Spec(
        embed_ch=field.embed_ch, use_metadata=field.use_metadata,
        min_deg=field.min_deg, max_deg=field.max_deg,
        depth=field.trunk.depth,
        width=field.trunk.logit.out_features, skips=tuple(field.trunk.skips),
        tile=256, bwd_tile=128, compute_dtype=cfg.compute_dtype,
        windowed=warp_alpha is not None, interpret=True)._replace(**spec_kw)
    scales = None if warp_alpha is None else encoding_scales(
        spec.enc_segments,
        [jnp.float32(warp_alpha)] + [None] * (len(spec.enc_segments) - 1))
    cot = jnp.asarray(inputs['cotangent'])[:, :6]

    def fn(x_raw, pairs):
        w, v = fused_se3_wv(spec, x_raw[:, :3], x_raw[:, 3:], pairs,
                            enc_scales=scales)
        return jnp.concatenate([w, v], -1)

    args = [jnp.asarray(inputs['x_raw']),
            [(jnp.asarray(w), jnp.asarray(b))
             for w, b in se3_params_to_list(params)]]
    g = jax.device_get(jax.grad(
        lambda *a: jnp.sum(fn(*a) * cot), argnums=(0, 1))(*args))
    res = {'out': np.asarray(jax.device_get(fn(*args)), np.float32),
           'dx': np.asarray(g[0], np.float32)}
    for layer, (dw, db) in enumerate(g[1]):
        res[f'dw{layer}'] = np.asarray(dw, np.float32).T.copy()
        res[f'db{layer}'] = np.asarray(db, np.float32)
    return res


def jax_jacobian(model, case: str, inputs, cases=None) -> dict:
    """The JAX warp-Jacobian kernel's numbers (interpret mode, at the
    model's compute dtype) on ``model``'s warp field for a
    ``JACOBIAN_CASES`` case (or one of ``cases``): 'out' (P, 9) J or (P,
    24) [w | v | dw | dv], and for sum(out * cotangent) 'dx', 'dw<l>' as
    (out, in) and 'db<l>' of the field's layers in kernel order."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hypernerf_tpu.ops.pallas.fused_field import (FusedFieldSpec,
                                                      encoding_scales,
                                                      mlp_params_to_list)
    from hypernerf_tpu.ops.pallas.fused_jacobian import fused_warp_jacobian
    from hypernerf_tpu.ops.pallas.fused_se3 import (FusedSE3Spec,
                                                    se3_params_to_list)
    from hypernerf_tpu.ops import quaternion, rigid_body
    from hypernerf_tpu.ops.pallas.fused_se3_jacobian import (
        fused_se3_warp_jacobian, fused_se3_wv_tangents)
    from hypernerf_tpu_torch.convert import params_to_jax
    from hypernerf_tpu_torch.flagship import JACOBIAN_CASES

    cfg = model.config
    field = model.warp_field
    params = params_to_jax(field.state_dict())
    alpha = (cases or JACOBIAN_CASES)[case][2]
    if cfg.warp_field_type == 'translation':
        spec = FusedFieldSpec(
            segments=((3, field.n_freq), (cfg.glo_dim, 0)),
            depth=field.mlp.depth, width=field.mlp.hidden(0).out_features,
            out_ch=3, skips=tuple(field.mlp.skips), tile=128,
            compute_dtype=cfg.compute_dtype, interpret=True)
        pairs = mlp_params_to_list(params['mlp'])

        def fn(x_raw, wbs):
            return fused_warp_jacobian(spec, x_raw[:, :3], x_raw[:, 3:],
                                       wbs).reshape(-1, 9)
    else:
        spec = FusedSE3Spec(
            embed_ch=field.embed_ch, use_metadata=field.use_metadata,
            min_deg=field.min_deg, max_deg=field.max_deg,
            depth=field.trunk.depth, width=field.trunk.logit.out_features,
            skips=tuple(field.trunk.skips), tile=128, bwd_tile=64,
            compute_dtype=cfg.compute_dtype, windowed=alpha is not None,
            interpret=True)
        scales = None if alpha is None else encoding_scales(
            spec.enc_segments, [jnp.float32(alpha), None])
        pairs = se3_params_to_list(params)

        def fn(x_raw, wbs):
            w, v, dw, dv = fused_se3_wv_tangents(
                spec, x_raw[:, :3], x_raw[:, 3:], wbs, enc_scales=scales)
            n = x_raw.shape[0]
            return jnp.concatenate([w, v, dw.reshape(n, 9),
                                    dv.reshape(n, 9)], -1)

    cot = jnp.asarray(inputs['cotangent'])
    args = [jnp.asarray(inputs['x_raw']),
            [(jnp.asarray(w), jnp.asarray(b)) for w, b in pairs]]
    g = jax.device_get(jax.grad(
        lambda *a: jnp.sum(fn(*a) * cot), argnums=(0, 1))(*args))
    res = {'out': np.asarray(jax.device_get(fn(*args)), np.float32),
           'dx': np.asarray(g[0], np.float32)}
    for layer, (dw, db) in enumerate(g[1]):
        res[f'dw{layer}'] = np.asarray(dw, np.float32).T.copy()
        res[f'db{layer}'] = np.asarray(db, np.float32)
    if cfg.warp_field_type != 'translation':
        # J of the SE(3) and of the quaternion warp on the same trunk: the
        # JAX side channel's retraction JVP on the kernel's tangents.
        for kind, retract in (('se3', rigid_body.se3_warp_vec),
                              ('quaternion', quaternion.quat_warp_vec)):
            res[f'jac_{kind}'] = np.asarray(jax.device_get(
                fused_se3_warp_jacobian(
                    spec, args[0][:, :3], args[0][:, 3:], args[1], retract,
                    enc_scales=scales)), np.float32).reshape(-1, 9)
    return res


def jax_anneal_template(model, level: str, inputs,
                        tmpl_alphas=(None, None), jit: bool = False) -> dict:
    """The JAX template kernel's numbers (``fused_nerf_mlp`` with its
    windowed Nerfies encoding, interpret mode) with the weights of
    ``model``'s ``level``: 'out' (P, 4), and for sum(out * cotangent) 'dx'
    (P, 8; (P, 16) with the plane's 8 hyper coordinates), 'd_rgb_cond',
    'dw<l>' as (out, in) and 'db<l>' of its 16 layers; ``jit``: from one
    jitted vjp (as ``jax_level_vjp``)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hypernerf_tpu.ops.pallas.fused_field import encoding_scales
    from hypernerf_tpu.ops.pallas.fused_mlp import (FusedMLPSpec,
                                                    fused_nerf_mlp,
                                                    nerf_mlp_params_to_list)
    from hypernerf_tpu_torch.convert import params_to_jax

    cfg = model.config
    params = params_to_jax(model.state_dict())
    hyper = (cfg.glo_dim if cfg.hyper_slice_method == 'axis_aligned_plane'
             else cfg.hyper_slice_out_dim)
    segments = ((3, cfg.spatial_point_max_deg - cfg.spatial_point_min_deg,
                 cfg.spatial_point_min_deg, True),
                (hyper, cfg.hyper_point_max_deg - cfg.hyper_point_min_deg,
                 cfg.hyper_point_min_deg, False))
    per = inputs['x_raw'].shape[0] // inputs['rgb_cond'].shape[0]
    spec = FusedMLPSpec(
        in_ch=sum(c * (2 * f + ident) for c, f, _, ident in segments),
        windowed=True, trunk_depth=cfg.trunk_depth,
        trunk_width=cfg.trunk_width, rgb_depth=cfg.rgb_branch_depth,
        rgb_width=cfg.rgb_branch_width, skips=tuple(cfg.skips),
        rgb_cond_ch=inputs['rgb_cond'].shape[1], tile=256, bwd_tile=128,
        compute_dtype=cfg.compute_dtype, enc_segments=segments,
        cond_samples=per if per > 1 else 0, interpret=True)
    scales = encoding_scales(
        segments, [None if a is None else jnp.float32(a) for a in tmpl_alphas])

    def fn(x_raw, rgb_cond, pairs):
        out = fused_nerf_mlp(spec, x_raw[:, :3 + hyper], rgb_cond, None,
                             pairs, enc_scales=scales)
        return jnp.concatenate([out['rgb'], out['alpha']], -1)

    args = [jnp.asarray(inputs['x_raw']), jnp.asarray(inputs['rgb_cond']),
            [(jnp.asarray(w), jnp.asarray(b)) for w, b in
             nerf_mlp_params_to_list(params[f'nerf_{level}'])]]
    cot = jnp.asarray(inputs['cotangent'])
    if jit:  # one jitted vjp (jax_level_vjp)
        def both(*a):
            out, vjp = jax.vjp(fn, *a)
            return out, vjp(cot)
        out, g = jax.device_get(jax.jit(both)(*args))
    else:
        g = jax.device_get(jax.grad(lambda *a: jnp.sum(fn(*a) * cot),
                                    argnums=(0, 1, 2))(*args))
        out = jax.device_get(fn(*args))
    res = {'out': np.asarray(out, np.float32),
           'dx': np.asarray(g[0], np.float32),
           'd_rgb_cond': np.asarray(g[1], np.float32)}
    for layer, (dw, db) in enumerate(g[2]):
        res[f'dw{layer}'] = np.asarray(dw, np.float32).T.copy()
        res[f'db{layer}'] = np.asarray(db, np.float32)
    return res


def jax_template(model, level: str, inputs, tmpl_alphas=(None, None),
                 jit: bool = True) -> dict:
    """The JAX template kernel's numbers (``fused_nerf_mlp``, interpret
    mode) in the model's layout with 4 hyper coordinates (the plane
    layouts' 8 with axis_aligned_plane slicing): posenc_orig, or
    the windowed Nerfies encoding at ``tmpl_alphas`` (nerf_alpha,
    hyper_alpha); the rgb condition of ``inputs`` and its 'alpha_cond'
    where it has one. 'out' (P, 4), and for sum(out * cotangent) 'dx' (P,
    8), 'd_rgb_cond' (and 'd_alpha_cond'), 'dw<l>' as (out, in) and
    'db<l>' of its 16 layers; ``jit``: from one jitted vjp (as
    ``jax_level_vjp``)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hypernerf_tpu.ops.pallas.fused_field import encoding_scales
    from hypernerf_tpu.ops.pallas.fused_mlp import (FusedMLPSpec,
                                                    fused_nerf_mlp,
                                                    nerf_mlp_params_to_list)
    from hypernerf_tpu_torch.convert import params_to_jax

    cfg = model.config
    params = params_to_jax(model.state_dict())
    hyper = (cfg.glo_dim if cfg.hyper_slice_method == 'axis_aligned_plane'
             else cfg.hyper_slice_out_dim)
    nerfies = not cfg.use_original_embed
    if nerfies:
        segments = ((3, cfg.spatial_point_max_deg - cfg.spatial_point_min_deg,
                     cfg.spatial_point_min_deg, True),
                    (hyper, cfg.hyper_point_max_deg - cfg.hyper_point_min_deg,
                     cfg.hyper_point_min_deg, False))
    else:
        segments = ((3, cfg.xyz_freq, 0, True), (hyper, cfg.hyper_freq, 0,
                                                  True))
    alpha_ch = inputs['alpha_cond'].shape[1] if 'alpha_cond' in inputs else 0
    per = inputs['x_raw'].shape[0] // inputs['rgb_cond'].shape[0]
    spec = FusedMLPSpec(
        in_ch=sum(c * (2 * f + ident) for c, f, _, ident in segments),
        windowed=nerfies, trunk_depth=cfg.trunk_depth,
        trunk_width=cfg.trunk_width, rgb_depth=cfg.rgb_branch_depth,
        rgb_width=cfg.rgb_branch_width, skips=tuple(cfg.skips),
        rgb_cond_ch=inputs['rgb_cond'].shape[1], alpha_cond_ch=alpha_ch,
        tile=256, bwd_tile=128, compute_dtype=cfg.compute_dtype,
        enc_segments=(segments if nerfies
                      else tuple(seg[:2] for seg in segments)),
        cond_samples=per if per > 1 else 0, interpret=True)
    scales = encoding_scales(
        segments, [None if a is None else jnp.float32(a)
                   for a in tmpl_alphas]) if nerfies else None

    def fn(x_raw, rgb_cond, *rest):
        pairs, alpha_cond = rest[-1], (rest[0] if alpha_ch else None)
        out = fused_nerf_mlp(spec, x_raw[:, :3 + hyper], rgb_cond,
                             alpha_cond, pairs, enc_scales=scales)
        return jnp.concatenate([out['rgb'], out['alpha']], -1)

    args = [jnp.asarray(inputs['x_raw']), jnp.asarray(inputs['rgb_cond'])]
    if alpha_ch:
        args.append(jnp.asarray(inputs['alpha_cond']))
    args.append([(jnp.asarray(w), jnp.asarray(b)) for w, b in
                 nerf_mlp_params_to_list(params[f'nerf_{level}'])])
    cot = jnp.asarray(inputs['cotangent'])
    if jit:
        def both(*a):
            out, vjp = jax.vjp(fn, *a)
            return out, vjp(cot)
        out, g = jax.device_get(jax.jit(both)(*args))
    else:
        g = jax.device_get(jax.grad(
            lambda *a: jnp.sum(fn(*a) * cot),
            argnums=tuple(range(len(args))))(*args))
        out = jax.device_get(fn(*args))
    res = {'out': np.asarray(out, np.float32),
           'dx': np.asarray(g[0], np.float32),
           'd_rgb_cond': np.asarray(g[1], np.float32)}
    if alpha_ch:
        res['d_alpha_cond'] = np.asarray(g[2], np.float32)
    for layer, (dw, db) in enumerate(g[-1]):
        res[f'dw{layer}'] = np.asarray(dw, np.float32).T.copy()
        res[f'db{layer}'] = np.asarray(db, np.float32)
    return res


def jax_plane_template(model, level: str, inputs) -> dict:
    """The JAX template kernel's numbers (``fused_nerf_mlp`` with its
    in-kernel posenc_orig of [xyz (10 bands) | 8 hyper coordinates (6)],
    ``in_ch`` 167, interpret mode) with the weights of ``model``'s
    ``level``: 'out' (P, 4), and for sum(out * cotangent) 'dx' (P, 16),
    'd_rgb_cond', 'dw<l>' as (out, in) and 'db<l>' of its 16 layers."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hypernerf_tpu.ops.pallas.fused_mlp import (FusedMLPSpec,
                                                    fused_nerf_mlp,
                                                    nerf_mlp_params_to_list)
    from hypernerf_tpu_torch.convert import params_to_jax

    cfg = model.config
    params = params_to_jax(model.state_dict())
    hyper = cfg.glo_dim
    segments = ((3, cfg.xyz_freq), (hyper, cfg.hyper_freq))
    per = inputs['x_raw'].shape[0] // inputs['rgb_cond'].shape[0]
    spec = FusedMLPSpec(
        in_ch=sum(c * (1 + 2 * f) for c, f in segments),
        trunk_depth=cfg.trunk_depth, trunk_width=cfg.trunk_width,
        rgb_depth=cfg.rgb_branch_depth, rgb_width=cfg.rgb_branch_width,
        skips=tuple(cfg.skips), rgb_cond_ch=inputs['rgb_cond'].shape[1],
        tile=256, bwd_tile=128, compute_dtype=cfg.compute_dtype,
        enc_segments=segments, cond_samples=per if per > 1 else 0,
        interpret=True)

    def fn(x_raw, rgb_cond, pairs):
        out = fused_nerf_mlp(spec, x_raw[:, :3 + hyper], rgb_cond, None,
                             pairs)
        return jnp.concatenate([out['rgb'], out['alpha']], -1)

    args = [jnp.asarray(inputs['x_raw']), jnp.asarray(inputs['rgb_cond']),
            [(jnp.asarray(w), jnp.asarray(b)) for w, b in
             nerf_mlp_params_to_list(params[f'nerf_{level}'])]]
    cot = jnp.asarray(inputs['cotangent'])
    g = jax.device_get(jax.grad(lambda *a: jnp.sum(fn(*a) * cot),
                                argnums=(0, 1, 2))(*args))
    res = {'out': np.asarray(jax.device_get(fn(*args)), np.float32),
           'dx': np.asarray(g[0], np.float32),
           'd_rgb_cond': np.asarray(g[1], np.float32)}
    for layer, (dw, db) in enumerate(g[2]):
        res[f'dw{layer}'] = np.asarray(dw, np.float32).T.copy()
        res[f'db{layer}'] = np.asarray(db, np.float32)
    return res


def jax_condition_template(model, level: str, inputs) -> dict:
    """The JAX template kernel's numbers (``fused_nerf_mlp`` with its
    in-kernel posenc_orig of [xyz | 4 hyper coordinates], a 47-column rgb
    condition and ``alpha_cond_ch`` 8, interpret mode) with the weights of
    ``model``'s ``level``: 'out' (P, 4), and for sum(out * cotangent) 'dx'
    (P, 8), 'd_rgb_cond', 'd_alpha_cond', 'dw<l>' as (out, in) and 'db<l>'
    of its 16 layers."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hypernerf_tpu.ops.pallas.fused_mlp import (FusedMLPSpec,
                                                    fused_nerf_mlp,
                                                    nerf_mlp_params_to_list)
    from hypernerf_tpu_torch.convert import params_to_jax

    cfg = model.config
    params = params_to_jax(model.state_dict())
    segments = ((3, cfg.xyz_freq), (cfg.hyper_slice_out_dim, cfg.hyper_freq))
    per = inputs['x_raw'].shape[0] // inputs['rgb_cond'].shape[0]
    spec = FusedMLPSpec(
        in_ch=sum(c * (1 + 2 * f) for c, f in segments),
        trunk_depth=cfg.trunk_depth, trunk_width=cfg.trunk_width,
        rgb_depth=cfg.rgb_branch_depth, rgb_width=cfg.rgb_branch_width,
        skips=tuple(cfg.skips), rgb_cond_ch=inputs['rgb_cond'].shape[1],
        alpha_cond_ch=inputs['alpha_cond'].shape[1], tile=256, bwd_tile=128,
        compute_dtype=cfg.compute_dtype, enc_segments=segments,
        cond_samples=per, interpret=True)

    def fn(x_raw, rgb_cond, alpha_cond, pairs):
        out = fused_nerf_mlp(spec, x_raw[:, :7], rgb_cond, alpha_cond, pairs)
        return jnp.concatenate([out['rgb'], out['alpha']], -1)

    args = [jnp.asarray(inputs['x_raw']), jnp.asarray(inputs['rgb_cond']),
            jnp.asarray(inputs['alpha_cond']),
            [(jnp.asarray(w), jnp.asarray(b)) for w, b in
             nerf_mlp_params_to_list(params[f'nerf_{level}'])]]
    cot = jnp.asarray(inputs['cotangent'])
    g = jax.device_get(jax.grad(lambda *a: jnp.sum(fn(*a) * cot),
                                argnums=(0, 1, 2, 3))(*args))
    res = {'out': np.asarray(jax.device_get(fn(*args)), np.float32),
           'dx': np.asarray(g[0], np.float32),
           'd_rgb_cond': np.asarray(g[1], np.float32),
           'd_alpha_cond': np.asarray(g[2], np.float32)}
    for layer, (dw, db) in enumerate(g[3]):
        res[f'dw{layer}'] = np.asarray(dw, np.float32).T.copy()
        res[f'db{layer}'] = np.asarray(db, np.float32)
    return res


def condition_reference() -> dict:
    """Every array of the conditions file: each case's inputs and numbers
    (dW of ``CONDITION_GRAD_LAYERS`` alone)."""
    from hypernerf_tpu_torch.flagship import (CONDITION_GRAD_LAYERS,
                                              CONDITION_LEVEL_CASES,
                                              CONDITION_TEMPLATE_CASES,
                                              condition_probe_inputs,
                                              flagship_model,
                                              load_probe_weights)
    model = load_probe_weights(flagship_model('cpu', config='nerf_embed'))
    arrays = {}

    def keep(case, kind, numbers):
        for k, v in numbers.items():
            if k.startswith('dw') and int(k[2:]) not in \
                    CONDITION_GRAD_LAYERS[kind]:
                continue
            arrays[f'{case}/{k}'] = v

    for case, (level, *_) in CONDITION_LEVEL_CASES.items():
        inputs = condition_probe_inputs(case)
        arrays.update({f'{case}/{k}': v for k, v in inputs.items()})
        rays = {k: v for k, v in inputs.items() if k != 'cotangent'}
        arrays[f'{case}/out'] = jax_level(model, level, rays)
        keep(case, 'level', jax_level_grads(model, level, rays,
                                            inputs['cotangent']))
    for case, (level, *_) in CONDITION_TEMPLATE_CASES.items():
        inputs = condition_probe_inputs(case)
        arrays.update({f'{case}/{k}': v for k, v in inputs.items()})
        keep(case, 'template', jax_condition_template(model, level, inputs))
    return arrays


def plane_models() -> dict:
    """The ``plane`` configuration at the probe weights, in bf16 (as it
    runs) and in float32: {dtype name: model}."""
    from hypernerf_tpu_torch.flagship import flagship_model, load_probe_weights
    return {dt: load_probe_weights(flagship_model('cpu', config='plane',
                                                  compute_dtype=dt))
            for dt in ('bfloat16', 'float32')}


def plane_reference() -> dict:
    """Every array of the plane file: each case's inputs and numbers."""
    from hypernerf_tpu_torch.flagship import (PLANE_F32_CASES,
                                              PLANE_LEVEL_CASES,
                                              PLANE_TEMPLATE_CASES,
                                              plane_probe_inputs)
    models = plane_models()
    arrays = {}
    cases = [(c, 'bfloat16') for c in (*PLANE_LEVEL_CASES,
                                       *PLANE_TEMPLATE_CASES)]
    cases += [(c, 'float32') for c in PLANE_F32_CASES]
    for case, dt in cases:
        base = PLANE_F32_CASES.get(case, case)
        model, inputs = models[dt], plane_probe_inputs(case)
        arrays.update({f'{case}/{k}': v for k, v in inputs.items()})
        if base in PLANE_TEMPLATE_CASES:
            level = PLANE_TEMPLATE_CASES[base][0]
            arrays.update({f'{case}/{k}': v for k, v in jax_plane_template(
                model, level, inputs).items()})
            continue
        level = PLANE_LEVEL_CASES[base][0]
        rays = {k: v for k, v in inputs.items() if k != 'cotangent'}
        arrays[f'{case}/out'] = jax_level(model, level, rays)
        arrays.update({f'{case}/{k}': v for k, v in jax_level_grads(
            model, level, rays, inputs['cotangent']).items()})
    return arrays


def anneal_reference() -> dict:
    """Every array of the anneal file: each case's inputs and numbers."""
    from hypernerf_tpu_torch.flagship import (ANNEAL_LEVEL_CASES,
                                              ANNEAL_TEMPLATE_CASES,
                                              anneal_extra_params,
                                              anneal_probe_inputs,
                                              flagship_model,
                                              load_probe_weights)
    model = load_probe_weights(flagship_model('cpu', config='anneal'))
    ep = anneal_extra_params()
    alphas = (ep['nerf_alpha'], ep['hyper_alpha'])
    arrays = {}
    for case, (level, *_) in ANNEAL_LEVEL_CASES.items():
        inputs = anneal_probe_inputs(case)
        arrays.update({f'{case}/{k}': v for k, v in inputs.items()})
        rays = {k: v for k, v in inputs.items() if k != 'cotangent'}
        arrays[f'{case}/out'] = jax_level(model, level, rays,
                                          tmpl_alphas=alphas)
        arrays.update({f'{case}/{k}': v for k, v in jax_level_grads(
            model, level, rays, inputs['cotangent'],
            tmpl_alphas=alphas).items()})
    for case, (level, *_) in ANNEAL_TEMPLATE_CASES.items():
        inputs = anneal_probe_inputs(case)
        arrays.update({f'{case}/{k}': v for k, v in inputs.items()})
        arrays.update({f'{case}/{k}': v for k, v in jax_anneal_template(
            model, level, inputs, alphas).items()})
    return arrays


def b4_reference() -> dict:
    """Every array of the B.4 file: each case's inputs and numbers (dW of
    ``b4_grad_layers`` alone)."""
    from hypernerf_tpu_torch.flagship import (B4_LEVEL_CASES,
                                              B4_TEMPLATE_CASES,
                                              b4_extra_params, b4_grad_layers,
                                              b4_probe_inputs, flagship_model,
                                              load_probe_weights)
    arrays = {}

    def keep(case, numbers):
        for k, v in numbers.items():
            if k.startswith('dw') and int(k[2:]) not in b4_grad_layers(case):
                continue
            arrays[f'{case}/{k}'] = v

    cases = [(c, *spec) for c, spec in B4_LEVEL_CASES.items()]
    cases += [(c, *spec) for c, spec in B4_TEMPLATE_CASES.items()]
    for case, config, level, *_ in cases:
        model = load_probe_weights(flagship_model('cpu', config=config))
        ep = b4_extra_params(config)
        alphas = (ep.get('nerf_alpha'), ep.get('hyper_alpha'))
        inputs = b4_probe_inputs(case)
        arrays.update({f'{case}/{k}': v for k, v in inputs.items()})
        if case in B4_TEMPLATE_CASES:
            keep(case, jax_anneal_template(model, level, inputs, alphas,
                                           jit=True))
            continue
        rays = {k: v for k, v in inputs.items() if k != 'cotangent'}
        keep(case, jax_level_vjp(model, level, rays, inputs['cotangent'],
                                 ep.get('warp_alpha'), alphas))
    return arrays


def f32_reference() -> dict:
    """Every array of the float32 file: the case's inputs and numbers (dW
    of ``F32_GRAD_LAYERS`` alone)."""
    from hypernerf_tpu_torch.flagship import (F32_GRAD_LAYERS,
                                              F32_LEVEL_CASES,
                                              f32_probe_inputs,
                                              flagship_model,
                                              load_probe_weights)
    model = load_probe_weights(flagship_model('cpu',
                                              compute_dtype='float32'))
    arrays = {}
    for case, (level, *_) in F32_LEVEL_CASES.items():
        inputs = f32_probe_inputs(case)
        arrays.update({f'{case}/{k}': v for k, v in inputs.items()})
        rays = {k: v for k, v in inputs.items() if k != 'cotangent'}
        for k, v in jax_level_vjp(model, level, rays,
                                  inputs['cotangent']).items():
            if not k.startswith('dw') or int(k[2:]) in F32_GRAD_LAYERS:
                arrays[f'{case}/{k}'] = v
    return arrays


def f32_modular_reference() -> dict:
    """Every array of the float32 per-module file: each case's inputs and
    the JAX field and template kernels' numbers at float32 (a template's
    dW of ``F32_MODULAR_TEMPLATE_DW`` alone)."""
    from hypernerf_tpu_torch.flagship import (F32_MODULAR_CASES,
                                              F32_MODULAR_TEMPLATE_DW,
                                              flagship_model,
                                              load_probe_weights,
                                              modular_probe_inputs)
    models = {c: load_probe_weights(flagship_model(
        'cpu', config=c, compute_dtype='float32'))
        for c in {case[1] for case in F32_MODULAR_CASES.values()}}
    arrays = {}
    for case, (kind, config, *_) in F32_MODULAR_CASES.items():
        inputs = modular_probe_inputs(case, F32_MODULAR_CASES)
        arrays.update({f'{case}/{k}': v for k, v in inputs.items()})
        for k, v in jax_modular(models[config], case, inputs,
                                F32_MODULAR_CASES).items():
            if kind == 'field' or not k.startswith('dw') \
                    or int(k[2:]) in F32_MODULAR_TEMPLATE_DW:
                arrays[f'{case}/{k}'] = v
    return arrays


def f32_screw_reference() -> dict:
    """Every array of the float32 screw-warp file: each case's inputs and
    the JAX kernels' numbers at float32 (dW of some layers alone)."""
    from hypernerf_tpu_torch.flagship import (F32_SCREW_GRAD_LAYERS,
                                              F32_SCREW_LEVEL_CASES,
                                              F32_SCREW_TRUNK_CASES,
                                              F32_SCREW_TRUNK_DW,
                                              f32_screw_model,
                                              f32_screw_probe_inputs)
    arrays = {}
    for case, (config, level, _, _, alpha, _, heads) in \
            F32_SCREW_LEVEL_CASES.items():
        inputs = f32_screw_probe_inputs(case)
        arrays.update({f'{case}/{k}': v for k, v in inputs.items()})
        rays = {k: v for k, v in inputs.items() if k != 'cotangent'}
        for k, v in jax_level_vjp(f32_screw_model(config, heads), level,
                                  rays, inputs['cotangent'], alpha).items():
            if not k.startswith('dw') or int(k[2:]) in F32_SCREW_GRAD_LAYERS:
                arrays[f'{case}/{k}'] = v
    for case, (_, alpha, _, heads) in F32_SCREW_TRUNK_CASES.items():
        inputs = f32_screw_probe_inputs(case)
        arrays.update({f'{case}/{k}': v for k, v in inputs.items()})
        for k, v in jax_se3_trunk(f32_screw_model('se3', heads), inputs,
                                  alpha).items():
            if not k.startswith('dw') or int(k[2:]) in F32_SCREW_TRUNK_DW:
                arrays[f'{case}/{k}'] = v
    return arrays


def f32_nerfies_case(case: str, model=None) -> dict:
    """The JAX kernels' numbers of one F32_NERFIES case at float32 (every
    dW; ``model``: its ``flagship.f32_nerfies_model``, made when None)."""
    from hypernerf_tpu_torch.flagship import (F32_NERFIES_FIELD_CASES,
                                              F32_NERFIES_LEVEL_CASES,
                                              f32_nerfies_extra,
                                              f32_nerfies_model,
                                              f32_nerfies_probe_inputs)
    model = model or f32_nerfies_model(case)
    inputs = f32_nerfies_probe_inputs(case, model)
    if case in F32_NERFIES_FIELD_CASES:
        return jax_modular(model, case, inputs, F32_NERFIES_FIELD_CASES)
    ep = f32_nerfies_extra(case)
    alphas = (ep.get('nerf_alpha'), ep.get('hyper_alpha'))
    if case in F32_NERFIES_LEVEL_CASES:
        level = F32_NERFIES_LEVEL_CASES[case][2]
        rays = {k: v for k, v in inputs.items() if k != 'cotangent'}
        screw = model.config.warp_field_type != 'translation'
        return jax_level_vjp(model, level, rays, inputs['cotangent'],
                             ep.get('warp_alpha') if screw else None,
                             alphas)
    from hypernerf_tpu_torch.flagship import F32_NERFIES_TEMPLATE_CASES
    return jax_template(model, F32_NERFIES_TEMPLATE_CASES[case][2], inputs,
                        alphas)


def f32_nerfies_reference() -> dict:
    """Every array of the float32 Nerfies-layout file: each case's inputs
    and the JAX kernels' numbers at float32 (dW of
    ``f32_nerfies_grad_layers`` alone)."""
    from hypernerf_tpu_torch.flagship import (F32_NERFIES_FIELD_CASES,
                                              F32_NERFIES_LEVEL_CASES,
                                              F32_NERFIES_TEMPLATE_CASES,
                                              f32_nerfies_grad_layers,
                                              f32_nerfies_model,
                                              f32_nerfies_probe_inputs)
    arrays = {}
    for case in (*F32_NERFIES_LEVEL_CASES, *F32_NERFIES_TEMPLATE_CASES,
                 *F32_NERFIES_FIELD_CASES):
        model = f32_nerfies_model(case)
        inputs = f32_nerfies_probe_inputs(case, model)
        arrays.update({f'{case}/{k}': v for k, v in inputs.items()})
        for k, v in f32_nerfies_case(case, model).items():
            if not k.startswith('dw') or int(k[2:]) in \
                    f32_nerfies_grad_layers(case):
                arrays[f'{case}/{k}'] = v
    return arrays


def f32_plane_case(case: str, model=None) -> dict:
    """The JAX kernels' numbers of one F32_PLANE case at float32 (every dW,
    a level's gradients where its case keeps them; ``model``: its
    ``flagship.f32_plane_model``, made when None)."""
    from hypernerf_tpu_torch.flagship import (F32_PLANE_LEVEL_CASES,
                                              F32_PLANE_TEMPLATE_CASES,
                                              f32_plane_extra,
                                              f32_plane_model,
                                              f32_plane_probe_inputs)
    model = model or f32_plane_model(case)
    inputs = f32_plane_probe_inputs(case, model)
    ep = f32_plane_extra(case)
    nerfies = not model.config.use_original_embed
    alphas = ((ep.get('nerf_alpha'), ep.get('hyper_alpha')) if nerfies
              else (None, None))
    if case in F32_PLANE_TEMPLATE_CASES:
        return jax_template(model, F32_PLANE_TEMPLATE_CASES[case][1], inputs,
                            alphas)
    _, level, *_, grads = F32_PLANE_LEVEL_CASES[case]
    rays = {k: v for k, v in inputs.items() if k != 'cotangent'}
    screw = model.config.warp_field_type != 'translation'
    warp_alpha = ep.get('warp_alpha') if screw else None
    if not grads:
        return {'out': jax_level(model, level, rays, warp_alpha, alphas)}
    return jax_level_vjp(model, level, rays, inputs['cotangent'], warp_alpha,
                         alphas)


def f32_plane_reference() -> dict:
    """Every array of the float32 plane-table file: each case's inputs and
    the JAX kernels' numbers at float32 (dW of ``f32_plane_grad_layers``
    alone)."""
    from hypernerf_tpu_torch.flagship import (F32_PLANE_LEVEL_CASES,
                                              F32_PLANE_TEMPLATE_CASES,
                                              f32_plane_grad_layers,
                                              f32_plane_model,
                                              f32_plane_probe_inputs)
    arrays = {}
    for case in (*F32_PLANE_LEVEL_CASES, *F32_PLANE_TEMPLATE_CASES):
        model = f32_plane_model(case)
        inputs = f32_plane_probe_inputs(case, model)
        if case in F32_PLANE_LEVEL_CASES and not F32_PLANE_LEVEL_CASES[
                case][-1]:
            del inputs['cotangent']
        arrays.update({f'{case}/{k}': v for k, v in inputs.items()})
        for k, v in f32_plane_case(case, model).items():
            if not k.startswith('dw') or int(k[2:]) in \
                    f32_plane_grad_layers(case):
                arrays[f'{case}/{k}'] = v
    return arrays


def jacobian_reference() -> dict:
    """Every array of the Jacobian file: each case's inputs and numbers."""
    from hypernerf_tpu_torch.flagship import (JACOBIAN_CASES, flagship_model,
                                              jacobian_probe_inputs,
                                              load_probe_weights)
    arrays = {}
    for case, (config, *_) in JACOBIAN_CASES.items():
        model = load_probe_weights(flagship_model('cpu', config=config))
        inputs = jacobian_probe_inputs(case)
        arrays.update({f'{case}/{k}': v for k, v in inputs.items()})
        arrays.update({f'{case}/{k}': v for k, v in jax_jacobian(
            model, case, inputs).items()})
    return arrays


def f32_jacobian_reference() -> dict:
    """Every array of the float32 Jacobian file: each case's inputs and the
    JAX Jacobian kernels' numbers at float32."""
    from hypernerf_tpu_torch.flagship import (F32_JACOBIAN_CASES,
                                              f32_jacobian_model,
                                              jacobian_probe_inputs)
    arrays = {}
    for case in F32_JACOBIAN_CASES:
        inputs = jacobian_probe_inputs(case, F32_JACOBIAN_CASES)
        arrays.update({f'{case}/{k}': v for k, v in inputs.items()})
        arrays.update({f'{case}/{k}': v for k, v in jax_jacobian(
            f32_jacobian_model(case), case, inputs,
            F32_JACOBIAN_CASES).items()})
    return arrays


def se3_reference() -> dict:
    """Every array of the SE(3) file: each case's inputs and numbers."""
    from hypernerf_tpu_torch.flagship import (SE3_LEVEL_CASES,
                                              SE3_TRUNK_CASES, flagship_model,
                                              load_probe_weights,
                                              se3_probe_inputs)
    models = {c: load_probe_weights(flagship_model('cpu', config=c))
              for c in ('se3', 'quaternion')}
    arrays = {}
    for case, (_, alpha, _) in SE3_TRUNK_CASES.items():
        inputs = se3_probe_inputs(case)
        arrays.update({f'{case}/{k}': v for k, v in inputs.items()})
        arrays.update({f'{case}/{k}': v for k, v in jax_se3_trunk(
            models['se3'], inputs, alpha).items()})
    for case, (config, level, _, _, alpha, _) in SE3_LEVEL_CASES.items():
        inputs = se3_probe_inputs(case)
        arrays.update({f'{case}/{k}': v for k, v in inputs.items()})
        rays = {k: v for k, v in inputs.items() if k != 'cotangent'}
        arrays[f'{case}/out'] = jax_level(models[config], level, rays, alpha)
        arrays.update({f'{case}/{k}': v for k, v in jax_level_grads(
            models[config], level, rays, inputs['cotangent'],
            alpha).items()})
    return arrays


def modular_reference() -> dict:
    """Every array of the modular file: each case's inputs and numbers."""
    from hypernerf_tpu_torch.flagship import (MODULAR_REFERENCE_CASES,
                                              modular_probe_inputs)
    models = probe_models()
    arrays = {}
    for case, (_, config, *_) in MODULAR_REFERENCE_CASES.items():
        inputs = modular_probe_inputs(case)
        arrays.update({f'{case}/{k}': v for k, v in inputs.items()})
        arrays.update({f'{case}/{k}': v for k, v in jax_modular(
            models[config], case, inputs).items()})
    return arrays


def gradient_reference(model) -> dict:
    """Every array of the gradients file."""
    from hypernerf_tpu_torch.flagship import (GRAD_REFERENCE_CASE,
                                              composite_probe_inputs,
                                              probe_cotangents,
                                              probe_inputs)
    name, n_rays, samples, seed = GRAD_REFERENCE_CASE
    inputs = probe_inputs(n_rays, samples, seed)
    cots = probe_cotangents(n_rays, samples, seed)
    arrays = {f'level/{k}': v for k, v in inputs.items()}
    arrays['level/cotangent'] = cots['level']
    arrays.update({f'level/{k}': v for k, v in jax_level_grads(
        model, name, inputs, cots['level']).items()})
    comp = composite_probe_inputs(n_rays, samples, seed)
    arrays.update({f'composite/{k}': v for k, v in comp.items()})
    arrays['composite/cot_outs'] = cots['outs']
    arrays['composite/cot_weights'] = cots['weights']
    arrays.update({f'composite/{k}': v for k, v in jax_composite_grads(
        comp, cots['outs'], cots['weights']).items()})
    return arrays


def main():
    import numpy as np

    from hypernerf_tpu_torch.flagship import (ANNEAL_REFERENCE,
                                              B4_REFERENCE, F32_REFERENCE,
                                              F32_MODULAR_REFERENCE,
                                              F32_SCREW_REFERENCE,
                                              F32_NERFIES_REFERENCE,
                                              F32_PLANE_REFERENCE,
                                              F32_JACOBIAN_REFERENCE,
                                              GRAD_REFERENCE,
                                              LEVEL_REFERENCE,
                                              PLANE_REFERENCE,
                                              CONDITION_REFERENCE,
                                              LEVEL_REFERENCE_CASES,
                                              MODULAR_REFERENCE,
                                              JACOBIAN_REFERENCE,
                                              SE3_REFERENCE, probe_inputs)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--out', default=LEVEL_REFERENCE)
    parser.add_argument('--grads_out', default=GRAD_REFERENCE)
    parser.add_argument('--modular_out', default=MODULAR_REFERENCE)
    parser.add_argument('--se3_out', default=SE3_REFERENCE)
    parser.add_argument('--jacobian_out', default=JACOBIAN_REFERENCE)
    parser.add_argument('--anneal_out', default=ANNEAL_REFERENCE)
    parser.add_argument('--plane_out', default=PLANE_REFERENCE)
    parser.add_argument('--conditions_out', default=CONDITION_REFERENCE)
    parser.add_argument('--b4_out', default=B4_REFERENCE)
    parser.add_argument('--f32_out', default=F32_REFERENCE)
    parser.add_argument('--f32_modular_out', default=F32_MODULAR_REFERENCE)
    parser.add_argument('--f32_screw_out', default=F32_SCREW_REFERENCE)
    parser.add_argument('--f32_nerfies_out', default=F32_NERFIES_REFERENCE)
    parser.add_argument('--f32_plane_out', default=F32_PLANE_REFERENCE)
    parser.add_argument('--f32_jacobian_out', default=F32_JACOBIAN_REFERENCE)
    parser.add_argument('--only', choices=('se3', 'jacobian', 'anneal',
                                           'plane', 'conditions', 'b4',
                                           'f32', 'f32_modular',
                                           'f32_screw', 'f32_nerfies',
                                           'f32_plane', 'f32_jacobian'),
                        default=None, help='write the SE(3), the Jacobian, '
                        'the anneal, the plane, the conditions, the B.4, '
                        'the float32, the float32 per-module, the float32 '
                        'screw-warp, the float32 Nerfies-layout, the '
                        'float32 plane-table or the float32 Jacobian file '
                        'alone')
    args = parser.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.se3_out)), exist_ok=True)
    if args.only in (None, 'f32'):
        np.savez_compressed(args.f32_out, **f32_reference())
        print(args.f32_out)
    if args.only in (None, 'f32_modular'):
        np.savez_compressed(args.f32_modular_out, **f32_modular_reference())
        print(args.f32_modular_out)
    if args.only in (None, 'f32_screw'):
        np.savez_compressed(args.f32_screw_out, **f32_screw_reference())
        print(args.f32_screw_out)
    if args.only in (None, 'f32_nerfies'):
        np.savez_compressed(args.f32_nerfies_out, **f32_nerfies_reference())
        print(args.f32_nerfies_out)
    if args.only in (None, 'f32_plane'):
        np.savez_compressed(args.f32_plane_out, **f32_plane_reference())
        print(args.f32_plane_out)
    if args.only in (None, 'f32_jacobian'):
        np.savez_compressed(args.f32_jacobian_out, **f32_jacobian_reference())
        print(args.f32_jacobian_out)
    if args.only in (None, 'b4'):
        np.savez_compressed(args.b4_out, **b4_reference())
        print(args.b4_out)
    if args.only in (None, 'conditions'):
        np.savez_compressed(args.conditions_out, **condition_reference())
        print(args.conditions_out)
    if args.only in (None, 'plane'):
        np.savez_compressed(args.plane_out, **plane_reference())
        print(args.plane_out)
    if args.only in (None, 'anneal'):
        np.savez_compressed(args.anneal_out, **anneal_reference())
        print(args.anneal_out)
    if args.only in (None, 'jacobian'):
        np.savez_compressed(args.jacobian_out, **jacobian_reference())
        print(args.jacobian_out)
    if args.only in (None, 'se3'):
        np.savez_compressed(args.se3_out, **se3_reference())
        print(args.se3_out)
    if args.only:
        return
    model = probe_model()
    arrays = {}
    for name, n_rays, samples, seed in LEVEL_REFERENCE_CASES:
        inputs = probe_inputs(n_rays, samples, seed)
        arrays.update({f'{name}/{k}': v for k, v in inputs.items()})
        arrays[f'{name}/out'] = jax_level(model, name, inputs)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(args.out)
    np.savez_compressed(args.grads_out, **gradient_reference(model))
    print(args.grads_out)
    np.savez_compressed(args.modular_out, **modular_reference())
    print(args.modular_out)


if __name__ == '__main__':
    main()
