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
      [--only se3|jacobian]

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
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def probe_model():
    from hypernerf_tpu_torch.flagship import flagship_model, load_probe_weights
    return load_probe_weights(flagship_model('cpu'))


def _jax_level_fn(model, level: str, inputs, warp_alpha=None, **spec_kw):
    """(fn, args): ``fn(*args)`` is the JAX level kernel's packed output
    with the weights of ``model``'s ``level``; args are the five ray inputs
    in ``LEVEL_INPUTS`` order, then the warp, hyper and template (W, b)
    pair lists. The warp type is the model's; ``warp_alpha`` windows the
    SE(3) / quaternion trunk's encoding (None: a row of ones, as the JAX
    model threads it). ``spec_kw`` overrides fields of the spec (the backward
    schedule)."""
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
    spec = FusedLevelSpec(
        embed_ch=cfg.glo_dim, warp_type=cfg.warp_field_type,
        se3_min_deg=cfg.warp_min_deg, se3_max_deg=cfg.warp_max_deg,
        warp_windowed=screw, warp_depth=cfg.warp_depth,
        warp_width=cfg.warp_width, warp_freq=cfg.warp_freq,
        hyper_depth=cfg.hyper_sheet_depth, hyper_width=cfg.hyper_sheet_width,
        hyper_sheet_freq=cfg.hyper_sheet_freq,
        hyper_out=cfg.hyper_slice_out_dim, xyz_freq=cfg.xyz_freq,
        hyper_freq=cfg.hyper_freq, trunk_depth=cfg.trunk_depth,
        trunk_width=cfg.trunk_width, rgb_depth=cfg.rgb_branch_depth,
        rgb_width=cfg.rgb_branch_width,
        rgb_cond_ch=inputs['rgb_cond'].shape[1], alpha_cond_ch=0,
        skips=tuple(cfg.skips), tile=512, bwd_tile=256, interpret=True,
        compute_dtype=cfg.compute_dtype, cond_samples=s,
        pipelined_bwd=cfg.pallas_pipelined_bwd)._replace(**spec_kw)
    warp_scales = None
    if screw:
        warp_scales = encoding_scales(
            spec.warp_fs.enc_segments,
            [None if warp_alpha is None else jnp.float32(warp_alpha), None])

    def fn(z_vals, origins, directions, embed, rgb_cond, warp, hyper, tmpl):
        return fused_level(spec, None, embed, rgb_cond, None, warp, hyper,
                           tmpl, warp_enc_scales=warp_scales,
                           origins=origins, directions=directions,
                           z_vals=z_vals, return_packed=True)[:, :4]

    as_jnp = lambda pairs: [(jnp.asarray(w), jnp.asarray(b))
                            for w, b in pairs]
    args = [jnp.asarray(inputs[k]) for k in LEVEL_INPUTS] + [
        as_jnp(se3_params_to_list(params['warp_field']) if screw else
               mlp_params_to_list(params['warp_field']['mlp'])),
        as_jnp(mlp_params_to_list(params['hyper_sheet_mlp']['mlp'])),
        as_jnp(nerf_mlp_params_to_list(params[f'nerf_{level}']))]
    return fn, args


def jax_level(model, level: str, inputs, warp_alpha=None) -> 'np.ndarray':
    """(R * S, 4) [rgb logits | raw sigma] of the JAX level kernel with the
    weights of ``model``'s ``level`` ('coarse' or 'fine')."""
    import jax
    import numpy as np
    fn, args = _jax_level_fn(model, level, inputs, warp_alpha)
    return np.asarray(jax.device_get(fn(*args)))


def jax_level_grads(model, level: str, inputs, cotangent, warp_alpha=None,
                    **spec_kw) -> dict:
    """Gradients of sum(level output * cotangent) through the JAX level
    kernel's own backward: {'d_<input>'} for the five ray inputs and
    {'dw<l>', 'db<l>'} for the level's layers (30, or 32 with the SE(3) /
    quaternion warp) in kernel order, dW as (out, in)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    fn, args = _jax_level_fn(model, level, inputs, warp_alpha, **spec_kw)
    from hypernerf_tpu_torch.flagship import LEVEL_INPUTS

    def loss(*a):
        return jnp.sum(fn(*a) * jnp.asarray(cotangent))

    g = jax.device_get(jax.grad(loss, argnums=tuple(range(8)))(*args))
    out = {f'd_{k}': np.asarray(v, np.float32)
           for k, v in zip(LEVEL_INPUTS, g[:5])}
    pairs = [p for group in g[5:] for p in group]
    for layer, (dw, db) in enumerate(pairs):
        out[f'dw{layer}'] = np.asarray(dw, np.float32).T.copy()
        out[f'db{layer}'] = np.asarray(db, np.float32)
    return out


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


def jax_modular(model, case: str, inputs) -> dict:
    """The JAX kernel's numbers for one modular case: 'out', and for
    sum(out * cotangent) 'dx' (and 'd_rgb_cond' of a template), 'dw<l>' as
    (out, in) and 'db<l>' of every layer of the module in kernel order."""
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

    kind, _, module, rows, per, _ = MODULAR_REFERENCE_CASES[case]
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


def jax_jacobian(model, case: str, inputs) -> dict:
    """The JAX warp-Jacobian kernel's numbers (interpret mode) on
    ``model``'s warp field: 'out' (P, 9) J or (P, 24) [w | v | dw | dv], and
    for sum(out * cotangent) 'dx', 'dw<l>' as (out, in) and 'db<l>' of the
    field's layers in kernel order."""
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
    alpha = JACOBIAN_CASES[case][2]
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

    from hypernerf_tpu_torch.flagship import (GRAD_REFERENCE,
                                              LEVEL_REFERENCE,
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
    parser.add_argument('--only', choices=('se3', 'jacobian'), default=None,
                        help='write the SE(3) or the Jacobian file alone')
    args = parser.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.se3_out)), exist_ok=True)
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
