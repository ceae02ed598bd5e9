#!/usr/bin/env python
"""Write the JAX level kernel's outputs for the flagship at the probe
weights, the reference against which ``chip_smoke.py`` holds the CUDA level
kernel on a card that has no JAX.

  python tools/make_level_reference.py \
      [--out tests/data/fused_level_jax_ref.npz]

The weights are ``hypernerf_tpu_torch.flagship.load_probe_weights`` (numpy,
seed 0), which the card redraws bit for bit; the inputs
(``flagship.probe_inputs``) are stored in the file beside the outputs. The
outputs come from ``hypernerf_tpu``'s ``fused_level`` (the TPU kernel) in
Pallas interpret mode on the CPU, in bf16 as the flagship runs.
``tests/test_torch_fused_level.py`` recomputes them and checks the file.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def probe_model():
    from hypernerf_tpu_torch.flagship import flagship_model, load_probe_weights
    return load_probe_weights(flagship_model('cpu'))


def jax_level(model, level: str, inputs) -> 'np.ndarray':
    """(R * S, 4) [rgb logits | raw sigma] of the JAX level kernel with the
    weights of ``model``'s ``level`` ('coarse' or 'fine')."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hypernerf_tpu.ops.pallas.fused_field import mlp_params_to_list
    from hypernerf_tpu.ops.pallas.fused_level import (FusedLevelSpec,
                                                      fused_level)
    from hypernerf_tpu.ops.pallas.fused_mlp import nerf_mlp_params_to_list
    from hypernerf_tpu_torch.convert import params_to_jax

    params = params_to_jax(model.state_dict())
    cfg = model.config
    r, s = inputs['z_vals'].shape
    spec = FusedLevelSpec(
        embed_ch=cfg.glo_dim, warp_depth=cfg.warp_depth,
        warp_width=cfg.warp_width, warp_freq=cfg.warp_freq,
        hyper_depth=cfg.hyper_sheet_depth, hyper_width=cfg.hyper_sheet_width,
        hyper_sheet_freq=cfg.hyper_sheet_freq,
        hyper_out=cfg.hyper_slice_out_dim, xyz_freq=cfg.xyz_freq,
        hyper_freq=cfg.hyper_freq, trunk_depth=cfg.trunk_depth,
        trunk_width=cfg.trunk_width, rgb_depth=cfg.rgb_branch_depth,
        rgb_width=cfg.rgb_branch_width,
        rgb_cond_ch=inputs['rgb_cond'].shape[1], alpha_cond_ch=0,
        skips=tuple(cfg.skips), tile=512, interpret=True,
        compute_dtype=cfg.compute_dtype, cond_samples=s)
    a = {k: jnp.asarray(v) for k, v in inputs.items()}
    packed = fused_level(
        spec, None, a['embed'], a['rgb_cond'], None,
        mlp_params_to_list(params['warp_field']['mlp']),
        mlp_params_to_list(params['hyper_sheet_mlp']['mlp']),
        nerf_mlp_params_to_list(params[f'nerf_{level}']),
        origins=a['origins'], directions=a['directions'],
        z_vals=a['z_vals'], return_packed=True)
    return np.asarray(jax.device_get(packed))[:, :4]


def main():
    import numpy as np

    from hypernerf_tpu_torch.flagship import (LEVEL_REFERENCE,
                                              LEVEL_REFERENCE_CASES,
                                              probe_inputs)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--out', default=LEVEL_REFERENCE)
    args = parser.parse_args()
    model = probe_model()
    arrays = {}
    for name, n_rays, samples, seed in LEVEL_REFERENCE_CASES:
        inputs = probe_inputs(n_rays, samples, seed)
        arrays.update({f'{name}/{k}': v for k, v in inputs.items()})
        arrays[f'{name}/out'] = jax_level(model, name, inputs)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(args.out)


if __name__ == '__main__':
    main()
