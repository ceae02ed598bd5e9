"""The train CLI's default sample count, 64 coarse + 128 fine
(``--N_importance 128``; ``python -m hypernerf_tpu_torch.bench --n_fine
128``), against the JAX package at narrow widths, on the CPU: the fine
level at S = 192 and the compositing forward's fine draw at N = 128 from 64
coarse samples (a z_union of 192, not a power of two).

- the plain compositing forward with the fine draw at S = 64, N = 128
  against the JAX kernel in interpret mode (1e-5 on every output, as
  ``test_torch_fused_composite.py``);
- the deterministic render against the JAX model on its kernels in
  interpret mode (1e-5, as ``test_torch_model.py``);
- one stochastic forward's loss (1e-5) and gradients (1e-4 of each
  parameter's largest entry) with the JAX model's own draws passed in (as
  ``test_torch_train_step.py``), the JAX model on its kernels too.

About 25 s on one worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hypernerf_tpu.configs import NerfConfig
from hypernerf_tpu.models.nerf import NerfModel as JaxNerfModel
from hypernerf_tpu.ops.pallas.fused_composite import (CompositeSpec,
                                                      fused_composite)
from hypernerf_tpu.ops.ray_dict import prepare_ray_dict as jax_ray_dict
from hypernerf_tpu.ops.sampling import sorted_uniform
from hypernerf_tpu.training.losses import mse_loss as jax_mse_loss
from hypernerf_tpu_torch import configs as port_configs
from hypernerf_tpu_torch.convert import params_from_jax, params_to_jax
from hypernerf_tpu_torch.kernels import fused_composite as port_composite
from hypernerf_tpu_torch.kernels import fused_composite_plain
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
from hypernerf_tpu_torch.training.losses import mse_loss

S64, N128, R = 64, 128, 4
ARCH = dict(num_embeddings=4, glo_dim=8, num_coarse_samples=S64,
            num_fine_samples=N128, warp_depth=2, warp_width=16, warp_freq=4,
            hyper_sheet_depth=2, hyper_sheet_width=16, hyper_sheet_freq=3,
            xyz_freq=4, hyper_freq=2, dir_freq=2, trunk_depth=2,
            trunk_width=32, rgb_branch_depth=1, rgb_branch_width=16,
            skips=(1,), compute_dtype='float32')


def test_plain_composite_with_a_fine_draw_of_128_matches_jax():
    rs = np.random.RandomState(7)
    packed = rs.randn(8 * S64, 4).astype(np.float32)
    packed[:, 3] -= 3.0
    z = np.sort(rs.rand(8, S64).astype(np.float32) * 3 + 0.5, axis=-1)
    dirs = rs.randn(8, 3).astype(np.float32)
    u = np.array(sorted_uniform(jax.random.PRNGKey(7), 8, N128))
    spec = CompositeSpec(samples=S64, rays_per_tile=8, fine_samples=N128,
                         interpret=True)
    packed8 = np.concatenate([packed, np.zeros_like(packed)], -1)
    want = fused_composite(spec, jnp.asarray(packed8), jnp.asarray(z),
                           jnp.asarray(dirs), u=jnp.asarray(u))
    calls = fused_composite_plain.calls
    got = port_composite(torch.from_numpy(packed), torch.from_numpy(z),
                         torch.from_numpy(dirs), torch.from_numpy(u))
    assert fused_composite_plain.calls == calls + 1
    assert got['z_union'].shape == (8, S64 + N128)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


def _rays(seed=0):
    rs = np.random.RandomState(seed)
    o = (rs.randn(R, 3) * 0.1).astype(np.float32)
    d = rs.randn(R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((R, 1), 0.2, np.float32),
                           np.full((R, 1), 2.0, np.float32),
                           rs.randint(0, 4, (R, 1)).astype(np.float32)], 1)
    return rays, rs.rand(R, 3).astype(np.float32)


def _jax_cfg(**kw):
    return NerfConfig(use_pallas=True, use_pallas_fields=True,
                      use_pallas_level=True, pallas_interpret=True,
                      pallas_tile=256, pallas_bwd_tile=256,
                      **{**ARCH, **kw})


def _flax_params():
    """flax init with the warp and sheet heads scaled up, as
    ``test_torch_train_step.py`` scales them, so both fields carry
    gradient of ordinary size."""
    model = JaxNerfModel(NerfConfig(use_pallas=False, noise_std=None,
                                    **ARCH))
    params = jax.device_get(jax.jit(model.init)(
        {'params': jax.random.PRNGKey(0)},
        jax_ray_dict(jnp.asarray(_rays()[0])))['params'])
    params = jax.tree.map(np.array, params)
    params['warp_field']['mlp']['logit']['kernel'] *= 300.0
    params['hyper_sheet_mlp']['mlp']['logit']['kernel'] *= 1e4
    return params


def _port_model(params, **kw):
    model = NerfModel(port_configs.NerfConfig(**{**ARCH, **kw}))
    model.load_state_dict(params_from_jax(params))
    return model


def _flat(tree, prefix=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f'{prefix}{k}/')
        else:
            yield f'{prefix}{k}', np.asarray(v)


def test_render_at_64_plus_128_matches_jax():
    rays, _ = _rays()
    params = _flax_params()
    jmodel = JaxNerfModel(_jax_cfg(noise_std=None))
    want = jax.device_get(jax.jit(lambda p, r: jmodel.apply(
        {'params': p}, r, deterministic=True))(
            params, jax_ray_dict(jnp.asarray(rays))))
    with torch.no_grad():
        got = _port_model(params, noise_std=None)(
            prepare_ray_dict(torch.from_numpy(rays)))
    assert got['fine']['rgb'].shape == (R, 3)
    assert sorted(got) == sorted(want) == ['coarse', 'fine']
    for level in want:
        assert sorted(got[level]) == sorted(want[level])
        for k, v in want[level].items():
            np.testing.assert_allclose(got[level][k].numpy(), v, rtol=0,
                                       atol=1e-5, err_msg=f'{level}/{k}')


def test_stochastic_loss_and_gradients_at_64_plus_128_match_jax():
    rays, rgbs = _rays(1)
    params = _flax_params()
    jmodel = JaxNerfModel(_jax_cfg(noise_std=0.7))
    k_sample, k_noise = jax.random.split(jax.random.PRNGKey(3))

    def jax_loss(p):
        out = jmodel.apply({'params': p}, jax_ray_dict(jnp.asarray(rays)),
                           rngs={'sampling': k_sample,
                                 'sigma_noise': k_noise})
        return jax_mse_loss(out, jnp.asarray(rgbs))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)

    def keys(m):
        return (m.make_rng('sampling'), m.make_rng('sampling'),
                m.make_rng('sigma_noise'), m.make_rng('sigma_noise'))

    # The JAX model's own draws, in its order (test_torch_train_step.py).
    k_coarse, k_fine, k_n0, k_n1 = jmodel.apply(
        {'params': params}, rngs={'sampling': k_sample,
                                  'sigma_noise': k_noise}, method=keys)
    draws = {k: torch.from_numpy(np.array(v)) for k, v in {
        't_rand': jax.random.uniform(k_coarse, (R, S64), jnp.float32),
        'fine_u': sorted_uniform(k_fine, R, N128),
        'noise_coarse': jax.random.normal(k_n0, (R, S64), jnp.float32),
        'noise_fine': jax.random.normal(k_n1, (R, S64 + N128),
                                        jnp.float32)}.items()}
    model = _port_model(params, noise_std=0.7).train()
    out = model(prepare_ray_dict(torch.from_numpy(rays)),
                deterministic=False, draws=draws)
    loss = mse_loss(out, torch.from_numpy(rgbs))
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    loss.backward()
    got = dict(_flat(params_to_jax({k: p.grad for k, p in
                                    model.named_parameters()})))
    want = dict(_flat(jax.device_get(want_grads)))
    assert sorted(got) == sorted(want)
    for k, b in want.items():
        scale = max(np.abs(b).max(), 1e-12)
        assert np.abs(got[k] - b).max() / scale <= 1e-4, k
        assert np.abs(got[k]).max() > 0, k
