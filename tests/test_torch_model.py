"""The port's deterministic coarse + fine render against the JAX NerfModel,
same weights (flax init carried over) and same rays; and the port's tiled
renderer.

Tolerances: 1e-5 absolute at float32 against both JAX paths, the fused one
(Pallas kernels in interpret mode) and the dense one. At bfloat16 the port
rounds where the JAX kernels do; last-bit fp32 differences that cross a
bf16 rounding boundary (2^-8 relative) are allowed 1e-3 on per-ray outputs
of order 1 (measured here: 1.2e-7).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.configs import NerfConfig
from hypernerf_tpu.models.nerf import NerfModel as JaxNerfModel
from hypernerf_tpu.ops.ray_dict import prepare_ray_dict as jax_ray_dict
from hypernerf_tpu.utils.visualization import to_uint8
from hypernerf_tpu_torch.convert import params_from_jax
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
from hypernerf_tpu_torch.training.renderer import ImageRenderer

N_RAYS = 4


def _cfg(pallas=False, **kw):
    base = dict(num_embeddings=4, glo_dim=8, num_coarse_samples=8,
                num_fine_samples=8, warp_depth=2, warp_width=16, warp_freq=4,
                hyper_sheet_depth=2, hyper_sheet_width=16,
                hyper_sheet_freq=3, xyz_freq=4, hyper_freq=2, dir_freq=2,
                trunk_depth=2, trunk_width=32, rgb_branch_depth=1,
                rgb_branch_width=16, skips=(1,), noise_std=None,
                compute_dtype='float32', use_pallas=pallas,
                use_pallas_fields=pallas, use_pallas_level=pallas,
                pallas_interpret=pallas, pallas_tile=8, pallas_bwd_tile=8)
    base.update(kw)
    return NerfConfig(**base)


def _rays(n=N_RAYS, seed=0):
    rs = np.random.RandomState(seed)
    o = (rs.randn(n, 3) * 0.1).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d, np.full((n, 1), 0.2, np.float32),
                           np.full((n, 1), 2.0, np.float32),
                           rs.randint(0, 4, (n, 1)).astype(np.float32)], 1)


@functools.cache
def _flax_params():
    model = JaxNerfModel(_cfg())
    return jax.device_get(jax.jit(model.init)(
        {'params': jax.random.PRNGKey(0)},
        jax_ray_dict(jnp.asarray(_rays())))['params'])


def _port_model(dtype='float32'):
    model = NerfModel(_cfg(compute_dtype=dtype))
    model.load_state_dict(params_from_jax(_flax_params()))
    return model


def _jax_render(cfg, rays):
    model = JaxNerfModel(cfg)
    out = jax.jit(lambda p, r: model.apply({'params': p}, r,
                                           deterministic=True))(
        _flax_params(), jax_ray_dict(jnp.asarray(rays)))
    return jax.device_get(out)


@pytest.mark.parametrize('pallas,dtype,tol', [
    (True, 'float32', 1e-5),
    (False, 'float32', 1e-5),
    (True, 'bfloat16', 1e-3),
], ids=['fused-f32', 'dense-f32', 'fused-bf16'])
def test_render_matches_jax_model(pallas, dtype, tol):
    rays = _rays()
    want = _jax_render(_cfg(pallas, compute_dtype=dtype), rays)
    with torch.no_grad():
        got = _port_model(dtype)(prepare_ray_dict(torch.from_numpy(rays)))
    assert sorted(got) == sorted(want) == ['coarse', 'fine']
    for level in want:
        assert sorted(got[level]) == sorted(want[level])
        for k, v in want[level].items():
            np.testing.assert_allclose(got[level][k].numpy(), v, rtol=0,
                                       atol=tol, err_msg=f'{level}/{k}')


def test_image_renderer_pads_and_quantizes():
    """13 rays over chunks of 4: padded by the last ray, sliced back; the
    uint8 output is bit-equal to utils.visualization.to_uint8."""
    model = _port_model()
    rays = _rays(13, seed=1)
    floats = ImageRenderer(model, chunk=4)(rays)
    with torch.no_grad():
        whole = model(prepare_ray_dict(torch.from_numpy(rays)))
    assert sorted(floats) == ['coarse', 'fine']
    for level, res in floats.items():
        assert sorted(res) == ['acc', 'depth', 'med_depth', 'rgb']
        for k, v in res.items():
            assert v.shape[0] == 13
            np.testing.assert_allclose(v, whole[level][k].numpy(), rtol=0,
                                       atol=1e-6)
    u8 = ImageRenderer(model, chunk=4, keep=('rgb',), levels=('fine',),
                       quantize=True)(rays)
    assert list(u8) == ['fine'] and list(u8['fine']) == ['rgb']
    assert u8['fine']['rgb'].dtype == np.uint8
    np.testing.assert_array_equal(u8['fine']['rgb'],
                                  to_uint8(floats['fine']['rgb']))


@pytest.mark.parametrize('override', [
    dict(warp_field_type='se3', use_original_embed=False),
    dict(hyper_slice_method='axis_aligned_plane'),
    dict(use_original_embed=False), dict(use_occupancy_grid=True),
    dict(use_warp=False, hyper_slice_method='none', use_viewdirs=False)],
    ids=['se3', 'plane', 'anneal', 'occupancy', 'static'])
def test_unported_configs_raise(override):
    """(The static NeRF itself is ported; without view directions on its
    template it is not yet. The SE(3) warp is ported with the original
    template encoding; with the annealed one, as it is usually trained, not
    yet.)"""
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        NerfModel(_cfg(**override))
