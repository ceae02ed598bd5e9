"""The level kernel's plain version against the JAX Pallas level kernel
(``fused_level``, interpret mode, ray-native) and the composed flax modules.

Tolerances: 1e-5 absolute at float32 (same fp32 math, other summation
order). At bfloat16 both round at the same points (encodings, hidden
activations, biases, conditions), so they differ only where a last-bit fp32
difference moves a value across a bf16 rounding boundary (2^-8 relative):
allowed 1e-2 absolute on outputs of order 1 and a mean below 1e-4 (on the
CPU the two agree bit for bit here).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.models.modules import HyperSheetMLP, NerfMLP
from hypernerf_tpu.models.warping import TranslationField
from hypernerf_tpu.ops.pallas.fused_field import mlp_params_to_list
from hypernerf_tpu.ops.pallas.fused_level import FusedLevelSpec, fused_level
from hypernerf_tpu.ops.pallas.fused_mlp import nerf_mlp_params_to_list
from hypernerf_tpu.ops.posenc import posenc_orig
from hypernerf_tpu_torch.convert import params_from_jax
from hypernerf_tpu_torch.kernels import Level, fused_level as port_level
from hypernerf_tpu_torch.kernels import fused_level_plain
from hypernerf_tpu_torch.models import modules
from hypernerf_tpu_torch.models.warping import TranslationField as PWarp

R, S, E, H, C = 3, 8, 8, 4, 11


def _spec(dtype):
    return FusedLevelSpec(
        embed_ch=E, warp_depth=2, warp_width=16, warp_freq=4,
        hyper_depth=2, hyper_width=16, hyper_sheet_freq=3, hyper_out=H,
        xyz_freq=4, hyper_freq=2, trunk_depth=3, trunk_width=32,
        rgb_depth=2, rgb_width=16, rgb_cond_ch=C, alpha_cond_ch=0,
        skips=(1,), tile=8, bwd_tile=8, tmpl_bwd_tile=8, interpret=True,
        compute_dtype=dtype, cond_samples=S)


@functools.cache
def _setup(seed=0):
    rs = np.random.RandomState(seed)
    z = np.sort(rs.rand(R, S).astype(np.float32) * 1.5 + 0.2, axis=-1)
    o = (rs.randn(R, 3) * 0.2).astype(np.float32)
    d = rs.randn(R, 3).astype(np.float32)
    embed = (rs.randn(R, E) * 0.3).astype(np.float32)
    rgbc = rs.randn(R, C).astype(np.float32)
    pts = jnp.asarray(o[:, None] + z[..., None] * d[:, None])
    emb_b = jnp.broadcast_to(jnp.asarray(embed)[:, None], (R, S, E))
    warp = TranslationField(depth=2, width=16, n_freq=4, skips=(1,))
    hyper = HyperSheetMLP(out_ch=H, depth=2, width=16, n_freq=3, skips=(1,))
    tmpl = NerfMLP(trunk_depth=3, trunk_width=32, rgb_branch_depth=2,
                   rgb_branch_width=16, skips=(1,))
    wp = warp.init(jax.random.PRNGKey(0), pts, emb_b)['params']
    # A visible warp: scale the U(0, 1e-4) logit up.
    wp = jax.tree.map(lambda a: a * 300.0 if a.shape == (16, 3) else a, wp)
    hp = hyper.init(jax.random.PRNGKey(1), pts, emb_b)['params']
    hp = jax.tree.map(lambda a: a * 1e4 if a.shape == (16, H) else a, hp)
    feat = jnp.zeros((R, S, 3 * 9 + H * 5))
    tp = tmpl.init(jax.random.PRNGKey(2), feat,
                   rgb_condition=jnp.asarray(rgbc))['params']
    data = dict(z=z, o=o, d=d, embed=embed, rgbc=rgbc)
    return data, (warp, wp), (hyper, hp), (tmpl, tp)


def _port_level(wp, hp, tp, dtype):
    dt = modules.torch_dtype(dtype)
    warp = PWarp(E, 2, 16, 4, (1,), dtype=dt)
    hyper = modules.HyperSheetMLP(E, H, 2, 16, 3, (1,), dtype=dt)
    tmpl = modules.NerfMLP(3 * 9 + H * 5, C, 3, 32, 2, 16, skips=(1,),
                           dtype=dt)
    for mod, p in ((warp, wp), (hyper, hp), (tmpl, tp)):
        mod.load_state_dict(params_from_jax(jax.device_get(p)))
    return Level(warp, hyper, tmpl, 4, 2)


def _jax_kernel(data, wp, hp, tp, dtype):
    packed = fused_level(
        _spec(dtype), None, jnp.asarray(data['embed']),
        jnp.asarray(data['rgbc']), None, mlp_params_to_list(wp['mlp']),
        mlp_params_to_list(hp['mlp']), nerf_mlp_params_to_list(tp),
        origins=jnp.asarray(data['o']), directions=jnp.asarray(data['d']),
        z_vals=jnp.asarray(data['z']), return_packed=True)
    return np.asarray(packed)[:, :4]


def _port(level, data):
    args = [torch.from_numpy(data[k]) for k in ('z', 'o', 'd', 'embed',
                                                  'rgbc')]
    return port_level(level, *args).detach().numpy()


@pytest.mark.parametrize('dtype,atol,mean_tol', [('float32', 1e-5, 1e-5),
                                                 ('bfloat16', 1e-2, 1e-4)])
def test_plain_level_matches_jax_kernel(dtype, atol, mean_tol):
    data, (_, wp), (_, hp), (_, tp) = _setup()
    want = _jax_kernel(data, wp, hp, tp, dtype)
    calls = fused_level_plain.calls
    got = _port(_port_level(wp, hp, tp, dtype), data)
    assert fused_level_plain.calls == calls + 1  # CPU tensors: the plain path
    assert got.shape == (R * S, 4)
    diff = np.abs(got - want)
    assert diff.max() <= atol, diff.max()
    assert diff.mean() <= mean_tol, diff.mean()


def test_plain_level_matches_flax_composition():
    """The dense JAX modules chained by hand at float32."""
    data, (warp, wp), (hyper, hp), (tmpl, tp) = _setup()
    pts = jnp.asarray(data['o'][:, None]
                      + data['z'][..., None] * data['d'][:, None])
    emb_b = jnp.broadcast_to(jnp.asarray(data['embed'])[:, None], (R, S, E))
    warped = warp.apply({'params': wp}, pts, emb_b)['warped_points']
    hyper_pts = hyper.apply({'params': hp}, pts, emb_b)
    feat = jnp.concatenate([posenc_orig(warped, 4),
                            posenc_orig(hyper_pts, 2)], -1)
    raw = tmpl.apply({'params': tp}, feat,
                     rgb_condition=jnp.asarray(data['rgbc']))
    want = np.concatenate([np.asarray(raw['rgb']), np.asarray(raw['alpha'])],
                          -1).reshape(R * S, 4)
    got = _port(_port_level(wp, hp, tp, 'float32'), data)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_packed_weights_follow_parameter_updates():
    """The level kernel's cached bf16 blobs are repacked after an in-place
    update of a parameter and after load_state_dict."""
    from hypernerf_tpu_torch.flagship import flagship_model
    from hypernerf_tpu_torch.kernels.fused_level import pack_level

    def fresh(model):  # a copy's parameters have new storage: no cache hit
        return pack_level(copy.deepcopy(model).level('coarse'))

    model = flagship_model('cpu', seed=0)
    level = model.level('coarse')
    w0, b0, shapes = pack_level(level)
    assert sum(n * k for n, k in shapes) == w0.numel()
    assert sum(n for n, _ in shapes) == b0.numel()
    assert pack_level(level)[0] is w0  # unchanged parameters: the cache
    with torch.no_grad():
        level.warp.mlp.logit.weight.add_(0.5)
        level.template.alpha_head.bias.sub_(0.25)
    w1, b1, _ = pack_level(level)
    assert not torch.equal(w1, w0) and not torch.equal(b1, b0)
    assert all(torch.equal(a, b) for a, b in zip((w1, b1), fresh(model)))
    model.load_state_dict(flagship_model('cpu', seed=1).state_dict())
    w2, b2, _ = pack_level(level)
    assert not torch.equal(w2, w1)
    assert all(torch.equal(a, b) for a, b in zip((w2, b2), fresh(model)))


def test_stored_jax_level_reference():
    """tests/data/fused_level_jax_ref.npz, what chip_smoke.py holds the CUDA
    level kernel to on the card, is the JAX kernel's output (interpret mode,
    flagship widths, bf16) at the numpy probe weights and its stored inputs,
    and the port's plain level matches it. The bf16 tolerance above holds
    both: a JAX or torch of another version may sum in another order."""
    from hypernerf_tpu_torch.flagship import (LEVEL_REFERENCE_CASES,
                                              probe_inputs,
                                              read_level_reference)
    from tools.make_level_reference import jax_level, probe_model
    model = probe_model()
    reference = read_level_reference()
    for name, n_rays, samples, seed in LEVEL_REFERENCE_CASES:
        inputs, want = reference[name]
        assert want.shape == (n_rays * samples, 4)
        for k, v in probe_inputs(n_rays, samples, seed).items():
            np.testing.assert_allclose(inputs[k], v, rtol=0, atol=1e-6)
        args = [torch.from_numpy(v) for v in inputs.values()]
        with torch.no_grad():
            port = port_level(model.level(name), *args).numpy()
        for got in (jax_level(model, name, inputs), port):
            diff = np.abs(got - want)
            assert diff.max() <= 1e-2, (name, diff.max())
            assert diff.mean() <= 1e-4, (name, diff.mean())
