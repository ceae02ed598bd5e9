"""The port's nn.Modules against the flax modules, flax weights carried over
by ``convert.params_from_jax``; and the port's own init against flax's.

Tolerance 1e-5 absolute at float32 (same fp32 products; only the summation
order differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.models import modules as jmodules
from hypernerf_tpu.models.warping import QuaternionField as JQuaternion
from hypernerf_tpu.models.warping import SE3Field as JSE3
from hypernerf_tpu.models.warping import TranslationField as JTranslation
from hypernerf_tpu_torch.convert import params_from_jax
from hypernerf_tpu_torch.models import modules
from hypernerf_tpu_torch.models.warping import (QuaternionField, SE3Field,
                                                TranslationField)

TOL = 1e-5
B, S, E = 3, 5, 8


def _np(x):
    return np.array(x, np.float32)


def _load(port, flax_params):
    port.load_state_dict(params_from_jax(jax.device_get(flax_params)))
    return port


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol)


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    pts = _np(rs.randn(B, S, 3) * 0.5)
    embed = _np(rs.randn(B, S, E) * 0.3)
    return pts, embed


@pytest.mark.parametrize('skips', [(1,), (2,), ()])
def test_mlp(skips):
    x = _np(np.random.RandomState(1).randn(B, S, 10))
    flax_mlp = jmodules.MLP(out_ch=5, depth=3, width=16, skips=skips)
    params = flax_mlp.init(jax.random.PRNGKey(0), jnp.asarray(x))['params']
    want = flax_mlp.apply({'params': params}, jnp.asarray(x))
    port = _load(modules.MLP(10, 5, depth=3, width=16, skips=skips), params)
    _close(port(torch.from_numpy(x)), want)


def test_nerf_mlp():
    rs = np.random.RandomState(2)
    x = _np(rs.randn(B, S, 21))
    cond = _np(rs.randn(B, 11))
    kw = dict(trunk_depth=3, trunk_width=32, rgb_branch_depth=2,
              rgb_branch_width=16, skips=(1,))
    flax_mlp = jmodules.NerfMLP(**kw)
    params = flax_mlp.init(jax.random.PRNGKey(1), jnp.asarray(x),
                           rgb_condition=jnp.asarray(cond))['params']
    want = flax_mlp.apply({'params': params}, jnp.asarray(x),
                          rgb_condition=jnp.asarray(cond))
    port = _load(modules.NerfMLP(21, 11, **kw), params)
    got = port(torch.from_numpy(x), torch.from_numpy(cond))
    _close(got['rgb'], want['rgb'])
    _close(got['alpha'], want['alpha'])


@pytest.mark.parametrize('out_ch,residual', [(4, False), (E, True)])
def test_hyper_sheet_mlp(out_ch, residual):
    pts, embed = _inputs(3)
    flax_mod = jmodules.HyperSheetMLP(out_ch=out_ch, depth=2, width=16,
                                      n_freq=3, skips=(1,),
                                      use_residual=residual)
    params = flax_mod.init(jax.random.PRNGKey(2), jnp.asarray(pts),
                           jnp.asarray(embed))['params']
    want = flax_mod.apply({'params': params}, jnp.asarray(pts),
                          jnp.asarray(embed))
    port = _load(modules.HyperSheetMLP(E, out_ch, depth=2, width=16,
                                       n_freq=3, skips=(1,),
                                       use_residual=residual), params)
    _close(port(torch.from_numpy(pts), torch.from_numpy(embed)), want)


def test_translation_field():
    pts, embed = _inputs(4)
    flax_mod = JTranslation(depth=2, width=16, n_freq=4, skips=(1,))
    params = flax_mod.init(jax.random.PRNGKey(3), jnp.asarray(pts),
                           jnp.asarray(embed))['params']
    # Push the warp away from the identity so the check sees the MLP.
    params = jax.tree.map(lambda a: a * 50.0 if a.size == 3 else a, params)
    want = flax_mod.apply({'params': params}, jnp.asarray(pts),
                          jnp.asarray(embed))['warped_points']
    port = _load(TranslationField(E, depth=2, width=16, n_freq=4,
                                  skips=(1,)), params)
    got = port(torch.from_numpy(pts), torch.from_numpy(embed))
    assert np.abs(np.asarray(want) - pts).max() > 1e-3
    _close(got, want)


@pytest.mark.parametrize('kind', ['se3', 'quaternion'])
@pytest.mark.parametrize('alpha', [None, 2.5])
def test_se3_field(kind, alpha):
    """The dense SE(3) / quaternion field against the flax module at float32
    with converted weights (heads scaled up so that the rotation shows), with
    and without the warp_alpha window; and its gradient with respect to the
    points, which runs through the hand-derived retraction VJP."""
    jcls, pcls = {'se3': (JSE3, SE3Field),
                  'quaternion': (JQuaternion, QuaternionField)}[kind]
    rs = np.random.RandomState(6)
    pts = rs.randn(2, 5, 3).astype(np.float32)
    emb = (rs.randn(2, 5, E) * 0.3).astype(np.float32)
    flax_mod = jcls(trunk_depth=2, trunk_width=16, min_deg=0, max_deg=4,
                    skips=(0,))
    params = flax_mod.init(jax.random.PRNGKey(3), jnp.asarray(pts),
                           jnp.asarray(emb))['params']
    params = jax.tree.map(lambda a: a * 3e3 if a.shape == (16, 3) else a,
                          params)
    extra = {'warp_alpha': None if alpha is None else jnp.float32(alpha)}
    want = flax_mod.apply({'params': params}, jnp.asarray(pts),
                          jnp.asarray(emb), extra)['warped_points']
    port = _load(pcls(E, 2, 16, 0, 4, (0,)), params)
    xt = torch.from_numpy(pts).requires_grad_()
    got = port(xt, torch.from_numpy(emb), {'warp_alpha': alpha})
    assert np.abs(np.asarray(want) - pts).max() > 1e-2
    _close(got, want)
    want_g = jax.grad(lambda p: jnp.sum(flax_mod.apply(
        {'params': params}, p, jnp.asarray(emb), extra)['warped_points']
        ** 2))(jnp.asarray(pts))
    got_g, = torch.autograd.grad((got ** 2).sum(), xt)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-4)


def test_se3_field_refuses_the_posenc_identity():
    """The field builds (A.9, ported) and runs in tensor code, as the JAX
    package runs it: it refuses the trunk kernels, whose paths all refuse
    it (``fused_se3.se3_layers``), even on a CUDA tensor."""
    from hypernerf_tpu_torch.kernels.fused_se3 import se3_layers
    field = SE3Field(E, use_posenc_identity=True)
    assert not field.runs_kernels(torch.empty(0, 3, device='meta'))
    cuda_points = type('CudaPoints', (), {'is_cuda': True})()
    assert not field.runs_kernels(cuda_points)
    with pytest.raises(ValueError, match='tensor code'):
        se3_layers(field)


def test_glo_embed_clips_ids():
    ids = np.array([[0], [3], [-2], [9]], np.int32)
    flax_mod = jmodules.GLOEmbed(num_embeddings=5, features=E)
    params = flax_mod.init(jax.random.PRNGKey(4), jnp.asarray(ids))['params']
    want = flax_mod.apply({'params': params}, jnp.asarray(ids))
    port = _load(modules.GLOEmbed(5, E), params)
    got = port(torch.from_numpy(ids.astype(np.int64)))
    _close(got, want, 0.0)
    assert got.shape == (4, E)


def _pairs():
    """(flax module, init args, port module) at widths where the moments of
    each parameter are well estimated."""
    x = jnp.zeros((2, 4, 63 + E))
    pts, emb = jnp.zeros((2, 4, 3)), jnp.zeros((2, 4, E))
    return [
        (JTranslation(depth=2, width=128, n_freq=10, skips=(0,)),
         (pts, emb), TranslationField(E, depth=2, width=128, n_freq=10,
                                      skips=(0,))),
        (jmodules.HyperSheetMLP(out_ch=64, depth=2, width=128, n_freq=7),
         (pts, emb), modules.HyperSheetMLP(E, 64, depth=2, width=128,
                                           n_freq=7)),
        (jmodules.NerfMLP(trunk_depth=2, trunk_width=256, rgb_branch_depth=1,
                          rgb_branch_width=128, skips=(0,)),
         (x, None, jnp.zeros((2, 39))),
         modules.NerfMLP(63 + E, 39, trunk_depth=2, trunk_width=256,
                         rgb_branch_depth=1, rgb_branch_width=128,
                         skips=(0,))),
        (jmodules.GLOEmbed(num_embeddings=400, features=E),
         (jnp.zeros((2, 1), jnp.int32),), modules.GLOEmbed(400, E)),
        (JSE3(trunk_depth=2, trunk_width=128, skips=(0,)), (pts, emb),
         SE3Field(E, trunk_depth=2, trunk_width=128, skips=(0,))),
    ]


def test_init_matches_flax_distributions():
    """Each parameter's spread and range from the port's own init match the
    flax init's (same distributions, different draws)."""
    torch.manual_seed(0)
    for flax_mod, args, port in _pairs():
        flax_params = params_from_jax(jax.device_get(
            jax.jit(flax_mod.init)(jax.random.PRNGKey(5), *args)['params']))
        port_params = port.state_dict()
        assert sorted(flax_params) == sorted(port_params)
        for k, want in flax_params.items():
            got = port_params[k]
            assert got.shape == want.shape, k
            if k.endswith('bias') and not want.any():
                # The SE(3) heads' biases start at zero in both packages.
                assert k.split('.')[0] in ('w_net', 'v_net'), k
                assert not got.any(), k
                continue
            if k.endswith('bias'):
                # torch's default bias: U(+-1/sqrt(fan_in)).
                fan_in = port_params[k[:-4] + 'weight'].shape[1]
                assert got.abs().max() <= fan_in ** -0.5, k
            if got.numel() < 64:
                continue
            # Spread and range within 20% (the smallest tensors compared
            # have 64 entries); means within four standard errors.
            for stat in (torch.std, lambda t: t.abs().max()):
                a, b = float(stat(got)), float(stat(want))
                assert abs(a - b) <= 0.2 * b, (k, a, b)
            sem = float(want.std()) * (2.0 / got.numel()) ** 0.5
            assert abs(float(got.mean() - want.mean())) <= 4 * sem, k
