"""The SE(3) and quaternion models as a whole: the port's NerfModel against
the JAX NerfModel on the same converted weights, rays and draws, at float32
with the JAX kernels in interpret mode — on the level path (the level kernel
with the in-kernel retraction, then the compositing kernel) and on the
per-module path (``use_pallas_level=False``, separate GLO tables,
``return_points``, ``query_sigma``: the trunk kernel, the retraction outside
it, the sheet's field kernel, the template kernel), with ``warp_alpha`` set
and None. The loss, the gradients and three Adam steps are in
``test_torch_se3_train_step.py``.

Tolerance (fp32 both ways, other summation orders; that of
``test_torch_modular_model.py``): per-ray and per-sample outputs 1e-5
absolute.
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
from hypernerf_tpu_torch import configs as port_configs
from hypernerf_tpu_torch import kernels as K
from hypernerf_tpu_torch.convert import params_from_jax
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.models.warping import QuaternionField, SE3Field
from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
from hypernerf_tpu_torch.training.train_state import compute_extra_params
from tests.test_torch_train_step import (ARCH, _batch, _jax_draws,
                                         _step_keys)

KINDS = ['se3', 'quaternion']
# path -> (overrides of the configuration, the JAX model takes its level
# kernel).
PATHS = {'level': ({}, True),
         'modules': ({}, False),
         'split_glo': (dict(share_glo=False), True)}
TOL = 1e-5
WARP_ALPHA = 1.4  # of 4 bands


def _arch(kind, path):
    return {**ARCH, 'warp_field_type': kind, 'warp_min_deg': 0,
            'warp_max_deg': 4, **PATHS[path][0]}


def _jax_cfg(kind, path):
    return NerfConfig(use_pallas=True, use_pallas_fields=True,
                      use_pallas_level=PATHS[path][1], pallas_interpret=True,
                      pallas_tile=8, pallas_bwd_tile=8, **_arch(kind, path))


def _port_cfg(kind, path):
    return port_configs.NerfConfig(**_arch(kind, path))


@functools.cache
def _flax_params(kind, path):
    """flax init with the w, v and sheet heads scaled up so that the rotation
    and the sheet move the output and carry gradient."""
    model = JaxNerfModel(NerfConfig(use_pallas=False, **_arch(kind, path)))
    params = jax.device_get(jax.jit(model.init)(
        {'params': jax.random.PRNGKey(0)},
        jax_ray_dict(jnp.asarray(_batch()[0])))['params'])
    params = jax.tree.map(np.array, params)
    for head in ('w_net', 'v_net'):
        params['warp_field'][head]['logit']['kernel'] *= 1e3
    params['hyper_sheet_mlp']['mlp']['logit']['kernel'] *= 1e4
    return params


def _port_model(kind, path):
    model = NerfModel(_port_cfg(kind, path))
    model.load_state_dict(params_from_jax(_flax_params(kind, path)))
    return model


def _extra(alpha):
    return ({'warp_alpha': None if alpha is None else jnp.float32(alpha)},
            {'warp_alpha': alpha})


def _assert_outputs_close(got, want, tol=TOL):
    assert sorted(got) == sorted(want)
    for level in want:
        assert sorted(got[level]) == sorted(want[level]), level
        for k, v in want[level].items():
            a = got[level][k].detach().numpy()
            assert a.shape == np.shape(v), (level, k, a.shape, np.shape(v))
            np.testing.assert_allclose(a, v, rtol=0, atol=tol,
                                       err_msg=f'{level}/{k}')


def _render_both(kind, path, alpha=None, **kw):
    rays, _ = _batch()
    jextra, pextra = _extra(alpha)
    jmodel = JaxNerfModel(_jax_cfg(kind, path))
    want = jax.device_get(jmodel.apply(
        {'params': _flax_params(kind, path)},
        jax_ray_dict(jnp.asarray(rays)), jextra, deterministic=True, **kw))
    with torch.no_grad():
        got = _port_model(kind, path)(
            prepare_ray_dict(torch.from_numpy(rays)), deterministic=True,
            extra_params=pextra, **kw)
    return got, want


@pytest.mark.parametrize('kind,path,alpha', [
    (kind, path, None) for kind in KINDS for path in sorted(PATHS)] + [
    ('se3', 'level', WARP_ALPHA), ('se3', 'modules', WARP_ALPHA),
    ('quaternion', 'level', WARP_ALPHA),
    ('quaternion', 'split_glo', WARP_ALPHA)])
def test_deterministic_render_matches_jax(kind, path, alpha):
    got, want = _render_both(kind, path, alpha)
    assert sorted(want) == ['coarse', 'fine']
    _assert_outputs_close(got, want)


@pytest.mark.parametrize('kind', KINDS)
def test_the_warp_and_its_window_are_visible(kind):
    """The rotation moves the render, and so does the window on its bands:
    the comparisons above are not of near-identity warps."""
    rays = prepare_ray_dict(torch.from_numpy(_batch()[0]))

    def render(k, **kw):
        with torch.no_grad():
            return _port_model(k, 'level')(rays, **kw)['fine']

    base = render(kind)
    windowed = render(kind, extra_params={'warp_alpha': WARP_ALPHA})
    assert (base['rgb'] - windowed['rgb']).abs().max() > 1e-3
    other = render([k for k in KINDS if k != kind][0])
    assert (base['rgb'] - other['rgb']).abs().max() > 1e-4
    pts = render(kind, return_points=True)
    assert (pts['warped_points'][..., :3] - pts['points']).abs().max() > 1e-2


@pytest.mark.parametrize('path', ['level', 'split_glo'])
@pytest.mark.parametrize('kind', KINDS)
def test_stochastic_forward_matches_jax(kind, path):
    """Stratified jitter, the ascending fine u and the sigma noise of both
    levels, all with the JAX model's own draws."""
    rays, _ = _batch()
    jmodel = JaxNerfModel(_jax_cfg(kind, path))
    params = _flax_params(kind, path)
    k_sample, k_noise = _step_keys(jax.random.PRNGKey(2), 0)
    want = jax.device_get(jmodel.apply(
        {'params': params}, jax_ray_dict(jnp.asarray(rays)),
        rngs={'sampling': k_sample, 'sigma_noise': k_noise}))
    draws = _jax_draws(jmodel, params, k_sample, k_noise)
    with torch.no_grad():
        got = _port_model(kind, path)(
            prepare_ray_dict(torch.from_numpy(rays)), deterministic=False,
            draws=draws)
    _assert_outputs_close(got, want)


@pytest.mark.parametrize('kind,alpha', [('se3', None), ('se3', WARP_ALPHA),
                                        ('quaternion', WARP_ALPHA)])
def test_return_points_matches_jax(kind, alpha):
    """'points', 'warped_points' (with the hyper coordinates) and
    'med_points'; the request alone leaves the level kernel's branch."""
    got, want = _render_both(kind, 'level', alpha, return_points=True)
    for level, s in (('coarse', 8), ('fine', 16)):
        assert got[level]['points'].shape == (8, s, 3)
        assert got[level]['warped_points'].shape == (8, s, 7)
        assert got[level]['med_points'].shape == (8, 1, 7)
    _assert_outputs_close(got, want)


@pytest.mark.parametrize('path,alpha', [('level', None),
                                        ('split_glo', WARP_ALPHA)])
@pytest.mark.parametrize('kind', KINDS)
def test_query_sigma_matches_jax(kind, path, alpha):
    """One sample per row and a row count (13) no tile divides."""
    rs = np.random.RandomState(4)
    pts = (rs.randn(13, 3) * 0.5).astype(np.float32)
    ids = rs.randint(0, 4, (13, 1)).astype(np.int32)
    jextra, pextra = _extra(alpha)
    jmodel = JaxNerfModel(_jax_cfg(kind, path))
    want = np.asarray(jmodel.apply(
        {'params': _flax_params(kind, path)}, jnp.asarray(pts),
        jnp.asarray(ids), jextra, method=JaxNerfModel.query_sigma))
    with torch.no_grad():
        got = _port_model(kind, path).query_sigma(
            torch.from_numpy(pts), torch.from_numpy(ids).long(), pextra)
    assert got.shape == (13,) and (got >= 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_level_kernel_branch_is_taken_exactly_where_the_gate_holds():
    """A shared-GLO ``se3`` / ``quaternion`` call goes through ``fused_level``
    and ``fused_composite`` (on CPU tensors: one plain call per level each)
    and never through the trunk alone; asked for points, or with two GLO
    tables, it runs module by module: the trunk once per level."""
    rays, _ = _batch()
    counters = (K.fused_level_plain, K.fused_composite_plain)

    def calls(kind, path, **kw):
        before = [fn.calls for fn in counters]
        with torch.no_grad():
            _port_model(kind, path)(
                prepare_ray_dict(torch.from_numpy(rays)), **kw)
        return tuple(fn.calls - b for fn, b in zip(counters, before))

    for kind in KINDS:
        assert calls(kind, 'level') == (2, 2)
        assert calls(kind, 'level', return_points=True) == (0, 0)
        assert calls(kind, 'split_glo') == (0, 0)


def test_model_builds_the_field_the_configuration_names():
    """``warp_field_type`` picks the field; its parameters carry the flax
    names; a model constructs at the flagship's widths; the train step's
    extra parameters are empty with the original template encoding; the
    template's windowed encoding still raises, naming its ROADMAP item."""
    from hypernerf_tpu_torch.flagship import CONFIGS, flagship_config
    for kind, cls in (('se3', SE3Field), ('quaternion', QuaternionField)):
        model = NerfModel(_port_cfg(kind, 'level'))
        assert type(model.warp_field) is cls
        assert sorted(params_from_jax(_flax_params(kind, 'level'))) == \
            sorted(model.state_dict())
        assert {k.split('.')[1] for k in model.state_dict()
                if k.startswith('warp_field.')} == {'trunk', 'w_net', 'v_net'}
        assert kind in CONFIGS
        full = NerfModel(flagship_config(kind))
        assert full.warp_field.trunk.hidden_0.in_features == 56
        assert full.warp_field.trunk.logit.out_features == 128
        assert not full.warp_field.w_net.logit.bias.any()
        assert compute_extra_params(flagship_config(kind),
                                    port_configs.TrainConfig(), 5) == {}
    with pytest.raises(NotImplementedError, match='A.9'):
        NerfModel(port_configs.NerfConfig(**{**_arch('se3', 'level'),
                                             'use_original_embed': False}))
