"""The level kernels' plain versions with the SE(3) and quaternion warps,
forward and backward, against the JAX Pallas level kernel (``fused_level``
with ``warp_type='se3'`` / ``'quaternion'``, interpret mode) in each of its
backward schedules, against autograd and the composed flax modules, at zero
rotation, and against the stored JAX numbers
(``tests/data/fused_se3_jax_ref.npz``). The translation level's cases, and
the inputs, modules and helpers these build on, are
``tests/test_torch_fused_level.py``'s.

Tolerances: those of ``tests/test_torch_fused_level.py``, with float32
gradients at 1e-4 of each gradient's largest entry (below).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.ops.pallas.fused_field import mlp_params_to_list
from hypernerf_tpu.ops.pallas.fused_level import fused_level
from hypernerf_tpu.ops.pallas.fused_mlp import nerf_mlp_params_to_list
from hypernerf_tpu.ops.posenc import posenc_orig
from hypernerf_tpu_torch.convert import params_from_jax
from hypernerf_tpu_torch.kernels import fused_level as port_level
from hypernerf_tpu_torch.kernels import (fused_fields_bwd_plain,
                                         fused_level_plain,
                                         fused_template_bwd_plain)
from hypernerf_tpu_torch.kernels.fused_level import (_level_params,
                                                     level_layers)
from hypernerf_tpu_torch.models import modules
from tests.test_torch_fused_level import (E, FLAGSHIP_GRAD_MAX, R, S,
                                          SCHEDULES, _INPUTS,
                                          _assert_grads_close, _cotangent,
                                          _flax_grads_to_list, _port,
                                          _port_level, _setup, _spec)


# -- the SE(3) and quaternion warps --------------------------------------------
#
# The same level with the warp field's trunk and the in-kernel retraction
# (``warp_type='se3'`` / ``'quaternion'``, the warp window row always
# threaded, as the JAX model does). float32 gradients: 1e-4 of each
# gradient's largest entry where the translation level has 1e-5 — the
# retraction's sin / cos and divisions by the angle differ in their last bits
# between the two libraries, and the gradient with respect to the points
# carries those through the template's bands.

SE3_GRAD_TOL = {'float32': 1e-4, 'bfloat16': 2e-2}
WARP_ALPHA = 1.4


def _se3_spec(kind, dtype, **kw):
    return _spec(dtype)._replace(warp_type=kind, se3_min_deg=0, se3_max_deg=4,
                                 warp_windowed=True, **kw)


@functools.cache
def _se3_setup(kind):
    """The translation setup's inputs, sheet and template with an SE(3) or
    quaternion warp whose heads are scaled up so that the rotation shows."""
    from hypernerf_tpu.models.warping import QuaternionField, SE3Field
    data, _, hyper, tmpl = _setup()
    pts = jnp.asarray(data['o'][:, None]
                      + data['z'][..., None] * data['d'][:, None])
    emb_b = jnp.broadcast_to(jnp.asarray(data['embed'])[:, None], (R, S, E))
    cls = SE3Field if kind == 'se3' else QuaternionField
    warp = cls(trunk_depth=2, trunk_width=16, min_deg=0, max_deg=4,
               skips=(1,))
    wp = warp.init(jax.random.PRNGKey(3), pts, emb_b)['params']
    wp = jax.tree.map(lambda a: a * 3e3 if a.shape == (16, 3) else a, wp)
    return data, (warp, wp), hyper, tmpl


def _se3_port_level(kind, wp, hp, tp, dtype):
    from hypernerf_tpu_torch.models.warping import WARP_FIELDS
    dt = modules.torch_dtype(dtype)
    warp = WARP_FIELDS[kind](E, 2, 16, 0, 4, (1,), dtype=dt)
    warp.load_state_dict(params_from_jax(jax.device_get(wp)))
    base = _port_level(_setup()[1][1], hp, tp, dtype)
    return base._replace(warp=warp)


def _se3_scales(alpha):
    from hypernerf_tpu.ops.pallas.fused_field import encoding_scales
    return encoding_scales(((3, 4, 0, False), (E, 0)),
                           [None if alpha is None else jnp.float32(alpha),
                            None])


def _se3_jax(kind, data, wp, hp, tp, spec, alpha, cot=None):
    """The JAX level kernel's output, or with ``cot`` its gradients in the
    port's layout."""
    from hypernerf_tpu.ops.pallas.fused_se3 import se3_params_to_list
    pairs = (se3_params_to_list(wp), mlp_params_to_list(hp['mlp']),
             nerf_mlp_params_to_list(tp))
    scales = _se3_scales(alpha)

    def fn(z, o, d, embed, rgbc, warp_pairs, hyper_pairs, tmpl_pairs):
        return fused_level(spec, None, embed, rgbc, None, warp_pairs,
                           hyper_pairs, tmpl_pairs, warp_enc_scales=scales,
                           origins=o, directions=d, z_vals=z,
                           return_packed=True)[:, :4]

    args = [jnp.asarray(data[k]) for k in _INPUTS] + list(pairs)
    if cot is None:
        return np.asarray(jax.jit(fn)(*args))
    g = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) * jnp.asarray(cot)),
                         argnums=tuple(range(8))))(*args)
    return [np.asarray(a) for a in g[:5]] + _flax_grads_to_list(*g[5:])


def _se3_port(level, data, alpha, cot=None):
    from hypernerf_tpu_torch.kernels.fused_se3 import se3_encoding_scales
    scales = None if alpha is None else se3_encoding_scales(level.warp, alpha)
    args = [torch.from_numpy(data[k]).requires_grad_(cot is not None)
            for k in _INPUTS]
    out = port_level(level, *args, scales)
    if cot is None:
        return out.detach().numpy()
    grads = torch.autograd.grad(out, args + _level_params(level),
                                torch.from_numpy(cot))
    return [g.numpy() for g in grads]


@pytest.mark.parametrize('alpha', [None, WARP_ALPHA], ids=['ones', 'window'])
@pytest.mark.parametrize('dtype,atol,mean_tol', [('float32', 1e-5, 1e-5),
                                                 ('bfloat16', 1e-2, 1e-4)])
@pytest.mark.parametrize('kind', ['se3', 'quaternion'])
def test_plain_se3_level_matches_jax_kernel(kind, dtype, atol, mean_tol,
                                            alpha):
    """With no alpha the JAX kernel takes a row of ones and the port none:
    the same numbers."""
    data, (_, wp), (_, hp), (_, tp) = _se3_setup(kind)
    want = _se3_jax(kind, data, wp, hp, tp, _se3_spec(kind, dtype), alpha)
    level = _se3_port_level(kind, wp, hp, tp, dtype)
    assert len(level_layers(level)) == 5 + 3 + 9  # warp, sheet, template
    got = _se3_port(level, data, alpha)
    diff = np.abs(got - want)
    assert diff.max() <= atol, diff.max()
    assert diff.mean() <= mean_tol, diff.mean()
    # The warp is visible: the translation level's output is another.
    assert np.abs(got - _port(_port_level(_setup()[1][1], hp, tp, dtype),
                              data)).max() > 1e-2


@pytest.mark.parametrize('kind', ['se3', 'quaternion'])
def test_plain_se3_level_matches_flax_composition(kind):
    """The dense JAX modules chained by hand at float32, windowed."""
    data, (warp, wp), (hyper, hp), (tmpl, tp) = _se3_setup(kind)
    pts = jnp.asarray(data['o'][:, None]
                      + data['z'][..., None] * data['d'][:, None])
    emb_b = jnp.broadcast_to(jnp.asarray(data['embed'])[:, None], (R, S, E))
    warped = warp.apply({'params': wp}, pts, emb_b,
                        {'warp_alpha': jnp.float32(WARP_ALPHA)}
                        )['warped_points']
    hyper_pts = hyper.apply({'params': hp}, pts, emb_b)
    feat = jnp.concatenate([posenc_orig(warped, 4),
                            posenc_orig(hyper_pts, 2)], -1)
    raw = tmpl.apply({'params': tp}, feat,
                     rgb_condition=jnp.asarray(data['rgbc']))
    want = np.concatenate([np.asarray(raw['rgb']), np.asarray(raw['alpha'])],
                          -1).reshape(R * S, 4)
    got = _se3_port(_se3_port_level(kind, wp, hp, tp, 'float32'), data,
                    WARP_ALPHA)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('schedule', sorted(SCHEDULES))
@pytest.mark.parametrize('kind', ['se3', 'quaternion'])
def test_plain_se3_level_backward_matches_jax_schedule(kind, schedule, dtype):
    """Template backward then fields backward (retraction VJP, trunk
    backward, sheet backward) against the JAX level's gradients under each
    backward schedule, windowed: every input's and all 2 x 17 layers' dW /
    db. The JAX backward tile (16) differs from its forward tile (8) and
    does not divide the 24 rows."""
    data, (_, wp), (_, hp), (_, tp) = _se3_setup(kind)
    spec = _se3_spec(kind, dtype, bwd_tile=16, tmpl_bwd_tile=16,
                     **SCHEDULES[schedule])
    cot = _cotangent()
    want = _se3_jax(kind, data, wp, hp, tp, spec, WARP_ALPHA, cot)
    level = _se3_port_level(kind, wp, hp, tp, dtype)
    calls = (fused_template_bwd_plain.calls, fused_fields_bwd_plain.calls)
    got = _se3_port(level, data, WARP_ALPHA, cot)
    assert (fused_template_bwd_plain.calls,
            fused_fields_bwd_plain.calls) == (calls[0] + 1, calls[1] + 1)
    assert len(got) == 5 + 2 * 17
    _assert_grads_close(got, want, SE3_GRAD_TOL[dtype])


@pytest.mark.parametrize('alpha', [None, WARP_ALPHA], ids=['ones', 'window'])
@pytest.mark.parametrize('kind', ['se3', 'quaternion'])
def test_plain_se3_level_backward_matches_autograd(kind, alpha):
    """At float32 the explicit backward is the autograd of the plain forward
    (whose retraction carries the hand-derived VJP)."""
    from hypernerf_tpu_torch.kernels.fused_se3 import se3_encoding_scales
    data, (_, wp), (_, hp), (_, tp) = _se3_setup(kind)
    level = _se3_port_level(kind, wp, hp, tp, 'float32')
    scales = None if alpha is None else se3_encoding_scales(level.warp, alpha)
    cot = _cotangent()
    args = [torch.from_numpy(data[k]).requires_grad_() for k in _INPUTS]
    want = torch.autograd.grad(
        fused_level_plain(level, *args, warp_scales=scales),
        args + _level_params(level), torch.from_numpy(cot))
    _assert_grads_close(_se3_port(level, data, alpha, cot),
                        [g.numpy() for g in want], 1e-5)


@pytest.mark.parametrize('kind', ['se3', 'quaternion'])
def test_se3_level_at_zero_rotation(kind):
    """A zero w head: every row has w = 0 exactly. The level is finite,
    equals the JAX kernel's, and the w head gets a zero gradient (the
    hand-derived VJP's d_w = 0) where the v head's is not."""
    data, (_, wp), (_, hp), (_, tp) = _se3_setup(kind)
    wp = jax.tree.map(lambda a: a, wp)
    wp['w_net']['logit'] = jax.tree.map(jnp.zeros_like,
                                        wp['w_net']['logit'])
    want = _se3_jax(kind, data, wp, hp, tp, _se3_spec(kind, 'float32'), None)
    level = _se3_port_level(kind, wp, hp, tp, 'float32')
    np.testing.assert_allclose(_se3_port(level, data, None), want, rtol=0,
                               atol=1e-5)
    grads = _se3_port(level, data, None, _cotangent())
    assert all(np.isfinite(g).all() for g in grads)
    layers = level_layers(level)
    heads = [i for i, (lin, _) in enumerate(layers)
             if lin in (level.warp.w_net.logit, level.warp.v_net.logit)]
    assert heads == [3, 4]
    assert not grads[5 + 2 * 3].any() and not grads[6 + 2 * 3].any()
    assert np.abs(grads[5 + 2 * 4]).max() > 0


def test_se3_level_covered_check():
    """What the level kernels would refuse on CUDA tensors for the SE(3)
    family, decided on the CPU: the flagship's ``se3`` and ``quaternion``
    levels pass, in bf16 and (the float32 kernels, since A.13.1 sub-item 2)
    in float32; another band count does not, in either; the packed layout
    has the 32 layers of the second compiled table."""
    from hypernerf_tpu_torch.flagship import flagship_model
    from hypernerf_tpu_torch.kernels.fused_level import (_check_covered,
                                                         pack_level)
    for config in ('se3', 'quaternion'):
        level = flagship_model('cpu', config=config).level('fine')
        _check_covered(level)
        w, b, shapes = pack_level(level)
        assert len(shapes) == 32
        assert shapes[:9] == [(128, 64)] + [(128, 128)] * 4 + [
            (128, 192), (128, 128), (8, 128), (8, 128)]
        assert shapes[9] == (64, 64) and shapes[16] == (256, 128)
        assert w.numel() == sum(n * k for n, k in shapes)
    _check_covered(flagship_model('cpu', config='se3',
                                  compute_dtype='float32').level('coarse'))
    for kw in (dict(warp_max_deg=6),
               dict(warp_max_deg=6, compute_dtype='float32')):
        level = flagship_model('cpu', config='se3', **kw).level('coarse')
        with pytest.raises(NotImplementedError, match='A.13'):
            _check_covered(level)


@pytest.mark.parametrize('case', ['level_se3', 'level_se3_window',
                                  'level_quaternion'])
def test_stored_jax_se3_level_reference(case):
    """tests/data/fused_se3_jax_ref.npz, what chip_smoke.py holds the level
    kernels' SE(3) and quaternion variants to on the card: the JAX level
    kernel's outputs and gradients (interpret mode, flagship widths, bf16,
    the default pipelined schedule) at the numpy probe weights, recomputed
    here, and the port's plain level matches them.

    Outputs: 6e-2 absolute and a mean of 1e-4. Gradients: relative L2 0.12
    and 0.25 of the largest entry. Both are wider than the translation
    level's (1e-2, 5e-2): one bf16 flip in the trunk moves w by some 4e-4 rad
    at these weights, the retraction moves the point by as much, and the
    template's 2^9 band turns that into 0.2 rad of phase; the biases' db are
    sums of such cotangents of both signs (measured here: outputs up to
    3.9e-2, db of one layer 8.1e-2, everything else under 3e-2)."""
    from hypernerf_tpu_torch.flagship import (LEVEL_INPUTS, SE3_LEVEL_CASES,
                                              flagship_model,
                                              load_probe_weights,
                                              read_se3_reference,
                                              se3_probe_inputs)
    from hypernerf_tpu_torch.kernels.fused_se3 import se3_encoding_scales
    from tools.make_level_reference import jax_level, jax_level_grads
    config, name, n_rays, samples, alpha, _ = SE3_LEVEL_CASES[case]
    stored = read_se3_reference()[case]
    inputs = se3_probe_inputs(case)
    for k, v in inputs.items():
        np.testing.assert_array_equal(stored[k], v)
    model = load_probe_weights(flagship_model('cpu', config=config))
    rays = {k: stored[k] for k in LEVEL_INPUTS}

    def close_out(a, what):
        diff = np.abs(a - stored['out'])
        assert a.shape == (n_rays * samples, 4)
        assert diff.max() <= 6e-2 and diff.mean() <= 1e-4, \
            (what, diff.max(), diff.mean())

    def close_grad(a, b, what):
        assert a.shape == b.shape, (what, a.shape, b.shape)
        l2 = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)
        assert l2 <= 0.12 and err <= FLAGSHIP_GRAD_MAX, (what, l2, err)

    close_out(jax_level(model, name, rays, alpha), 'recomputed out')
    again = jax_level_grads(model, name, rays, stored['cotangent'], alpha)
    assert sorted(again) == sorted(
        k for k in stored if k.startswith(('d_', 'dw', 'db')))
    assert len(again) == 5 + 2 * 32
    for k, v in again.items():
        close_grad(v, stored[k], f'recomputed {k}')
    level = model.level(name)
    scales = None if alpha is None else se3_encoding_scales(level.warp, alpha)
    args = [torch.from_numpy(stored[k].copy()).requires_grad_()
            for k in LEVEL_INPUTS]
    out = port_level(level, *args, scales)
    close_out(out.detach().numpy(), 'port out')
    grads = torch.autograd.grad(out, args + _level_params(level),
                                torch.from_numpy(stored['cotangent'].copy()))
    for k, g in zip(LEVEL_INPUTS, grads[:5]):
        close_grad(g.numpy(), stored[f'd_{k}'], f'port d_{k}')
    for layer in range(32):
        close_grad(grads[5 + 2 * layer].numpy(), stored[f'dw{layer}'],
                   f'port dw{layer}')
        close_grad(grads[6 + 2 * layer].numpy(), stored[f'db{layer}'],
                   f'port db{layer}')
