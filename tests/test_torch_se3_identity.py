"""An SE(3) (or quaternion) field with the identity in its encoding
(``use_posenc_identity``) against the JAX package's, on the CPU.

The JAX package has no kernel for such a field: its trunk kernel and its
Jacobian kernel both skip it and run it in XLA. The port runs it in tensor
code on every device: ``SE3Field.runs_kernels`` is False for it on a CUDA
tensor, its Jacobian takes forward-mode derivatives of the tensor code, and
every kernel path (``fused_se3.se3_layers``: the trunk's wrappers, their
tangents', the level's) refuses it.

- forward (with and without the warp_alpha window) and the gradients of
  sum(warped * cotangent) in the points, the embedding and every weight;
- the Jacobian (the elastic loss's d warped / d points) and the gradients
  of sum(J * cotangent) in the weights;
- the weights carried across from the flax field (``convert``) at the wider
  first layer, both ways;
- the gates.

Small widths (a trunk of 3 x 32, degrees 0..4, skip after layer 1), float32
both ways, the heads drawn large enough that the rotation shows.
Tolerances: warped points and the Jacobian 1e-5, gradients 1e-4 of each
one's largest entry (fp32 both ways, other summation orders).

About 25 s on one worker.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.models.warping import QuaternionField as JaxQuaternion
from hypernerf_tpu.models.warping import SE3Field as JaxSE3
from hypernerf_tpu_torch.convert import params_from_jax, params_to_jax
from hypernerf_tpu_torch.kernels import (Level, fused_level, fused_se3_plain,
                                         fused_se3_wv, fused_se3_wv_tangents)
from hypernerf_tpu_torch.kernels import fused_se3_jacobian
from hypernerf_tpu_torch.models.modules import NerfMLP
from hypernerf_tpu_torch.models.warping import QuaternionField, SE3Field
from hypernerf_tpu_torch.ops.posenc import posenc_channels

E, P = 8, 37
KW = dict(trunk_depth=3, trunk_width=32, min_deg=0, max_deg=4, skips=(1,))
KINDS = {'se3': (JaxSE3, SE3Field), 'quaternion': (JaxQuaternion,
                                                   QuaternionField)}
TOL, GRAD_TOL = 1e-5, 1e-4


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    pts = (rs.randn(P, 3) * 0.4).astype(np.float32)
    emb = (rs.randn(P, E) * 0.1).astype(np.float32)
    return pts, emb


@functools.cache
def _flax_params(kind):
    jfield = KINDS[kind][0](use_posenc_identity=True, **KW)
    pts, emb = _inputs()
    params = jax.device_get(jfield.init(jax.random.PRNGKey(0),
                                        jnp.asarray(pts),
                                        jnp.asarray(emb))['params'])
    params = jax.tree.map(np.array, params)
    rs = np.random.RandomState(1)
    for head, scale in (('w_net', 0.1), ('v_net', 0.05)):
        for leaf in ('kernel', 'bias'):
            a = params[head]['logit'][leaf]
            params[head]['logit'][leaf] = rs.uniform(
                -scale, scale, a.shape).astype(np.float32)
    return params


def _port_field(kind):
    field = KINDS[kind][1](E, use_posenc_identity=True, **_port_kw())
    field.load_state_dict(params_from_jax(_flax_params(kind)), strict=True)
    return field


def _port_kw():
    return dict(trunk_depth=KW['trunk_depth'], trunk_width=KW['trunk_width'],
                min_deg=KW['min_deg'], max_deg=KW['max_deg'],
                skips=KW['skips'])


def _max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _assert_grads(got: dict, want: dict):
    want = dict(_flat(want))
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        assert _max_rel(g, want[k]) <= GRAD_TOL, k


def _flat(tree, prefix=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f'{prefix}{k}/')
        else:
            yield f'{prefix}{k}', np.asarray(v)


def _port_grads(field):
    """The field's gradients in the flax tree's names; a parameter that got
    none (the quaternion's v bias in J: J does not depend on it) reads 0."""
    return dict(_flat(params_to_jax({
        k: torch.zeros_like(p) if p.grad is None else p.grad
        for k, p in field.named_parameters()})))


@pytest.mark.parametrize('kind', KINDS)
def test_the_field_builds_at_its_wider_first_layer(kind):
    field = _port_field(kind)
    assert field.trunk.hidden(0).in_features == \
        posenc_channels(3, 0, 4, True) + E == 3 * 9 + E
    # The converted weights go back to the flax tree unchanged.
    back = dict(_flat(params_to_jax(field.state_dict())))
    for k, v in _flat(_flax_params(kind)):
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize('alpha', [None, 2.5])
@pytest.mark.parametrize('kind', KINDS)
def test_forward_and_gradients_match_jax(kind, alpha):
    pts, emb = _inputs()
    cot = np.random.RandomState(2).randn(P, 3).astype(np.float32)
    extra = None if alpha is None else {'warp_alpha': alpha}
    jfield = KINDS[kind][0](use_posenc_identity=True, **KW)

    def jax_loss(params, p, e):
        warped = jfield.apply({'params': params}, p, e,
                              None if alpha is None
                              else {'warp_alpha': jnp.float32(alpha)}
                              )['warped_points']
        return jnp.sum(warped * jnp.asarray(cot)), warped

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                          has_aux=True)(
        _flax_params(kind), jnp.asarray(pts), jnp.asarray(emb))
    field = _port_field(kind)
    tp = torch.from_numpy(pts).requires_grad_()
    te = torch.from_numpy(emb).requires_grad_()
    calls = fused_se3_plain.calls
    warped = field(tp, te, extra)
    assert fused_se3_plain.calls == calls  # tensor code, no plain kernel
    np.testing.assert_allclose(warped.detach().numpy(), np.asarray(want),
                               rtol=0, atol=TOL)
    moved = np.abs(np.asarray(want) - pts).max()
    assert moved > 1e-2, moved
    (warped * torch.from_numpy(cot)).sum().backward()
    _assert_grads(_port_grads(field), grads[0])
    assert _max_rel(tp.grad.numpy(), grads[1]) <= GRAD_TOL
    assert _max_rel(te.grad.numpy(), grads[2]) <= GRAD_TOL


@pytest.mark.parametrize('kind', KINDS)
def test_jacobian_matches_jax(kind):
    pts, emb = _inputs(3)
    cot = np.random.RandomState(4).randn(P, 3, 3).astype(np.float32)
    jfield = KINDS[kind][0](use_posenc_identity=True, **KW)
    extra = {'warp_alpha': 3.0}

    def jax_loss(params):
        jac = jfield.apply({'params': params}, jnp.asarray(pts),
                           jnp.asarray(emb),
                           {'warp_alpha': jnp.float32(3.0)},
                           return_jacobian=True)['jacobian']
        return jnp.sum(jac * jnp.asarray(cot)), jac

    (_, want), grads = jax.value_and_grad(jax_loss, has_aux=True)(
        _flax_params(kind))
    field = _port_field(kind)
    calls = fused_se3_jacobian.fused_se3_jacobian_plain.calls
    jac = field.jacobian(torch.from_numpy(pts), torch.from_numpy(emb),
                         extra)
    assert fused_se3_jacobian.fused_se3_jacobian_plain.calls == calls
    assert jac.shape == (P, 3, 3)
    np.testing.assert_allclose(jac.detach().numpy(), np.asarray(want),
                               rtol=0, atol=TOL)
    assert np.abs(np.asarray(want) - np.eye(3)).max() > 1e-2
    (jac * torch.from_numpy(cot)).sum().backward()
    _assert_grads(_port_grads(field), grads)


def test_the_kernel_gates_send_the_field_to_tensor_code():
    """On a CUDA tensor a field runs its trunk kernels unless its encoding
    has the identity; every kernel path refuses such a field."""
    cuda_points = types.SimpleNamespace(is_cuda=True)
    ident = _port_field('se3')
    plain = SE3Field(E, **_port_kw())
    assert not ident.runs_kernels(cuda_points)
    assert plain.runs_kernels(cuda_points)
    assert not plain.runs_kernels(torch.zeros(1, 3))
    x_raw = torch.zeros(4, 3 + E)
    for call in (lambda: fused_se3_wv(ident, x_raw),
                 lambda: fused_se3_wv_tangents(ident, x_raw)):
        with pytest.raises(ValueError, match='tensor code'):
            call()
    template = NerfMLP(3 * 9, 3 * 5, 2, 32, 1, 16, skips=(1,))
    level = Level(ident, None, template, 4, 2, False)
    with pytest.raises(ValueError, match='tensor code'):
        fused_level(level, torch.rand(2, 4), torch.zeros(2, 3),
                    torch.ones(2, 3), torch.zeros(2, E),
                    torch.zeros(2, 15))
