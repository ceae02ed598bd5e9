"""The port's quaternion math against ``hypernerf_tpu.ops.quaternion`` on the
same numpy inputs (made from a seed), at float32.

Tolerances as in ``test_torch_rigid_body.py``: values 1e-6, the hand-derived
VJP against the JAX hand-derived VJP 1e-5 and against torch autograd of the
clamped forward 1e-4 relative + 1e-5 (float32), 1e-12 (float64); the w = 0
rows apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from hypernerf_tpu.ops import quaternion as jq
from hypernerf_tpu_torch.ops import quaternion as pq
from hypernerf_tpu_torch.ops import rigid_body as prb


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _unit_quats(n, seed=0):
    q = np.random.RandomState(seed).randn(n, 4)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _wvpg(seed=0, n=64, dtype=np.float32):
    rs = np.random.RandomState(seed)
    w = np.concatenate([rs.normal(scale=0.7, size=(n - 8, 3)),
                        rs.normal(scale=1e-8, size=(4, 3)),
                        rs.normal(scale=3.0, size=(4, 3))])
    v = rs.normal(scale=0.5, size=(n, 3))
    p = rs.normal(scale=1.0, size=(n, 3))
    g = rs.normal(size=(n, 3))
    return [a.astype(dtype) for a in (w, v, p, g)]


def test_identity_and_parts():
    np.testing.assert_array_equal(pq.identity().numpy(), [0, 0, 0, 1])
    x = torch.tensor([[1., 2., 3., 4.]])
    np.testing.assert_array_equal(pq.im(x).numpy(), [[1, 2, 3]])
    np.testing.assert_array_equal(pq.re(x).numpy(), [[4]])


@pytest.mark.parametrize('name', ['conjugate', 'norm', 'normalize',
                                  'inverse', 'log', 'exp',
                                  'to_rotation_matrix'])
def test_unary_functions_match_jax(name):
    q = _unit_quats(7, 1) * (1.0 if name == 'to_rotation_matrix' else 1.3)
    got = getattr(pq, name)(_t(q)).numpy()
    want = np.asarray(getattr(jq, name)(jnp.asarray(q)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_multiply_matches_jax_and_scipy():
    a, b = _unit_quats(5, 0), _unit_quats(5, 1)
    got = pq.multiply(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jq.multiply(jnp.asarray(a), jnp.asarray(b))),
        rtol=0, atol=1e-6)
    want = (Rotation.from_quat(a) * Rotation.from_quat(b)).as_quat()
    sign = np.sign(np.sum(got * want, axis=-1, keepdims=True))
    np.testing.assert_allclose(got, want * sign, rtol=1e-4, atol=1e-5)


def test_rotate_matches_jax_and_the_rotation_matrix():
    q = _unit_quats(6, 2)
    v = np.random.RandomState(3).randn(6, 3).astype(np.float32)
    got = pq.rotate(_t(q), _t(v)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jq.rotate(jnp.asarray(q), jnp.asarray(v))), rtol=0,
        atol=1e-6)
    want = Rotation.from_quat(q).apply(v)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    rot = pq.to_rotation_matrix(_t(q)).numpy()
    np.testing.assert_allclose(np.einsum('bij,bj->bi', rot, v), want,
                               rtol=1e-4, atol=1e-5)


def test_inverse_gives_the_identity():
    q = _t(_unit_quats(4, 4))
    np.testing.assert_allclose(pq.multiply(q, pq.inverse(q)).numpy(),
                               np.tile([0, 0, 0, 1.0], (4, 1)), atol=1e-5)
    np.testing.assert_allclose(pq.norm(q).numpy(), 1.0, atol=1e-6)


def test_exp_log_roundtrip_and_axis_angle():
    axis = np.array([[0, 0, 1.0], [1.0, 0, 0]], np.float32)
    theta = np.array([0.8, 1.2], np.float32)
    pure = np.concatenate([axis * (theta[:, None] / 2),
                           np.zeros((2, 1), np.float32)], -1)
    rot = pq.exp(_t(pure)).numpy()
    want = Rotation.from_rotvec(axis * theta[:, None]).as_quat()
    np.testing.assert_allclose(rot, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pq.log(_t(rot)).numpy()[:, :3], pure[:, :3],
                               rtol=1e-3, atol=1e-4)
    got = pq.from_axis_angle(_t(axis), _t(theta)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jq.from_axis_angle(jnp.asarray(axis),
                                           jnp.asarray(theta))), atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        pq.safe_acos(torch.tensor([-1.0, 0.3, 1.0])).numpy(),
        np.asarray(jq.safe_acos(jnp.asarray([-1.0, 0.3, 1.0]))), atol=1e-6)


def test_quat_warp_vec_matches_jax_and_scipy():
    w, v, p, _ = _wvpg(0)
    got = pq.quat_warp_vec(_t(w), _t(v), _t(p)).numpy()
    want = np.asarray(jq.quat_warp_vec(jnp.asarray(w), jnp.asarray(v),
                                       jnp.asarray(p)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, Rotation.from_rotvec(w).apply(p) + v,
                               rtol=1e-4, atol=1e-5)
    # Same (w, v): the screw couples the translation, this warp does not.
    se3 = prb.se3_warp_vec(_t(w), _t(v), _t(p)).numpy()
    assert np.abs(got - se3).max() > 1e-3


def test_quat_warp_vec_bwd_matches_the_jax_hand_derived_vjp():
    w, v, p, g = _wvpg(0)
    got = pq.quat_warp_vec_bwd(_t(w), _t(v), _t(p), _t(g))
    want = jq.quat_warp_vec_bwd(jnp.asarray(w), jnp.asarray(v),
                                jnp.asarray(p), jnp.asarray(g))
    for a, b, name in zip(got, want, ('d_w', 'd_v', 'd_p')):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def _autograd(fwd, w, v, p, g):
    leaves = [t.clone().requires_grad_() for t in (w, v, p)]
    return torch.autograd.grad(fwd(*leaves), leaves, g)


@pytest.mark.parametrize('dtype,rtol,atol', [(np.float32, 1e-4, 1e-5),
                                             (np.float64, 1e-12, 1e-12)])
def test_quat_warp_vec_bwd_matches_autograd_of_the_clamped_forward(dtype,
                                                                   rtol,
                                                                   atol):
    """Off w = 0: the small-angle rows are replaced by generic ones."""
    w, v, p, g = _wvpg(1, dtype=dtype)
    w[-8:-4] = w[:4] * 0.1
    w, v, p, g = map(_t, (w, v, p, g))
    want = _autograd(pq.quat_warp_vec_fwd, w, v, p, g)
    for a, b, name in zip(pq.quat_warp_vec_bwd(w, v, p, g), want,
                          ('d_w', 'd_v', 'd_p')):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


def test_quat_warp_vec_gradient_is_the_hand_derived_vjp():
    w, v, p, g = map(_t, _wvpg(2))
    got = _autograd(pq.quat_warp_vec, w, v, p, g)
    for a, b in zip(got, pq.quat_warp_vec_bwd(w, v, p, g)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize('scale', [0.0, 1e-8])
def test_quat_warp_vec_at_zero_rotation(scale):
    _, v, p, g = map(_t, _wvpg(3, n=16))
    w = torch.from_numpy(np.random.RandomState(9).randn(16, 3).astype(
        np.float32)) * scale
    np.testing.assert_allclose(pq.quat_warp_vec(w, v, p).numpy(),
                               (p + v).numpy(), rtol=0, atol=1e-6)
    for grads in (pq.quat_warp_vec_bwd(w, v, p, g),
                  _autograd(pq.quat_warp_vec, w, v, p, g)):
        d_w, d_v, d_p = (t.numpy() for t in grads)
        np.testing.assert_array_equal(d_w, np.zeros_like(d_w))
        np.testing.assert_array_equal(d_v, g.numpy())
        np.testing.assert_array_equal(d_p, g.numpy())
    raw = _autograd(pq.quat_warp_vec_fwd, w, v, p, g)
    assert all(torch.isfinite(t).all() for t in raw)
