"""The port's rigid-body math against ``hypernerf_tpu.ops.rigid_body`` on the
same numpy inputs (made from a seed), at float32.

Tolerances: values 1e-6 (the same formulas, other libm); the hand-derived VJP
against the JAX hand-derived VJP 1e-5, and against torch autograd of the
clamped forward 1e-4 relative + 1e-5 (float32) and 1e-12 (float64). Inputs of
an autodiff comparison stay off w = 0; the w = 0 rows are checked apart
against the closed form d_w = 0, d_v = d_p = g, where the JAX forward's
unclamped root gives autodiff a NaN and the port's clamped one does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from hypernerf_tpu.ops import rigid_body as jrb
from hypernerf_tpu_torch.ops import rigid_body as prb


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _wvpg(seed=0, n=64, dtype=np.float32):
    """(w, v, p, g): generic, tiny (the small-angle branch) and large
    rotation vectors."""
    rs = np.random.RandomState(seed)
    w = np.concatenate([rs.normal(scale=0.7, size=(n - 8, 3)),
                        rs.normal(scale=1e-8, size=(4, 3)),
                        rs.normal(scale=3.0, size=(4, 3))])
    v = rs.normal(scale=0.5, size=(n, 3))
    p = rs.normal(scale=1.0, size=(n, 3))
    g = rs.normal(size=(n, 3))
    return [a.astype(dtype) for a in (w, v, p, g)]


def test_skew_matches_jax_and_is_the_cross_product():
    rs = np.random.RandomState(0)
    w = rs.randn(4, 5, 3).astype(np.float32)
    v = rs.randn(4, 5, 3).astype(np.float32)
    got = prb.skew(_t(w)).numpy()
    assert got.shape == (4, 5, 3, 3)
    np.testing.assert_allclose(got, np.asarray(jrb.skew(jnp.asarray(w))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.einsum('...ij,...j->...i', got, v),
                               np.cross(w, v), rtol=1e-4, atol=1e-5)


def test_exp_so3_matches_jax_and_scipy():
    rs = np.random.RandomState(1)
    axis = rs.randn(6, 3)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    theta = rs.rand(6) * np.pi
    a32, t32 = axis.astype(np.float32), theta.astype(np.float32)
    got = prb.exp_so3(_t(a32), _t(t32)).numpy()
    want = np.asarray(jrb.exp_so3(jnp.asarray(a32), jnp.asarray(t32)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        got, Rotation.from_rotvec(axis * theta[:, None]).as_matrix(),
        rtol=1e-4, atol=1e-5)


def test_exp_se3_matches_jax_and_the_closed_form():
    rs = np.random.RandomState(2)
    axis = rs.randn(5, 3)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    screw = np.concatenate([axis, rs.randn(5, 3)], -1).astype(np.float32)
    theta = rs.rand(5).astype(np.float32)
    got = prb.exp_se3(_t(screw), _t(theta)).numpy()
    want = np.asarray(jrb.exp_se3(jnp.asarray(screw), jnp.asarray(theta)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # A unit screw about z: rotation by theta, translation (0, 0, theta).
    one = prb.exp_se3(torch.tensor([[0, 0, 1, 0, 0, 1.0]]),
                      torch.tensor([0.7]))[0].numpy()
    np.testing.assert_allclose(
        one[:3, :3], Rotation.from_rotvec([0, 0, 0.7]).as_matrix(),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(one[:3, 3], [0, 0, 0.7], atol=1e-5)
    np.testing.assert_allclose(one[3], [0, 0, 0, 1], atol=1e-7)


def test_exp_se3_from_wv_matches_jax_and_translates_at_zero():
    w, v, _, _ = _wvpg(3)
    got = prb.exp_se3_from_wv(_t(w), _t(v)).numpy()
    want = np.asarray(jrb.exp_se3_from_wv(jnp.asarray(w), jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    zero = prb.exp_se3_from_wv(torch.zeros(3, 3), _t(v[:3])).numpy()
    np.testing.assert_allclose(zero[..., :3, :3],
                               np.tile(np.eye(3), (3, 1, 1)), atol=1e-6)
    np.testing.assert_allclose(zero[..., :3, 3], v[:3], atol=1e-6)


def test_transform_points_and_homogeneous_helpers_match_jax():
    w, v, p, _ = _wvpg(4, n=16)
    tj = jrb.exp_se3_from_wv(jnp.asarray(w), jnp.asarray(v))
    got = prb.transform_points(_t(np.asarray(tj)), _t(p)).numpy()
    want = np.asarray(jrb.transform_points(tj, jnp.asarray(p)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # Inverting the transform brings the points back.
    back = np.einsum('bij,bj->bi', np.linalg.inv(np.asarray(tj)),
                     np.concatenate([got, np.ones((16, 1))], -1))[:, :3]
    np.testing.assert_allclose(back, p, rtol=1e-3, atol=1e-4)
    h = prb.to_homogenous(torch.tensor([[1.0, 2.0, 3.0]]))
    np.testing.assert_array_equal(h.numpy(), [[1, 2, 3, 1]])
    np.testing.assert_allclose(prb.from_homogenous(h * 2.0).numpy(),
                               [[1, 2, 3]])
    r = prb.exp_so3(torch.tensor([[0.0, 0.0, 1.0]]), torch.tensor([0.3]))
    np.testing.assert_allclose(
        prb.rp_to_se3(r, torch.tensor([[1.0, 2.0, 3.0]])).numpy(),
        np.asarray(jrb.rp_to_se3(jnp.asarray(r.numpy()),
                                 jnp.asarray([[1.0, 2.0, 3.0]]))), atol=1e-7)


def test_se3_warp_vec_matches_jax_and_the_matrix_path():
    w, v, p, _ = _wvpg(0)
    got = prb.se3_warp_vec(_t(w), _t(v), _t(p)).numpy()
    want = np.asarray(jrb.se3_warp_vec(jnp.asarray(w), jnp.asarray(v),
                                       jnp.asarray(p)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    ref = prb.transform_points(prb.exp_se3_from_wv(_t(w), _t(v)), _t(p))
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-5, atol=2e-6)


def test_se3_warp_vec_broadcasts_over_leading_dims():
    w, v, p, _ = _wvpg(5, n=24)
    got = prb.se3_warp_vec(_t(w).reshape(4, 6, 3), _t(v).reshape(4, 6, 3),
                           _t(p).reshape(4, 6, 3))
    flat = prb.se3_warp_vec(_t(w), _t(v), _t(p))
    assert got.shape == (4, 6, 3)
    np.testing.assert_array_equal(got.reshape(-1, 3).numpy(), flat.numpy())


def test_se3_warp_vec_bwd_matches_the_jax_hand_derived_vjp():
    w, v, p, g = _wvpg(0)
    got = prb.se3_warp_vec_bwd(_t(w), _t(v), _t(p), _t(g))
    want = jrb.se3_warp_vec_bwd(jnp.asarray(w), jnp.asarray(v),
                                jnp.asarray(p), jnp.asarray(g))
    for a, b, name in zip(got, want, ('d_w', 'd_v', 'd_p')):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def _autograd_of_clamped_forward(fwd, w, v, p, g):
    leaves = [t.clone().requires_grad_() for t in (w, v, p)]
    return torch.autograd.grad(fwd(*leaves), leaves, g)


@pytest.mark.parametrize('dtype,rtol,atol', [(np.float32, 1e-4, 1e-5),
                                             (np.float64, 1e-12, 1e-12)])
def test_se3_warp_vec_bwd_matches_autograd_of_the_clamped_forward(dtype, rtol,
                                                                  atol):
    """Off w = 0: the small-angle rows are replaced by generic ones."""
    w, v, p, g = _wvpg(1, dtype=dtype)
    w[-8:-4] = w[:4] * 0.1
    w, v, p, g = map(_t, (w, v, p, g))
    want = _autograd_of_clamped_forward(prb.se3_warp_vec_fwd, w, v, p, g)
    for a, b, name in zip(prb.se3_warp_vec_bwd(w, v, p, g), want,
                          ('d_w', 'd_v', 'd_p')):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


def test_se3_warp_vec_gradient_is_the_hand_derived_vjp():
    """``se3_warp_vec`` back-propagates through ``se3_warp_vec_bwd``."""
    w, v, p, g = map(_t, _wvpg(2))
    got = _autograd_of_clamped_forward(prb.se3_warp_vec, w, v, p, g)
    for a, b in zip(got, prb.se3_warp_vec_bwd(w, v, p, g)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize('scale', [0.0, 1e-8])
def test_se3_warp_vec_at_zero_rotation(scale):
    """w = 0 (and |w| below 1e-6): the value is points + v, the gradient
    d_w = 0 and d_v = d_p = g, finite through autograd of the clamped forward
    too."""
    _, v, p, g = map(_t, _wvpg(3, n=16))
    w = torch.from_numpy(np.random.RandomState(9).randn(16, 3).astype(
        np.float32)) * scale
    np.testing.assert_allclose(prb.se3_warp_vec(w, v, p).numpy(),
                               (p + v).numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        prb.se3_warp_vec(w, v, p).numpy(),
        np.asarray(jrb.se3_warp_vec(jnp.asarray(w.numpy()),
                                    jnp.asarray(v.numpy()),
                                    jnp.asarray(p.numpy()))), atol=1e-6)
    for grads in (prb.se3_warp_vec_bwd(w, v, p, g),
                  _autograd_of_clamped_forward(prb.se3_warp_vec, w, v, p, g)):
        d_w, d_v, d_p = (t.numpy() for t in grads)
        np.testing.assert_array_equal(d_w, np.zeros_like(d_w))
        np.testing.assert_array_equal(d_v, g.numpy())
        np.testing.assert_array_equal(d_p, g.numpy())
    raw = _autograd_of_clamped_forward(prb.se3_warp_vec_fwd, w, v, p, g)
    assert all(torch.isfinite(t).all() for t in raw)
