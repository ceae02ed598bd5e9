"""The elastic and background regularizers (``training/losses.py``) and the
Jacobian subsample's draw (``ops.sampling.weighted_sample_indices``) against
the JAX package on the same numpy inputs and uniforms.

Tolerances: eigenvalues against ``np.linalg.eigvalsh`` in float64 1e-9 of
the largest, and 1e-3 where two coincide (the clip of acos's argument at
1 - 1e-6 moves them by up to sqrt(2e-6) of their spread; measured 1.8e-4);
the losses and their gradients against JAX at float32 1e-5
relative (the same closed form, other summation orders); the draw exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.ops import sampling as jax_sampling
from hypernerf_tpu.training import losses as jax_losses
from hypernerf_tpu_torch.ops.sampling import weighted_sample_indices
from hypernerf_tpu_torch.training import losses

TOL = 1e-5


def _jacobians(n, seed, spread=0.3):
    rs = np.random.RandomState(seed)
    return (np.eye(3) + rs.randn(n, 3, 3) * spread).astype(np.float32)


def test_sym3_eigvals_match_eigvalsh():
    rs = np.random.RandomState(0)
    a = rs.randn(200, 3, 3)
    sym = a @ np.swapaxes(a, -1, -2)
    sym[:5] = np.eye(3) * 2.0               # degenerate: J = I up to scale
    sym[5:10] = np.diag([1.0, 1.0, 3.0])    # two coincident eigenvalues
    got = losses._sym3_eigvals(torch.from_numpy(sym)).numpy()
    want = np.linalg.eigvalsh(sym)[..., ::-1]
    err = np.abs(got - want).max(-1) / np.abs(want).max(-1)
    assert err[:5].max() == 0.0
    assert err[5:10].max() <= 1e-3
    assert err[10:].max() <= 1e-9


def test_sym3_eigvals_gradient_finite_at_identity():
    """At J = I every entry takes the degenerate branch: the double-where
    keeps the gradient finite (and zero for the elastic loss)."""
    jac = torch.eye(3).expand(16, 3, 3).clone().requires_grad_()
    loss = losses.elastic_loss(jac)
    assert not loss.any()
    grad, = torch.autograd.grad(loss.sum(), jac)
    assert torch.isfinite(grad).all() and not grad.any()
    a = torch.eye(3).expand(4, 3, 3).clone().requires_grad_()
    g2, = torch.autograd.grad(losses._sym3_eigvals(a).sum(), a)
    assert torch.isfinite(g2).all()


@pytest.mark.parametrize('spread', [0.3, 1e-3])
def test_elastic_loss_matches_jax(spread):
    jac = _jacobians(300, seed=1, spread=spread)
    want, want_grad = jax.value_and_grad(
        lambda j: jnp.sum(jax_losses.elastic_loss(j) * jnp.arange(300.0)))(
        jnp.asarray(jac))
    t = torch.from_numpy(jac).requires_grad_()
    got = torch.sum(losses.elastic_loss(t) * torch.arange(300.0))
    grad, = torch.autograd.grad(got, t)
    assert abs(got.item() - float(want)) <= TOL * abs(float(want))
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                               rtol=TOL, atol=TOL * np.abs(want_grad).max())


def test_background_loss_matches_jax():
    rs = np.random.RandomState(2)
    pts = rs.randn(64, 3).astype(np.float32)
    warped = pts + rs.randn(64, 3).astype(np.float32) * 1e-3
    want = jax_losses.background_loss(jnp.asarray(warped), jnp.asarray(pts))
    got = losses.background_loss(torch.from_numpy(warped),
                                 torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL)


@pytest.mark.parametrize('subsampled', [False, True])
def test_weighted_elastic_loss_matches_jax(subsampled):
    rs = np.random.RandomState(3)
    res = {}
    for level, s in (('coarse', 6), ('fine', 9)):
        res[level] = {'warp_jacobian': _jacobians(4 * s, seed=s).reshape(
            4, s, 3, 3), 'weights': rs.rand(4, s).astype(np.float32)}
        if subsampled:
            res[level]['warp_jacobian_weights'] = rs.rand(4, s).astype(
                np.float32)
    want = jax_losses.weighted_elastic_loss(
        jax.tree.map(jnp.asarray, res), scale=0.05)
    got = losses.weighted_elastic_loss(
        {lv: {k: torch.from_numpy(v) for k, v in r.items()}
         for lv, r in res.items()}, scale=0.05)
    assert abs(got.item() - float(want)) <= TOL * abs(float(want))


def test_weighted_sample_indices_match_jax():
    """The same uniforms give the same indices, including a ray whose
    weights are all zero (the last index) and negative weights (clipped)."""
    rs = np.random.RandomState(4)
    w = rs.rand(32, 20).astype(np.float32)
    w[0] = 0.0
    w[1, :10] = -1.0
    key = jax.random.PRNGKey(5)
    want = jax_sampling.weighted_sample_indices(key, jnp.asarray(w), 7)
    u = np.array(jax.random.uniform(key, (32, 7)))
    got = weighted_sample_indices(torch.from_numpy(w), 7,
                                  u=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[0] == 19).all() and (got[1] >= 10).all()
    # Drawn from a generator: the same shape and range.
    drawn = weighted_sample_indices(torch.from_numpy(w), 7,
                                    generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (32, 7) and 0 <= drawn.min() and drawn.max() < 20
