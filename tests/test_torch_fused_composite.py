"""The compositing kernel's plain versions, forward and backward, against the
JAX Pallas compositing kernel (``fused_composite``, interpret mode) and its
``_fused_bwd``, with and without the in-kernel fine draw and the sigma noise.

Tolerance 1e-5 absolute at float32 on every output. The fine depths are
ill-conditioned where a bin holds little CDF mass: a draw moves by the
CDF's last-bit difference (a few 2^-24) over the bin's mass, times the
bin's width. The main cases keep every bin's mass above 1e-2; the opaque
case lets masses fall to ~1e-4 and bounds z_union by that conditioning.
Gradients: 1e-5 of each gradient's largest entry (fp32 both ways; the
reverse cumulative sum is taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.ops.pallas.fused_composite import (CompositeSpec,
                                                      fused_composite)
from hypernerf_tpu.ops.rendering import volumetric_rendering
from hypernerf_tpu.ops.sampling import sorted_uniform
from hypernerf_tpu_torch.kernels import fused_composite as port_composite
from hypernerf_tpu_torch.kernels import (fused_composite_bwd_plain,
                                         fused_composite_plain)

R, S = 16, 8
TOL = 1e-5


def _inputs(seed, n_fine, u_kind, sigma_shift=-3.0):
    rs = np.random.RandomState(seed)
    packed = rs.randn(R * S, 4).astype(np.float32)
    packed[:, 3] += sigma_shift  # raw density: -3 keeps weights spread
    z = np.sort(rs.rand(R, S).astype(np.float32) * 3 + 0.5, axis=-1)
    dirs = rs.randn(R, 3).astype(np.float32)
    u = None
    if n_fine and u_kind == 'linspace':  # hits 0 and 1 exactly
        u = np.broadcast_to(np.linspace(0, 1, n_fine, dtype=np.float32),
                            (R, n_fine)).copy()
    elif n_fine:
        u = np.array(sorted_uniform(jax.random.PRNGKey(seed), R, n_fine))
    return packed, z, dirs, u


@pytest.mark.parametrize('n_fine,u_kind,white,infinity', [
    (0, None, False, True),
    (0, None, True, False),
    (8, 'linspace', False, True),    # union 16: a power of two
    (8, 'sorted', False, True),
    (12, 'linspace', False, True),   # union 20: not a power of two
    (12, 'sorted', True, True),
])
def test_plain_composite_matches_jax_kernel(n_fine, u_kind, white, infinity):
    packed, z, dirs, u = _inputs(n_fine + 1, n_fine, u_kind)
    spec = CompositeSpec(samples=S, rays_per_tile=8,
                         use_white_background=white,
                         sample_at_infinity=infinity, fine_samples=n_fine,
                         interpret=True)
    packed8 = np.concatenate([packed, np.zeros_like(packed)], -1)
    want = fused_composite(spec, jnp.asarray(packed8), jnp.asarray(z),
                           jnp.asarray(dirs),
                           u=None if u is None else jnp.asarray(u))
    calls = fused_composite_plain.calls
    got = port_composite(torch.from_numpy(packed), torch.from_numpy(z),
                         torch.from_numpy(dirs),
                         None if u is None else torch.from_numpy(u),
                         use_white_background=white,
                         sample_at_infinity=infinity)
    assert fused_composite_plain.calls == calls + 1
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=TOL, err_msg=k)
    if n_fine:
        zu = got['z_union'].numpy()
        assert zu.shape == (R, S + n_fine)
        assert (np.diff(zu, axis=-1) >= 0).all()


def test_plain_composite_matches_jax_kernel_opaque():
    """Dense media: most weight in a few bins, the rest near eps."""
    packed, z, dirs, u = _inputs(3, 8, 'linspace', sigma_shift=0.0)
    spec = CompositeSpec(samples=S, rays_per_tile=8, fine_samples=8,
                         interpret=True)
    packed8 = np.concatenate([packed, np.zeros_like(packed)], -1)
    want = fused_composite(spec, jnp.asarray(packed8), jnp.asarray(z),
                           jnp.asarray(dirs), u=jnp.asarray(u))
    got = port_composite(torch.from_numpy(packed), torch.from_numpy(z),
                         torch.from_numpy(dirs), torch.from_numpy(u))
    for k in ('rgb', 'depth', 'med_depth', 'acc', 'weights'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=TOL, err_msg=k)
    w = got['weights'].numpy()[:, 1:-1] + 1e-5
    min_mass = (w / w.sum(-1, keepdims=True)).min()
    max_bin = np.diff(z, axis=-1).max()
    tol = TOL + 8 * 2.0 ** -24 / min_mass * max_bin
    assert tol < 0.05 * max_bin  # still a small fraction of a bin
    np.testing.assert_allclose(got['z_union'].numpy(),
                               np.asarray(want['z_union']), rtol=0, atol=tol)


_OUT_W = {'rgb': 1.3, 'depth': 0.4, 'med_depth': 0.7, 'acc': 0.2,
          'weights': 0.05}


def _jax_loss(out, cot):
    return sum(jnp.sum(out[k] * cot[k]) for k in _OUT_W)


@pytest.mark.parametrize('white', [False, True])
@pytest.mark.parametrize('infinity', [False, True])
@pytest.mark.parametrize('with_noise', [False, True])
def test_plain_composite_backward_matches_jax(white, infinity, with_noise):
    """The port's explicit backward (through ``FusedCompositeFn`` on CPU
    tensors) against the JAX kernel's ``_fused_bwd`` in interpret mode and
    against ``jax.grad`` of ``volumetric_rendering``; the forward with
    noise too."""
    packed, z, dirs, _ = _inputs(11, 0, None)
    rs = np.random.RandomState(5)
    noise = rs.randn(R, S).astype(np.float32) if with_noise else None
    cot = {k: (w * rs.rand(*shape)).astype(np.float32) for (k, w), shape in
           zip(_OUT_W.items(), ((R, 3), (R,), (R,), (R,), (R, S)))}
    spec = CompositeSpec(samples=S, rays_per_tile=8,
                         use_white_background=white,
                         sample_at_infinity=infinity, has_noise=with_noise,
                         interpret=True)
    jcot = {k: jnp.asarray(v) for k, v in cot.items()}

    def kernel_loss(pk, zz, dd, nn):
        pk8 = jnp.concatenate([pk, jnp.zeros_like(pk)], -1)
        out = fused_composite(spec, pk8, zz, dd, nn)
        return _jax_loss(out, jcot), out

    def xla_loss(pk, zz, dd, nn):
        pk = pk.reshape(R, S, 4)
        raw = pk[..., 3] if nn is None else pk[..., 3] + nn
        out = volumetric_rendering(jax.nn.sigmoid(pk[..., :3]),
                                   jax.nn.softplus(raw), zz, dd, white,
                                   infinity)
        return _jax_loss(out, jcot), out

    argnums = (0, 1, 2) + ((3,) if with_noise else ())
    jargs = (jnp.asarray(packed), jnp.asarray(z), jnp.asarray(dirs),
             None if noise is None else jnp.asarray(noise))
    (_, want_out), g_kernel = jax.value_and_grad(
        kernel_loss, argnums=argnums, has_aux=True)(*jargs)
    _, g_xla = jax.value_and_grad(xla_loss, argnums=argnums,
                                  has_aux=True)(*jargs)

    targs = [None if a is None else torch.from_numpy(a).requires_grad_()
             for a in (packed, z, dirs, noise)]
    calls = fused_composite_bwd_plain.calls
    out = port_composite(targs[0], targs[1], targs[2], None,
                         use_white_background=white,
                         sample_at_infinity=infinity, noise=targs[3])
    for k in _OUT_W:  # the forward, noise included
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(want_out[k]), rtol=0, atol=TOL,
                                   err_msg=k)
    loss = sum((out[k] * torch.from_numpy(cot[k])).sum() for k in _OUT_W)
    got = torch.autograd.grad(loss, [t for t in targs if t is not None])
    assert fused_composite_bwd_plain.calls == calls + 1  # the explicit one
    for name, g, gk, gx in zip(('packed', 'z', 'dirs', 'noise'), got,
                               g_kernel, g_xla):
        for ref, want in (('kernel', gk), ('xla', gx)):
            want = np.asarray(want)
            err = np.abs(g.numpy() - want).max() / max(np.abs(want).max(),
                                                       1e-6)
            assert err <= 1e-5, (name, ref, err)


def test_plain_composite_backward_matches_autograd():
    """The explicit backward is the autograd of the plain forward."""
    packed, z, dirs, _ = _inputs(4, 0, None)
    rs = np.random.RandomState(6)
    noise = rs.randn(R, S).astype(np.float32)
    for white, infinity in ((False, True), (True, False)):
        targs = [torch.from_numpy(a).requires_grad_()
                 for a in (packed, z, dirs, noise)]
        cots = None
        grads = []
        for fn in (fused_composite_plain, port_composite):
            out = fn(targs[0], targs[1], targs[2], None, white, infinity,
                     targs[3])
            if cots is None:
                cots = {k: torch.from_numpy(
                    rs.rand(*out[k].shape).astype(np.float32)) for k in out}
            loss = sum((out[k] * cots[k]).sum() for k in out)
            grads.append(torch.autograd.grad(loss, targs))
        for a, b in zip(*grads):
            assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_z_union_carries_no_gradient():
    """``z_union`` is non-differentiable and ``u`` gets no gradient, and
    asking for the fine draw leaves the other gradients unchanged."""
    packed, z, dirs, u = _inputs(9, 8, 'sorted')
    targs = [torch.from_numpy(a).requires_grad_() for a in (packed, z, dirs)]
    tu = torch.from_numpy(u).requires_grad_()
    grads = []
    for uu in (None, tu):
        out = port_composite(*targs, uu)
        if uu is not None:
            assert not out['z_union'].requires_grad
            assert out['z_union'].shape == (R, S + 8)
        loss = out['rgb'].sum() + 0.3 * out['weights'].sum()
        grads.append(torch.autograd.grad(loss, targs + [tu],
                                         allow_unused=True))
    assert grads[1][3] is None
    for a, b in zip(grads[0][:3], grads[1][:3]):
        assert torch.equal(a, b)
