"""The compositing kernel's plain version against the JAX Pallas compositing
kernel (``fused_composite``, interpret mode), with and without the
in-kernel fine draw.

Tolerance 1e-5 absolute at float32 on every output. The fine depths are
ill-conditioned where a bin holds little CDF mass: a draw moves by the
CDF's last-bit difference (a few 2^-24) over the bin's mass, times the
bin's width. The main cases keep every bin's mass above 1e-2; the opaque
case lets masses fall to ~1e-4 and bounds z_union by that conditioning.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.ops.pallas.fused_composite import (CompositeSpec,
                                                      fused_composite)
from hypernerf_tpu.ops.sampling import sorted_uniform
from hypernerf_tpu_torch.kernels import fused_composite as port_composite
from hypernerf_tpu_torch.kernels import fused_composite_plain

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
