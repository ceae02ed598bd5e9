"""The port's plain ops against hypernerf_tpu.ops, same numpy inputs.

Tolerance 1e-5 absolute at float32: both sides run the same fp32 formulas
and differ only in the last bits of sin / exp and in summation order.
"""

import importlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu_torch.ops import posenc, rendering, sampling
from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict

# hypernerf_tpu.ops re-exports functions under its submodules' names.
jposenc = importlib.import_module('hypernerf_tpu.ops.posenc')
jrendering = importlib.import_module('hypernerf_tpu.ops.rendering')
jsampling = importlib.import_module('hypernerf_tpu.ops.sampling')

TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


def _rays(n=6, seed=0):
    rs = np.random.RandomState(seed)
    o = (rs.randn(n, 3) * 0.1).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize('n_freqs,log_scale', [(0, True), (4, True),
                                               (10, True), (3, False)])
def test_posenc_orig(n_freqs, log_scale):
    x = np.random.RandomState(1).randn(5, 7, 3).astype(np.float32)
    want = jposenc.posenc_orig(jnp.asarray(x), n_freqs, log_scale)
    got = posenc.posenc_orig(torch.from_numpy(x), n_freqs, log_scale)
    assert got.shape[-1] == posenc.posenc_orig_channels(3, n_freqs)
    _close(got, want)


@pytest.mark.parametrize('min_deg,max_deg,identity,alpha', [
    (0, 8, False, None), (0, 8, False, 3.5), (2, 6, True, 1.25),
    (0, 4, True, None), (1, 5, False, 0.0), (0, 8, False, 8.0)])
def test_posenc_nerfies(min_deg, max_deg, identity, alpha):
    """Layout [x? | sin bands | cos bands], band k of channel c at k * C + c,
    scales 2^[min_deg, max_deg), the Hann window on alpha - band with bands
    counted from min_deg; values 1e-6, and the same gradient (the JAX
    function carries an analytic VJP, the port autograd)."""
    jax_posenc = importlib.import_module('hypernerf_tpu.ops.posenc')
    x = np.random.RandomState(4).randn(5, 7, 3).astype(np.float32)
    jalpha = None if alpha is None else jnp.float32(alpha)
    want = jax_posenc.posenc(jnp.asarray(x), min_deg, max_deg, identity,
                             jalpha)
    xt = torch.from_numpy(x).requires_grad_()
    got = posenc.posenc(xt, min_deg, max_deg, identity, alpha)
    assert got.shape[-1] == posenc.posenc_channels(3, min_deg, max_deg,
                                                   identity)
    assert posenc.posenc_channels(3, min_deg, max_deg, identity) == \
        jax_posenc.posenc_channels(3, min_deg, max_deg, identity)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    cot = np.random.RandomState(5).randn(*got.shape).astype(np.float32)
    want_g = jax.grad(lambda a: jnp.sum(jax_posenc.posenc(
        a, min_deg, max_deg, identity, jalpha) * cot))(jnp.asarray(x))
    got_g, = torch.autograd.grad(got, xt, torch.from_numpy(cot))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-4)
    if max_deg - min_deg == 8 and not identity and alpha is None:
        # Band 2 of channel 1 sits at column 2 * 3 + 1, its cosine 24 on.
        np.testing.assert_allclose(got.detach().numpy()[..., 7],
                                   np.sin(x[..., 1] * 4.0), atol=1e-6)
        np.testing.assert_allclose(got.detach().numpy()[..., 24 + 7],
                                   np.cos(x[..., 1] * 4.0), atol=1e-6)


@pytest.mark.parametrize('min_deg,max_deg,alpha', [(0, 8, 3.5), (0, 8, 0.0),
                                                   (0, 8, 9.0), (2, 6, 3.25),
                                                   (0, 10, 4.5)])
def test_posenc_window(min_deg, max_deg, alpha):
    jax_posenc = importlib.import_module('hypernerf_tpu.ops.posenc')
    want = np.asarray(jax_posenc.posenc_window(min_deg, max_deg,
                                               jnp.float32(alpha)))
    got = posenc.posenc_window(min_deg, max_deg, alpha).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # Fully on once alpha >= band + 1, off while alpha <= band.
    bands = np.arange(min_deg, max_deg)
    assert np.all(got[alpha >= bands + 1] == 1.0)
    assert np.all(got[alpha <= bands] == 0.0)


@pytest.mark.parametrize('segments,alphas', [
    (((3, 8, 0, False), (8, 0)), (3.5, None)),
    (((3, 8, 0, False), (8, 0)), (None, None)),
    (((3, 10), (8, 0)), (4.5, None)),
    (((3, 6, 2, True), (4, 3, 1, False)), (2.25, 1.5))])
def test_encoding_scales_match_jax(segments, alphas):
    """The window row over a segmented encoding against
    ``fused_field.encoding_scales`` (whose row is padded to the TPU's lane
    width; the port pads per kernel)."""
    from hypernerf_tpu.ops.pallas.fused_field import encoding_scales
    from hypernerf_tpu_torch.kernels.common import \
        encoding_scales as port_scales
    want = np.asarray(encoding_scales(
        segments, [None if a is None else jnp.float32(a) for a in alphas]))[0]
    got = port_scales(segments, alphas).numpy()
    np.testing.assert_allclose(got, want[:got.shape[0]], rtol=0, atol=1e-6)
    assert not want[got.shape[0]:].any()


@pytest.mark.parametrize('stratified,disparity', [(False, False),
                                                  (False, True),
                                                  (True, False)])
def test_sample_along_rays(stratified, disparity):
    o, d = _rays()
    near = np.linspace(0.2, 0.5, 6).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want_z, want_p = jsampling.sample_along_rays(
        key, jnp.asarray(o), jnp.asarray(d), 9, jnp.asarray(near), 2.0,
        stratified, disparity)
    # The JAX function draws its jitter from `key`; hand the same draws over.
    t_rand = np.array(jax.random.uniform(key, (6, 9)))
    got_z, got_p = sampling.sample_along_rays(
        torch.from_numpy(o), torch.from_numpy(d), 9, torch.from_numpy(near),
        2.0, stratified, disparity, t_rand=torch.from_numpy(t_rand))
    _close(got_z, want_z)
    _close(got_p, want_p)


@pytest.mark.parametrize('stratified', [False, True])
def test_sample_pdf(stratified):
    rs = np.random.RandomState(2)
    o, d = _rays()
    z = np.sort(rs.rand(6, 12).astype(np.float32) * 2 + 0.5, axis=-1)
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    weights = rs.rand(6, 10).astype(np.float32)
    weights[0] = 0.0        # empty ray: the eps floor decides
    weights[1, 3:] = 0.0    # mass in the first bins only
    key = jax.random.PRNGKey(5)
    want_z, want_p = jsampling.sample_pdf(
        key, jnp.asarray(bins), jnp.asarray(weights), jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(z), 16, stratified)
    u = (np.array(jsampling.sorted_uniform(key, 6, 16)) if stratified
         else None)
    got_z, got_p = sampling.sample_pdf(
        torch.from_numpy(bins), torch.from_numpy(weights), torch.from_numpy(o),
        torch.from_numpy(d), torch.from_numpy(z), 16, stratified,
        u=None if u is None else torch.from_numpy(u))
    _close(got_z, want_z)
    _close(got_p, want_p)


@pytest.mark.parametrize('white,infinity', [(False, True), (False, False),
                                            (True, True)])
def test_volumetric_rendering(white, infinity):
    rs = np.random.RandomState(4)
    rgb = rs.rand(7, 11, 3).astype(np.float32)
    sigma = (rs.rand(7, 11) * 3).astype(np.float32)
    sigma[0] = 0.0
    z = np.sort(rs.rand(7, 11).astype(np.float32) * 3 + 0.1, axis=-1)
    d = rs.randn(7, 3).astype(np.float32)
    want = jrendering.volumetric_rendering(
        jnp.asarray(rgb), jnp.asarray(sigma), jnp.asarray(z), jnp.asarray(d),
        white, infinity)
    got = rendering.volumetric_rendering(
        torch.from_numpy(rgb), torch.from_numpy(sigma), torch.from_numpy(z),
        torch.from_numpy(d), white, infinity)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])
    np.testing.assert_array_equal(
        rendering.compute_depth_index(got['weights']).numpy(),
        np.asarray(jrendering.compute_depth_index(want['weights'])))


def test_prepare_ray_dict():
    rays = np.random.RandomState(0).rand(2, 3, 9).astype(np.float32)
    rays[..., 8] = [[0, 1, 2], [3, 1, 0]]
    got = prepare_ray_dict(torch.from_numpy(rays))
    _close(got['origins'], rays.reshape(6, 9)[:, :3])
    _close(got['far'], rays.reshape(6, 9)[:, 7])
    assert got['metadata']['time'].tolist() == [[0], [1], [2], [3], [1], [0]]
    no_id = prepare_ray_dict(torch.from_numpy(rays[..., :8]))
    assert no_id['metadata']['warp'].abs().sum() == 0


def test_port_imports_no_jax():
    """The port and each of its modules import without jax."""
    mods = ['hypernerf_tpu_torch', 'hypernerf_tpu_torch.ops',
            'hypernerf_tpu_torch.kernels', 'hypernerf_tpu_torch.kernels.build',
            'hypernerf_tpu_torch.models.modules',
            'hypernerf_tpu_torch.models.warping',
            'hypernerf_tpu_torch.models.nerf',
            'hypernerf_tpu_torch.training.renderer',
            'hypernerf_tpu_torch.training.metrics',
            'hypernerf_tpu_torch.training.checkpoints',
            'hypernerf_tpu_torch.eval', 'hypernerf_tpu_torch.convert',
            'hypernerf_tpu_torch.flagship']
    code = ('import importlib, sys\n'
            f'for m in {mods!r}: importlib.import_module(m)\n'
            'bad = sorted(m for m in sys.modules\n'
            '             if m.split(".")[0] in ("jax", "flax", "optax"))\n'
            'assert not bad, bad\n')
    subprocess.run([sys.executable, '-c', code], check=True, timeout=120)


def test_flagship_spiral_rays():
    """The smoke run's rays: (H * W, 9) NDC rays, near 0, far 1, frame id."""
    from hypernerf_tpu_torch.flagship import spiral_rays
    frames = spiral_rays([0, 30], width=8, height=6)
    assert [f.shape for f in frames] == [(48, 9), (48, 9)]
    for i, rays in zip((0, 30), frames):
        assert np.isfinite(rays).all()
        assert (rays[:, 6] == 0).all() and (rays[:, 7] == 1).all()
        assert (rays[:, 8] == i).all()
        _close(rays[:, 2], -np.ones(48))  # NDC origins on the near plane
    assert not np.array_equal(frames[0][:, :6], frames[1][:, :6])


@pytest.mark.parametrize('noise_std,stratified', [(0.7, True), (0.7, False),
                                                  (0.0, True), (None, True)])
def test_noise_regularize(noise_std, stratified):
    """Same noise in (JAX's own standard-normal draws), same raw density
    out; no noise without stratified sampling or a positive deviation."""
    key = jax.random.PRNGKey(4)
    raw = np.random.RandomState(1).randn(5, 7).astype(np.float32)
    want = jrendering.noise_regularize(key, jnp.asarray(raw), noise_std,
                                       stratified)
    draws = np.array(jax.random.normal(key, raw.shape, jnp.float32))
    got = rendering.noise_regularize(torch.from_numpy(raw), noise_std,
                                     stratified,
                                     noise=torch.from_numpy(draws))
    _close(got, want)
    gen = torch.Generator().manual_seed(0)
    drawn = rendering.noise_regularize(torch.from_numpy(raw), noise_std,
                                       stratified, generator=gen)
    on = bool(noise_std) and stratified
    assert torch.equal(drawn, torch.from_numpy(raw)) != on


def test_stochastic_sampling_gradients_follow_jax():
    """The stratified coarse depths are differentiable in the rays' bounds
    (as in JAX); the hierarchical draw is not (``stop_gradient`` there,
    ``detach`` here), with explicit draws or a generator alike."""
    o, d = _rays()
    near = torch.full((6,), 0.5, requires_grad=True)
    t_rand = torch.rand(6, 8, generator=torch.Generator().manual_seed(1))
    z, _ = sampling.sample_along_rays(torch.from_numpy(o),
                                      torch.from_numpy(d), 8, near, 3.0,
                                      True, False, t_rand=t_rand)
    assert z.requires_grad
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    weights = torch.rand(6, 6, requires_grad=True)
    for kw in (dict(u=torch.sort(torch.rand(6, 5), -1)[0]),
               dict(generator=torch.Generator().manual_seed(2))):
        fine = sampling.piecewise_constant_pdf(bins, weights, 5, True, **kw)
        assert not fine.requires_grad and fine.shape == (6, 5)
        assert (fine[:, 1:] >= fine[:, :-1]).all()  # ascending u in, out
