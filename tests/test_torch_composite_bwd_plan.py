"""The compositing backward's lane plan (``csrc/fused_composite_bwd.cu``: a
warp per ray, its 32 lanes over the samples in chunks) mirrored in torch on
the CPU: the forward pass's product scan of 1 - alpha + 1e-5 and sum scan of
the weights, each with its carry from one chunk to the next, and the median
by a ballot; the backward pass from the last chunk down, with the strict
tail sum_{t > s} g_w w as a reverse scan plus the later chunks' carry, d z's
neighbour term from the lane below and, at a chunk's first lane, from the
chunk below, and d |d| as a warp sum. Held against
``fused_composite_bwd_plain`` and against the JAX kernel's backward
(``_fused_bwd``, whose tile body is ``_backward_tile``) in interpret mode, at
S = 40 (a ragged last chunk), 64 and 128, white background and sample at
infinity both ways, with sigma noise.

Tolerance: 1e-5 of each output's largest entry, the card's
(``chip_smoke.py`` ``COMPOSITE_GRAD_TOL``): fp32 everywhere, the scans sum in
another order than the plain version's cumulative sums. d z leaves out the
rays whose cumulative weight passes within 1e-5 of 0.5, where another order
of sums may pick the median's neighbour.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.ops.pallas.fused_composite import CompositeSpec
from hypernerf_tpu.ops.pallas.fused_composite import _fused as _jax_fused
from hypernerf_tpu_torch.kernels import build, fused_composite_plain
from hypernerf_tpu_torch.kernels.fused_composite import (
    fused_composite_bwd, fused_composite_bwd_plain)
from tests.test_torch_composite_plan import (EPS, LANES, _scan, _shift,
                                             _warp_sum)

TOL = 1e-5  # chip_smoke.py's COMPOSITE_GRAD_TOL, of each output's max
NAMES = ('d_packed', 'd_z', 'd_dnorm', 'd_noise')


def _shift_down(v, d, fill):
    """__shfl_down_sync by d (lanes past 31 - d keep ``fill``)."""
    out = fill.clone()
    out[:, :-d] = v[:, d:]
    return out


def _softplus(x):
    return torch.log1p(torch.exp(-x.abs())) + x.clamp(min=0)


def _kernel_bwd(packed, z, dirs, noise, d_outs, d_w, white, infinity,
                edge_carry=True):
    """The kernel's arithmetic, every ray's warp at once: (d packed, d z,
    d dnorm, d noise). ``edge_carry`` False drops the neighbour term that
    crosses a chunk edge (a broken plan, for the test that it matters)."""
    r, s = z.shape
    pk = packed.reshape(r, s, 4)
    dn = torch.sqrt(dirs[:, 0] * dirs[:, 0] + dirs[:, 1] * dirs[:, 1]
                    + dirs[:, 2] * dirs[:, 2])[:, None]
    last = 1e7 if infinity else 1e-7
    lanes = torch.arange(LANES)
    zero = torch.zeros(())
    d_r, d_g, d_b = d_outs[:, 0:1], d_outs[:, 1:2], d_outs[:, 2:3]
    d_depth, d_med, d_acc = d_outs[:, 3:4], d_outs[:, 4:5], d_outs[:, 5:6]
    wsum = d_r + d_g + d_b if white else torch.zeros(r, 1)

    # Forward: what the warp leaves in shared memory, and the median.
    raw_sh = torch.zeros(r, s)
    tr_sh = torch.zeros(r, s)
    carry_t, carry_w = torch.ones(r, 1), torch.zeros(r, 1)
    med = torch.full((r,), -1)
    chunks = list(range(0, s, LANES))
    for s0 in chunks:
        idx = s0 + lanes
        inn, nxt = idx < s, idx + 1 < s
        at = idx.clamp(max=s - 1)
        zc = torch.where(inn, z[:, at], zero)
        zn = torch.where(nxt, z[:, (idx + 1).clamp(max=s - 1)], zero)
        raw = torch.where(inn, pk[:, at, 3] + noise[:, at], zero)
        dist = torch.where(nxt, zn - zc, torch.full_like(zc, last)) * dn
        alpha = torch.where(inn, 1 - torch.exp(-(_softplus(raw) * dist)),
                            zero)
        incl = _scan(torch.where(inn, 1 - alpha + EPS, torch.ones(())),
                     torch.mul)
        excl = _shift(incl, 1, torch.ones_like(incl))
        tr = carry_t * excl
        w = alpha * tr
        carry_t = carry_t * incl[:, -1:]
        cum = carry_w + _scan(w, torch.add)
        carry_w = cum[:, -1:]
        hit = inn & (cum >= 0.5)
        first = torch.where(hit, lanes, torch.full_like(lanes, LANES)).min(
            -1).values
        med = torch.where((med < 0) & (first < LANES), s0 + first, med)
        keep = idx[inn]
        raw_sh[:, keep] = raw[:, inn]
        tr_sh[:, keep] = tr[:, inn]

    # Backward, from the last chunk down.
    d_packed = torch.zeros(r, s, 4)
    d_z = torch.zeros(r, s)
    tail = torch.zeros(r, 1)
    pending = torch.zeros(r)
    dn_acc = torch.zeros(r, LANES)
    for s0 in reversed(chunks):
        idx = s0 + lanes
        inn, nxt = idx < s, idx + 1 < s
        at = idx.clamp(max=s - 1)
        p = torch.where(inn[None, :, None], pk[:, at], zero)
        raw = torch.where(inn, raw_sh[:, at], zero)
        sigma = _softplus(raw)
        zc = torch.where(inn, z[:, at], zero)
        dist_raw = torch.where(nxt, z[:, (idx + 1).clamp(max=s - 1)] - zc,
                               torch.full_like(zc, last))
        dist = dist_raw * dn
        e = torch.exp(-(sigma * dist))
        alpha = 1 - e
        u = 1 - alpha + EPS
        tr = torch.where(inn, tr_sh[:, at], zero)
        w = alpha * tr
        rgb = torch.sigmoid(p[..., :3])
        g_w = torch.where(inn, d_w[:, at], zero) + zc * d_depth
        g_w = g_w + rgb[..., 0] * d_r
        g_w = g_w + rgb[..., 1] * d_g
        g_w = g_w + rgb[..., 2] * d_b
        g_w = g_w - wsum
        g_w = g_w + torch.where(nxt | (not infinity), d_acc, zero)
        gw_w = torch.where(inn, g_w * w, zero)
        incl = gw_w
        for d in (1, 2, 4, 8, 16):
            incl = incl + _shift_down(incl, d, torch.zeros_like(incl))
        later = _shift_down(incl, 1, torch.zeros_like(incl))
        d_u = (tail + later) / u
        tail = tail + incl[:, :1]
        d_alpha = g_w * tr - d_u
        exp_term = 1 - alpha
        d_sigma = d_alpha * dist * exp_term
        d_dist = d_alpha * sigma * exp_term
        d_raw = d_sigma * torch.sigmoid(raw)
        d_logits = w[..., None] * torch.cat([d_r, d_g, d_b], -1)[:, None] \
            * rgb * (1 - rgb)
        keep = idx[inn]
        d_packed[:, keep] = torch.cat([d_logits, d_raw[..., None]],
                                      -1)[:, inn]
        dn_acc = dn_acc + torch.where(inn, d_dist * dist_raw, zero)
        d_draw = torch.where(nxt, d_dist * dn, zero)
        own = w * d_depth + torch.where(idx[None] == med[:, None], d_med,
                                        zero) - d_draw
        below = _shift(d_draw, 1, d_draw)
        mid = inn & (lanes > 0)
        d_z[:, idx[mid]] = (own + below)[:, mid]
        if s0 + LANES < s:  # the chunk above's first sample
            d_z[:, s0 + LANES] = pending + (d_draw[:, -1] if edge_carry
                                            else 0.0)
        pending = own[:, 0]
    d_z[:, 0] = pending
    d_dnorm = _warp_sum(dn_acc)[:, :1]
    return (d_packed.reshape(r * s, 4), d_z, d_dnorm, d_packed[..., 3])


def _inputs(r, s, seed):
    """chip_smoke.py's compositing inputs, a noise and the cotangents."""
    rs = np.random.RandomState(seed)
    packed = rs.randn(r * s, 4).astype(np.float32) * 2.0
    z = np.sort(rs.rand(r, s).astype(np.float32) * 0.9 + 0.05, axis=-1)
    dirs = rs.randn(r, 3).astype(np.float32)
    noise = rs.randn(r, s).astype(np.float32)
    d_outs = rs.randn(r, 6).astype(np.float32)
    d_w = (rs.randn(r, s) * 0.1).astype(np.float32)
    return packed, z, dirs, noise, d_outs, d_w


def _median_edge(packed, z, dirs, noise, white, infinity):
    cum = torch.cumsum(fused_composite_plain(
        packed, z, dirs, None, white, infinity, noise)['weights'], dim=-1)
    return ((cum - 0.5).abs() < 1e-5).any(-1)


def _assert_close(got, want, edge):
    for name, a, b in zip(NAMES, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        if name == 'd_z':
            a, b = a[~edge], b[~edge]
        assert np.abs(a - b).max() <= TOL * np.abs(b).max(), name


@pytest.mark.parametrize('s', [40, 64, 128, 192])
@pytest.mark.parametrize('white,infinity', [(False, True), (True, False),
                                            (True, True), (False, False)])
def test_mirror_holds_to_plain(s, white, infinity):
    """The lane plan's outputs against ``fused_composite_bwd_plain``, which
    is also what ``fused_composite_bwd`` runs on CPU tensors."""
    args = [torch.from_numpy(a) for a in _inputs(24, s, s + 10 * white
                                                 + 20 * infinity)]
    packed, z, dirs, noise, d_outs, d_w = args
    got = _kernel_bwd(packed, z, dirs, noise, d_outs, d_w, white, infinity)
    want = fused_composite_bwd(packed, z, dirs, noise, d_outs, d_w, white,
                               infinity)
    edge = _median_edge(packed, z, dirs, noise, white, infinity).numpy()
    _assert_close(got, want, edge)
    # Every ray's median sample gets d med_depth: some rays cross 0.5.
    assert (got[1].numpy() != 0).all()


def _jax_bwd(packed, z, dirs, noise, d_outs, d_w, white, infinity):
    """The JAX kernel's backward (``_fused_bwd``) in interpret mode: d
    packed, d z, d |d| and d noise for the cotangents of [rgb | depth |
    med_depth | acc] and of the weights."""
    r, s = z.shape
    spec = CompositeSpec(samples=s, rays_per_tile=8, has_noise=True,
                         use_white_background=white,
                         sample_at_infinity=infinity, interpret=True)

    def loss(packed, z_vals, dnorm, noise):
        pk8 = jnp.concatenate([packed, jnp.zeros_like(packed)], -1)
        outs, weights, _ = _jax_fused(spec, pk8, z_vals, dnorm, noise, None)
        return (jnp.sum(outs[:, :6] * jnp.asarray(d_outs))
                + jnp.sum(weights * jnp.asarray(d_w)))

    dnorm = np.linalg.norm(dirs, axis=-1, keepdims=True).astype(np.float32)
    g = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(packed), jnp.asarray(z), jnp.asarray(dnorm),
        jnp.asarray(noise))
    return [np.asarray(v, np.float32) for v in g]


@pytest.mark.parametrize('s,white,infinity', [(40, False, True),
                                              (64, True, False),
                                              (128, False, True)])
def test_mirror_holds_to_the_jax_kernel(s, white, infinity):
    """The lane plan against the JAX kernel's backward (``_fused_bwd`` ->
    ``_backward_tile``) in interpret mode on the same numbers."""
    arrays = _inputs(16, s, 100 + s)
    args = [torch.from_numpy(a) for a in arrays]
    got = _kernel_bwd(*args, white, infinity)
    want = _jax_bwd(*arrays, white, infinity)
    edge = _median_edge(args[0], args[1], args[2], args[3], white,
                        infinity).numpy()
    _assert_close(got, want, edge)


def test_neighbour_term_crosses_the_chunk_edge():
    """d z at a chunk's first sample (32, 64, 96) holds d dist of the sample
    below, which the kernel adds only once the chunk below is walked: the
    plan without that carry leaves d z off at those samples alone."""
    s = 128
    args = [torch.from_numpy(a) for a in _inputs(8, s, 7)]
    dnorm = torch.linalg.norm(args[2], dim=-1, keepdim=True)
    want = fused_composite_bwd_plain(args[0], args[1], dnorm, args[3],
                                     args[4], args[5])[1]
    tol = TOL * want.abs().max()
    got = _kernel_bwd(*args, False, True)[1]
    assert (got - want).abs().max() <= tol
    cut = _kernel_bwd(*args, False, True, edge_carry=False)[1]
    off = ((cut - want).abs() > tol).any(0).nonzero()[:, 0].tolist()
    assert off == [32, 64, 96]


def test_source_holds_the_plan():
    """The C source runs the plan mirrored here: a warp per ray, the
    forward's scans as the compositing forward's, the reverse tail scan with
    its carry, the neighbour term by a shuffle and across the chunk edge."""
    src = ' '.join((build.CSRC / 'fused_composite_bwd.cu').read_text()
                   .split())
    for line in (
            'const long long r = (long long)blockIdx.x * kWarps + wid;',
            'carry_t = __fmul_rn(carry_t, __shfl_sync(kAll, incl, 31));',
            'const unsigned hit = __ballot_sync(kAll, in && cum >= 0.5f);',
            'if (med < 0 && hit) med = s0 + __ffs(hit) - 1;',
            'for (int s0 = (S - 1) / 32 * 32; s0 >= 0; s0 -= 32) {',
            'const float incl = scan_add_down(gw_w, lane);',
            'const float d_u = (tail + later) / u;',
            'tail += __shfl_sync(kAll, incl, 0);',
            'const float below = __shfl_up_sync(kAll, d_draw, 1);',
            'if (lane == 31 && s0 + 32 < S) dzr[s0 + 32] = pending + d_draw;',
            'pending = __shfl_sync(kAll, own, 0);',
            'if (!sample_at_infinity || has_next) g_w += d_acc;'):
        assert line in src, line
