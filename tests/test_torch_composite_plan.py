"""The compositing forward's lane plan (``csrc/fused_composite.cu``: a warp
per ray, its 32 lanes over the samples) mirrored in torch on the CPU: the
rank rule that builds z_union against ``torch.sort`` of the union, ties
included; the binary search that inverts each u_j against the two-pointer
scan of the earlier one-thread-per-ray design; and the whole kernel, its
shuffle scans with a carry from one chunk of 32 samples to the next, its
warp sums and its ballot for the median, against ``fused_composite_plain``
at the card's tolerances (``chip_smoke.py`` ``check_composite``). Random
sorted inputs at S in {5, 64, 128, 192}.

The card holds the kernel itself to the plain version (phase 4); these
tests hold the plan that the kernel's lanes follow. The rank and search
checks are exact.
"""

import numpy as np
import pytest
import torch

from hypernerf_tpu_torch.kernels import build, fused_composite_plain
from hypernerf_tpu_torch.kernels.fused_composite import MAX_SAMPLES_WITH_FINE
from hypernerf_tpu_torch.ops.sampling import sorted_uniform

SIZES = (5, 64, 128, 192)
LANES = 32
EPS = 1e-5
ATOL = 1e-4  # chip_smoke.py's COMPOSITE_ATOL


def _sorted(rs, shape, ties=False):
    x = rs.rand(*shape).astype(np.float32)
    if ties:  # a coarse grid, so values repeat
        x = np.round(x * 16) / 16
    return np.sort(x, axis=-1)


def _count(a, v, upper):
    """The kernel's count_below: #{k : a[k] <= v} (upper) or #{k : a[k] <
    v}, by bisection over ascending a."""
    lo, hi = 0, len(a)
    while lo < hi:
        mid = (lo + hi) >> 1
        if (a[mid] <= v) if upper else (a[mid] < v):
            lo = mid + 1
        else:
            hi = mid
    return lo


def _ranks(z, f):
    """z_union of one ray by ranks: coarse z_i to i + #{j : f_j < z_i},
    draw f_j to j + #{i : z_i <= f_j}."""
    out = np.full(len(z) + len(f), np.nan, dtype=np.float32)
    for i, v in enumerate(z):
        out[i + _count(f, v, upper=False)] = v
    for j, v in enumerate(f):
        out[j + _count(z, v, upper=True)] = v
    return out


def _two_pointer(z, f):
    """The earlier design's merge: a coarse depth equal to a draw first."""
    out, zi = [], 0
    for v in f:
        while zi < len(z) and z[zi] <= v:
            out.append(z[zi])
            zi += 1
        out.append(v)
    out.extend(z[zi:])
    return np.array(out, dtype=np.float32)


@pytest.mark.parametrize('s', SIZES)
@pytest.mark.parametrize('ties', [False, True])
def test_ranks_merge_like_sort(s, ties):
    """Every position of z_union is written once (the ranks are a
    permutation), the result is ``torch.sort`` of the union and the earlier
    two-pointer merge, ties (coarse depths equal to draws, equal draws,
    equal depths) included."""
    rs = np.random.RandomState(s + 100 * ties)
    for n in (1, 7, 64, 128):
        z = _sorted(rs, (s,), ties)
        f = _sorted(rs, (n,), ties)
        if ties:
            f[: n // 2] = z[rs.randint(0, s, n // 2)]
            f = np.sort(f)
        got = _ranks(z, f)
        assert not np.isnan(got).any()
        want = torch.sort(torch.from_numpy(np.concatenate([z, f])))[0]
        assert np.array_equal(got, want.numpy())
        assert np.array_equal(got, _two_pointer(z, f))


@pytest.mark.parametrize('s', SIZES)
def test_bisection_is_the_two_pointer_bracket(s):
    """Over a monotone CDF of S - 1 edges (cdf_0 = 0), the bisection count
    #{k : cdf_k <= u} of each ascending u is the index the two-pointer scan
    reaches, ``searchsorted(right=True)``'s, so the brackets [idx - 1, idx]
    clamped into [0, S - 3] x [1, S - 2] agree, ties of u with an edge and
    u = 0, 1 included."""
    assert s >= 3  # the fine draw's least
    rs = np.random.RandomState(s)
    for _ in range(20):
        pdf = rs.rand(s - 2).astype(np.float32) + EPS
        cdf = np.concatenate([[0.0], np.cumsum(pdf / pdf.sum())]).astype(
            np.float32)
        u = np.sort(np.concatenate([
            rs.rand(40).astype(np.float32), cdf[rs.randint(0, s - 1, 8)],
            np.float32([0.0, 1.0])]))
        idx, brackets = 0, []
        for uj in u:
            while idx <= s - 2 and cdf[idx] <= uj:
                idx += 1
            got = _count(cdf, uj, upper=True)
            assert got == idx == np.searchsorted(cdf, uj, side='right')
            brackets.append((min(max(got - 1, 0), s - 3),
                             max(min(got, s - 2), 1)))
        assert all(0 <= a < b <= s - 2 for a, b in brackets)


# ---------------------------------------------------------------------------
# The whole kernel, lane by lane.


def _shift(v, d, fill):
    """__shfl_up_sync by d over each ray's 32 lanes (lanes below d keep
    ``fill``, as the kernel keeps its own value there)."""
    out = fill.clone()
    out[:, d:] = v[:, :-d]
    return out


def _scan(v, op):
    for d in (1, 2, 4, 8, 16):
        o = _shift(v, d, v)
        v = torch.where(torch.arange(LANES) >= d, op(o, v), v)
    return v


def _warp_sum(v):
    for d in (16, 8, 4, 2, 1):
        v = v + v[:, torch.arange(LANES) ^ d]
    return v


def _kernel(packed, z, dirs, u, noise=None, white=False, infinity=True):
    """The kernel's arithmetic, every ray's warp at once: (outs (R, 6),
    weights, z_union or None)."""
    r, s = z.shape
    n = 0 if u is None else u.shape[1]
    pk = packed.reshape(r, s, 4)
    dn = torch.sqrt(dirs[:, 0] * dirs[:, 0] + dirs[:, 1] * dirs[:, 1]
                    + dirs[:, 2] * dirs[:, 2])
    last = 1e7 if infinity else 1e-7
    lanes = torch.arange(LANES)
    carry_t, carry_w = torch.ones(r), torch.zeros(r)
    sums = torch.zeros(6, r, LANES)  # rgb, depth, acc_all, acc_inner
    wsum = torch.zeros(r, LANES)
    weights = torch.zeros(r, s)
    pdf = torch.zeros(r, s)
    med, found = torch.zeros(r), torch.zeros(r, dtype=torch.bool)
    zero = torch.zeros(())
    for s0 in range(0, s, LANES):
        idx = s0 + lanes
        inn, nxt = idx < s, idx + 1 < s
        zc = torch.where(inn, z[:, idx.clamp(max=s - 1)], zero)
        zn = torch.where(nxt, z[:, (idx + 1).clamp(max=s - 1)], zero)
        p = torch.where(inn[None, :, None], pk[:, idx.clamp(max=s - 1)], zero)
        raw = p[..., 3] if noise is None else torch.where(
            inn, p[..., 3] + noise[:, idx.clamp(max=s - 1)], p[..., 3])
        dist = torch.where(nxt, zn - zc, torch.full_like(zc, last)) * dn[:,
                                                                        None]
        sp = torch.log1p(torch.exp(-raw.abs())) + raw.clamp(min=0)
        alpha = torch.where(inn, 1 - torch.exp(-(sp * dist)), zero)
        incl = _scan(torch.where(inn, 1 - alpha + EPS, torch.ones(())),
                     torch.mul)
        excl = _shift(incl, 1, torch.ones_like(incl))
        w = alpha * (carry_t[:, None] * excl)
        carry_t = carry_t * incl[:, -1]
        weights[:, s0:s0 + LANES] = w[:, :min(LANES, s - s0)]
        rgb = torch.sigmoid(p[..., :3])
        for c in range(3):
            sums[c] += w * rgb[..., c]
        sums[3] += w * zc
        sums[4] += w
        sums[5] += torch.where(nxt, w, zero)
        cum = carry_w[:, None] + _scan(w, torch.add)
        carry_w = cum[:, -1]
        hit = inn & (cum >= 0.5)
        first = torch.where(hit, lanes, torch.full_like(lanes, LANES)).min(
            -1).values
        new = ~found & (first < LANES)
        med = torch.where(new, zc.gather(1, first.clamp(max=LANES - 1)[:,
                                                                      None])
                          [:, 0], med)
        found |= new
        bin_ = (idx >= 1) & nxt
        pdf[:, s0:s0 + LANES] = torch.where(bin_, w + EPS, zero)[
            :, :min(LANES, s - s0)]
        wsum += torch.where(bin_, w + EPS, zero)
    tot = [_warp_sum(v)[:, 0] for v in sums]
    white_v = 1 - tot[4] if white else torch.zeros(r)
    outs = torch.stack([tot[0] + white_v, tot[1] + white_v, tot[2] + white_v,
                        tot[3], med, tot[5] if infinity else tot[4]], -1)
    if n == 0:
        return outs, weights, None
    wsum = _warp_sum(wsum)[:, 0]
    cdf = torch.zeros(r, s - 1)
    carry_c, carry_m = torch.zeros(r), torch.zeros(r)
    for k0 in range(0, s - 1, LANES):
        k = k0 + lanes
        ok = (k >= 1) & (k <= s - 2)
        v = torch.where(ok, pdf[:, k.clamp(max=s - 1)] / wsum[:, None], zero)
        c = carry_c[:, None] + _scan(v, torch.add)
        carry_c = c[:, -1]
        m = torch.maximum(carry_m[:, None], _scan(c, torch.maximum))
        carry_m = m[:, -1]
        keep = k <= s - 2
        cdf[:, k[keep]] = m[:, keep]
    mids = 0.5 * (z[:, :-1] + z[:, 1:])
    draws = torch.zeros(r, n)
    carry_f = torch.full((r,), -float('inf'))
    for j0 in range(0, n, LANES):
        j = j0 + lanes
        ok = j < n
        uj = u[:, j.clamp(max=n - 1)]
        cnt = torch.stack([torch.searchsorted(cdf[i], uj[i], right=True)
                           for i in range(r)])
        assert all(_count(cdf[0].numpy(), float(v), True) == int(c)
                   for v, c in zip(uj[0], cnt[0]))
        i0 = (cnt - 1).clamp(0, s - 3)
        i1 = cnt.clamp(max=s - 2).clamp(min=1)
        c0, c1 = cdf.gather(1, i0), cdf.gather(1, i1)
        b0, b1 = mids.gather(1, i0), mids.gather(1, i1)
        den = c1 - c0
        den = torch.where(den < EPS, torch.ones_like(den), den)
        f = torch.where(ok, b0 + ((uj - c0) / den) * (b1 - b0),
                        torch.full_like(b0, -float('inf')))
        f = torch.maximum(carry_f[:, None], _scan(f, torch.maximum))
        carry_f = f[:, -1]
        draws[:, j[ok]] = f[:, ok]
    z_union = torch.from_numpy(np.stack([
        _ranks(z[i].numpy(), draws[i].numpy()) for i in range(r)]))
    return outs, weights, z_union


def _inputs(r, s, n, seed, linspace_u, noise):
    """chip_smoke.py's ``composite_inputs`` on the CPU, and a noise."""
    g = torch.Generator().manual_seed(seed)
    packed = torch.randn(r * s, 4, generator=g) * 2.0
    z = torch.sort(torch.rand(r, s, generator=g) * 0.9 + 0.05, dim=-1)[0]
    dirs = torch.randn(r, 3, generator=g)
    u = None
    if n:
        u = (torch.linspace(0, 1, n).expand(r, n).contiguous() if linspace_u
             else sorted_uniform(r, n, g))
    sigma = torch.randn(r, s, generator=g) if noise else None
    return packed, z, dirs, u, sigma


@pytest.mark.parametrize('s,n,linspace_u,noise', [
    (5, 7, False, False), (64, 64, True, False), (64, 64, False, True),
    (128, 0, True, False), (192, 64, False, False), (64, 128, False, True)])
def test_kernel_mirror_holds_to_plain(s, n, linspace_u, noise):
    """The kernel's lane plan, with its scans' order of sums, gives the
    plain version's outputs within the card's tolerances: 1e-4 on every
    output, plus z_union's conditioning term (a few 2^-24 of CDF over a
    bin's mass, times the widest bin), the median left out on rays whose
    cumulative weight passes within 1e-5 of 0.5."""
    assert s <= MAX_SAMPLES_WITH_FINE
    packed, z, dirs, u, sigma = _inputs(48, s, n, s + n, linspace_u, noise)
    outs, weights, z_union = _kernel(packed, z, dirs, u, sigma)
    want = fused_composite_plain(packed, z, dirs, u, noise=sigma)
    edge = ((torch.cumsum(want['weights'], -1) - 0.5).abs() < 1e-5).any(-1)
    got = {'rgb': outs[:, :3], 'depth': outs[:, 3], 'med_depth': outs[:, 4],
           'acc': outs[:, 5], 'weights': weights}
    for k, v in got.items():
        d = (v - want[k]).abs()
        if k == 'med_depth':
            d = d.masked_fill(edge, 0.0)
        assert d.max() <= ATOL, k
    if n:
        w = want['weights'][:, 1:-1] + EPS
        mass = (w / w.sum(-1, keepdim=True)).min().item()
        widest = (z[:, 1:] - z[:, :-1]).max().item()
        tol = ATOL + 8 * 2.0 ** -24 / mass * widest
        assert (z_union - want['z_union']).abs().max() <= tol
        assert torch.equal(z_union, torch.sort(z_union, -1)[0])


def test_source_holds_the_plan():
    """The C source runs the plan mirrored here: a warp per ray, the tie
    rule's two counts, the bisection, the running maxima and the carries."""
    src = ' '.join((build.CSRC / 'fused_composite.cu').read_text().split())
    for line in (
            'buf[i + count_below<false>(fs, N, zs[i])] = zs[i];',
            'buf[j + count_below<true>(zs, S, fs[j])] = fs[j];',
            'const int idx = count_below<true>(buf, S - 1, uj);',
            'const int i0 = min(max(idx - 1, 0), S - 3);',
            'const int i1 = max(min(idx, S - 2), 1);',
            'if (denom < kEps) denom = 1.f;',
            'const float m = fmaxf(carry_m, scan_max(c, lane));',
            'f = fmaxf(carry_f, scan_max(f, lane));',
            'carry_t = __fmul_rn(carry_t, __shfl_sync(kAll, incl, 31));',
            'const unsigned hit = __ballot_sync(kAll, in && cum >= 0.5f);',
            'const long long r = (long long)blockIdx.x * kWarps + wid;'):
        assert line in src, line
