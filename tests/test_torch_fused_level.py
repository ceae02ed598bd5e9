"""The level kernels' plain versions, forward and backward, against the JAX
Pallas level kernel (``fused_level``, interpret mode, ray-native) in each of
its backward schedules, the template backward alone against
``fused_mlp._bwd_call``, and the composed flax modules.

Tolerances: 1e-5 absolute at float32 (same fp32 math, other summation
order). At bfloat16 both round at the same points (encodings, hidden
activations, biases, conditions), so they differ only where a last-bit fp32
difference moves a value across a bf16 rounding boundary (2^-8 relative):
allowed 1e-2 absolute on outputs of order 1 and a mean below 1e-4 (on the
CPU the two agree bit for bit here).

Gradients: 1e-5 of each gradient's largest entry at float32. At bfloat16 the
cotangent is rounded to bf16 (2^-9 relative) before every product, in both
packages at the same points, but the JAX kernel also rounds its finished dW,
db and condition gradients to bf16 (they are cotangents of its bf16-cast
weights) where the port keeps fp32, and a last-bit difference moves single
cotangent entries across a rounding boundary: allowed 2e-2 of each
gradient's largest entry (measured here: under 6e-3).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.models.modules import HyperSheetMLP, NerfMLP
from hypernerf_tpu.models.warping import TranslationField
from hypernerf_tpu.ops.pallas.fused_field import mlp_params_to_list
from hypernerf_tpu.ops.pallas.fused_level import FusedLevelSpec, fused_level
from hypernerf_tpu.ops.pallas.fused_mlp import nerf_mlp_params_to_list
from hypernerf_tpu.ops.posenc import posenc_orig
from hypernerf_tpu_torch.convert import params_from_jax
from hypernerf_tpu.ops.pallas import fused_mlp as jax_fused_mlp
from hypernerf_tpu_torch.kernels import Level, fused_level as port_level
from hypernerf_tpu_torch.kernels import (fused_fields_bwd_plain,
                                         fused_level_plain,
                                         fused_template_bwd_plain)
from hypernerf_tpu_torch.kernels.fused_level import (_level_params,
                                                     level_layers)
from hypernerf_tpu_torch.models import modules
from hypernerf_tpu_torch.models.warping import TranslationField as PWarp

R, S, E, H, C = 3, 8, 8, 4, 11


def _spec(dtype):
    return FusedLevelSpec(
        embed_ch=E, warp_depth=2, warp_width=16, warp_freq=4,
        hyper_depth=2, hyper_width=16, hyper_sheet_freq=3, hyper_out=H,
        xyz_freq=4, hyper_freq=2, trunk_depth=3, trunk_width=32,
        rgb_depth=2, rgb_width=16, rgb_cond_ch=C, alpha_cond_ch=0,
        skips=(1,), tile=8, bwd_tile=8, tmpl_bwd_tile=8, interpret=True,
        compute_dtype=dtype, cond_samples=S)


@functools.cache
def _setup(seed=0):
    rs = np.random.RandomState(seed)
    z = np.sort(rs.rand(R, S).astype(np.float32) * 1.5 + 0.2, axis=-1)
    o = (rs.randn(R, 3) * 0.2).astype(np.float32)
    d = rs.randn(R, 3).astype(np.float32)
    embed = (rs.randn(R, E) * 0.3).astype(np.float32)
    rgbc = rs.randn(R, C).astype(np.float32)
    pts = jnp.asarray(o[:, None] + z[..., None] * d[:, None])
    emb_b = jnp.broadcast_to(jnp.asarray(embed)[:, None], (R, S, E))
    warp = TranslationField(depth=2, width=16, n_freq=4, skips=(1,))
    hyper = HyperSheetMLP(out_ch=H, depth=2, width=16, n_freq=3, skips=(1,))
    tmpl = NerfMLP(trunk_depth=3, trunk_width=32, rgb_branch_depth=2,
                   rgb_branch_width=16, skips=(1,))
    wp = warp.init(jax.random.PRNGKey(0), pts, emb_b)['params']
    # A visible warp: scale the U(0, 1e-4) logit up.
    wp = jax.tree.map(lambda a: a * 300.0 if a.shape == (16, 3) else a, wp)
    hp = hyper.init(jax.random.PRNGKey(1), pts, emb_b)['params']
    hp = jax.tree.map(lambda a: a * 1e4 if a.shape == (16, H) else a, hp)
    feat = jnp.zeros((R, S, 3 * 9 + H * 5))
    tp = tmpl.init(jax.random.PRNGKey(2), feat,
                   rgb_condition=jnp.asarray(rgbc))['params']
    data = dict(z=z, o=o, d=d, embed=embed, rgbc=rgbc)
    return data, (warp, wp), (hyper, hp), (tmpl, tp)


def _port_level(wp, hp, tp, dtype):
    dt = modules.torch_dtype(dtype)
    warp = PWarp(E, 2, 16, 4, (1,), dtype=dt)
    hyper = modules.HyperSheetMLP(E, H, 2, 16, 3, (1,), dtype=dt)
    tmpl = modules.NerfMLP(3 * 9 + H * 5, C, 3, 32, 2, 16, skips=(1,),
                           dtype=dt)
    for mod, p in ((warp, wp), (hyper, hp), (tmpl, tp)):
        mod.load_state_dict(params_from_jax(jax.device_get(p)))
    return Level(warp, hyper, tmpl, 4, 2)


def _jax_kernel(data, wp, hp, tp, dtype):
    packed = fused_level(
        _spec(dtype), None, jnp.asarray(data['embed']),
        jnp.asarray(data['rgbc']), None, mlp_params_to_list(wp['mlp']),
        mlp_params_to_list(hp['mlp']), nerf_mlp_params_to_list(tp),
        origins=jnp.asarray(data['o']), directions=jnp.asarray(data['d']),
        z_vals=jnp.asarray(data['z']), return_packed=True)
    return np.asarray(packed)[:, :4]


def _port(level, data):
    args = [torch.from_numpy(data[k]) for k in ('z', 'o', 'd', 'embed',
                                                  'rgbc')]
    return port_level(level, *args).detach().numpy()


@pytest.mark.parametrize('dtype,atol,mean_tol', [('float32', 1e-5, 1e-5),
                                                 ('bfloat16', 1e-2, 1e-4)])
def test_plain_level_matches_jax_kernel(dtype, atol, mean_tol):
    data, (_, wp), (_, hp), (_, tp) = _setup()
    want = _jax_kernel(data, wp, hp, tp, dtype)
    calls = fused_level_plain.calls
    got = _port(_port_level(wp, hp, tp, dtype), data)
    assert fused_level_plain.calls == calls + 1  # CPU tensors: the plain path
    assert got.shape == (R * S, 4)
    diff = np.abs(got - want)
    assert diff.max() <= atol, diff.max()
    assert diff.mean() <= mean_tol, diff.mean()


def test_plain_level_matches_flax_composition():
    """The dense JAX modules chained by hand at float32."""
    data, (warp, wp), (hyper, hp), (tmpl, tp) = _setup()
    pts = jnp.asarray(data['o'][:, None]
                      + data['z'][..., None] * data['d'][:, None])
    emb_b = jnp.broadcast_to(jnp.asarray(data['embed'])[:, None], (R, S, E))
    warped = warp.apply({'params': wp}, pts, emb_b)['warped_points']
    hyper_pts = hyper.apply({'params': hp}, pts, emb_b)
    feat = jnp.concatenate([posenc_orig(warped, 4),
                            posenc_orig(hyper_pts, 2)], -1)
    raw = tmpl.apply({'params': tp}, feat,
                     rgb_condition=jnp.asarray(data['rgbc']))
    want = np.concatenate([np.asarray(raw['rgb']), np.asarray(raw['alpha'])],
                          -1).reshape(R * S, 4)
    got = _port(_port_level(wp, hp, tp, 'float32'), data)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_packed_weights_follow_parameter_updates():
    """The level kernel's cached bf16 blobs are repacked after an in-place
    update of a parameter and after load_state_dict."""
    from hypernerf_tpu_torch.flagship import flagship_model
    from hypernerf_tpu_torch.kernels.fused_level import pack_level

    def fresh(model):  # a copy's parameters have new storage: no cache hit
        return pack_level(copy.deepcopy(model).level('coarse'))

    model = flagship_model('cpu', seed=0)
    level = model.level('coarse')
    w0, b0, shapes = pack_level(level)
    assert sum(n * k for n, k in shapes) == w0.numel()
    assert sum(n for n, _ in shapes) == b0.numel()
    assert pack_level(level)[0] is w0  # unchanged parameters: the cache
    with torch.no_grad():
        level.warp.mlp.logit.weight.add_(0.5)
        level.template.alpha_head.bias.sub_(0.25)
    w1, b1, _ = pack_level(level)
    assert not torch.equal(w1, w0) and not torch.equal(b1, b0)
    assert all(torch.equal(a, b) for a, b in zip((w1, b1), fresh(model)))
    model.load_state_dict(flagship_model('cpu', seed=1).state_dict())
    w2, b2, _ = pack_level(level)
    assert not torch.equal(w2, w1)
    assert all(torch.equal(a, b) for a, b in zip((w2, b2), fresh(model)))


def test_stored_jax_level_reference():
    """tests/data/fused_level_jax_ref.npz, what chip_smoke.py holds the CUDA
    level kernel to on the card, is the JAX kernel's output (interpret mode,
    flagship widths, bf16) at the numpy probe weights and its stored inputs,
    and the port's plain level matches it. The bf16 tolerance above holds
    both: a JAX or torch of another version may sum in another order."""
    from hypernerf_tpu_torch.flagship import (LEVEL_REFERENCE_CASES,
                                              probe_inputs,
                                              read_level_reference)
    from tools.make_level_reference import jax_level, probe_model
    model = probe_model()
    reference = read_level_reference()
    for name, n_rays, samples, seed in LEVEL_REFERENCE_CASES:
        inputs, want = reference[name]
        assert want.shape == (n_rays * samples, 4)
        for k, v in probe_inputs(n_rays, samples, seed).items():
            np.testing.assert_allclose(inputs[k], v, rtol=0, atol=1e-6)
        args = [torch.from_numpy(v) for v in inputs.values()]
        with torch.no_grad():
            port = port_level(model.level(name), *args).numpy()
        for got in (jax_level(model, name, inputs), port):
            diff = np.abs(got - want)
            assert diff.max() <= 1e-2, (name, diff.max())
            assert diff.mean() <= 1e-4, (name, diff.mean())


# -- backward ---------------------------------------------------------------

SCHEDULES = {'single': dict(split_bwd=False, pipelined_bwd=False),
             'split': dict(split_bwd=True, pipelined_bwd=False),
             'pipelined': dict(split_bwd=True, pipelined_bwd=True)}
GRAD_TOL = {'float32': 1e-5, 'bfloat16': 2e-2}
# bf16 at the flagship's widths and probe weights: see
# test_stored_jax_gradient_reference.
FLAGSHIP_GRAD_L2, FLAGSHIP_GRAD_MAX = 5e-2, 0.25
_INPUTS = ('z', 'o', 'd', 'embed', 'rgbc')


def _cotangent():
    return np.random.RandomState(7).randn(R * S, 4).astype(np.float32)


def _flax_grads_to_list(gw, gh, gt):
    """JAX (dW (in, out), db) pair lists -> [dW (out, in), db, ...] in the
    port's kernel order."""
    out = []
    for w, b in list(gw) + list(gh) + list(gt):
        out += [np.asarray(w).T, np.asarray(b)]
    return out


def _jax_level_grads(data, wp, hp, tp, spec, cot):
    """Gradients of sum(packed * cot) through the JAX level kernel: the
    five ray inputs in ``_INPUTS`` order, then the 2 x layers parameter
    gradients in the port's layout."""
    pairs = (mlp_params_to_list(wp['mlp']), mlp_params_to_list(hp['mlp']),
             nerf_mlp_params_to_list(tp))

    def loss(z, o, d, embed, rgbc, warp_pairs, hyper_pairs, tmpl_pairs):
        packed = fused_level(spec, None, embed, rgbc, None, warp_pairs,
                             hyper_pairs, tmpl_pairs, origins=o,
                             directions=d, z_vals=z, return_packed=True)
        return jnp.sum(packed[:, :4] * jnp.asarray(cot))

    g = jax.grad(loss, argnums=tuple(range(8)))(
        *[jnp.asarray(data[k]) for k in _INPUTS], *pairs)
    return [np.asarray(a) for a in g[:5]] + _flax_grads_to_list(*g[5:])


def _port_level_grads(level, data, cot):
    args = [torch.from_numpy(data[k]).requires_grad_() for k in _INPUTS]
    out = port_level(level, *args)
    grads = torch.autograd.grad(out, args + _level_params(level),
                                torch.from_numpy(cot))
    return [g.numpy() for g in grads]


def _assert_grads_close(got, want, tol):
    names = list(_INPUTS) + [f'layer{i // 2}.{"Wb"[i % 2]}'
                             for i in range(len(got) - 5)]
    assert len(got) == len(want) == len(names)
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)
        assert err <= tol, (name, err)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('schedule', sorted(SCHEDULES))
def test_plain_level_backward_matches_jax_schedule(schedule, dtype):
    """Template backward then fields backward (``FusedLevelFn`` on CPU
    tensors) against the JAX level's gradients under each backward
    schedule: every input's and all 2 x 16 layers' dW / db, unpacked. The
    JAX backward tile (16) differs from its forward tile (8) and does not
    divide the 24 rows, so its row padding is in play."""
    data, (_, wp), (_, hp), (_, tp) = _setup()
    spec = _spec(dtype)._replace(bwd_tile=16, tmpl_bwd_tile=16,
                                 **SCHEDULES[schedule])
    cot = _cotangent()
    want = _jax_level_grads(data, wp, hp, tp, spec, cot)
    level = _port_level(wp, hp, tp, dtype)
    calls = (fused_template_bwd_plain.calls, fused_fields_bwd_plain.calls)
    got = _port_level_grads(level, data, cot)
    assert (fused_template_bwd_plain.calls,
            fused_fields_bwd_plain.calls) == (calls[0] + 1, calls[1] + 1)
    assert len(got) == 5 + 2 * len(level_layers(level))
    _assert_grads_close(got, want, GRAD_TOL[dtype])


def test_plain_level_backward_matches_autograd():
    """At float32 the explicit backward is the autograd of the plain
    forward."""
    data, (_, wp), (_, hp), (_, tp) = _setup()
    level = _port_level(wp, hp, tp, 'float32')
    cot = _cotangent()
    args = [torch.from_numpy(data[k]).requires_grad_() for k in _INPUTS]
    want = torch.autograd.grad(fused_level_plain(level, *args),
                               args + _level_params(level),
                               torch.from_numpy(cot))
    _assert_grads_close(_port_level_grads(level, data, cot),
                        [g.numpy() for g in want], 1e-5)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_plain_template_backward_matches_jax_bwd_call(dtype):
    """Kernel A's plain version alone against ``fused_mlp._bwd_call`` (the
    TPU template backward kernel, interpret mode) on the same ``raw_t``."""
    data, (_, wp), (_, hp), (_, tp) = _setup()
    level = _port_level(wp, hp, tp, dtype)
    args = [torch.from_numpy(data[k]) for k in _INPUTS]
    with torch.no_grad():
        _, raw_t = fused_level_plain(level, *args, return_raw_t=True)
    cot = _cotangent()
    fs = _spec(dtype)._replace(tmpl_bwd_tile=16).tmpl_fs
    dt = jnp.dtype(dtype)
    pad_rows = 32 - R * S  # whole rays: 4 rays of 8 samples
    raw_pad = jnp.pad(jnp.asarray(raw_t.numpy()), ((0, pad_rows), (0, 0)))
    rgbc_pad = jnp.pad(jnp.asarray(data['rgbc']).astype(dt),
                       ((0, pad_rows // S), (0, fs.rc - C)))
    g_pad = jnp.pad(jnp.asarray(cot), ((0, pad_rows), (0, 4)))
    padded = jax_fused_mlp._pad_params(fs, nerf_mlp_params_to_list(tp))
    outs = jax_fused_mlp._bwd_call(fs, raw_pad, rgbc_pad, None, padded,
                                   g_pad)
    defs = jax_fused_mlp._layer_defs(fs)
    want = [np.asarray(outs[0])[:R * S], np.asarray(outs[1])[:R, :C]]
    pairs = nerf_mlp_params_to_list(tp)
    for k, ((_, segs, _), (w, _)) in enumerate(zip(defs, pairs)):
        dw = jax_fused_mlp._unpad_weight_grad(outs[2 + 2 * k], segs,
                                              w.shape[1])
        want += [np.asarray(dw).T, np.asarray(outs[3 + 2 * k])[0,
                                                                :w.shape[1]]]
    with torch.no_grad():
        dx_t, d_cond, grads, _ = fused_template_bwd_plain(
            level, raw_t, torch.from_numpy(data['rgbc']),
            torch.from_numpy(cot))
    got = [dx_t.numpy(), d_cond.numpy()] + [g.numpy() for g in grads]
    tol = GRAD_TOL[dtype]
    assert len(got) == len(want) == 2 + 2 * 9  # dx_t, d cond, 9 layers
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)
        assert err <= tol, (i, err)


def test_fields_backward_sums_both_levels():
    """``warp`` and ``hyper`` are shared by the two levels: two calls
    through ``FusedLevelFn`` add their gradients up in autograd."""
    data, (_, wp), (_, hp), (_, tp) = _setup()
    level = _port_level(wp, hp, tp, 'float32')
    cot = torch.from_numpy(_cotangent())
    args = [torch.from_numpy(data[k]) for k in _INPUTS]
    shared = list(level.warp.parameters()) + list(level.hyper.parameters())
    once = torch.autograd.grad((port_level(level, *args) * cot).sum(), shared)
    twice = torch.autograd.grad(
        (port_level(level, *args) * cot).sum()
        + (port_level(level, *args) * cot).sum(), shared)
    for a, b in zip(once, twice):
        np.testing.assert_allclose(2 * a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-9)
    with torch.no_grad():
        d_z, d_o, d_d, d_e, grads = fused_fields_bwd_plain(
            level, *args[:4], torch.randn(R * S, 8))
    assert d_z.shape == (R, S) and d_o.shape == d_d.shape == (R, 3)
    assert d_e.shape == (R, E) and len(grads) == 2 * 6


def test_stored_jax_gradient_reference():
    """tests/data/fused_jax_grads.npz, what chip_smoke.py holds the CUDA
    backward kernels to on the card: the level part is the JAX level
    kernel's gradients (interpret mode, flagship widths, bf16, the default
    pipelined schedule) at the numpy probe weights, and the port's plain
    backward matches them within the bf16 tolerance above; the compositing
    part is the JAX kernel's ``_fused_bwd`` and the port's plain backward
    matches it at 1e-5. Both parts are recomputed here.

    At the flagship's widths and the probe weights (large warp and sheet
    heads under a 2^9 posenc band) bf16 gradients are noisy: the JAX kernel
    and the port's plain version, which round at the same points, each lie
    10 to 36 % (relative L2) from the float32 gradient, and 0.9 to 2.4 % from
    each other, with single entries up to 10 % of the largest apart. The
    bound is twice that; a 1 % change of one warp layer moves these
    gradients by 70 to 100 % (``chip_smoke.py`` shows it)."""
    from hypernerf_tpu_torch.flagship import (GRAD_REFERENCE_CASE,
                                              LEVEL_INPUTS,
                                              composite_probe_inputs,
                                              probe_cotangents, probe_inputs,
                                              read_grad_reference)
    from hypernerf_tpu_torch.kernels import fused_composite as port_composite
    from tools.make_level_reference import (jax_composite_grads,
                                            jax_level_grads, probe_model)
    name, n_rays, samples, seed = GRAD_REFERENCE_CASE
    ref = read_grad_reference()
    lev, comp = ref['level'], ref['composite']
    cots = probe_cotangents(n_rays, samples, seed)
    for k, v in probe_inputs(n_rays, samples, seed).items():
        np.testing.assert_allclose(lev[k], v, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(lev['cotangent'], cots['level'])
    for k, v in composite_probe_inputs(n_rays, samples, seed).items():
        np.testing.assert_array_equal(comp[k], v)

    def close(a, b, tol, what):
        assert a.shape == b.shape, (what, a.shape, b.shape)
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)
        assert err <= tol, (what, err)

    def close_bf16(a, b, what):
        """FLAGSHIP_GRAD_L2 of the norm and FLAGSHIP_GRAD_MAX of the
        largest entry."""
        assert a.shape == b.shape, (what, a.shape, b.shape)
        l2 = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)
        assert l2 <= FLAGSHIP_GRAD_L2 and err <= FLAGSHIP_GRAD_MAX, \
            (what, l2, err)

    model = probe_model()
    level = model.level(name)
    inputs = {k: lev[k] for k in LEVEL_INPUTS}
    again = jax_level_grads(model, name, inputs, lev['cotangent'])
    assert sorted(again) == sorted(
        k for k in lev if k.startswith(('d_', 'dw', 'db')))
    for k, v in again.items():
        close_bf16(v, lev[k], f'recomputed {k}')
    args = [torch.from_numpy(lev[k]).requires_grad_() for k in LEVEL_INPUTS]
    grads = torch.autograd.grad(port_level(level, *args),
                                args + _level_params(level),
                                torch.from_numpy(lev['cotangent']))
    for k, g in zip(LEVEL_INPUTS, grads[:5]):
        close_bf16(g.numpy(), lev[f'd_{k}'], f'port d_{k}')
    for layer in range(30):
        close_bf16(grads[5 + 2 * layer].numpy(), lev[f'dw{layer}'],
                   f'port dw{layer}')
        close_bf16(grads[6 + 2 * layer].numpy(), lev[f'db{layer}'],
                   f'port db{layer}')

    cin = {k: comp[k] for k in ('packed', 'z_vals', 'directions', 'noise')}
    for k, v in jax_composite_grads(cin, comp['cot_outs'],
                                    comp['cot_weights']).items():
        close(v, comp[k], 1e-5, f'recomputed composite {k}')
    targs = {k: torch.from_numpy(v).requires_grad_() for k, v in cin.items()}
    out = port_composite(targs['packed'], targs['z_vals'],
                         targs['directions'], noise=targs['noise'])
    outs = torch.cat([out['rgb'], out['depth'][:, None],
                      out['med_depth'][:, None], out['acc'][:, None]], -1)
    loss = ((outs * torch.from_numpy(comp['cot_outs'])).sum()
            + (out['weights'] * torch.from_numpy(comp['cot_weights'])).sum())
    for (k, t), g in zip(targs.items(),
                         torch.autograd.grad(loss, list(targs.values()))):
        close(g.numpy(), comp[f'd_{k}'], 1e-5, f'port composite d_{k}')


@pytest.mark.parametrize('impl', ['for-loop', 'foreach', 'fused'])
def test_optimizer_step_repacks_cached_weights(impl):
    """After ``torch.optim.Adam.step()`` the level kernel's cached bf16
    blobs (and their transposes for the backward) are repacked: the for-loop
    and foreach implementations bump the parameters' version counters, which
    the cache follows. The fused one does not on every build, so the train
    step refuses an optimizer built with it."""
    from hypernerf_tpu_torch.configs import TrainConfig
    from hypernerf_tpu_torch.flagship import flagship_model
    from hypernerf_tpu_torch.kernels.fused_level import pack_level
    from hypernerf_tpu_torch.training.train_state import make_train_step
    model = flagship_model('cpu', seed=0)
    level = model.level('coarse')
    kwargs = {'for-loop': dict(foreach=False), 'foreach': dict(foreach=True),
              'fused': dict(fused=True)}[impl]
    opt = torch.optim.Adam(model.parameters(), lr=1e-2, **kwargs)
    if impl == 'fused':
        with pytest.raises(ValueError, match='fused'):
            make_train_step(model, opt, model.config, TrainConfig(), 'cpu')
        return
    make_train_step(model, opt, model.config, TrainConfig(), 'cpu')
    w0, b0, _ = pack_level(level)
    assert pack_level(level)[0] is w0
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    w1, b1, shapes = pack_level(level)
    assert w1 is not w0 and not torch.equal(w1, w0)
    assert not torch.equal(b1, b0)
    fresh = pack_level(copy.deepcopy(model).level('coarse'))
    assert torch.equal(w1, fresh[0]) and torch.equal(b1, fresh[1])
    at = 0
    for (n, k), (w, _) in zip(shapes, level.template._packed_level['packed']):
        # the blob is each layer's packed (n_pad, k_pad) weight in turn
        assert torch.equal(w1[at:at + n * k].view(n, k), w)
        at += n * k
    assert at == w1.numel()


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
        return np.asarray(fn(*args))
    g = jax.grad(lambda *a: jnp.sum(fn(*a) * jnp.asarray(cot)),
                 argnums=tuple(range(8)))(*args)
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
    levels pass, another band count or float32 does not; the packed layout
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
    for kw in (dict(warp_max_deg=6), dict(compute_dtype='float32')):
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
