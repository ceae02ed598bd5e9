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
        dx_t, d_cond, grads = fused_template_bwd_plain(
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
    wt0, _, _ = pack_level(level, transposed=True)
    assert pack_level(level)[0] is w0
    assert pack_level(level, transposed=True)[0] is wt0
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    w1, b1, shapes = pack_level(level)
    wt1, _, _ = pack_level(level, transposed=True)
    assert w1 is not w0 and not torch.equal(w1, w0)
    assert not torch.equal(b1, b0) and not torch.equal(wt1, wt0)
    fresh = pack_level(copy.deepcopy(model).level('coarse'))
    assert torch.equal(w1, fresh[0]) and torch.equal(b1, fresh[1])
    at = 0
    for n, k in shapes:  # the transposed blob is each layer transposed
        assert torch.equal(wt1[at:at + n * k].view(k, n),
                           w1[at:at + n * k].view(n, k).t())
        at += n * k
