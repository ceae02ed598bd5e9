"""The ``plane`` configuration (``bench.py --mode plane``: the flagship with
``hyper_slice_method='axis_aligned_plane'``, whose hyper coordinates are the
ray's 8 GLO coordinates themselves: no sheet, a 167-column template
encoding) against the JAX package, on the CPU.

- posenc_orig of 8 hyper coordinates and the template's whole encoding
  (``fused_mlp._encode`` at the plane layout) against JAX's;
- the plain level forward and backward (no sheet; d embed = the warp's +
  d hyper) against the JAX level kernel in interpret mode with
  ``slice_method='axis_aligned_plane'``, at small widths, each backward
  schedule;
- the plain template forward and backward at ``in_ch`` 167 against the JAX
  template kernel ``fused_nerf_mlp`` in interpret mode;
- the stored JAX numbers the card is held to
  (``tests/data/fused_plane_jax_ref.npz``) recomputed from the JAX package,
  and the port's plain level and template against them, in bf16 and, for
  the level, in float32;
- the model, its conversion, its refusals and ``eval`` on a plane weight
  file: ``tests/test_torch_plane_model.py``.

Tolerances: the plain level and template against the JAX
kernels as ``test_torch_fused_level.py`` / ``test_torch_fused_mlp.py``
(float32: outputs 1e-5, gradients 1e-5 of the largest entry; bfloat16:
outputs 1e-2 + 1e-2 |x|, gradients 2e-2 of the largest entry, the template
relative L2 5e-2 and 0.25 of the largest entry); the bf16 plain versions
against the stored JAX numbers at the probe weights: outputs 1e-2 + 1e-2
|x| with a mean below 1e-4, gradients relative L2 5e-2 and 0.25 of the
largest entry (``chip_smoke.py`` ``GRAD_L2`` / ``GRAD_MAX``); the float32
plain level against the stored float32 JAX numbers: outputs 1e-4 of the
largest entry, gradients relative L2 1e-2 and 5e-2 of the largest entry.
At the full width float32 does not agree to 1e-4 on every gradient: one
template layer 4 pre-activation of the probe lies within 2e-6 of zero, its
ReLU falls on the other side in one of the two sums, and that row's
cotangent reaches the layers below (measured: relative L2 5e-3 on template
layers 0..4, 7e-4 on the warp and the inputs, under 1e-5 above the flip).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.models.modules import NerfMLP as JaxNerfMLP
from hypernerf_tpu.ops.pallas.fused_field import mlp_params_to_list
from hypernerf_tpu.ops.pallas.fused_level import fused_level as jax_level
from hypernerf_tpu.ops.pallas.fused_mlp import (FusedMLPSpec, fused_nerf_mlp,
                                                nerf_mlp_params_to_list)
from hypernerf_tpu.ops.posenc import posenc_orig as jax_posenc_orig
from hypernerf_tpu_torch import kernels as K
from hypernerf_tpu_torch.convert import params_from_jax
from hypernerf_tpu_torch.kernels import Level, common, fused_mlp
from hypernerf_tpu_torch.kernels.fused_level import _level_params, level_layers
from hypernerf_tpu_torch.models import modules
from hypernerf_tpu_torch.models.warping import TranslationField as PWarp
from hypernerf_tpu_torch.ops.posenc import posenc_orig
from tests.test_torch_fused_field import _assert_close
from tests.test_torch_fused_level import (C, E, R, S, SCHEDULES, _INPUTS,
                                          _assert_grads_close, _cotangent,
                                          _flax_grads_to_list, _setup, _spec)

TOL = 1e-5
PLANE = dict(hyper_slice_method='axis_aligned_plane')
SPLIT = dict(PLANE, share_glo=False)
GRAD_L2, GRAD_MAX = 5e-2, 0.25


# ---------------------------------------------------------------------------
# The encoding at 8 hyper coordinates.


def test_posenc_of_eight_hyper_coordinates_matches_jax():
    """posenc_orig(x, 6) of 8 channels, and the plane template's encoding of
    raw rows [xyz | hyper (8) | 0] (16 columns): [posenc_orig(xyz, 10) |
    posenc_orig(hyper, 6)], 63 + 104 = 167 columns, as the JAX model's
    ``query_template`` encodes."""
    rs = np.random.RandomState(0)
    x = (rs.randn(40, 16) * 0.5).astype(np.float32)
    x[:, 11:] = 0.0
    np.testing.assert_allclose(
        posenc_orig(torch.from_numpy(x[:, 3:11]), 6).numpy(),
        np.asarray(jax_posenc_orig(jnp.asarray(x[:, 3:11]), 6)), rtol=0,
        atol=1e-6)
    mlp = modules.NerfMLP(167, 39, 2, 32, 1, 16, skips=(1,))
    tmpl = fused_mlp.Template(mlp, 10, 6)
    assert fused_mlp.n_hyper(tmpl) == 8
    assert fused_mlp.layout(tmpl) == 'plane' and fused_mlp.raw_pad(tmpl) == 16
    got = fused_mlp._encode(tmpl, torch.from_numpy(x), None)[2]
    want = jnp.concatenate([jax_posenc_orig(jnp.asarray(x[:, :3]), 10),
                            jax_posenc_orig(jnp.asarray(x[:, 3:11]), 6)], -1)
    assert got.shape == (40, 167)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# The plain level against the JAX level kernel, small widths.

PLANE_IN = 3 * 9 + E * 5  # posenc_orig(warped, 4) ++ posenc_orig(embed, 2)


def _plane_spec(dtype):
    return _spec(dtype)._replace(slice_method='axis_aligned_plane',
                                 hyper_out=E)


@functools.cache
def _plane_tmpl_params(seed=3):
    data = _setup()[0]
    tmpl = JaxNerfMLP(trunk_depth=3, trunk_width=32, rgb_branch_depth=2,
                      rgb_branch_width=16, skips=(1,))
    return jax.device_get(tmpl.init(
        jax.random.PRNGKey(seed), jnp.zeros((R, S, PLANE_IN)),
        rgb_condition=jnp.asarray(data['rgbc']))['params'])


def _port_plane_level(wp, tp, dtype):
    dt = modules.torch_dtype(dtype)
    warp = PWarp(E, 2, 16, 4, (1,), dtype=dt)
    tmpl = modules.NerfMLP(PLANE_IN, C, 3, 32, 2, 16, skips=(1,), dtype=dt)
    for mod, p in ((warp, wp), (tmpl, tp)):
        mod.load_state_dict(params_from_jax(jax.device_get(p)))
    return Level(warp, None, tmpl, 4, 2)


def _jax_plane_packed(spec, data, warp_pairs, tmpl_pairs):
    return jax_level(spec, None, data['embed'], data['rgbc'], None,
                     warp_pairs, [], tmpl_pairs, origins=data['o'],
                     directions=data['d'], z_vals=data['z'],
                     return_packed=True)[:, :4]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_plain_level_forward_matches_jax_kernel(dtype):
    """``fused_level_plain`` without a sheet (the hyper coordinates are the
    embedding, raw_t [warped | embed | 0] of 16 columns) against the JAX
    level kernel with ``slice_method='axis_aligned_plane'``."""
    data, (_, wp), _, _ = _setup()
    tp = _plane_tmpl_params()
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    spec = _plane_spec(dtype)
    want = np.asarray(jax.jit(
        lambda jd, w, t: _jax_plane_packed(spec, jd, w, t))(
            jd, mlp_params_to_list(wp['mlp']), nerf_mlp_params_to_list(tp)))
    level = _port_plane_level(wp, tp, dtype)
    args = [torch.from_numpy(data[k]) for k in _INPUTS]
    with torch.no_grad():
        got, raw_t = K.fused_level_plain(level, *args, return_raw_t=True)
    assert raw_t.shape == (R * S, 16)
    np.testing.assert_array_equal(
        raw_t[:, 3:11].numpy(), np.repeat(data['embed'], S, axis=0))
    assert (raw_t[:, 11:] == 0).all()
    if dtype == 'float32':
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    else:
        d = np.abs(got.numpy() - want)
        assert (d <= 1e-2 + 1e-2 * np.abs(want)).all() and d.mean() < 1e-4


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('schedule', sorted(SCHEDULES))
def test_plain_level_backward_matches_jax_schedule(schedule, dtype):
    """Kernel A's and kernel B's plain versions (``FusedLevelFn`` on CPU
    tensors) against the JAX plane level's gradients under each backward
    schedule: every ray input (d embed carries the warp's part and d hyper)
    and the warp's and the template's dW / db."""
    data, (_, wp), _, _ = _setup()
    tp = _plane_tmpl_params()
    spec = _plane_spec(dtype)._replace(bwd_tile=16, tmpl_bwd_tile=16,
                                       **SCHEDULES[schedule])
    cot = _cotangent()

    def loss(z, o, d, embed, rgbc, warp_pairs, tmpl_pairs):
        packed = _jax_plane_packed(spec, dict(z=z, o=o, d=d, embed=embed,
                                              rgbc=rgbc),
                                   warp_pairs, tmpl_pairs)
        return jnp.sum(packed * jnp.asarray(cot))

    g = jax.jit(jax.grad(loss, argnums=tuple(range(7))))(
        *[jnp.asarray(data[k]) for k in _INPUTS],
        mlp_params_to_list(wp['mlp']), nerf_mlp_params_to_list(tp))
    want = [np.asarray(a) for a in g[:5]] + _flax_grads_to_list(g[5], [],
                                                                g[6])
    level = _port_plane_level(wp, tp, dtype)
    args = [torch.from_numpy(data[k]).requires_grad_() for k in _INPUTS]
    calls = (K.fused_template_bwd_plain.calls,
             K.fused_fields_bwd_plain.calls)
    out = K.fused_level(level, *args)
    got = [t.numpy() for t in torch.autograd.grad(
        out, args + _level_params(level), torch.from_numpy(cot))]
    assert (K.fused_template_bwd_plain.calls,
            K.fused_fields_bwd_plain.calls) == (calls[0] + 1, calls[1] + 1)
    assert len(got) == 5 + 2 * len(level_layers(level)) == 5 + 2 * 12
    _assert_grads_close(got, want, {'float32': 1e-5, 'bfloat16': 2e-2}[dtype])


def test_plain_level_backward_is_the_autograd_of_the_forward():
    """At float32 the explicit backward (no sheet: d embed = the warp's +
    dx_t[:, 3:11]) is the autograd of the plain forward."""
    data, (_, wp), _, _ = _setup()
    level = _port_plane_level(wp, _plane_tmpl_params(), 'float32')
    cot = torch.from_numpy(_cotangent())
    args = [torch.from_numpy(data[k]).requires_grad_() for k in _INPUTS]
    want = torch.autograd.grad(K.fused_level_plain(level, *args),
                               args + _level_params(level), cot)
    got = torch.autograd.grad(K.fused_level(level, *args),
                              args + _level_params(level), cot)
    _assert_grads_close([g.numpy() for g in got], [g.numpy() for g in want],
                        1e-5)


# ---------------------------------------------------------------------------
# The plain template at in_ch 167 against the JAX template kernel.

SEGMENTS = ((3, 10), (8, 6))
ENC = 167
ROWS = {8: (6, 48), 1: (50, 50)}


def _template_setup(per, seed=0):
    """Numpy raw rows (P, 16), condition rows, cotangent and the (W (in,
    out), b) pairs of a 3 x 32 trunk (skip after 1) with a 2 x 16 rgb
    branch on the 167-column encoding, in the kernel's layer order."""
    r, p = ROWS[per]
    rs = np.random.RandomState(seed)
    x = np.zeros((p, 16), np.float32)
    x[:, :11] = rs.randn(p, 11) * 0.5
    cond = rs.randn(r, C).astype(np.float32)
    shapes = [(ENC, 32), (32, 32), (32 + ENC, 32), (32, 32), (32, 16),
              (16, 1), (16 + C, 16), (16, 16), (16 + 16 + C, 3)]
    pairs = [((rs.randn(i, o) * np.sqrt(2.0 / i)).astype(np.float32),
              (rs.randn(o) * 0.1).astype(np.float32)) for i, o in shapes]
    return x, cond, rs.randn(p, 4).astype(np.float32), pairs


@pytest.mark.parametrize('per', [8, 1], ids=['per_ray', 'per_sample'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_plain_template_matches_jax_kernel(dtype, per):
    """Forward and backward through the wrapper and its autograd Function
    on CPU tensors: dx (P, 16) with zeros past the 11 raw columns, d
    rgb_cond and every dW / db."""
    x, cond, cot, pairs = _template_setup(per)
    spec = FusedMLPSpec(in_ch=ENC, trunk_depth=3, trunk_width=32,
                        rgb_depth=2, rgb_width=16, skips=(1,),
                        rgb_cond_ch=C, tile=16, bwd_tile=32,
                        compute_dtype=dtype, enc_segments=SEGMENTS,
                        cond_samples=per if per > 1 else 0, interpret=True)

    def fn(x_raw, rgb_cond, wbs):
        out = fused_nerf_mlp(spec, x_raw[:, :11], rgb_cond, None, wbs)
        return jnp.concatenate([out['rgb'], out['alpha']], -1)

    args = (jnp.asarray(x), jnp.asarray(cond),
            [(jnp.asarray(w), jnp.asarray(b)) for w, b in pairs])
    dx, d_cond, dwb = jax.jit(jax.grad(
        lambda *a: jnp.sum(fn(*a) * jnp.asarray(cot)), argnums=(0, 1, 2)))(
            *args)
    want = [np.asarray(dx), np.asarray(d_cond)] + [
        np.asarray(t) for dw, db in dwb for t in (dw.T, db)]

    mlp = modules.NerfMLP(ENC, C, 3, 32, 2, 16, skips=(1,),
                          dtype=modules.torch_dtype(dtype))
    with torch.no_grad():
        for (lin, _), (w, b) in zip(fused_mlp.template_layers(mlp), pairs):
            lin.weight.copy_(torch.from_numpy(w.T))
            lin.bias.copy_(torch.from_numpy(b))
    tmpl = fused_mlp.Template(mlp, 10, 6)
    assert fused_mlp.layout(tmpl) == 'plane'
    assert fused_mlp.template_scales(tmpl) is None
    xt = torch.from_numpy(x).requires_grad_()
    ct = torch.from_numpy(cond).requires_grad_()
    out = K.fused_template(tmpl, xt, ct)
    params = common.layer_params(fused_mlp.template_layers(mlp))
    grads = torch.autograd.grad(out, [xt, ct] + params, torch.from_numpy(cot))
    _assert_close(out.detach().numpy(), np.asarray(fn(*args)), dtype, 'out')
    assert grads[0].shape == (x.shape[0], 16)
    assert (grads[0][:, 11:] == 0).all()
    for i, (g, w) in enumerate(zip(grads, want)):
        _assert_close(g.numpy(), w, dtype, f'grad {i}')


# ---------------------------------------------------------------------------
# The stored JAX numbers of the card's checks.


def test_stored_reference_recomputes():
    """``tests/data/fused_plane_jax_ref.npz`` is what
    ``tools/make_level_reference.py --only plane`` computes now: the JAX
    level and template kernels in interpret mode at the probe weights, in
    bf16 and (the first level case) in float32."""
    import tools.make_level_reference as mlr
    from hypernerf_tpu_torch.flagship import PLANE_REFERENCE
    want = mlr.plane_reference()
    with np.load(PLANE_REFERENCE) as f:
        assert sorted(f.files) == sorted(want)
        for k in f.files:
            np.testing.assert_allclose(f[k], want[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30),
            np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _level_names():
    from hypernerf_tpu_torch.flagship import LEVEL_INPUTS
    return [f'd_{k}' for k in LEVEL_INPUTS] + [
        f'd{"wb"[i % 2]}{i // 2}' for i in range(2 * 23)]


@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_plain_level_holds_to_the_stored_jax_numbers(dtype):
    """The port's plain level (the level kernel's and kernel B's plain
    versions, kernel A's) on each draw of its inputs at the probe weights:
    bf16 against the bf16 JAX numbers at the card's bounds, float32 against
    the float32 JAX numbers (see the module docstring)."""
    from hypernerf_tpu_torch.flagship import (LEVEL_INPUTS, PLANE_F32_CASES,
                                              PLANE_LEVEL_CASES,
                                              flagship_model,
                                              load_probe_weights,
                                              read_plane_reference)
    ref = read_plane_reference()
    model = load_probe_weights(flagship_model('cpu', config='plane',
                                              compute_dtype=dtype))
    cases = (PLANE_LEVEL_CASES if dtype == 'bfloat16' else
             {c: PLANE_LEVEL_CASES[b] for c, b in PLANE_F32_CASES.items()})
    names = _level_names()
    for case, (level, *_) in cases.items():
        a = {k: torch.from_numpy(v) for k, v in ref[case].items()}
        lv = model.level(level)
        args = [a[k].clone().requires_grad_() for k in LEVEL_INPUTS]
        out = K.fused_level(lv, *args)
        d = (out.detach() - a['out']).abs()
        got = torch.autograd.grad(out, args + _level_params(lv),
                                  a['cotangent'])
        assert len(got) == len(names)
        if dtype == 'bfloat16':
            assert (d <= 1e-2 + 1e-2 * a['out'].abs()).all()
            assert d.mean() < 1e-4
            bounds = (GRAD_L2, GRAD_MAX)
        else:
            assert d.max() <= 1e-4 * a['out'].abs().max()
            bounds = (1e-2, 5e-2)
        for n, g in zip(names, got):
            l2, mx = _rel(g, a[n])
            assert l2 <= bounds[0] and mx <= bounds[1], (case, n, l2, mx)


def test_plain_template_holds_to_the_stored_jax_numbers():
    """The template alone at the plane layout (x_raw (P, 16)), bf16,
    against the stored JAX numbers."""
    from hypernerf_tpu_torch.flagship import (flagship_model,
                                              load_probe_weights,
                                              read_plane_reference)
    t = {k: torch.from_numpy(v) for k, v in
         read_plane_reference()['template'].items()}
    tm = load_probe_weights(flagship_model('cpu', config='plane')
                            ).template_of('coarse')
    x = t['x_raw'].clone().requires_grad_()
    c = t['rgb_cond'].clone().requires_grad_()
    out = K.fused_template(tm, x, c)
    d = (out.detach() - t['out']).abs()
    assert (d <= 1e-2 + 1e-2 * t['out'].abs()).all() and d.mean() < 1e-4
    layers = fused_mlp.template_layers(tm.template)
    got = torch.autograd.grad(out, [x, c] + common.layer_params(layers),
                              t['cotangent'])
    names = ['dx', 'd_rgb_cond'] + [f'd{"wb"[i % 2]}{i // 2}'
                                    for i in range(2 * len(layers))]
    for n, g in zip(names, got):
        l2, mx = _rel(g, t[n])
        assert l2 <= GRAD_L2 and mx <= GRAD_MAX, (n, l2, mx)
