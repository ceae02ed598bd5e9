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
- the model (small widths, float32): the render on the level kernel's
  branch and on the per-module branch (``return_points``),
  ``query_sigma``, ``share_glo=False`` (a separate hyper table, module by
  module), the loss and every gradient, and three Adam steps, against the
  JAX model on the same converted weights and draws;
- the conversion of a plane model both ways, and what the CUDA path does not
  cover, refused with its ROADMAP item.

Tolerances: float32 as ``test_torch_modular_model.py`` (outputs and loss
1e-5, gradients 1e-4 of each parameter's largest entry, parameters after
three Adam steps 1e-5); the plain level and template against the JAX
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

from hypernerf_tpu.configs import NerfConfig, TrainConfig
from hypernerf_tpu.models.modules import NerfMLP as JaxNerfMLP
from hypernerf_tpu.models.nerf import NerfModel as JaxNerfModel
from hypernerf_tpu.ops.pallas.fused_field import mlp_params_to_list
from hypernerf_tpu.ops.pallas.fused_level import fused_level as jax_level
from hypernerf_tpu.ops.pallas.fused_mlp import (FusedMLPSpec, fused_nerf_mlp,
                                                nerf_mlp_params_to_list)
from hypernerf_tpu.ops.posenc import posenc_orig as jax_posenc_orig
from hypernerf_tpu.ops.ray_dict import prepare_ray_dict as jax_ray_dict
from hypernerf_tpu.parallel.mesh import create_mesh
from hypernerf_tpu.training.losses import mse_loss as jax_mse_loss
from hypernerf_tpu.training.optimizers import get_optimizer as jax_optimizer
from hypernerf_tpu.training.train_state import TrainState as JaxTrainState
from hypernerf_tpu.training.train_state import \
    make_train_step as jax_make_train_step
from hypernerf_tpu_torch import configs as port_configs
from hypernerf_tpu_torch import kernels as K
from hypernerf_tpu_torch.convert import params_from_jax, params_to_jax
from hypernerf_tpu_torch.kernels import Level, common, fused_mlp
from hypernerf_tpu_torch.kernels.fused_level import (_check_covered,
                                                     _level_params,
                                                     level_layers, pack_level)
from hypernerf_tpu_torch.models import modules
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.models.warping import TranslationField as PWarp
from hypernerf_tpu_torch.ops.posenc import posenc_orig
from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
from hypernerf_tpu_torch.training.losses import mse_loss
from hypernerf_tpu_torch.training.optimizers import get_optimizer
from hypernerf_tpu_torch.training.train_state import (TrainState,
                                                      make_train_step)
from tests.test_torch_fused_field import _assert_close
from tests.test_torch_fused_level import (C, E, R, S, SCHEDULES, _INPUTS,
                                          _assert_grads_close, _cotangent,
                                          _flax_grads_to_list, _setup, _spec)
from tests.test_torch_modular_model import _assert_outputs_close
from tests.test_torch_train_step import (ARCH, STEPS_PER_EPOCH, TRAIN,
                                         _assert_trees_close, _batch, _flat,
                                         _jax_draws, _step_keys)

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
    want = np.asarray(_jax_plane_packed(
        _plane_spec(dtype), jd, mlp_params_to_list(wp['mlp']),
        nerf_mlp_params_to_list(tp)))
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

    g = jax.grad(loss, argnums=tuple(range(7)))(
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
    dx, d_cond, dwb = jax.grad(lambda *a: jnp.sum(fn(*a) * jnp.asarray(cot)),
                               argnums=(0, 1, 2))(*args)
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


# ---------------------------------------------------------------------------
# The model against the JAX model.


def _jax_cfg(**kw):
    return NerfConfig(use_pallas=True, use_pallas_fields=True,
                      use_pallas_level=True, pallas_interpret=True,
                      pallas_tile=8, pallas_bwd_tile=8, **{**ARCH, **kw})


@functools.cache
def _flax_params(split: bool = False):
    """flax init of the plane model (``split``: with its own hyper table)
    with the warp head scaled up so that the warp moves the output."""
    over = SPLIT if split else PLANE
    model = JaxNerfModel(NerfConfig(use_pallas=False, **ARCH, **over))
    params = jax.device_get(jax.jit(model.init)(
        {'params': jax.random.PRNGKey(0)},
        jax_ray_dict(jnp.asarray(_batch()[0])))['params'])
    params = jax.tree.map(np.array, params)
    params['warp_field']['mlp']['logit']['kernel'] *= 300.0
    return params


def _port_model(split: bool = False):
    over = SPLIT if split else PLANE
    model = NerfModel(port_configs.NerfConfig(**ARCH, **over))
    model.load_state_dict(params_from_jax(_flax_params(split)))
    return model


def test_model_builds_what_the_configuration_names():
    """No sheet; the template's encoding holds the 8 GLO coordinates (3 x 9
    + 8 x 5 at the small bands); a separate hyper table only with
    ``share_glo=False``; the flax trees' keys are the port's."""
    model = _port_model()
    assert {k.split('.')[0] for k in model.state_dict()} == {
        'warp_embed', 'warp_field', 'nerf_coarse', 'nerf_fine'}
    assert model.nerf_coarse.trunk.hidden_0.in_features == 3 * 9 + 8 * 5
    assert model.level('fine').hyper is None
    split = _port_model(True)
    assert {k.split('.')[0] for k in split.state_dict()} == {
        'warp_embed', 'hyper_embed', 'warp_field', 'nerf_coarse',
        'nerf_fine'}
    for s in (False, True):
        assert sorted(params_from_jax(_flax_params(s))) == sorted(
            _port_model(s).state_dict())


@pytest.mark.parametrize('return_points', [False, True],
                         ids=['level_kernel', 'per_module'])
def test_render_matches_jax(return_points):
    """The level kernel's branch (one level call per level: on CPU tensors
    its plain version) and, asked for points, the per-module branch (the
    warp field, the embedding broadcast as the hyper coordinates, the
    template on its 11 channels)."""
    rays, _ = _batch()
    jmodel = JaxNerfModel(_jax_cfg(**PLANE))
    want = jax.device_get(jmodel.apply(
        {'params': _flax_params()}, jax_ray_dict(jnp.asarray(rays)),
        deterministic=True, return_points=return_points))
    calls = K.fused_level_plain.calls
    with torch.no_grad():
        got = _port_model()(prepare_ray_dict(torch.from_numpy(rays)),
                            deterministic=True, return_points=return_points)
    assert K.fused_level_plain.calls - calls == (0 if return_points else 2)
    _assert_outputs_close(got, want)
    if return_points:
        assert got['fine']['warped_points'].shape == (8, 16, 11)


@pytest.mark.parametrize('split', [False, True], ids=['shared', 'split_glo'])
def test_query_sigma_matches_jax(split):
    """One sample per row and a row count (13) no tile divides; with
    ``share_glo=False`` the hyper coordinates come from the second table."""
    rs = np.random.RandomState(4)
    pts = (rs.randn(13, 3) * 0.5).astype(np.float32)
    ids = rs.randint(0, 4, (13, 1)).astype(np.int32)
    jmodel = JaxNerfModel(_jax_cfg(**(SPLIT if split else PLANE)))
    want = np.asarray(jmodel.apply({'params': _flax_params(split)},
                                   jnp.asarray(pts), jnp.asarray(ids),
                                   method=JaxNerfModel.query_sigma))
    with torch.no_grad():
        got = _port_model(split).query_sigma(torch.from_numpy(pts),
                                             torch.from_numpy(ids).long())
    assert got.shape == (13,) and (got >= 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_split_glo_render_matches_jax():
    """``share_glo=False``: a separate hyper table fails the level kernel's
    gate, as in JAX; the per-module branch renders."""
    rays, _ = _batch()
    jmodel = JaxNerfModel(_jax_cfg(**SPLIT))
    want = jax.device_get(jmodel.apply(
        {'params': _flax_params(True)}, jax_ray_dict(jnp.asarray(rays)),
        deterministic=True))
    calls = K.fused_level_plain.calls
    with torch.no_grad():
        got = _port_model(True)(prepare_ray_dict(torch.from_numpy(rays)),
                                deterministic=True)
    assert K.fused_level_plain.calls == calls
    _assert_outputs_close(got, want)


def _port_setup(split: bool = False):
    cfg = port_configs.NerfConfig(**ARCH, **(SPLIT if split else PLANE))
    train_cfg = port_configs.TrainConfig(**TRAIN)
    model = _port_model(split).train()
    optimizer, schedule = get_optimizer(train_cfg, model.parameters(),
                                        STEPS_PER_EPOCH)
    step_fn = make_train_step(model, optimizer, cfg, train_cfg, 'cpu',
                              schedule=schedule, explicit_batch=True)
    return model, TrainState(0, model, optimizer, seed=0), step_fn


@pytest.mark.parametrize('split', [False, True], ids=['shared', 'split_glo'])
def test_loss_and_gradients_match_jax(split):
    """The stochastic forward with the JAX model's own draws: the loss and
    every parameter's gradient; the GLO table's gradient carries the warp's
    part and the hyper coordinates' (or, split, each table its own)."""
    rays, rgbs = _batch()
    jmodel = JaxNerfModel(_jax_cfg(**(SPLIT if split else PLANE)))
    params = _flax_params(split)
    k_sample, k_noise = _step_keys(jax.random.PRNGKey(1), 0)

    def jax_loss(p):
        out = jmodel.apply({'params': p}, jax_ray_dict(jnp.asarray(rays)),
                           rngs={'sampling': k_sample,
                                 'sigma_noise': k_noise})
        return jax_mse_loss(out, jnp.asarray(rgbs))

    want_loss, want_grads = jax.value_and_grad(jax_loss)(params)
    draws = _jax_draws(jmodel, params, k_sample, k_noise)
    model, _, _ = _port_setup(split)
    out = model(prepare_ray_dict(torch.from_numpy(rays)),
                deterministic=False, draws=draws)
    loss = mse_loss(out, torch.from_numpy(rgbs))
    assert abs(loss.item() - float(want_loss)) <= TOL
    loss.backward()
    got = params_to_jax({k: p.grad for k, p in model.named_parameters()})
    _assert_trees_close(got, jax.device_get(want_grads), 1e-4, True)
    for k, g in _flat(got):
        assert np.abs(g).max() > 0, k


def test_three_adam_steps_match_jax():
    rays, rgbs = _batch()
    cfg = _jax_cfg(**PLANE)
    train_cfg = TrainConfig(**TRAIN)
    jmodel = JaxNerfModel(cfg)
    tx = jax_optimizer(train_cfg, steps_per_epoch=STEPS_PER_EPOCH)
    params = jax.tree.map(jnp.asarray, _flax_params())
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params))
    jstep = jax_make_train_step(jmodel, tx, cfg, train_cfg,
                                create_mesh(num_devices=1),
                                explicit_batch=True)
    base_rng = jax.random.PRNGKey(1)
    model, state, step_fn = _port_setup()
    t_rays, t_rgbs = torch.from_numpy(rays), torch.from_numpy(rgbs)
    for step in range(3):
        draws = _jax_draws(jmodel, jax.device_get(jstate.params),
                           *_step_keys(base_rng, step))
        jstate, jmetrics = jstep(jstate, jnp.asarray(rays),
                                 jnp.asarray(rgbs), base_rng)
        metrics = step_fn(state, t_rays, t_rgbs, draws=draws)
        assert state.step == step + 1 == int(jstate.step)
        assert abs(metrics['loss'].item() - float(jmetrics['loss'])) <= TOL
        _assert_trees_close(params_to_jax(model.state_dict()),
                            jax.device_get(jstate.params), 1e-5, False)


# ---------------------------------------------------------------------------
# Conversion and what is refused.


def test_convert_round_trip_of_a_plane_model():
    """The flax tree of a plane model at the full widths (no
    ``hyper_sheet_mlp``; template layer 0 with 167 inputs, the skip layer
    256 + 167) loads into the port's model and comes back unchanged; the
    level packs to the compiled plane table (23 layers, the encoding padded
    to 192)."""
    cfg = NerfConfig(use_pallas=False, num_embeddings=4,
                     num_coarse_samples=4, num_fine_samples=4, **PLANE)
    jmodel = JaxNerfModel(cfg)
    params = jax.tree.map(np.array, jax.device_get(jax.jit(jmodel.init)(
        {'params': jax.random.PRNGKey(3)},
        jax_ray_dict(jnp.asarray(_batch()[0])))['params']))
    assert 'hyper_sheet_mlp' not in params
    assert params['nerf_coarse']['trunk']['hidden_0']['kernel'].shape == (
        167, 256)
    assert params['nerf_coarse']['trunk']['hidden_5']['kernel'].shape == (
        256 + 167, 256)
    model = NerfModel(port_configs.NerfConfig(num_embeddings=4,
                                              compute_dtype='bfloat16',
                                              **PLANE))
    model.load_state_dict(params_from_jax(params))
    back = params_to_jax(model.state_dict())
    assert sorted(k for k, _ in _flat(back)) == sorted(
        k for k, _ in _flat(params))
    for (k, a), (_, b) in zip(sorted(_flat(back)), sorted(_flat(params))):
        np.testing.assert_array_equal(a, b, err_msg=k)
    level = model.level('fine')
    _check_covered(level)
    shapes = pack_level(level)[2]
    assert len(shapes) == 23 and shapes[7] == (256, 192)
    assert shapes[12] == (256, 256 + 192)


def test_what_the_cuda_path_does_not_cover_is_refused():
    """The plane with the SE(3) or quaternion warp, or with the Nerfies
    encoding, is ported; with heads other than rgb 3 + alpha 1 it is refused
    with its ROADMAP item (A.9); the kernels' checks refuse a plane template
    of other widths (A.13)."""
    for override in (dict(warp_field_type='se3', rgb_channels=4),
                     dict(warp_field_type='quaternion', alpha_channels=2),
                     dict(use_original_embed=False, rgb_channels=4)):
        with pytest.raises(NotImplementedError, match='A.9'):
            NerfModel(port_configs.NerfConfig(**ARCH, **PLANE, **override))
    small = _port_model().template_of('fine')
    with pytest.raises(NotImplementedError, match='A.13'):
        fused_mlp.check_covered(small)
    with pytest.raises(NotImplementedError, match='A.13'):
        _check_covered(_port_model().level('fine'))
    full = NerfModel(port_configs.NerfConfig(compute_dtype='bfloat16',
                                             **PLANE))
    fused_mlp.check_covered(full.template_of('fine'))
    assert fused_mlp.kernel_scales(full.template_of('fine'), None,
                                   torch.device('cpu')) is None


def test_eval_renders_a_plane_weight_file(tmp_path):
    """``python -m hypernerf_tpu_torch.eval`` on a plane weight file (its
    ``nerf_config.json`` names ``axis_aligned_plane``) renders the frames of
    a 16x12 synthetic scene on the CPU (``HYPERNERF_PLATFORM=cpu``)."""
    import os
    import subprocess
    import sys
    from hypernerf_tpu_torch.training.checkpoints import save_weights
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(repo, 'tools'))
    import make_synthetic_scene
    scene = make_synthetic_scene.make_scene(str(tmp_path / 'scene'),
                                            n_frames=2, width=16, height=12,
                                            focal=18.0)
    cfg = port_configs.NerfConfig(**{**ARCH, 'num_embeddings': 2,
                                     'noise_std': None}, **PLANE)
    torch.manual_seed(0)
    weights = str(tmp_path / 'weights' / 'model.pt')
    save_weights(weights, NerfModel(cfg).state_dict(), cfg)
    env = dict(os.environ, HYPERNERF_PLATFORM='cpu',
               PYTHONPATH=os.pathsep.join([repo,
                                           os.environ.get('PYTHONPATH', '')]))
    proc = subprocess.run(
        [sys.executable, '-m', 'hypernerf_tpu_torch.eval', '--root_dir',
         scene, '--dataset_name', 'llff', '--img_wh', '16', '12', '--split',
         'test_train', '--weight_path', weights, '--scene_name', 'synth',
         '--chunk', '64', '--gif_fps', '5'],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[2].startswith('Mean PSNR : ')
    assert (tmp_path / 'results' / 'llff' / 'synth' / '001.png').exists()
