"""The template's ``use_nerf_embed`` alpha and rgb conditions and
``use_viewdirs=False`` (the ``nerf_embed`` configuration and its variants)
against the JAX package, on the CPU.

- ``get_condition_inputs``: the rgb condition alone, the alpha condition
  alone, both; ``use_viewdirs=False`` with and without the embedding; a
  nerf table of its own (``share_glo=False``); the static model; the
  Nerfies encoding; and the nerf embedding interpolated between two ids;
- ``NerfMLP`` with an alpha condition (and with an rgb condition of 0
  columns) against the JAX ``NerfMLP``;
- the plain level forward and backward with both conditions (d rgb_cond
  and d alpha_cond summed per ray) against the JAX level kernel in
  interpret mode with ``alpha_cond_ch``, as ``tests/test_fused_level.py``
  builds it, at small widths;
- the plain template forward and backward against ``fused_nerf_mlp`` with
  ``alpha_cond_ch``;
- the stored JAX numbers the card is held to
  (``tests/data/fused_conditions_jax_ref.npz``) recomputed from the JAX
  package, and the port's plain level and template against them;
- (the model against the JAX model: ``test_torch_conditions_model.py``);
- the conversion of each condition case's flax tree both ways, a full JAX
  checkpoint of a ``nerf_embed`` model converted and resumed, the train
  entry point with the three flags, and what is still refused.

Tolerances: float32 as ``test_torch_modular_model.py`` (outputs and loss
1e-5, gradients 1e-4 of each parameter's largest entry, parameters after
three Adam steps 1e-5, also in ``test_torch_conditions_model.py``); the
plain level and template against the JAX
kernels as ``test_torch_fused_level.py`` / ``test_torch_fused_mlp.py``
(float32: outputs 1e-5, gradients 1e-5 of the largest entry; bfloat16:
outputs 1e-2 + 1e-2 |x|, gradients 2e-2 of the largest entry, the template
relative L2 5e-2 and 0.25 of the largest entry); the bf16 plain versions
against the stored JAX numbers at the probe weights: outputs 1e-2 + 1e-2
|x| with a mean below 1e-4, gradients relative L2 5e-2 and 0.25 of the
largest entry (``chip_smoke.py`` ``GRAD_L2`` / ``GRAD_MAX``).

The file runs its JAX models once each (module-scoped caches) and the
full-width probe on one thread.
"""

import dataclasses
import functools
import os
import sys

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
from hypernerf_tpu.ops.ray_dict import prepare_ray_dict as jax_ray_dict
from hypernerf_tpu.parallel.mesh import create_mesh
from hypernerf_tpu.training import checkpoints as jax_ckpt
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
                                                     pack_level)
from hypernerf_tpu_torch.models import modules
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.models.warping import TranslationField as PWarp
from hypernerf_tpu_torch.training import checkpoints
from hypernerf_tpu_torch.training.optimizers import get_optimizer
from hypernerf_tpu_torch.training.train_state import (TrainState,
                                                      make_train_step)
from tests.test_torch_fused_field import _assert_close
from tests.test_torch_fused_level import (E, H, R, S, SCHEDULES, _INPUTS,
                                          _cotangent, _setup, _spec)
from tests.test_torch_train_step import (ARCH, STEPS_PER_EPOCH, TRAIN,
                                         _assert_trees_close, _batch, _flat,
                                         _jax_draws, _step_keys)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
GRAD_L2, GRAD_MAX = 5e-2, 0.25
EMBED = dict(use_nerf_embed=True)
# name -> what it changes of the small flagship (``ARCH``).
CASES = {
    'both': dict(EMBED, use_alpha_condition=True, use_rgb_condition=True),
    'rgb': dict(EMBED, use_rgb_condition=True),
    'alpha': dict(EMBED, use_alpha_condition=True),
    'no_viewdirs': dict(use_viewdirs=False),
    'no_viewdirs_embed': dict(EMBED, use_viewdirs=False,
                              use_rgb_condition=True,
                              use_alpha_condition=True),
    'split': dict(EMBED, use_alpha_condition=True, use_rgb_condition=True,
                  share_glo=False),
    'static': dict(EMBED, use_alpha_condition=True, use_rgb_condition=True,
                   use_warp=False, hyper_slice_method='none'),
    'nerfies': dict(EMBED, use_alpha_condition=True, use_rgb_condition=True,
                    use_original_embed=False, viewdir_max_deg=2,
                    spatial_point_max_deg=4, hyper_point_max_deg=2),
}


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """Small products and one full-width probe: one thread keeps the file's
    time on a loaded worker (torch starts a thread per core)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_cfg(case, **kw):
    """The JAX model of ``case`` on its kernels in interpret mode (with no
    rgb condition its template leaves them for XLA)."""
    return NerfConfig(use_pallas=True, use_pallas_fields=True,
                      use_pallas_level=True, pallas_interpret=True,
                      pallas_tile=8, pallas_bwd_tile=8,
                      **{**ARCH, **CASES[case], **kw})


@functools.cache
def _flax_params(case):
    """flax init of ``case`` with the warp and sheet heads scaled up so
    that the two fields move the output and carry gradient."""
    model = JaxNerfModel(NerfConfig(use_pallas=False,
                                    **{**ARCH, **CASES[case]}))
    params = jax.device_get(jax.jit(model.init)(
        {'params': jax.random.PRNGKey(0)},
        jax_ray_dict(jnp.asarray(_batch()[0])))['params'])
    params = jax.tree.map(np.array, params)
    if 'warp_field' in params:
        params['warp_field']['mlp']['logit']['kernel'] *= 300.0
    if 'hyper_sheet_mlp' in params:
        params['hyper_sheet_mlp']['mlp']['logit']['kernel'] *= 1e4
    return params


def _port_cfg(case):
    return port_configs.NerfConfig(**{**ARCH, **CASES[case]})


def _port_model(case):
    model = NerfModel(_port_cfg(case))
    model.load_state_dict(params_from_jax(_flax_params(case)))
    return model


# ---------------------------------------------------------------------------
# The conditions.


@pytest.mark.parametrize('case', sorted(CASES))
def test_condition_inputs_match_jax(case):
    """(alpha condition, rgb condition) of each case, with ids (B, 1) and
    with two ids interpolated ((B, 3) metadata) on the Nerfies window's
    ``nerf_alpha``; an empty condition is None in both packages."""
    rs = np.random.RandomState(3)
    viewdirs = rs.randn(6, 3).astype(np.float32)
    ids = rs.randint(0, 4, (6, 1)).astype(np.int32)
    mixed = np.concatenate([rs.randint(0, 4, (6, 2)),
                            rs.rand(6, 1)], 1).astype(np.float32)
    ep = {'nerf_alpha': 1.5, 'warp_alpha': None, 'hyper_alpha': None,
          'hyper_sheet_alpha': None}
    jmodel = JaxNerfModel(_jax_cfg(case))
    model = _port_model(case)
    for meta in (ids, mixed):
        jmeta = {k: jnp.asarray(meta) for k in ('warp', 'camera',
                                                 'appearance', 'time')}
        want = jax.device_get(jmodel.apply(
            {'params': _flax_params(case)}, jnp.asarray(viewdirs), jmeta, ep,
            method=JaxNerfModel.get_condition_inputs))
        tmeta = {k: torch.from_numpy(meta) for k in jmeta}
        if meta is ids:
            tmeta = {k: v.long() for k, v in tmeta.items()}
        with torch.no_grad():
            got = model.get_condition_inputs(torch.from_numpy(viewdirs),
                                             tmeta, ep)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                           atol=1e-6)
    t = model.nerf_coarse
    widths = (fused_mlp.alpha_cond_width(model.template_of('coarse')),
              fused_mlp.cond_width(model.template_of('coarse')))
    assert widths == tuple(0 if w is None else w.shape[1] for w in want)
    assert t.alpha_head.in_features == 16 + widths[0]
    assert hasattr(model, 'nerf_embed') == (case in ('split', 'static'))


# ---------------------------------------------------------------------------
# NerfMLP against the JAX module.


@pytest.mark.parametrize('rgb', [True, False], ids=['rgb', 'no_rgb'])
def test_nerf_mlp_with_an_alpha_condition_matches_jax(rgb):
    """The alpha head on [bottleneck | alpha condition] (its bias bound from
    its whole input, as flax's ``torch_linear_bias``), the rgb branch on
    [bottleneck | rgb condition] or, with no rgb condition, on the
    bottleneck alone; per-ray conditions broadcast over the samples."""
    rs = np.random.RandomState(1)
    x = rs.randn(3, 5, 20).astype(np.float32)
    alpha = rs.randn(3, E).astype(np.float32)
    rgbc = rs.randn(3, 7).astype(np.float32) if rgb else None
    jm = JaxNerfMLP(trunk_depth=2, trunk_width=32, rgb_branch_depth=1,
                    rgb_branch_width=16, skips=(1,))
    kw = dict(alpha_condition=jnp.asarray(alpha),
              rgb_condition=None if rgbc is None else jnp.asarray(rgbc))
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                    **kw)['params'])
    want = jax.device_get(jm.apply({'params': params}, jnp.asarray(x), **kw))
    mlp = modules.NerfMLP(20, 7 if rgb else 0, 2, 32, 1, 16, skips=(1,),
                          alpha_cond_ch=E)
    mlp.load_state_dict(params_from_jax(params))
    assert mlp.alpha_head.in_features == 16 + E
    with torch.no_grad():
        got = mlp(torch.from_numpy(x),
                  None if rgbc is None else torch.from_numpy(rgbc),
                  torch.from_numpy(alpha))
    for k in ('rgb', 'alpha'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5)
    # The default bias bound follows the alpha head's whole input.
    fresh = modules.NerfMLP(20, 7, 2, 32, 1, 16, skips=(1,), alpha_cond_ch=E)
    assert fresh.alpha_head.bias.abs().max() <= 1 / np.sqrt(16 + E)


# ---------------------------------------------------------------------------
# The plain level against the JAX level kernel with both conditions.

RC = 11 + E  # the rgb condition: 11 features, then the embedding


@functools.cache
def _cond_data(seed=0):
    """``_setup``'s rays with an rgb condition [11 features | embed] and
    the embedding as the alpha condition, and the JAX template's params on
    them."""
    data = dict(_setup(seed)[0])
    data['rgbc'] = np.concatenate([data['rgbc'], data['embed']], 1)
    data['alphac'] = data['embed'].copy()
    tmpl = JaxNerfMLP(trunk_depth=3, trunk_width=32, rgb_branch_depth=2,
                      rgb_branch_width=16, skips=(1,))
    tp = jax.device_get(tmpl.init(
        jax.random.PRNGKey(2), jnp.zeros((R, S, 3 * 9 + H * 5)),
        alpha_condition=jnp.asarray(data['alphac']),
        rgb_condition=jnp.asarray(data['rgbc']))['params'])
    return data, tp


def _cond_spec(dtype):
    return _spec(dtype)._replace(rgb_cond_ch=RC, alpha_cond_ch=E)


def _port_cond_level(dtype):
    _, (_, wp), (_, hp), _ = _setup()
    tp = _cond_data()[1]
    dt = modules.torch_dtype(dtype)
    warp = PWarp(E, 2, 16, 4, (1,), dtype=dt)
    hyper = modules.HyperSheetMLP(E, H, 2, 16, 3, (1,), dtype=dt)
    tmpl = modules.NerfMLP(3 * 9 + H * 5, RC, 3, 32, 2, 16, skips=(1,),
                           dtype=dt, alpha_cond_ch=E)
    for mod, p in ((warp, wp), (hyper, hp), (tmpl, tp)):
        mod.load_state_dict(params_from_jax(jax.device_get(p)))
    return Level(warp, hyper, tmpl, 4, 2)


def _jax_cond_packed(spec, d, pairs):
    return jax_level(spec, None, d['embed'], d['rgbc'], d['alphac'], *pairs,
                     origins=d['o'], directions=d['d'], z_vals=d['z'],
                     return_packed=True)[:, :4]


def _jax_pairs():
    _, (_, wp), (_, hp), _ = _setup()
    return (mlp_params_to_list(wp['mlp']), mlp_params_to_list(hp['mlp']),
            nerf_mlp_params_to_list(_cond_data()[1]))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_plain_level_forward_with_conditions_matches_jax_kernel(dtype):
    data = _cond_data()[0]
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    want = np.asarray(_jax_cond_packed(_cond_spec(dtype), jd, _jax_pairs()))
    level = _port_cond_level(dtype)
    args = [torch.from_numpy(data[k]) for k in _INPUTS]
    calls = K.fused_level_plain.calls
    with torch.no_grad():
        got = K.fused_level(level, *args,
                            alpha_cond=torch.from_numpy(data['alphac']))
    assert K.fused_level_plain.calls == calls + 1
    if dtype == 'float32':
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    else:
        d = np.abs(got.numpy() - want)
        assert (d <= 1e-2 + 1e-2 * np.abs(want)).all() and d.mean() < 1e-4
    # The alpha condition moves sigma alone.
    with torch.no_grad():
        moved = K.fused_level(level, *args, alpha_cond=torch.from_numpy(
            data['alphac'] + 1.0))
    assert torch.equal(moved[:, :3], got[:, :3])
    assert not torch.equal(moved[:, 3], got[:, 3])


@pytest.mark.parametrize('dtype,schedule', [('float32', 'pipelined'),
                                            ('bfloat16', 'split')])
def test_plain_level_backward_with_conditions_matches_jax(dtype, schedule):
    """Kernel A's and kernel B's plain versions (``FusedLevelFn`` on CPU
    tensors) against the JAX level's gradients: every ray input, d rgb_cond
    and d alpha_cond summed per ray, and every layer's dW / db, the alpha
    head's over [bottleneck | alpha condition]."""
    data = _cond_data()[0]
    spec = _cond_spec(dtype)._replace(bwd_tile=16, tmpl_bwd_tile=16,
                                      **SCHEDULES[schedule])
    cot = _cotangent()
    names = _INPUTS + ('alphac',)

    def loss(z, o, d, embed, rgbc, alphac, *pairs):
        packed = _jax_cond_packed(spec, dict(z=z, o=o, d=d, embed=embed,
                                             rgbc=rgbc, alphac=alphac), pairs)
        return jnp.sum(packed * jnp.asarray(cot))

    g = jax.jit(jax.grad(loss, argnums=tuple(range(9))))(
        *[jnp.asarray(data[k]) for k in names], *_jax_pairs())
    want = [np.asarray(a) for a in g[:6]]
    for group in g[6:]:
        for w, b in group:
            want += [np.asarray(w).T, np.asarray(b)]
    level = _port_cond_level(dtype)
    args = [torch.from_numpy(data[k]).requires_grad_() for k in names]
    out = K.fused_level(level, *args[:5], alpha_cond=args[5])
    got = torch.autograd.grad(out, args + _level_params(level),
                              torch.from_numpy(cot))
    assert len(got) == len(want) == 6 + 2 * 15
    tol = {'float32': 1e-5, 'bfloat16': 2e-2}[dtype]
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.numpy()
        assert a.shape == b.shape, (i, a.shape, b.shape)
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)
        assert err <= tol, (i, err)
    # The alpha head's condition columns carry gradient.
    at = [p is level.template.alpha_head.weight
          for p in _level_params(level)].index(True)
    assert got[6 + at].shape == (1, 16 + E)
    assert np.abs(got[6 + at].numpy()[:, 16:]).max() > 0


# ---------------------------------------------------------------------------
# The plain template against the JAX template kernel with both conditions.

ENC = 3 * 21 + 4 * 13  # posenc_orig: xyz at 10 bands, 4 hyper at 6
TROWS = {8: (6, 48), 1: (50, 50)}


def _template_setup(per, seed=0):
    r, p = TROWS[per]
    rs = np.random.RandomState(seed)
    x = np.zeros((p, 8), np.float32)
    x[:, :7] = rs.randn(p, 7) * 0.5
    rgbc = rs.randn(r, RC).astype(np.float32)
    alphac = rs.randn(r, E).astype(np.float32)
    shapes = [(ENC, 32), (32, 32), (32 + ENC, 32), (32, 32), (32, 16),
              (16 + E, 1), (16 + RC, 16), (16, 16), (16 + 16 + RC, 3)]
    pairs = [((rs.randn(i, o) * np.sqrt(2.0 / i)).astype(np.float32),
              (rs.randn(o) * 0.1).astype(np.float32)) for i, o in shapes]
    return x, rgbc, alphac, rs.randn(p, 4).astype(np.float32), pairs


@pytest.mark.parametrize('per', [8, 1], ids=['per_ray', 'per_sample'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_plain_template_with_conditions_matches_jax_kernel(dtype, per):
    """Forward and backward through the wrapper and its autograd Function:
    dx, d rgb_cond, d alpha_cond and every dW / db."""
    x, rgbc, alphac, cot, pairs = _template_setup(per)
    spec = FusedMLPSpec(in_ch=ENC, trunk_depth=3, trunk_width=32,
                        rgb_depth=2, rgb_width=16, skips=(1,),
                        rgb_cond_ch=RC, alpha_cond_ch=E, tile=16,
                        bwd_tile=32, compute_dtype=dtype,
                        enc_segments=((3, 10), (4, 6)),
                        cond_samples=per if per > 1 else 0, interpret=True)

    def fn(x_raw, rc, ac, wbs):
        out = fused_nerf_mlp(spec, x_raw[:, :7], rc, ac, wbs)
        return jnp.concatenate([out['rgb'], out['alpha']], -1)

    args = (jnp.asarray(x), jnp.asarray(rgbc), jnp.asarray(alphac),
            [(jnp.asarray(w), jnp.asarray(b)) for w, b in pairs])
    gx, grc, gac, dwb = jax.jit(jax.grad(
        lambda *a: jnp.sum(fn(*a) * jnp.asarray(cot)),
        argnums=(0, 1, 2, 3)))(*args)
    want = [np.asarray(gx), np.asarray(grc), np.asarray(gac)] + [
        np.asarray(t) for dw, db in dwb for t in (dw.T, db)]

    mlp = modules.NerfMLP(ENC, RC, 3, 32, 2, 16, skips=(1,),
                          dtype=modules.torch_dtype(dtype), alpha_cond_ch=E)
    with torch.no_grad():
        for (lin, _), (w, b) in zip(fused_mlp.template_layers(mlp), pairs):
            lin.weight.copy_(torch.from_numpy(w.T))
            lin.bias.copy_(torch.from_numpy(b))
    tmpl = fused_mlp.Template(mlp, 10, 6)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, rgbc, alphac)]
    out = K.fused_template(tmpl, ts[0], ts[1], alpha_cond=ts[2])
    params = common.layer_params(fused_mlp.template_layers(mlp))
    grads = torch.autograd.grad(out, ts + params, torch.from_numpy(cot))
    _assert_close(out.detach().numpy(), np.asarray(fn(*args)), dtype, 'out')
    assert len(grads) == len(want) == 3 + 2 * 9
    for i, (g, w) in enumerate(zip(grads, want)):
        _assert_close(g.numpy(), w, dtype, f'grad {i}')


# ---------------------------------------------------------------------------
# The stored JAX numbers of the card's checks.


def test_stored_reference_recomputes():
    """``tests/data/fused_conditions_jax_ref.npz`` is what
    ``tools/make_level_reference.py --only conditions`` computes now: the
    JAX level kernel with both conditions and the template kernel with both
    in interpret mode at the ``nerf_embed`` probe weights, bf16."""
    import tools.make_level_reference as mlr
    from hypernerf_tpu_torch.flagship import CONDITION_REFERENCE
    want = mlr.condition_reference()
    with np.load(CONDITION_REFERENCE) as f:
        assert sorted(f.files) == sorted(want)
        for k in f.files:
            np.testing.assert_allclose(f[k], want[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    assert os.path.getsize(CONDITION_REFERENCE) < 2 << 20


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30),
            np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_plain_versions_hold_to_the_stored_jax_numbers():
    """The port's plain level (the level kernel's, kernel A's and kernel
    B's plain versions) and plain template at the probe weights of
    ``nerf_embed``, bf16, against the stored JAX numbers at the card's
    bounds: outputs, every input's gradient (d alpha_cond too) and the
    stored layers' dW (the alpha head over 136 columns, rgb layer 0 over
    175), every db."""
    from hypernerf_tpu_torch.flagship import (CONDITION_GRAD_LAYERS,
                                              LEVEL_INPUTS, flagship_model,
                                              load_probe_weights,
                                              read_condition_reference)
    ref = read_condition_reference()
    model = load_probe_weights(flagship_model('cpu', config='nerf_embed'))
    a = {k: torch.from_numpy(v) for k, v in ref['level'].items()}
    lv = model.level('coarse')
    args = [a[k].clone().requires_grad_() for k in LEVEL_INPUTS]
    ac = a['alpha_cond'].clone().requires_grad_()
    out = K.fused_level(lv, *args, alpha_cond=ac)
    d = (out.detach() - a['out']).abs()
    assert (d <= 1e-2 + 1e-2 * a['out'].abs()).all() and d.mean() < 1e-4
    params = _level_params(lv)
    got = torch.autograd.grad(out, args + [ac] + params, a['cotangent'])
    names = [f'd_{k}' for k in LEVEL_INPUTS] + ['d_alpha_cond'] + [
        f'd{"wb"[i % 2]}{i // 2}' for i in range(len(params))]
    checked = 0
    for n, g in zip(names, got):
        if n not in a:
            continue
        l2, mx = _rel(g, a[n])
        assert l2 <= GRAD_L2 and mx <= GRAD_MAX, (n, l2, mx)
        checked += 1
    assert checked == 6 + 30 + len(CONDITION_GRAD_LAYERS['level'])
    assert a['dw24'].shape == (1, 136) and a['dw25'].shape == (128, 175)

    t = {k: torch.from_numpy(v) for k, v in ref['template'].items()}
    tm = model.template_of('fine')
    ins = [t[k].clone().requires_grad_() for k in ('x_raw', 'rgb_cond',
                                                    'alpha_cond')]
    out = K.fused_template(tm, ins[0], ins[1], alpha_cond=ins[2])
    d = (out.detach() - t['out']).abs()
    assert (d <= 1e-2 + 1e-2 * t['out'].abs()).all() and d.mean() < 1e-4
    layers = fused_mlp.template_layers(tm.template)
    got = torch.autograd.grad(out, ins + common.layer_params(layers),
                              t['cotangent'])
    names = ['dx', 'd_rgb_cond', 'd_alpha_cond'] + [
        f'd{"wb"[i % 2]}{i // 2}' for i in range(2 * len(layers))]
    for n, g in zip(names, got):
        if n in t:
            l2, mx = _rel(g, t[n])
            assert l2 <= GRAD_L2 and mx <= GRAD_MAX, (n, l2, mx)


# ---------------------------------------------------------------------------
# Conversion, checkpoints, the entry point and what is refused.


@pytest.mark.parametrize('case,rgb_in,table', [
    ('both', 128 + 47, False), ('alpha', 128 + 39, False),
    ('no_viewdirs', 128, False), ('no_viewdirs_embed', 128 + 8, False),
    ('split', 128 + 47, True), ('static', 128 + 47, True)])
def test_convert_round_trip_of_each_condition_case(case, rgb_in, table):
    """The flax tree of each case (its init at the small widths) loads into
    the port's model and comes back unchanged; at the full widths (the flax
    tree's shapes, ``jax.eval_shape``) the port's state dict has the flax
    tree's keys and shapes (a ``nerf_embed`` table where the warp's is not
    shared; the alpha head on 128 + 8 inputs where there is an alpha
    condition; rgb layer 0 on 175, 167, 136 or 128) and the template packs
    to the compiled table (the alpha head 8 x 128, rgb layer 0 128 x
    176)."""
    params = _flax_params(case)
    model = _port_model(case)
    back = params_to_jax(model.state_dict())
    assert sorted(k for k, _ in _flat(back)) == sorted(
        k for k, _ in _flat(params))
    for (k, a), (_, b) in zip(sorted(_flat(back)), sorted(_flat(params))):
        np.testing.assert_array_equal(a, b, err_msg=k)
    over = {k: v for k, v in CASES[case].items()
            if k not in ('viewdir_max_deg',)}
    cfg = NerfConfig(use_pallas=False, num_embeddings=4,
                     num_coarse_samples=4, num_fine_samples=4, **over)
    shapes = jax.eval_shape(JaxNerfModel(cfg).init,
                            {'params': jax.random.PRNGKey(3)},
                            jax_ray_dict(jnp.asarray(_batch()[0])))['params']
    assert ('nerf_embed' in shapes) == table
    assert shapes['nerf_coarse']['rgb_branch']['hidden_0']['kernel'].shape \
        == (rgb_in, 128)
    alpha_in = 128 + (8 if cfg.use_alpha_condition else 0)
    assert shapes['nerf_coarse']['alpha_head']['kernel'].shape == (
        alpha_in, 1)
    model = NerfModel(port_configs.NerfConfig(num_embeddings=4,
                                              compute_dtype='bfloat16',
                                              **over))
    state = model.state_dict()
    assert sorted(state) == sorted(params_from_jax(
        jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)))
    for key, arr in params_from_jax(jax.tree.map(
            lambda a: np.zeros(a.shape, np.float32), shapes)).items():
        assert tuple(state[key].shape) == tuple(arr.shape), key
    tmpl = model.template_of('fine')
    fused_mlp.check_covered(tmpl)
    shapes = common.pack_layers(
        tmpl.template, fused_mlp.kernel_template_layers(tmpl.template))[2]
    assert shapes[10] == (8, 128) and shapes[11] == (128, 176)
    if case in ('both', 'no_viewdirs', 'no_viewdirs_embed'):
        _check_covered(model.level('fine'))
        assert len(pack_level(model.level('fine'))[2]) == 30


def test_jax_full_checkpoint_of_a_nerf_embed_model_resumes(tmp_path):
    """JAX: two steps of the ``both`` model, ``save_checkpoint``;
    ``tools/jax_ckpt_to_torch.py --out_dir`` converts it (the nerf
    embedding's conditions in its config, the wider alpha head and rgb
    layer 0, Adam's moments, the step); the port restores it and takes the
    third step with JAX's draws: the loss and every parameter equal JAX's
    third step's."""
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    import jax_ckpt_to_torch
    rays, rgbs = _batch()
    cfg = NerfConfig(use_pallas=False, **{**ARCH, **CASES['both']})
    train_cfg = TrainConfig(**TRAIN)
    jmodel = JaxNerfModel(cfg)
    tx = jax_optimizer(train_cfg, steps_per_epoch=STEPS_PER_EPOCH)
    params = jax.tree.map(jnp.asarray, _flax_params('both'))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params))
    base_rng = jax.random.PRNGKey(1)
    jstep = jax_make_train_step(jmodel, tx, cfg, train_cfg,
                                create_mesh(num_devices=1),
                                explicit_batch=True)
    for _ in range(2):
        jstate, _ = jstep(jstate, jnp.asarray(rays), jnp.asarray(rgbs),
                          base_rng)
    jax_path = jax_ckpt.save_checkpoint(str(tmp_path / 'jax'), 2, jstate,
                                        nerf_config=cfg,
                                        train_config=train_cfg)
    draws = _jax_draws(jmodel, jax.device_get(jstate.params),
                       *_step_keys(base_rng, 2))
    jstate, jmetrics = jstep(jstate, jnp.asarray(rays), jnp.asarray(rgbs),
                             base_rng)
    path = jax_ckpt_to_torch.convert_checkpoint(jax_path,
                                                str(tmp_path / 'port'))
    pcfg = checkpoints.load_config(path)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
    assert pcfg.use_nerf_embed and pcfg.use_alpha_condition
    ptrain = checkpoints.load_train_config(path)
    model = NerfModel(pcfg).train()
    optimizer, schedule = get_optimizer(ptrain, model.parameters(),
                                        STEPS_PER_EPOCH)
    state = checkpoints.restore_checkpoint(
        path, TrainState(0, model, optimizer))
    assert state.step == 2
    step_fn = make_train_step(model, optimizer, pcfg, ptrain, 'cpu',
                              schedule=schedule, explicit_batch=True)
    metrics = step_fn(state, torch.from_numpy(rays), torch.from_numpy(rgbs),
                      draws=draws)
    assert abs(metrics['loss'].item() - float(jmetrics['loss'])) <= TOL
    _assert_trees_close(params_to_jax(model.state_dict()),
                        jax.device_get(jstate.params), TOL, False)


def test_train_entry_point_with_the_three_flags(tmp_path, monkeypatch,
                                                capsys):
    """``python -m hypernerf_tpu_torch.train --use_nerf_embedding
    --use_alpha_condition --use_rgb_condition`` (``HYPERNERF_PLATFORM=cpu``)
    trains a few steps on a tiny synthetic scene; its checkpoint's config
    names the conditions and its model has the wider heads."""
    from hypernerf_tpu_torch import train as port_train
    from tests.conftest import make_smooth_llff_scene
    scene = make_smooth_llff_scene(tmp_path / 'scene')
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    monkeypatch.setenv('HYPERNERF_PLATFORM', 'cpu')
    monkeypatch.chdir(tmp_path)
    trainer = port_train.main([
        '--root_dir', scene, '--img_wh', '16', '12', '--N_samples', '8',
        '--N_importance', '8', '--batch_size', '64', '--max_steps', '3',
        '--log_every', '1', '--val_check_interval', '1.0', '--chunk', '64',
        '--exp_name', 'cond', '--use_nerf_embedding', '--use_alpha_condition',
        '--use_rgb_condition'])
    assert 'Final metrics:' in capsys.readouterr().out
    assert trainer.state.step == 3
    model = trainer.state.model
    assert model.nerf_coarse.alpha_head.in_features == 128 + 8
    assert model.nerf_coarse.rgb_branch.hidden_0.in_features == 128 + 47
    ckpt = tmp_path / 'ckpts' / 'cond' / 'step_3'
    cfg = checkpoints.load_config(str(ckpt))
    assert (cfg.use_nerf_embed, cfg.use_alpha_condition,
            cfg.use_rgb_condition) == (True, True, True)
    loaded = NerfModel(cfg)
    checkpoints.load_weights(loaded, str(ckpt))
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, model.state_dict()[k].cpu())


def test_heads_and_b4_are_still_refused():
    """Heads other than rgb 3 + alpha 1 (with or without the nerf
    embedding, and with plane / anneal and the SE(3) warp, which are ported
    without them) raise naming B.3; the kernels' checks refuse a condition
    width no layout covers (A.13)."""
    for over in (dict(EMBED, use_rgb_condition=True, rgb_channels=4),
                 dict(use_viewdirs=False, alpha_channels=2),
                 dict(hyper_slice_method='axis_aligned_plane',
                      warp_field_type='se3', rgb_channels=4),
                 dict(use_original_embed=False, warp_field_type='se3',
                      alpha_channels=2)):
        with pytest.raises(NotImplementedError, match='B.3'):
            NerfModel(port_configs.NerfConfig(**ARCH, **over))
    full = NerfModel(port_configs.NerfConfig(compute_dtype='bfloat16',
                                             **CASES['both']))
    fused_mlp.check_covered(full.template_of('fine'))
    odd = NerfModel(port_configs.NerfConfig(compute_dtype='bfloat16',
                                            dir_freq=5, **CASES['both']))
    with pytest.raises(NotImplementedError, match='A.13'):
        fused_mlp.check_covered(odd.template_of('fine'))
