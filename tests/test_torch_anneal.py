"""The ``anneal`` configuration (``bench.py --mode anneal``: the flagship with
``use_original_embed=False``, the Nerfies template encoding windowed by the
annealing alphas) against the JAX package, on the CPU.

- ``posenc`` and ``posenc_window`` against JAX's at fractional alphas, and
  the template's window row (``fused_mlp.template_scales``) against JAX's
  ``encoding_scales`` of the same segments;
- the plain template forward and backward at the Nerfies layout (what the
  wrappers run on CPU tensors) against the JAX kernel ``fused_nerf_mlp``
  with its windowed in-kernel encoding, in interpret mode;
- the stored JAX numbers the card is held to
  (``tests/data/fused_anneal_jax_ref.npz``) recomputed from the JAX package,
  and the port's plain level and template against them;
- the model (small widths, float32): the render on the level kernel's
  branch and on the per-module branch (``return_points``), the loss and
  every gradient, and three Adam steps, against the JAX model on the same
  converted weights and draws, at fractional ``hyper_alpha``;
- ``compute_extra_params`` against JAX's, the alphas ``eval`` renders a
  weight file at, the conversion of an anneal model both ways, and what the
  CUDA path does not cover, refused with its ROADMAP item.

Tolerances: float32 as ``test_torch_modular_model.py`` (outputs and loss
1e-5, gradients 1e-4 of each parameter's largest entry, parameters after
three Adam steps 1e-5); the plain template against the JAX kernel as
``test_torch_fused_mlp.py`` (float32 rtol 2e-4 / atol 2e-5; bfloat16
outputs 1e-2 + 1e-2 |x|, gradients relative L2 5e-2 and 0.25 of the largest
entry); the bf16 plain versions against the stored JAX numbers at the probe
weights: outputs 1e-2 + 1e-2 |x| with a mean below 1e-4 (``chip_smoke.py``
``LEVEL_ATOL`` / ``LEVEL_MEAN``), gradients relative L2 5e-2 and 0.25 of the
largest entry (``GRAD_L2`` / ``GRAD_MAX``: bf16 gradients of two
implementations lie 3 to 5 % apart here, each 12 to 21 % from float32);
window rows and alphas 1e-6.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.configs import NerfConfig, TrainConfig
from hypernerf_tpu.models.nerf import NerfModel as JaxNerfModel
from hypernerf_tpu.ops.pallas.fused_field import \
    encoding_scales as jax_encoding_scales
from hypernerf_tpu.ops.pallas.fused_mlp import FusedMLPSpec, fused_nerf_mlp
from hypernerf_tpu.ops.posenc import posenc as jax_posenc
from hypernerf_tpu.ops.posenc import posenc_window as jax_posenc_window
from hypernerf_tpu.ops.ray_dict import prepare_ray_dict as jax_ray_dict
from hypernerf_tpu.parallel.mesh import create_mesh
from hypernerf_tpu.training.losses import mse_loss as jax_mse_loss
from hypernerf_tpu.training.optimizers import get_optimizer as jax_optimizer
from hypernerf_tpu.training.train_state import TrainState as JaxTrainState
from hypernerf_tpu.training.train_state import \
    compute_extra_params as jax_extra_params
from hypernerf_tpu.training.train_state import \
    make_train_step as jax_make_train_step
from hypernerf_tpu_torch import configs as port_configs
from hypernerf_tpu_torch import kernels as K
from hypernerf_tpu_torch.convert import params_from_jax, params_to_jax
from hypernerf_tpu_torch.eval import eval_extra_params
from hypernerf_tpu_torch.kernels import common, fused_mlp
from hypernerf_tpu_torch.kernels.fused_level import _level_params
from hypernerf_tpu_torch.models.modules import NerfMLP, torch_dtype
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.ops.posenc import posenc, posenc_window
from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
from hypernerf_tpu_torch.training import checkpoints
from hypernerf_tpu_torch.training.losses import mse_loss
from hypernerf_tpu_torch.training.optimizers import get_optimizer
from hypernerf_tpu_torch.training.train_state import (TrainState,
                                                      compute_extra_params,
                                                      make_train_step)
from tests.test_torch_fused_field import _assert_close
from tests.test_torch_modular_model import _assert_outputs_close
from tests.test_torch_train_step import (ARCH, STEPS_PER_EPOCH, TRAIN,
                                         _assert_trees_close, _batch, _flat,
                                         _jax_draws, _step_keys)

TOL = 1e-5
# The small flagship of the model tests with the Nerfies encoding: xyz over
# degrees 0..4 with identity, hyper over 0..2, viewdirs over 0..2.
ANNEAL = dict(use_original_embed=False, spatial_point_max_deg=4,
              hyper_point_max_deg=2, viewdir_max_deg=2)
# Alphas mid-ramp: hyper_alpha fractional (at 0 every hyper feature is
# zero and the sheet gets no gradient), the xyz bands fully on.
EXTRA = {'nerf_alpha': 4.0, 'warp_alpha': 0.3, 'hyper_alpha': 1.4,
         'hyper_sheet_alpha': 1.4}
# Ramps of three steps: hyper_alpha 0, 2/3, 4/3 at steps 0, 1, 2.
ANNEAL_TRAIN = dict(TRAIN, hyper_alpha_steps=3, warp_alpha_steps=3)


def _jax_cfg(**kw):
    return NerfConfig(use_pallas=True, use_pallas_fields=True,
                      use_pallas_level=True, pallas_interpret=True,
                      pallas_tile=8, pallas_bwd_tile=8,
                      **{**ARCH, **ANNEAL, **kw})


@functools.cache
def _flax_params():
    """flax init of the anneal model with the warp and sheet heads scaled
    up so that the two fields move the output and carry gradient."""
    model = JaxNerfModel(NerfConfig(use_pallas=False, **ARCH, **ANNEAL))
    params = jax.device_get(jax.jit(model.init)(
        {'params': jax.random.PRNGKey(0)},
        jax_ray_dict(jnp.asarray(_batch()[0])))['params'])
    params = jax.tree.map(np.array, params)
    params['warp_field']['mlp']['logit']['kernel'] *= 300.0
    params['hyper_sheet_mlp']['mlp']['logit']['kernel'] *= 1e4
    return params


def _port_model():
    model = NerfModel(port_configs.NerfConfig(**ARCH, **ANNEAL))
    model.load_state_dict(params_from_jax(_flax_params()))
    return model


def _jax_extra(extra):
    return {k: jnp.float32(v) for k, v in extra.items()}


# ---------------------------------------------------------------------------
# The encoding and its window.


@pytest.mark.parametrize('alpha', [0.0, 1.5, 3.25, None])
@pytest.mark.parametrize('identity', [True, False])
def test_posenc_matches_jax(alpha, identity):
    """[x? | sin, band-major | cos] (not posenc_orig's interleave), each
    band weighted by the Hann window at a fractional alpha."""
    x = np.random.RandomState(0).randn(7, 5, 3).astype(np.float32)
    got = posenc(torch.from_numpy(x), 0, 4, identity, alpha)
    want = jax_posenc(jnp.asarray(x), 0, 4, identity,
                      None if alpha is None else jnp.float32(alpha))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    if alpha is not None:
        np.testing.assert_allclose(
            posenc_window(0, 4, alpha).numpy(),
            np.asarray(jax_posenc_window(0, 4, jnp.float32(alpha))),
            rtol=0, atol=1e-6)


@pytest.mark.parametrize('hyper', [4, 0])
@pytest.mark.parametrize('alphas', [(10.0, 1.5), (3.3, 0.25), (None, None)])
def test_template_window_row_matches_jax(hyper, alphas):
    """The template's window row over [xyz (0..10, identity) | hyper (0..4,
    none)] as the JAX model's ``_template_enc_scales`` builds it: the first
    95 (or 63) entries of the JAX kernel's padded row, the rest zeros."""
    mlp = NerfMLP(63 + 8 * hyper, 27, 3, 32, 2, 16, skips=(1,))
    tmpl = fused_mlp.Template(mlp, 10, 4, nerfies=True)
    assert fused_mlp.n_hyper(tmpl) == hyper
    got = fused_mlp.template_scales(tmpl, *alphas)
    segs = ((3, 10, 0, True),) + (((4, 4, 0, False),) if hyper else ())
    want = np.asarray(jax_encoding_scales(
        segs, [None if a is None else jnp.float32(a) for a in alphas]
        [:len(segs)]))[0]
    assert got.shape == (63 + 8 * hyper,)
    np.testing.assert_allclose(got.numpy(), want[:got.shape[0]], atol=1e-6)
    assert (want[got.shape[0]:] == 0).all()
    assert fused_mlp.template_scales(fused_mlp.Template(mlp, 10, 4), *alphas
                                     ) is None


# ---------------------------------------------------------------------------
# The plain template at the Nerfies layout against the JAX kernel.

C = 11  # condition features of the small template
SEGMENTS = ((3, 10, 0, True), (4, 4, 0, False))
ENC = 63 + 32
ROWS = {8: (6, 48), 1: (50, 50)}


def _template_setup(per, seed=0):
    """Numpy raw rows (P, 8), condition rows, cotangent and the (W (in,
    out), b) pairs of a 3 x 32 trunk (skip after 1) with a 2 x 16 rgb
    branch on the Nerfies encoding, in the kernel's layer order."""
    r, p = ROWS[per]
    rs = np.random.RandomState(seed)
    x = np.zeros((p, 8), np.float32)
    x[:, :7] = rs.randn(p, 7) * 0.5
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
    on CPU tensors, at nerf_alpha 10 and hyper_alpha 1.5: a band of weight 0
    (hyper bands 2, 3) passes no gradient, one of 0.5 half of it."""
    x, cond, cot, pairs = _template_setup(per)
    alphas = (10.0, 1.5)
    spec = FusedMLPSpec(in_ch=ENC, windowed=True, trunk_depth=3,
                        trunk_width=32, rgb_depth=2, rgb_width=16,
                        skips=(1,), rgb_cond_ch=C, tile=16, bwd_tile=32,
                        compute_dtype=dtype, enc_segments=SEGMENTS,
                        cond_samples=per, interpret=True)
    scales = jax_encoding_scales(SEGMENTS, [jnp.float32(a) for a in alphas])

    def fn(x_raw, rgb_cond, wbs):
        out = fused_nerf_mlp(spec, x_raw[:, :7], rgb_cond, None, wbs,
                             enc_scales=scales)
        return jnp.concatenate([out['rgb'], out['alpha']], -1)

    args = (jnp.asarray(x), jnp.asarray(cond),
            [(jnp.asarray(w), jnp.asarray(b)) for w, b in pairs])
    dx, d_cond, dwb = jax.jit(jax.grad(
        lambda *a: jnp.sum(fn(*a) * jnp.asarray(cot)), argnums=(0, 1, 2)))(
            *args)
    want = [np.asarray(dx), np.asarray(d_cond)] + [
        np.asarray(t) for dw, db in dwb for t in (dw.T, db)]

    mlp = NerfMLP(ENC, C, 3, 32, 2, 16, skips=(1,), dtype=torch_dtype(dtype))
    with torch.no_grad():
        for (lin, _), (w, b) in zip(fused_mlp.template_layers(mlp), pairs):
            lin.weight.copy_(torch.from_numpy(w.T))
            lin.bias.copy_(torch.from_numpy(b))
    tmpl = fused_mlp.Template(mlp, 10, 4, nerfies=True)
    row = fused_mlp.template_scales(tmpl, *alphas)
    xt = torch.from_numpy(x).requires_grad_()
    ct = torch.from_numpy(cond).requires_grad_()
    out = K.fused_template(tmpl, xt, ct, row)
    params = common.layer_params(fused_mlp.template_layers(mlp))
    grads = torch.autograd.grad(out, [xt, ct] + params, torch.from_numpy(cot))
    _assert_close(out.detach().numpy(), np.asarray(fn(*args)), dtype, 'out')
    for i, (g, w) in enumerate(zip(grads, want)):
        _assert_close(g.numpy(), w, dtype, f'grad {i}')
    # The window's VJP: bands of weight 0 pass nothing to the hyper rows'
    # dx through layer 0; the identity-free hyper segment has no direct term.
    zero = fused_mlp.template_scales(tmpl, 10.0, 0.0)
    with torch.no_grad():
        dx0 = fused_mlp.fused_template_bwd_plain(
            tmpl, xt.detach(), ct.detach(), torch.from_numpy(cot), zero)[0]
    assert (dx0[:, 3:] == 0).all() and (dx0[:, :3] != 0).any()


# ---------------------------------------------------------------------------
# The stored JAX numbers of the card's checks.


def test_stored_reference_recomputes():
    """``tests/data/fused_anneal_jax_ref.npz`` is what
    ``tools/make_level_reference.py --only anneal`` computes now: the JAX
    level and template kernels in interpret mode at the probe weights and
    the alphas of ``flagship.ANNEAL_PROBE_STEP``."""
    import tools.make_level_reference as mlr
    from hypernerf_tpu_torch.flagship import ANNEAL_REFERENCE
    want = mlr.anneal_reference()
    with np.load(ANNEAL_REFERENCE) as f:
        assert sorted(f.files) == sorted(want)
        for k in f.files:
            np.testing.assert_allclose(f[k], want[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30),
            np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_plain_versions_hold_to_the_stored_jax_numbers():
    """The port's plain level (the level kernel's and kernel B's plain
    versions, kernel A's) on each draw of its inputs and the template alone
    at the anneal layout, bf16, against the stored JAX numbers, at
    hyper_alpha 1.5."""
    from hypernerf_tpu_torch.flagship import (ANNEAL_LEVEL_CASES,
                                              LEVEL_INPUTS,
                                              anneal_extra_params,
                                              flagship_model,
                                              load_probe_weights,
                                              read_anneal_reference)
    ref = read_anneal_reference()
    model = load_probe_weights(flagship_model('cpu', config='anneal'))
    ep = anneal_extra_params()
    assert 1.0 < ep['hyper_alpha'] < 2.0 and ep['nerf_alpha'] == 10.0
    row = fused_mlp.template_scales(model.template_of('coarse'),
                                    ep['nerf_alpha'], ep['hyper_alpha'])
    names = [f'd_{k}' for k in LEVEL_INPUTS] + [
        f'd{"wb"[i % 2]}{i // 2}' for i in range(60)]
    for case, (level, *_) in ANNEAL_LEVEL_CASES.items():
        a = {k: torch.from_numpy(v) for k, v in ref[case].items()}
        lv = model.level(level)
        args = [a[k].clone().requires_grad_() for k in LEVEL_INPUTS]
        out = K.fused_level(lv, *args, None, row)
        d = (out.detach() - a['out']).abs()
        assert (d <= 1e-2 + 1e-2 * a['out'].abs()).all() and d.mean() < 1e-4
        got = torch.autograd.grad(out, args + _level_params(lv),
                                  a['cotangent'])
        for n, g in zip(names, got):
            l2, mx = _rel(g, a[n])
            assert l2 <= 5e-2 and mx <= 0.25, (case, n, l2, mx)
    t = {k: torch.from_numpy(v) for k, v in ref['template'].items()}
    tm = model.template_of('coarse')
    x = t['x_raw'].clone().requires_grad_()
    c = t['rgb_cond'].clone().requires_grad_()
    out = K.fused_template(tm, x, c, row)
    d = (out.detach() - t['out']).abs()
    assert (d <= 1e-2 + 1e-2 * t['out'].abs()).all() and d.mean() < 1e-4
    layers = fused_mlp.template_layers(tm.template)
    got = torch.autograd.grad(out, [x, c] + common.layer_params(layers),
                              t['cotangent'])
    names = ['dx', 'd_rgb_cond'] + [f'd{"wb"[i % 2]}{i // 2}'
                                    for i in range(2 * len(layers))]
    for n, g in zip(names, got):
        l2, mx = _rel(g, t[n])
        assert l2 <= 5e-2 and mx <= 0.25, (n, l2, mx)


# ---------------------------------------------------------------------------
# The model against the JAX model.


def _render_both(**kw):
    rays, _ = _batch()
    jmodel = JaxNerfModel(_jax_cfg())
    want = jax.device_get(jmodel.apply(
        {'params': _flax_params()}, jax_ray_dict(jnp.asarray(rays)),
        extra_params=_jax_extra(EXTRA), deterministic=True, **kw))
    with torch.no_grad():
        got = _port_model()(prepare_ray_dict(torch.from_numpy(rays)),
                            deterministic=True, extra_params=EXTRA, **kw)
    return got, want


@pytest.mark.parametrize('return_points', [False, True],
                         ids=['level_kernel', 'per_module'])
def test_render_matches_jax(return_points):
    """The level kernel's branch (one level call per level, on CPU tensors
    its plain version) and, asked for points, the per-module branch (the
    warp field and the sheet, then the template on its windowed encoding)."""
    calls = K.fused_level_plain.calls
    got, want = _render_both(return_points=return_points)
    assert K.fused_level_plain.calls - calls == (0 if return_points else 2)
    _assert_outputs_close(got, want)
    if return_points:
        assert got['fine']['warped_points'].shape == (8, 16, 7)


def test_window_moves_the_render():
    """The hyper window is seen: hyper_alpha 0.4 and 1.4 render apart, by
    more than the test's tolerance, on both models alike."""
    rays = prepare_ray_dict(torch.from_numpy(_batch()[0]))
    model = _port_model()
    with torch.no_grad():
        a = model(rays, extra_params=EXTRA)['fine']['rgb']
        b = model(rays, extra_params={**EXTRA, 'hyper_alpha': 0.4})[
            'fine']['rgb']
    assert (a - b).abs().max() > 1e3 * TOL


def _port_setup():
    cfg = port_configs.NerfConfig(**ARCH, **ANNEAL)
    train_cfg = port_configs.TrainConfig(**ANNEAL_TRAIN)
    model = _port_model().train()
    optimizer, schedule = get_optimizer(train_cfg, model.parameters(),
                                        STEPS_PER_EPOCH)
    step_fn = make_train_step(model, optimizer, cfg, train_cfg, 'cpu',
                              schedule=schedule, explicit_batch=True)
    return model, TrainState(0, model, optimizer, seed=0), step_fn


def test_loss_and_gradients_match_jax():
    """The stochastic forward with the JAX model's own draws at fractional
    hyper_alpha: the loss and every parameter's gradient, the sheet's and
    both GLO lookups' included."""
    rays, rgbs = _batch()
    jmodel = JaxNerfModel(_jax_cfg())
    params = _flax_params()
    k_sample, k_noise = _step_keys(jax.random.PRNGKey(1), 0)

    def jax_loss(p):
        out = jmodel.apply({'params': p}, jax_ray_dict(jnp.asarray(rays)),
                           extra_params=_jax_extra(EXTRA),
                           rngs={'sampling': k_sample,
                                 'sigma_noise': k_noise})
        return jax_mse_loss(out, jnp.asarray(rgbs))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    draws = _jax_draws(jmodel, params, k_sample, k_noise)
    model, _, _ = _port_setup()
    out = model(prepare_ray_dict(torch.from_numpy(rays)),
                deterministic=False, draws=draws, extra_params=EXTRA)
    loss = mse_loss(out, torch.from_numpy(rgbs))
    assert abs(loss.item() - float(want_loss)) <= TOL
    loss.backward()
    got = params_to_jax({k: p.grad for k, p in model.named_parameters()})
    _assert_trees_close(got, jax.device_get(want_grads), 1e-4, True)
    for k, g in _flat(got):
        assert np.abs(g).max() > 0, k


def test_three_adam_steps_match_jax():
    """The train steps compute their alphas from the step (hyper_alpha 0,
    2/3, 4/3 over a ramp of three steps), as the JAX step does."""
    rays, rgbs = _batch()
    cfg = _jax_cfg()
    train_cfg = TrainConfig(**ANNEAL_TRAIN)
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


@pytest.mark.parametrize('step', [0, 1234, 3750, 10000, 80000, 123456])
def test_compute_extra_params_matches_jax(step):
    """Steps 0, mid-ramp and past each ramp, at the full configuration's
    bands and TrainConfig's ramps; none with the original encoding."""
    cfg = port_configs.NerfConfig(use_original_embed=False)
    tcfg = port_configs.TrainConfig()
    got = compute_extra_params(cfg, tcfg, step)
    want = jax_extra_params(NerfConfig(use_original_embed=False),
                            TrainConfig(), step)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert abs(got[k] - float(v)) <= 1e-6, k
    assert compute_extra_params(port_configs.NerfConfig(), tcfg, step) == {}


def test_eval_alphas_of_a_weight_file(tmp_path):
    """A weight file carries no step: ``eval`` renders it fully annealed, at
    the larger of the two ramps' steps of the TrainConfig saved beside it
    (``train_config.json``) or, without one, of the flags'."""
    cfg = port_configs.NerfConfig(**ARCH, **ANNEAL)
    tcfg = port_configs.TrainConfig(warp_alpha_steps=50,
                                    hyper_alpha_steps=70)
    got = eval_extra_params(cfg, tcfg)
    want = jax_extra_params(NerfConfig(**ARCH, **ANNEAL),
                            TrainConfig(warp_alpha_steps=50,
                                        hyper_alpha_steps=70), 70)
    assert got == {k: float(v) for k, v in want.items()}
    assert got['hyper_alpha'] == 2.0 and got['warp_alpha'] == 8.0
    path = str(tmp_path / 'w.pt')
    checkpoints.save_weights(path, _port_model().state_dict(), cfg)
    assert checkpoints.load_train_config(path) is None
    (tmp_path / 'train_config.json').write_text(tcfg.to_json())
    assert checkpoints.load_train_config(path) == tcfg
    assert checkpoints.load_config(path) == cfg
    assert os.path.exists(tmp_path / 'nerf_config.json')


def test_convert_round_trip_of_an_anneal_model():
    """The flax tree of an anneal model (template layer 0 with 95 inputs at
    the full widths, rgb layer 0 with 128 + 27) loads into the port's model
    and comes back unchanged."""
    cfg = NerfConfig(use_pallas=False, use_original_embed=False,
                     num_embeddings=4, num_coarse_samples=4,
                     num_fine_samples=4)
    jmodel = JaxNerfModel(cfg)
    params = jax.tree.map(np.array, jax.device_get(jax.jit(jmodel.init)(
        {'params': jax.random.PRNGKey(3)},
        jax_ray_dict(jnp.asarray(_batch()[0])))['params']))
    assert params['nerf_coarse']['trunk']['hidden_0']['kernel'].shape == (
        95, 256)
    assert params['nerf_coarse']['rgb_branch']['hidden_0']['kernel'].shape \
        == (128 + 27, 128)
    model = NerfModel(port_configs.NerfConfig(use_original_embed=False,
                                              num_embeddings=4))
    model.load_state_dict(params_from_jax(params))
    back = params_to_jax(model.state_dict())
    assert sorted(k for k, _ in _flat(back)) == sorted(
        k for k, _ in _flat(params))
    for (k, a), (_, b) in zip(sorted(_flat(back)), sorted(_flat(params))):
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_what_the_cuda_path_does_not_cover_is_refused():
    """The anneal model with the SE(3) or quaternion warp is ported; with
    heads other than rgb 3 + alpha 1 as well, or with bands from a degree
    other than 0, it is refused with its ROADMAP item; the kernels' checks
    refuse a Nerfies template of other widths (A.13) and a window row for
    the original encoding."""
    for override, item in ((dict(warp_field_type='se3', rgb_channels=4),
                            'B.3'),
                           (dict(warp_field_type='quaternion',
                                 alpha_channels=2), 'B.3'),
                           (dict(hyper_point_min_deg=1), 'A.13'),
                           (dict(viewdir_min_deg=1), 'A.13')):
        with pytest.raises(NotImplementedError, match=item):
            NerfModel(port_configs.NerfConfig(**ARCH, **ANNEAL, **override))
    small = _port_model().template_of('fine')
    with pytest.raises(NotImplementedError, match='A.13'):
        fused_mlp.check_covered(small)
    full = NerfModel(port_configs.NerfConfig(use_original_embed=False,
                                             compute_dtype='bfloat16'))
    fused_mlp.check_covered(full.template_of('fine'))
    K.fused_level.__globals__['_check_covered'](full.level('fine'))
    flagship = NerfModel(port_configs.NerfConfig(compute_dtype='bfloat16'))
    with pytest.raises(ValueError, match='no window row'):
        fused_mlp.kernel_scales(flagship.template_of('fine'),
                                torch.ones(115), torch.device('cpu'))
    row = fused_mlp.kernel_scales(full.template_of('fine'), None,
                                  torch.device('cpu'))
    assert row.shape == (128,) and (row[:95] == 1).all() and \
        (row[95:] == 0).all()
