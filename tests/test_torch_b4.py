"""The warp x slicing x encoding combinations (ROADMAP B.4) at the kernels'
level, against the JAX package, on the CPU:

- what ``unsupported()`` admits now: the seven combinations build; heads
  other than rgb 3 + alpha 1 (B.3), Nerfies bands from a degree other than
  0 (A.13) are still refused, each naming its item, and an SE(3) field
  with the identity in its encoding builds;
- the kernels' layer tables and layouts of the new combinations: each
  level packs to its table (``level_table``), the template to its layout;
- the stored JAX numbers the card is held to
  (``tests/data/fused_b4_jax_ref.npz``) recomputed from the JAX package,
  and the port's plain versions against them: the level forward (row 1) and
  its backward (kernel A, row 9, then kernel B, row 5) of ``anneal_se3``,
  ``plane_se3``, ``plane_anneal_se3`` and ``plane_quaternion``, the
  template alone in the Nerfies plane layout (rows 8 and 9);
- the conversion of a full-width JAX model of ``anneal_se3`` and of
  ``plane_anneal_se3``, and a full JAX checkpoint of ``plane_anneal_se3``
  converted and resumed.

(The models against the JAX model: ``test_torch_b4_model.py``.)

Tolerances: the stored numbers at the probe weights in bf16 as the SE(3)
levels' (``test_torch_fused_level.py``, ROADMAP D): outputs 6e-2 + 1e-2 |x|
with a mean below 1e-4, gradients relative L2 0.12 and 0.25 of the largest
entry; the template alone (no warp) as the plane template's: outputs 1e-2 +
1e-2 |x|, gradients relative L2 5e-2 and 0.25 of the largest entry; the
recomputed file 1e-6; the resumed step as ``test_torch_modular_model.py``
(loss and parameters 1e-5).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.configs import NerfConfig, TrainConfig
from hypernerf_tpu.models.nerf import NerfModel as JaxNerfModel
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
from hypernerf_tpu_torch.flagship import (B4_CONFIGS, B4_LEVEL_CASES,
                                          CONFIGS,
                                          B4_REFERENCE, B4_TEMPLATE_CASES,
                                          LEVEL_INPUTS, b4_extra_params,
                                          flagship_config, flagship_model,
                                          load_probe_weights,
                                          read_b4_reference)
from hypernerf_tpu_torch.kernels import common, fused_mlp
from hypernerf_tpu_torch.kernels.fused_level import (_check_covered,
                                                     _level_params,
                                                     level_table, pack_level)
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.models.warping import SE3Field
from hypernerf_tpu_torch.training import checkpoints
from hypernerf_tpu_torch.training.optimizers import get_optimizer
from hypernerf_tpu_torch.training.train_state import (TrainState,
                                                      make_train_step)
from tests.test_torch_b4_model import COMBOS, _flax_params
from tests.test_torch_train_step import (ARCH, STEPS_PER_EPOCH, TRAIN,
                                         _assert_trees_close, _batch, _flat,
                                         _jax_draws, _step_keys)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
SE3_ATOL, SE3_L2, GRAD_L2, GRAD_MAX = 6e-2, 0.12, 5e-2, 0.25
# Ramps of three steps: warp_alpha and hyper_alpha fractional in steps 0..2.
ANNEAL_TRAIN = dict(TRAIN, hyper_alpha_steps=3, warp_alpha_steps=3)
# (the table, the template's layout, the level's layer count) of each
# combination at the full widths.
TABLES = {'anneal_se3': ('se3', 'nerfies', 32),
          'anneal_quaternion': ('quaternion', 'nerfies', 32),
          'plane_se3': ('plane_se3', 'plane', 25),
          'plane_quaternion': ('plane_quaternion', 'plane', 25),
          'plane_anneal': ('nerfies_plane', 'nerfies_plane', 23),
          'plane_anneal_se3': ('nerfies_plane_se3', 'nerfies_plane', 25),
          'plane_anneal_quaternion': ('nerfies_plane_quaternion',
                                      'nerfies_plane', 25)}


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """Full-width bf16 products: one thread keeps the file's time on a
    loaded worker (torch starts a thread per core)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# What the port admits and refuses, and the tables the levels take.


@pytest.mark.parametrize('name', B4_CONFIGS)
def test_each_combination_packs_to_its_table(name):
    """At the full widths in bf16 the model builds; its levels pass the
    kernels' checks and pack to their compiled table (the template's first
    layer 256 x 128, or 256 x 192 in the plane layout, after the warp's 7
    or 9 layers and the sheet's 7), the template to its layout with raw rows
    of 8 or 16 columns and, with the Nerfies encoding, its window row."""
    table, layout, n_layers = TABLES[name]
    model = NerfModel(flagship_config(name))
    level = model.level('fine')
    _check_covered(level)
    assert level_table(level) == table
    assert fused_mlp.layout(level) == layout
    shapes = pack_level(level)[2]
    assert len(shapes) == n_layers
    enc = common.PLANE_ENC_PAD if layout == 'plane' else 128
    assert shapes[len(shapes) - 16] == (256, enc)  # the template's first
    assert fused_mlp.raw_pad(level) == (8 if table in common.WARP_CODES
                                        else 16)
    row = fused_mlp.kernel_scales(level, None, torch.device('cpu'))
    if 'anneal' in name:
        n_enc = model.nerf_fine.trunk.hidden_0.in_features
        assert row.shape == (128,) and (row[:n_enc] == 1).all() and \
            (row[n_enc:] == 0).all()
    else:
        assert row is None


def test_what_is_still_refused_names_its_item():
    """The seven combinations build at the small widths too; the heads
    (B.3) and Nerfies bands from another degree (A.13) are refused on top
    of any of them. An SE(3) field with the identity in its encoding, once
    refused (B.3), now builds at its wider first layer and stays off the
    trunk kernels (``tests/test_torch_se3_identity.py``)."""
    for name in COMBOS:
        NerfModel(port_configs.NerfConfig(**ARCH, **COMBOS[name]))
    for name, over, item in (
            ('plane_anneal_se3', dict(rgb_channels=4), 'B.3'),
            ('anneal_quaternion', dict(alpha_channels=2), 'B.3'),
            ('plane_anneal', dict(spatial_point_min_deg=1), 'A.13'),
            ('anneal_se3', dict(hyper_point_min_deg=1), 'A.13')):
        with pytest.raises(NotImplementedError, match=item):
            NerfModel(port_configs.NerfConfig(**ARCH, **COMBOS[name],
                                              **over))
    field = SE3Field(8, use_posenc_identity=True)
    assert field.trunk.hidden(0).in_features == 3 * (1 + 2 * 8) + 8
    assert not field.runs_kernels(torch.zeros(1, 3))


# ---------------------------------------------------------------------------
# The stored JAX numbers of the card's checks.


def test_stored_reference_recomputes():
    """``tests/data/fused_b4_jax_ref.npz`` is what
    ``tools/make_level_reference.py --only b4`` computes now: the JAX level
    kernel (interpret mode, flagship widths, bf16) of four combinations at
    their alphas and ``fused_nerf_mlp`` in the Nerfies plane layout, at the
    probe weights."""
    import tools.make_level_reference as mlr
    want = mlr.b4_reference()
    with np.load(B4_REFERENCE) as f:
        assert sorted(f.files) == sorted(want)
        for k in f.files:
            np.testing.assert_allclose(f[k], want[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30),
            np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _grads_close(got, names, want, l2_bound, case):
    """Each stored gradient of ``want`` against ``got`` by name; every
    stored one is checked."""
    checked = 0
    for n, g in zip(names, got):
        if n not in want:  # a weight whose dW the file does not keep
            continue
        l2, mx = _rel(g, want[n])
        assert l2 <= l2_bound and mx <= GRAD_MAX, (case, n, l2, mx)
        checked += 1
    assert checked == sum(k.startswith(('d_', 'dx', 'dw', 'db'))
                          for k in want)


@pytest.mark.parametrize('case', sorted(B4_LEVEL_CASES))
def test_plain_level_holds_to_the_stored_jax_numbers(case):
    """The port's plain level forward (row 1) with both window rows in one
    call, and its backward (kernel A's then kernel B's plain version,
    through ``FusedLevelFn``), at the probe weights and the case's alphas."""
    config, level, *_ = B4_LEVEL_CASES[case]
    ref = {k: torch.from_numpy(v) for k, v in
           read_b4_reference()[case].items()}
    model = load_probe_weights(flagship_model('cpu', config=config))
    warp_row, tmpl_row = model.window_rows(b4_extra_params(config),
                                           torch.device('cpu'))
    assert (warp_row is None) == (config == 'plane_quaternion')
    assert (tmpl_row is None) == ('anneal' not in config)
    lv = model.level(level)
    args = [ref[k].clone().requires_grad_() for k in LEVEL_INPUTS]
    out = K.fused_level(lv, *args, warp_row, tmpl_row)
    d = (out.detach() - ref['out']).abs()
    assert (d <= SE3_ATOL + 1e-2 * ref['out'].abs()).all()
    assert d.mean() < 1e-4
    params = _level_params(lv)
    got = torch.autograd.grad(out, args + params, ref['cotangent'])
    names = [f'd_{k}' for k in LEVEL_INPUTS] + [
        f'd{"wb"[i % 2]}{i // 2}' for i in range(len(params))]
    _grads_close(got, names, ref, SE3_L2, case)


def test_plain_template_holds_to_the_stored_jax_numbers():
    """The template alone in the Nerfies plane layout (x_raw (P, 16), the
    window row at the anneal alphas; rows 8 and 9's plain versions)."""
    case = 'template_nerfies_plane'
    config, level, *_ = B4_TEMPLATE_CASES[case]
    t = {k: torch.from_numpy(v) for k, v in read_b4_reference()[case].items()}
    tm = load_probe_weights(flagship_model('cpu', config=config)
                            ).template_of(level)
    assert fused_mlp.layout(tm) == 'nerfies_plane'
    ep = b4_extra_params(config)
    row = fused_mlp.template_scales(tm, ep['nerf_alpha'], ep['hyper_alpha'])
    x = t['x_raw'].clone().requires_grad_()
    c = t['rgb_cond'].clone().requires_grad_()
    out = K.fused_template(tm, x, c, row)
    d = (out.detach() - t['out']).abs()
    assert (d <= 1e-2 + 1e-2 * t['out'].abs()).all() and d.mean() < 1e-4
    layers = fused_mlp.template_layers(tm.template)
    got = torch.autograd.grad(out, [x, c] + common.layer_params(layers),
                              t['cotangent'])
    assert (got[0][:, 11:] == 0).all()
    names = ['dx', 'd_rgb_cond'] + [f'd{"wb"[i % 2]}{i // 2}'
                                    for i in range(2 * len(layers))]
    _grads_close(got, names, t, GRAD_L2, case)


# ---------------------------------------------------------------------------
# Conversion and checkpoints.


@pytest.mark.parametrize('name', ['anneal_se3', 'plane_anneal_se3'])
def test_full_width_jax_model_converts(name):
    """The flax tree of the paper's two models at the full widths (its
    shapes, ``jax.eval_shape``: the SE(3) trunk on 56 inputs, the template
    on 95 or 127 Nerfies columns, no sheet with the plane) has the port's
    keys and shapes, and a tree of those shapes loads into the port's model
    and comes back unchanged; the level packs to its table."""
    cfg = NerfConfig(use_pallas=False, num_embeddings=4,
                     num_coarse_samples=4, num_fine_samples=4,
                     **CONFIGS[name])
    shapes = jax.eval_shape(JaxNerfModel(cfg).init,
                            {'params': jax.random.PRNGKey(3)},
                            jax_ray_dict(jnp.asarray(_batch()[0])))['params']
    assert ('hyper_sheet_mlp' in shapes) == (name == 'anneal_se3')
    enc = 63 + (32 if name == 'anneal_se3' else 64)
    assert shapes['nerf_coarse']['trunk']['hidden_0']['kernel'].shape == (
        enc, 256)
    assert shapes['warp_field']['trunk']['hidden_0']['kernel'].shape == (
        56, 128)
    rs = np.random.RandomState(0)
    params = jax.tree.map(
        lambda a: rs.randn(*a.shape).astype(np.float32), shapes)
    model = NerfModel(port_configs.NerfConfig(
        num_embeddings=4, compute_dtype='bfloat16', **CONFIGS[name]))
    model.load_state_dict(params_from_jax(params))
    back = params_to_jax(model.state_dict())
    assert sorted(k for k, _ in _flat(back)) == sorted(
        k for k, _ in _flat(params))
    for (k, a), (_, b) in zip(sorted(_flat(back)), sorted(_flat(params))):
        np.testing.assert_array_equal(a, b, err_msg=k)
    _check_covered(model.level('fine'))
    assert len(pack_level(model.level('fine'))[2]) == TABLES[name][2]


def test_jax_full_checkpoint_of_plane_anneal_se3_resumes(tmp_path):
    """JAX: two steps of the small ``plane_anneal_se3`` model (its alphas
    from the step, ramps of three steps), ``save_checkpoint``;
    ``tools/jax_ckpt_to_torch.py --out_dir`` converts it (the config, the
    trunk and the template on the plane's Nerfies encoding, Adam's moments,
    the step); the port restores it and takes the third step with JAX's
    draws: the loss and every parameter equal JAX's third step's."""
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    import jax_ckpt_to_torch
    name = 'plane_anneal_se3'
    rays, rgbs = _batch()
    cfg = NerfConfig(use_pallas=False, **ARCH, **COMBOS[name])
    train_cfg = TrainConfig(**ANNEAL_TRAIN)
    jmodel = JaxNerfModel(cfg)
    tx = jax_optimizer(train_cfg, steps_per_epoch=STEPS_PER_EPOCH)
    params = jax.tree.map(jnp.asarray, _flax_params(name))
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
    ptrain = checkpoints.load_train_config(path)
    model = NerfModel(pcfg).train()
    assert model.level('fine').hyper is None
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
