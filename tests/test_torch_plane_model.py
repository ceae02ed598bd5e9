"""The ``plane`` configuration's model (``bench.py --mode plane``: the
flagship with ``hyper_slice_method='axis_aligned_plane'``, its hyper
coordinates the ray's 8 GLO coordinates themselves) against the JAX
package, on the CPU, at small widths in float32: the render on the level
kernel's branch and on the per-module branch (``return_points``),
``query_sigma``, ``share_glo=False`` (a separate hyper table, module by
module), the loss and every gradient, and three Adam steps, against the JAX
model on the same converted weights and draws; the conversion of a plane
model both ways, what the CUDA path does not cover, refused with its
ROADMAP item, and ``eval`` on a plane weight file. The plane level and
template kernels' plain versions are ``tests/test_torch_plane.py``'s.

Tolerances: float32 as ``test_torch_modular_model.py`` (outputs and loss
1e-5, gradients 1e-4 of each parameter's largest entry, parameters after
three Adam steps 1e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.configs import NerfConfig, TrainConfig
from hypernerf_tpu.models.nerf import NerfModel as JaxNerfModel
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
from hypernerf_tpu_torch.kernels import fused_mlp
from hypernerf_tpu_torch.kernels.fused_level import _check_covered, pack_level
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
from hypernerf_tpu_torch.training.losses import mse_loss
from hypernerf_tpu_torch.training.optimizers import get_optimizer
from hypernerf_tpu_torch.training.train_state import (TrainState,
                                                      make_train_step)
from tests.test_torch_modular_model import _assert_outputs_close
from tests.test_torch_plane import PLANE, SPLIT, TOL
from tests.test_torch_train_step import (ARCH, STEPS_PER_EPOCH, TRAIN,
                                         _assert_trees_close, _batch, _flat,
                                         _jax_draws, _step_keys)


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

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
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
    with its ROADMAP item (B.3); the kernels' checks refuse a plane template
    of other widths (A.13)."""
    for override in (dict(warp_field_type='se3', rgb_channels=4),
                     dict(warp_field_type='quaternion', alpha_channels=2),
                     dict(use_original_embed=False, rgb_channels=4)):
        with pytest.raises(NotImplementedError, match='B.3'):
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
