"""Checkpoints (``training/checkpoints.py``): a full checkpoint's round trip
(weights, Adam's moments, the step and the occupancy grid) resumes the same
run; a checkpoint without a grid keeps a state's fresh one (as
``tests/test_occupancy.py`` checks in JAX); the manifest's best / latest /
prune; the non-strict weight load; ``save_weights_only`` and its entry
point; a full JAX checkpoint, saved after two JAX steps and converted by
``tools/jax_ckpt_to_torch.py``, resumes in the port with JAX's third step,
and one of each other optimizer (sgd, radam, ranger) after four with JAX's
fifth and sixth;
and ``eval`` renders a full checkpoint at its step's alphas through its
grid. Small widths, float32, the CPU (the plain versions); the JAX model on
its XLA path.

Tolerances: a resumed run equals the uninterrupted one exactly (the same
ops on the same numbers); against JAX the loss 1e-5 and every parameter
1e-5 (``test_torch_train_step.py``'s reasons).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from hypernerf_tpu.configs import NerfConfig, TrainConfig
from hypernerf_tpu.models.nerf import NerfModel as JaxNerfModel
from hypernerf_tpu.parallel.mesh import create_mesh
from hypernerf_tpu.training import checkpoints as jax_ckpt
from hypernerf_tpu.training.optimizers import get_optimizer as jax_optimizer
from hypernerf_tpu.training.train_state import TrainState as JaxTrainState
from hypernerf_tpu.training.train_state import \
    make_occupancy_update as jax_make_occupancy_update
from hypernerf_tpu.training.train_state import \
    make_train_step as jax_make_train_step
from hypernerf_tpu_torch import configs as port_configs
from hypernerf_tpu_torch.convert import params_from_jax, params_to_jax
from hypernerf_tpu_torch.datasets import dataset_dict
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.training import checkpoints
from hypernerf_tpu_torch.training.optimizers import get_optimizer
from hypernerf_tpu_torch.training.renderer import render_rays
from hypernerf_tpu_torch.training.train_state import (TrainState,
                                                      compute_extra_params,
                                                      make_occupancy_update,
                                                      make_train_step)
from hypernerf_tpu_torch.utils.visualization import to_uint8
from tests.test_torch_occupancy import OCC, _grid, _occ_draws
from tests.test_torch_train_step import (ARCH, STEPS_PER_EPOCH, TRAIN,
                                         _assert_trees_close, _batch,
                                         _flax_params, _jax_draws,
                                         _step_keys)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tools'))
import jax_ckpt_to_torch  # noqa: E402
import make_synthetic_scene  # noqa: E402

TOL = 1e-5


def _cfg(**overrides):
    return port_configs.NerfConfig(**{**ARCH, **OCC, **overrides})


def _state(cfg, seed=0):
    """A TrainState of ``cfg`` from a seeded init, and its step."""
    train_cfg = port_configs.TrainConfig(**TRAIN)
    torch.manual_seed(seed)
    model = NerfModel(cfg).train()
    optimizer, schedule = get_optimizer(train_cfg, model.parameters(),
                                        STEPS_PER_EPOCH)
    state = TrainState(0, model, optimizer, seed=7)
    step_fn = make_train_step(model, optimizer, cfg, train_cfg, 'cpu',
                              schedule=schedule, explicit_batch=True)
    return state, step_fn, train_cfg


def _step(state, step_fn):
    rays, rgbs = _batch()
    return step_fn(state, torch.from_numpy(rays), torch.from_numpy(rgbs))


def test_full_checkpoint_round_trip_resumes_the_same_run(tmp_path):
    """Two steps and a grid refresh, saved; a fresh state restored from it
    holds the same weights, Adam state, step and grid, and its next step
    equals the uninterrupted run's next step exactly."""
    cfg = _cfg()
    state, step_fn, train_cfg = _state(cfg)
    make_occupancy_update(state.model, cfg, train_cfg)(state)
    for _ in range(2):
        _step(state, step_fn)
    path = checkpoints.save_checkpoint(str(tmp_path), state.step, state,
                                       cfg, train_cfg, {'val/psnr': 12.5})
    assert path == os.path.join(str(tmp_path), 'step_2')
    assert checkpoints.checkpoint_step(path) == 2
    assert torch.equal(checkpoints.load_occupancy(path), state.occupancy)
    raw = checkpoints.restore_checkpoint(path)
    assert sorted(raw) == ['nerf', 'occupancy', 'opt_state', 'step']
    assert dataclasses.asdict(checkpoints.load_config(path)) == \
        dataclasses.asdict(cfg)
    assert checkpoints.load_train_config(path) == train_cfg

    resumed, resumed_fn, _ = _state(cfg, seed=1)
    assert resumed.step == 0 and not resumed.occupancy.any()
    assert checkpoints.restore_checkpoint(path, resumed) is resumed
    assert resumed.step == 2
    assert torch.equal(resumed.occupancy, state.occupancy)
    for (k, a), b in zip(state.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    moments = [(s['step'], s['exp_avg'], s['exp_avg_sq'])
               for s in state.optimizer.state_dict()['state'].values()]
    for want, got in zip(moments, [
            (s['step'], s['exp_avg'], s['exp_avg_sq'])
            for s in resumed.optimizer.state_dict()['state'].values()]):
        assert all(torch.equal(a, b) for a, b in zip(want, got))
    assert len(moments) == len(list(state.model.parameters()))
    a, b = _step(state, step_fn), _step(resumed, resumed_fn)
    assert torch.equal(a['loss'], b['loss'])
    for (k, x), y in zip(state.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(x, y), k


def test_restore_without_a_saved_grid_keeps_the_fresh_one(tmp_path):
    """A run that turns the grid on resumes from a checkpoint saved
    without one: the weights and step come back, the state's grid stays."""
    no_grid = _cfg(use_occupancy_grid=False)
    old, old_fn, train_cfg = _state(no_grid)
    _step(old, old_fn)
    assert old.occupancy is None
    path = checkpoints.save_checkpoint(str(tmp_path), 7, old, no_grid,
                                       train_cfg)
    assert checkpoints.load_occupancy(path) is None
    new, _, _ = _state(_cfg(), seed=3)
    fresh = new.occupancy + 1.25
    new.occupancy = fresh
    checkpoints.restore_checkpoint(path, new)
    assert new.step == 7
    assert torch.equal(new.occupancy, fresh)
    assert torch.equal(new.model.nerf_fine.trunk.hidden_0.weight,
                       old.model.nerf_fine.trunk.hidden_0.weight)


def test_best_latest_and_prune(tmp_path):
    cfg = _cfg(use_occupancy_grid=False)
    state, _, _ = _state(cfg)
    root = str(tmp_path / 'ckpts')
    assert checkpoints.latest_checkpoint(root) is None
    scores = {10: 20.0, 20: 25.0, 30: None, 40: 22.0, 50: 18.0}
    for step, psnr in scores.items():
        metrics = {} if psnr is None else {'val/psnr': psnr, 'val/loss':
                                           1.0 / psnr}
        checkpoints.save_checkpoint(root, step, state, cfg, metrics=metrics)
    assert checkpoints.latest_checkpoint(root) == os.path.join(root,
                                                               'step_50')
    assert checkpoints.best_checkpoint(root) == os.path.join(root, 'step_20')
    assert checkpoints.best_checkpoint(root, 'val/loss', 'min') == \
        os.path.join(root, 'step_20')
    assert checkpoints.best_checkpoint(root, 'val/ssim') == \
        os.path.join(root, 'step_50')
    checkpoints.prune_checkpoints(root, keep_top_k=2)
    kept = sorted(n for n in os.listdir(root) if n.startswith('step_'))
    assert kept == ['step_20', 'step_40', 'step_50']  # the top two + latest
    with open(os.path.join(root, 'manifest.json')) as f:
        assert sorted(json.load(f), key=int) == ['10', '20', '30', '40',
                                                 '50']
    checkpoints.prune_checkpoints(root, keep_top_k=None)
    assert len([n for n in os.listdir(root) if n.startswith('step_')]) == 3


def test_non_strict_load_weights(tmp_path):
    """Keys of matching shape load, ignored prefixes and mismatched shapes
    keep their init; the strict load refuses the mismatch; a full
    checkpoint's weights load like a weight file's."""
    src_cfg = _cfg(use_occupancy_grid=False)
    src, _, train_cfg = _state(src_cfg, seed=4)
    weights = str(tmp_path / 'w' / 'model.pt')
    checkpoints.save_weights(weights, src.model.state_dict(), src_cfg)
    ckpt = checkpoints.save_checkpoint(str(tmp_path / 'c'), 3, src, src_cfg)
    dst_cfg = dataclasses.replace(src_cfg, rgb_branch_width=24)
    for path in (weights, ckpt):
        with pytest.raises(RuntimeError, match='size mismatch'):
            checkpoints.load_weights(NerfModel(dst_cfg), path)
        torch.manual_seed(5)
        dst = NerfModel(dst_cfg)
        init = {k: v.clone() for k, v in dst.state_dict().items()}
        checkpoints.load_weights(dst, path, strict=False,
                                 prefixes_to_ignore=('warp_field.',))
        want = src.model.state_dict()
        for k, v in dst.state_dict().items():
            if k.startswith('warp_field.') or v.shape != want[k].shape:
                assert torch.equal(v, init[k]), k
            else:
                assert torch.equal(v, want[k]), k
        assert any(k.startswith('nerf_coarse.rgb_branch') and
                   v.shape != want[k].shape for k, v in init.items())
    with pytest.raises(ValueError, match='strict'):
        checkpoints.load_weights(dst, weights, prefixes_to_ignore=('a',))


def test_save_weights_only(tmp_path):
    """The function and ``python -m hypernerf_tpu_torch.save_weights_only``
    strip a full checkpoint to a weight file with the configs beside it:
    no step, no grid; it loads strictly and renders as the checkpoint
    does without its grid."""
    cfg = _cfg()
    state, step_fn, train_cfg = _state(cfg)
    _step(state, step_fn)
    ckpt = checkpoints.save_checkpoint(str(tmp_path / 'ckpts'), 1, state,
                                       cfg, train_cfg)
    out = checkpoints.save_weights_only(ckpt, str(tmp_path / 'w' / 'm.pt'))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get('PYTHONPATH', '')]))
    proc = subprocess.run(
        [sys.executable, '-m', 'hypernerf_tpu_torch.save_weights_only',
         '--ckpt_path', ckpt], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    default = ckpt + '_weights.pt'
    assert proc.stdout.strip() == default
    for path in (out, default):
        assert checkpoints.checkpoint_step(path) is None
        assert checkpoints.load_occupancy(path) is None
        assert checkpoints.load_config(path) == cfg
        assert checkpoints.load_train_config(path) == train_cfg
        model = NerfModel(cfg)
        checkpoints.load_weights(model, path)
        for (k, a), b in zip(state.model.state_dict().items(),
                             model.state_dict().values()):
            assert torch.equal(a, b), k
    # The weights-only file does not count as a checkpoint of the run.
    assert checkpoints.latest_checkpoint(str(tmp_path / 'ckpts')) == ckpt
    with pytest.raises(ValueError, match='weight file'):
        checkpoints.restore_checkpoint(out, state)


def test_jax_full_checkpoint_resumes_in_the_port(tmp_path):
    """JAX: a grid refresh and two steps, then ``save_checkpoint``;
    ``tools/jax_ckpt_to_torch.py --out_dir`` converts it (weights, step,
    grid, Adam's mu / nu / count); the port restores it and takes the third
    step with JAX's draws: the loss and every parameter equal JAX's third
    step's."""
    rays, rgbs = _batch()
    cfg = NerfConfig(use_pallas=False, **{**ARCH, **OCC})
    train_cfg = TrainConfig(**TRAIN)
    jmodel = JaxNerfModel(cfg)
    tx = jax_optimizer(train_cfg, steps_per_epoch=STEPS_PER_EPOCH)
    params = jax.tree.map(jnp.asarray, _flax_params())
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params),
                           occupancy=jnp.asarray(_grid()))
    base_rng = jax.random.PRNGKey(1)
    jstate = jax_make_occupancy_update(jmodel, cfg, train_cfg)(jstate,
                                                               base_rng)
    jstep = jax_make_train_step(jmodel, tx, cfg, train_cfg,
                                create_mesh(num_devices=1),
                                explicit_batch=True)
    for _ in range(2):
        jstate, _ = jstep(jstate, jnp.asarray(rays), jnp.asarray(rgbs),
                          base_rng)
    jax_path = jax_ckpt.save_checkpoint(str(tmp_path / 'jax'), 2, jstate,
                                        nerf_config=cfg,
                                        train_config=train_cfg)
    draws = _occ_draws(jmodel, jax.device_get(jstate.params),
                       *_step_keys(base_rng, 2))
    grid = np.asarray(jstate.occupancy)
    jstate, jmetrics = jstep(jstate, jnp.asarray(rays), jnp.asarray(rgbs),
                             base_rng)

    path = jax_ckpt_to_torch.convert_checkpoint(jax_path,
                                                str(tmp_path / 'port'))
    assert path == os.path.join(str(tmp_path / 'port'), 'step_2')
    pcfg = checkpoints.load_config(path)
    ptrain = checkpoints.load_train_config(path)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
    assert dataclasses.asdict(ptrain) == dataclasses.asdict(train_cfg)
    torch.manual_seed(9)
    model = NerfModel(pcfg).train()
    optimizer, schedule = get_optimizer(ptrain, model.parameters(),
                                        STEPS_PER_EPOCH)
    state = checkpoints.restore_checkpoint(
        path, TrainState(0, model, optimizer))
    assert state.step == 2
    np.testing.assert_array_equal(state.occupancy.numpy(), grid)
    for s in optimizer.state_dict()['state'].values():
        assert s['step'].item() == 2.0
    step_fn = make_train_step(model, optimizer, pcfg, ptrain, 'cpu',
                              schedule=schedule, explicit_batch=True)
    metrics = step_fn(state, torch.from_numpy(rays), torch.from_numpy(rgbs),
                      draws=draws)
    assert state.step == 3 == int(jstate.step)
    assert abs(metrics['loss'].item() - float(jmetrics['loss'])) <= TOL
    _assert_trees_close(params_to_jax(model.state_dict()),
                        jax.device_get(jstate.params), TOL, False)
    # A JAX weights-only checkpoint converts to a weight file, not to a
    # full checkpoint.
    weights_only = str(tmp_path / 'jax' / 'step_2_weights')
    jax_ckpt.save_weights_only(jax_path, weights_only)
    out = jax_ckpt_to_torch.convert(weights_only,
                                    str(tmp_path / 'w' / 'm.pt'))
    assert checkpoints.checkpoint_step(out) is None
    checkpoints.load_weights(NerfModel(pcfg), out)
    with pytest.raises(ValueError, match='full checkpoint'):
        jax_ckpt_to_torch.convert_checkpoint(weights_only,
                                             str(tmp_path / 'x'))


@pytest.mark.parametrize('name', ['sgd', 'radam', 'ranger'])
def test_jax_checkpoint_of_each_optimizer_resumes_in_the_port(tmp_path,
                                                              name):
    """JAX: four steps of ``name`` (weight decay on), then
    ``save_checkpoint``; ``tools/jax_ckpt_to_torch.py --out_dir`` converts
    its optimizer state (SGD's momentum, RAdam's moments and count,
    ranger's moments of the fast weights, its slow weights and its count
    since the last sync); the port restores it and takes JAX's fifth and
    sixth steps (RAdam's first rectified update, ranger's first sync) with
    JAX's draws: the loss and every parameter, and ranger's slow weights,
    equal JAX's. A ranger checkpoint's weight file holds the fast weights.
    JAX's ranger step takes the fast weights' gradient here (ROADMAP D)."""
    rays, rgbs = _batch()
    cfg = NerfConfig(use_pallas=False, **ARCH)
    train_cfg = TrainConfig(**TRAIN, optimizer=name, weight_decay=1e-3)
    jmodel = JaxNerfModel(cfg)
    tx = jax_optimizer(train_cfg, steps_per_epoch=STEPS_PER_EPOCH)
    params = jax.tree.map(jnp.asarray, _flax_params())
    if name == 'ranger':
        inner = tx
        tx = optax.GradientTransformation(
            inner.init, lambda g, s, p=None: inner.update(g.fast, s, p))
        params = optax.LookaheadParams(
            fast=params, slow=jax.tree.map(jnp.copy, params))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params))
    jstep = jax_make_train_step(jmodel, tx, cfg, train_cfg,
                                create_mesh(num_devices=1),
                                explicit_batch=True)
    base_rng = jax.random.PRNGKey(1)
    for _ in range(4):
        jstate, _ = jstep(jstate, jnp.asarray(rays), jnp.asarray(rgbs),
                          base_rng)
    jax_path = jax_ckpt.save_checkpoint(str(tmp_path / 'jax'), 4, jstate,
                                        nerf_config=cfg,
                                        train_config=train_cfg)
    path = jax_ckpt_to_torch.convert_checkpoint(jax_path,
                                                str(tmp_path / 'port'))
    pcfg = checkpoints.load_config(path)
    ptrain = checkpoints.load_train_config(path)
    assert ptrain.optimizer == name
    torch.manual_seed(9)
    model = NerfModel(pcfg).train()
    optimizer, schedule = get_optimizer(ptrain, model.parameters(),
                                        STEPS_PER_EPOCH)
    state = checkpoints.restore_checkpoint(
        path, TrainState(0, model, optimizer))
    assert state.step == 4
    step_fn = make_train_step(model, optimizer, pcfg, ptrain, 'cpu',
                              schedule=schedule, explicit_batch=True)
    for step in (4, 5):
        fast = jstate.params.fast if name == 'ranger' else jstate.params
        draws = _jax_draws(jmodel, jax.device_get(fast),
                           *_step_keys(base_rng, step))
        jstate, jmetrics = jstep(jstate, jnp.asarray(rays),
                                 jnp.asarray(rgbs), base_rng)
        metrics = step_fn(state, torch.from_numpy(rays),
                          torch.from_numpy(rgbs), draws=draws)
        assert abs(metrics['loss'].item() - float(jmetrics['loss'])) <= TOL
        want = jax.device_get(jstate.params)
        if name == 'ranger':
            _assert_trees_close(params_to_jax(
                {k: optimizer.state[p]['slow']
                 for k, p in model.named_parameters()}), want.slow, TOL,
                False)
            want = want.fast
        _assert_trees_close(params_to_jax(model.state_dict()), want, TOL,
                            False)
    if name == 'ranger':
        out = jax_ckpt_to_torch.convert(jax_path, str(tmp_path / 'w.pt'))
        weights = torch.load(out, weights_only=True)
        restored = checkpoints.restore_checkpoint(path)['nerf']
        for k, v in restored.items():
            assert torch.equal(weights[k], v), k


def test_eval_renders_a_full_checkpoint_at_its_step_and_grid(
        tmp_path, monkeypatch):
    """``python -m hypernerf_tpu_torch.eval --ckpt_path step_N`` (run in
    this process, on the CPU) on an ``anneal`` + grid model saved at step
    2500: each frame equals the render at step 2500's alphas through the
    checkpoint's grid, and differs from the fully annealed render and from
    the render without the grid."""
    from hypernerf_tpu_torch import eval as port_eval
    scene = make_synthetic_scene.make_scene(str(tmp_path / 'scene'),
                                            n_frames=2, width=16, height=12,
                                            focal=18.0)
    cfg = _cfg(use_original_embed=False, num_embeddings=2, noise_std=None)
    state, _, train_cfg = _state(cfg)
    state.occupancy = torch.from_numpy(_grid())
    ckpt = checkpoints.save_checkpoint(str(tmp_path / 'ckpts'), 2500, state,
                                       cfg, train_cfg)
    monkeypatch.setenv('HYPERNERF_PLATFORM', 'cpu')
    monkeypatch.chdir(tmp_path)
    port_eval.main(['--root_dir', scene, '--dataset_name', 'llff',
                    '--img_wh', '16', '12', '--split', 'test_train',
                    '--ckpt_path', ckpt, '--scene_name', 'synth',
                    '--chunk', '64'])
    dataset = dataset_dict['llff'](root_dir=scene, split='test_train',
                                   img_wh=(16, 12), include_idx=True,
                                   spheric_poses=False)
    model = state.model.eval()
    at_step = compute_extra_params(cfg, train_cfg, 2500)
    annealed = port_eval.eval_extra_params(cfg, train_cfg)
    assert at_step['hyper_alpha'] < annealed['hyper_alpha']
    for i in range(len(dataset)):
        rays = dataset[i]['rays']
        png = np.asarray(Image.open(tmp_path / 'results' / 'llff' / 'synth'
                                    / f'{i:03d}.png'))

        def image(**kw):
            rgb = render_rays(model, rays, chunk=64, keep=('rgb',),
                              levels=('fine',), **kw)['fine']['rgb']
            return to_uint8(rgb).reshape(12, 16, 3)

        np.testing.assert_array_equal(
            png, image(extra_params=at_step, occupancy_grid=state.occupancy))
        assert (png != image(extra_params=annealed,
                             occupancy_grid=state.occupancy)).any()
        assert (png != image(extra_params=at_step)).any()
