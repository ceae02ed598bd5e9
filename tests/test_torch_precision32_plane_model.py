"""The plane tables' configurations at ``--precision 32`` as models, against
the JAX package at ``compute_dtype='float32'``, on the CPU (ROADMAP A.13.1
sub-item 3, second half; the kernels' checks are
``tests/test_torch_precision32_plane.py``'s).

- The CLI: ``--precision 32 --slice_method axis_aligned_plane`` with each
  warp, with and without ``--use_nerfies_embed``, builds the six plane
  configurations in float32 at the flagship widths, and both levels of each
  pass the float32 kernels' gate.
- The six at narrow widths (``test_torch_train_step.ARCH``; the Nerfies
  degrees of ``tests/test_torch_b4_model.py``, an SE(3) trunk over degrees
  0..4), on the level kernel's branch (one plain level call per level) and
  on the per-module branch (``return_points``: the warp, then the template
  alone), against the dense JAX model on the same weights with the alphas
  mid-ramp: a deterministic render's per-ray outputs of both levels and the
  loss's gradient relative L2 1e-5, each parameter's max|d| 1e-4 of its
  largest entry (the JAX render and gradient jitted once per
  configuration).
- A JAX checkpoint of the paper's axis-aligned-plane model
  (``plane_anneal_se3``) at float32 (``save_checkpoint``, Adam's state),
  converted by ``tools/jax_ckpt_to_torch.py`` and resumed in the port: the
  configuration float32 with the plane, the Nerfies encoding and the SE(3)
  warp; every weight equal bit for bit; the restored model's render and
  loss gradient the JAX model's within the same tolerances.

One torch thread. About 60 s alone on one worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.configs import NerfConfig as JaxNerfConfig
from hypernerf_tpu.configs import TrainConfig as JaxTrainConfig
from hypernerf_tpu.models.nerf import NerfModel as JaxNerfModel
from hypernerf_tpu.ops.ray_dict import prepare_ray_dict as jax_ray_dict
from hypernerf_tpu.training import checkpoints as jax_ckpt
from hypernerf_tpu.training.losses import mse_loss as jax_mse_loss
from hypernerf_tpu.training.optimizers import get_optimizer as jax_optimizer
from hypernerf_tpu.training.train_state import TrainState as JaxTrainState
from hypernerf_tpu_torch import configs as port_configs
from hypernerf_tpu_torch import opt as port_opt
from hypernerf_tpu_torch.convert import params_from_jax, params_to_jax
from hypernerf_tpu_torch.kernels import fused_level_plain
from hypernerf_tpu_torch.kernels.fused_level import _check_covered
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
from hypernerf_tpu_torch.training import checkpoints
from hypernerf_tpu_torch.training.losses import mse_loss
from tests.test_torch_b4_model import COMBOS, NERFIES, PLANE
from tests.test_torch_precision32 import jax_ckpt_to_torch
from tests.test_torch_train_step import (ARCH, STEPS_PER_EPOCH, TRAIN,
                                         _batch)

TOL = 1e-5
MODELS = {'plane': PLANE, **{k: v for k, v in COMBOS.items()
                             if k.startswith('plane')}}
# Every window partly on: the trunk's 1.4 of 4 bands, the hyper
# coordinates' 1.4 of 2, the xyz's 3.3 of 4.
EXTRA = {'nerf_alpha': 3.3, 'warp_alpha': 1.4, 'hyper_alpha': 1.4,
         'hyper_sheet_alpha': 1.4}
CLI = {'plane': (), 'plane_se3': ('--warp_field', 'se3'),
       'plane_quaternion': ('--warp_field', 'quaternion'),
       'plane_anneal': ('--use_nerfies_embed',),
       'plane_anneal_se3': ('--use_nerfies_embed', '--warp_field', 'se3'),
       'plane_anneal_quaternion': ('--use_nerfies_embed', '--warp_field',
                                   'quaternion')}


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a, b = torch.as_tensor(np.array(a)), torch.as_tensor(np.array(b))
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize('name', list(CLI))
def test_cli_precision_32_builds_the_plane_tables(name):
    """``--precision 32 --slice_method axis_aligned_plane`` (and the warp
    and encoding flags of ``name``) builds the plane configuration in
    float32 at the flagship widths; both levels pass the float32 gate (the
    plane tables' float32 kernels), none refuses."""
    nerf_cfg, _ = port_opt.configs_from_args(port_opt.get_opts(
        ['--precision', '32', '--slice_method', 'axis_aligned_plane',
         *CLI[name]]))
    assert nerf_cfg.compute_dtype == 'float32'
    assert nerf_cfg.hyper_slice_method == 'axis_aligned_plane'
    assert nerf_cfg.use_original_embed == ('anneal' not in name)
    assert nerf_cfg.warp_field_type == (
        name.rsplit('_', 1)[1] if name.endswith(('se3', 'quaternion'))
        else 'translation')
    model = NerfModel(nerf_cfg)
    for level in ('coarse', 'fine'):
        _check_covered(model.level(level))


def _jax_loss(jmodel, rays, rgbs, jextra):
    def loss(p):
        res = jmodel.apply({'params': p}, jax_ray_dict(jnp.asarray(rays)),
                           jextra, deterministic=True)
        return jax_mse_loss(res, jnp.asarray(rgbs)), res
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _extra(over):
    """The alphas of a configuration: the trunk's window with a screw warp,
    the template's with the Nerfies encoding."""
    return {k: v for k, v in EXTRA.items()
            if ('warp_field_type' in over if k == 'warp_alpha'
                else 'use_original_embed' in over)}


def _port_params(over):
    """The flax tree of a configuration from the port's seeded init, with
    the warp's heads scaled up so that the warp moves the output."""
    torch.manual_seed(0)
    model = NerfModel(port_configs.NerfConfig(**ARCH, **over))
    params = jax.tree.map(np.array, params_to_jax(model.state_dict()))
    warp = params['warp_field']
    if 'w_net' in warp:
        for head in ('w_net', 'v_net'):
            warp[head]['logit']['kernel'] *= 1e3
    else:
        warp['mlp']['logit']['kernel'] *= 300.0
    return params


@pytest.fixture(scope='module')
def models():
    """{name: (port model, JAX outputs, JAX gradients)} of each plane
    configuration at narrow widths in float32, the JAX render and the
    loss's gradient jitted once per configuration."""
    out = {}
    rays, rgbs = _batch()
    for name, over in MODELS.items():
        cfg = {**ARCH, **over}
        params = _port_params(over)
        jmodel = JaxNerfModel(JaxNerfConfig(use_pallas=False, **cfg))
        jextra = {k: jnp.float32(v) for k, v in _extra(over).items()}
        (_, want), grads = jax.device_get(_jax_loss(
            jmodel, rays, rgbs, jextra)(params))
        model = NerfModel(port_configs.NerfConfig(**cfg))
        model.load_state_dict(params_from_jax(params))
        assert model.config.compute_dtype == 'float32'
        out[name] = (model, want, params_from_jax(grads))
    return out


def _hold(model, want, jgrads, extra, return_points):
    """The port's render and loss gradient against the JAX model's."""
    rays, rgbs = _batch()
    model.zero_grad(set_to_none=True)
    got = model(prepare_ray_dict(torch.from_numpy(rays)), deterministic=True,
                extra_params=extra, return_points=return_points)
    for level in want:
        for k in ('rgb', 'depth', 'acc'):
            assert _rel(got[level][k].detach(), want[level][k]) <= TOL, \
                (level, k)
    mse_loss(got, torch.from_numpy(rgbs)).backward()
    mine, theirs = [], []
    for pname, p in model.named_parameters():
        want_g = torch.as_tensor(np.asarray(jgrads[pname]))
        g = torch.zeros_like(want_g) if p.grad is None else p.grad
        assert (g - want_g).abs().max() <= \
            10 * TOL * want_g.abs().max().clamp_min(1e-30), pname
        mine.append(g.reshape(-1))
        theirs.append(want_g.reshape(-1))
    assert _rel(torch.cat(mine), torch.cat(theirs)) <= TOL


@pytest.mark.parametrize('branch', ['level_kernel', 'per_module'])
@pytest.mark.parametrize('name', list(MODELS))
def test_float32_plane_models_match_jax(models, name, branch):
    """A deterministic render's per-ray outputs of both levels at the
    alphas mid-ramp and the loss's gradient against the JAX model at
    float32 (the module docstring's rule), on the level kernel's branch
    (one plain level call per level) and on the per-module branch."""
    model, want, jgrads = models[name]
    calls = fused_level_plain.calls
    _hold(model, want, jgrads, _extra(MODELS[name]),
          return_points=branch == 'per_module')
    assert fused_level_plain.calls - calls == (2 if branch == 'level_kernel'
                                               else 0)


def test_float32_plane_anneal_se3_checkpoint_resumes_in_the_port(tmp_path):
    """A float32 JAX checkpoint of ``plane_anneal_se3`` (Adam's state
    included) converted and restored in the port: its configuration, every
    weight bit for bit, and the JAX model's render and loss gradient."""
    over = MODELS['plane_anneal_se3']
    cfg = JaxNerfConfig(use_pallas=False, **ARCH, **over)
    assert cfg.compute_dtype == 'float32'
    train_cfg = JaxTrainConfig(**TRAIN)
    tx = jax_optimizer(train_cfg, steps_per_epoch=STEPS_PER_EPOCH)
    params = jax.tree.map(jnp.asarray, _port_params(over))
    state = JaxTrainState(step=jnp.asarray(3, jnp.int32), params=params,
                          opt_state=tx.init(params))
    path = jax_ckpt.save_checkpoint(str(tmp_path / 'jax'), 3, state,
                                    nerf_config=cfg, train_config=train_cfg)
    out = jax_ckpt_to_torch.convert_checkpoint(path, str(tmp_path / 'port'))
    port_cfg = checkpoints.load_config(out)
    assert (port_cfg.compute_dtype, port_cfg.hyper_slice_method,
            port_cfg.warp_field_type, port_cfg.use_original_embed) == (
                'float32', 'axis_aligned_plane', 'se3', False)
    model = NerfModel(port_cfg)
    checkpoints.load_weights(model, out)
    want = params_from_jax(jax.device_get(params))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.dtype == torch.float32, k
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    rays, rgbs = _batch()
    jextra = {k: jnp.float32(v) for k, v in _extra(over).items()}
    (_, jout), jgrads = jax.device_get(_jax_loss(
        JaxNerfModel(cfg), rays, rgbs, jextra)(params))
    _hold(model, jout, params_from_jax(jgrads), _extra(over),
          return_points=False)
