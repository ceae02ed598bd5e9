"""The flagship setups: the configuration ``bench.py`` renders and trains
(NerfConfig defaults with 64 + 64 samples, bf16 matmuls), a seeded model of
it, LLFF spiral-path NDC rays of a 504x378 frame, the train step's model,
optimizer and synthetic ray buffer (``flagship_train_setup``), and the probe
weights and inputs at which the level kernels are held against the JAX
kernels' stored outputs and gradients (``LEVEL_REFERENCE``, written by
``tools/make_level_reference.py``).

Shared by ``chip_smoke.py``, ``tools/profile_render.py``,
``tools/profile_train.py`` and ``tools/make_level_reference.py``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from hypernerf_tpu_torch.configs import NerfConfig, TrainConfig
from hypernerf_tpu_torch.datasets.llff import create_spiral_poses
from hypernerf_tpu_torch.datasets.rays import (get_ndc_rays, get_ray_directions,
                                         get_rays, make_ray_tensor)
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.ops.posenc import posenc_orig

W, H = 504, 378
FOCAL = 407.5
# The JAX level kernel's outputs at the probe weights (seed 0): for each
# (level, rays, samples per ray, input seed), the inputs and the outputs.
LEVEL_REFERENCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'tests',
    'data', 'fused_level_jax_ref.npz')
LEVEL_REFERENCE_CASES = (('coarse', 8, 64, 1), ('fine', 4, 128, 2))
LEVEL_INPUTS = ('z_vals', 'origins', 'directions', 'embed', 'rgb_cond')
# The JAX kernels' gradients at the probe weights for fixed cotangents: the
# level's (level, rays, samples per ray, seed) and the compositing kernel's
# at the same size.
GRAD_REFERENCE = os.path.join(os.path.dirname(LEVEL_REFERENCE),
                              'fused_jax_grads.npz')
GRAD_REFERENCE_CASE = ('coarse', 8, 64, 3)


def flagship_config() -> NerfConfig:
    """What ``bench.py`` renders and trains by default (its other settings —
    100 embeddings, translation warp, bendy sheet, sigma noise of deviation
    1 — are NerfConfig's defaults)."""
    return NerfConfig(num_coarse_samples=64, num_fine_samples=64,
                      compute_dtype='bfloat16')


TRAIN_BATCH = 16384
TRAIN_RAYS = 1 << 18


def synthetic_train_rays(n_rays: int = TRAIN_RAYS):
    """The synthetic ray buffer ``bench.py`` trains on: numpy
    RandomState(0) origins near 0, unit directions, near 0, far 1, image
    ids in [0, 100) and uniform colours. Returns (rays (N, 9), rgbs (N, 3))
    float32."""
    rs = np.random.RandomState(0)
    origins = rs.randn(n_rays, 3).astype(np.float32) * 0.1
    dirs = rs.randn(n_rays, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays = np.concatenate([
        origins, dirs, np.zeros((n_rays, 1), np.float32),
        np.ones((n_rays, 1), np.float32),
        rs.randint(0, 100, (n_rays, 1)).astype(np.float32)], 1)
    rgbs = rs.rand(n_rays, 3).astype(np.float32)
    return rays, rgbs


def flagship_train_setup(device, seed: int = 0, batch_size: int = TRAIN_BATCH,
                         n_rays: int = TRAIN_RAYS):
    """The flagship train step's parts on ``device``: (state, step_fn,
    all_rays, all_rgbs) — a seeded model in train mode, Adam at 5e-4 with
    the ``steplr`` schedule at 1000 steps per epoch, the step built by
    ``make_train_step``, and the synthetic ray buffer."""
    from hypernerf_tpu_torch.training.optimizers import get_optimizer
    from hypernerf_tpu_torch.training.train_state import (TrainState,
                                                          make_train_step)
    cfg = flagship_config()
    train_cfg = TrainConfig(batch_size=batch_size, lr=5e-4)
    torch.manual_seed(seed)
    model = NerfModel(cfg).to(device).train()
    optimizer, schedule = get_optimizer(train_cfg, model.parameters(),
                                        steps_per_epoch=1000)
    step_fn = make_train_step(model, optimizer, cfg, train_cfg, device,
                              schedule=schedule)
    rays, rgbs = synthetic_train_rays(n_rays)
    state = TrainState(step=0, model=model, optimizer=optimizer, seed=seed)
    return (state, step_fn, torch.from_numpy(rays).to(device),
            torch.from_numpy(rgbs).to(device))


def flagship_model(device, seed: int = 0) -> NerfModel:
    """The flagship NerfModel with this package's init drawn from ``seed``,
    on ``device``, in eval mode."""
    torch.manual_seed(seed)
    return NerfModel(flagship_config()).to(device).eval()


def load_probe_weights(model: NerfModel, seed: int = 0) -> NerfModel:
    """Overwrite every parameter of ``model`` with numpy draws from
    ``seed``, which are the same on every machine and version (torch's
    generators promise no such thing), so that the kernels can be checked
    on the card against outputs computed elsewhere.

    Weights are Xavier-uniform, biases U(+-1/sqrt(fan_in)), the GLO table
    N(0, 0.1 / dim). The warp and hyper heads are drawn large, U(0, 0.01)
    and N(0, 0.05) where the init has U(0, 1e-4) and N(0, 1e-5), so that
    the 14 warp and hyper layers move the level's output.
    """
    rs = np.random.RandomState(seed)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    state = {}
    for name, shape in shapes.items():
        if name == 'warp_field.mlp.logit.weight':
            a = rs.uniform(0.0, 0.01, shape)
        elif name == 'hyper_sheet_mlp.mlp.logit.weight':
            a = rs.normal(0.0, 0.05, shape)
        elif name == 'warp_embed.embed.weight':
            a = rs.normal(0.0, 0.1 / shape[1], shape)
        elif name.endswith('.weight'):
            bound = np.sqrt(6.0 / (shape[0] + shape[1]))
            a = rs.uniform(-bound, bound, shape)
        else:
            bound = 1.0 / np.sqrt(shapes[name[:-len('bias')] + 'weight'][1])
            a = rs.uniform(-bound, bound, shape)
        state[name] = torch.from_numpy(a.astype(np.float32))
    model.load_state_dict(state)
    return model


def probe_inputs(n_rays: int, samples: int, seed: int, dir_freq: int = 6):
    """Numpy level inputs (``LEVEL_INPUTS``): sorted depths in (0, 1),
    origins near 0, unit directions, GLO codes and posenc(directions)."""
    rs = np.random.RandomState(seed)
    z = np.sort(rs.rand(n_rays, samples), axis=-1)
    origins = rs.randn(n_rays, 3) * 0.1
    dirs = rs.randn(n_rays, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    embed = rs.randn(n_rays, 8) * 0.1
    out = [a.astype(np.float32) for a in (z, origins, dirs, embed)]
    out.append(posenc_orig(torch.from_numpy(out[2]), dir_freq).numpy())
    return dict(zip(LEVEL_INPUTS, out))


def probe_cotangents(n_rays: int, samples: int, seed: int):
    """Numpy cotangents for the gradient reference: 'level' (R * S, 4),
    and the compositing kernel's 'outs' (R, 6) and 'weights' (R, S)."""
    rs = np.random.RandomState(seed + 1000)
    return {'level': rs.randn(n_rays * samples, 4).astype(np.float32),
            'outs': rs.randn(n_rays, 6).astype(np.float32),
            'weights': (rs.randn(n_rays, samples) * 0.1).astype(np.float32)}


def composite_probe_inputs(n_rays: int, samples: int, seed: int):
    """Numpy compositing inputs: 'packed' (R * S, 4) with raw sigma shifted
    down so that the weights spread, ascending 'z_vals', 'directions' and
    sigma 'noise' (R, S)."""
    rs = np.random.RandomState(seed + 2000)
    packed = rs.randn(n_rays * samples, 4).astype(np.float32)
    packed[:, 3] -= 3.0
    z = np.sort(rs.rand(n_rays, samples) * 3 + 0.5, axis=-1)
    return {'packed': packed, 'z_vals': z.astype(np.float32),
            'directions': rs.randn(n_rays, 3).astype(np.float32),
            'noise': rs.randn(n_rays, samples).astype(np.float32)}


def read_grad_reference(path: str = GRAD_REFERENCE):
    """{'level': {...}, 'composite': {...}} arrays of the gradients file."""
    out = {'level': {}, 'composite': {}}
    with np.load(path) as f:
        for key in f.files:
            group, name = key.split('/', 1)
            out[group][name] = f[key]
    return out


def read_level_reference(path: str = LEVEL_REFERENCE):
    """{level: (inputs dict, (R * S, 4) JAX outputs)} of each case."""
    with np.load(path) as f:
        return {name: ({k: f[f'{name}/{k}'] for k in LEVEL_INPUTS},
                       f[f'{name}/out'])
                for name, *_ in LEVEL_REFERENCE_CASES}


def spiral_rays(frames, width: int = W, height: int = H):
    """(height * width, 9) numpy rays of each frame index in ``frames`` on
    the 120-pose spiral test path of a forward-facing LLFF camera, in NDC."""
    poses = create_spiral_poses(np.array([0.3, 0.2, 0.1]), 3.5, 120)
    directions = get_ray_directions(height, width, FOCAL)
    out = []
    for i in frames:
        o, d = get_rays(directions, poses[i].astype(np.float32))
        o, d = get_ndc_rays(height, width, FOCAL, 1.0, o, d)
        out.append(make_ray_tensor(o, d, 0.0, 1.0, idx=i % 100))
    return out
