"""The flagship render setup: the configuration ``bench.py`` renders
(NerfConfig defaults with 64 + 64 samples, bf16 matmuls), a seeded model of
it, LLFF spiral-path NDC rays of a 504x378 frame, and the probe weights and
inputs at which the level kernel is held against the JAX kernel's stored
outputs (``LEVEL_REFERENCE``, written by ``tools/make_level_reference.py``).

Shared by ``chip_smoke.py``, ``tools/profile_render.py`` and
``tools/make_level_reference.py``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from hypernerf_tpu.configs import NerfConfig
from hypernerf_tpu.datasets.llff import create_spiral_poses
from hypernerf_tpu.datasets.rays import (get_ndc_rays, get_ray_directions,
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


def flagship_config() -> NerfConfig:
    return NerfConfig(num_coarse_samples=64, num_fine_samples=64,
                      compute_dtype='bfloat16')


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
