"""The flagship setups: the configuration ``bench.py`` renders and trains
(NerfConfig defaults with 64 + 64 samples, bf16 matmuls) and its ``static``,
``split_glo``, ``se3``, ``quaternion`` and ``elastic*`` variants
(``CONFIGS``), a seeded model of each, LLFF
spiral-path NDC rays of a 504x378 frame, the train step's model, optimizer
and synthetic ray buffer (``flagship_train_setup``), and the probe weights
and inputs at which the kernels are held against the JAX kernels' stored
outputs and gradients (``LEVEL_REFERENCE``, ``GRAD_REFERENCE``,
``MODULAR_REFERENCE``, ``SE3_REFERENCE``, ``JACOBIAN_REFERENCE``, written by
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


# The variants of the flagship by name: ``static`` is ``bench.py --mode
# static`` (a plain NeRF: no warp, no hyper coordinates), ``split_glo`` the
# flagship with ``--share_GLO`` off (the sheet reads its own GLO table). Both
# run the per-module path: a kernel per field and one for the template.
# ``se3`` and ``quaternion`` are ``bench.py --mode se3`` / ``--mode
# quaternion``: the flagship with that warp field, on the level kernels.
# ``elastic``, ``elastic_se3`` and ``elastic_quaternion`` are ``bench.py
# --mode elastic*``: those three with the Jacobian side channel at 16 samples
# per ray, trained with the elastic loss at weight 0.01 (``TRAIN_CONFIGS``).
CONFIGS = {'flagship': {},
           'static': dict(use_warp=False, hyper_slice_method='none'),
           'split_glo': dict(share_glo=False),
           'se3': dict(warp_field_type='se3'),
           'quaternion': dict(warp_field_type='quaternion'),
           'elastic': dict(elastic_jacobian_samples=16),
           'elastic_se3': dict(warp_field_type='se3',
                               elastic_jacobian_samples=16),
           'elastic_quaternion': dict(warp_field_type='quaternion',
                                      elastic_jacobian_samples=16)}
# TrainConfig overrides of a configuration (``bench.py``'s elastic weight).
TRAIN_CONFIGS = {c: dict(elastic_loss_weight=0.01)
                 for c in ('elastic', 'elastic_se3', 'elastic_quaternion')}


def flagship_config(config: str = 'flagship', **overrides) -> NerfConfig:
    """What ``bench.py`` renders and trains by default (its other settings —
    100 embeddings, translation warp, bendy sheet, sigma noise of deviation
    1 — are NerfConfig's defaults), or the variant ``config`` of it."""
    return NerfConfig(**{**dict(num_coarse_samples=64, num_fine_samples=64,
                                compute_dtype='bfloat16'),
                         **CONFIGS[config], **overrides})


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


def synthetic_background_points(n_points: int = 1 << 16):
    """(N, 3) float32 known-static points for the background loss:
    RandomState(1) normals of deviation 0.3 around the synthetic rays'
    origins."""
    rs = np.random.RandomState(1)
    return (rs.randn(n_points, 3) * 0.3).astype(np.float32)


def flagship_train_setup(device, seed: int = 0, batch_size: int = TRAIN_BATCH,
                         n_rays: int = TRAIN_RAYS, config: str = 'flagship',
                         train_overrides=None, **overrides):
    """The train step's parts of ``config`` (with ``overrides`` of its
    NerfConfig and ``train_overrides`` of its TrainConfig, after
    ``TRAIN_CONFIGS``) on ``device``: (state, step_fn, all_rays, all_rgbs) —
    a seeded model in train mode, Adam at 5e-4 with the ``steplr`` schedule
    at 1000 steps per epoch, the step built by ``make_train_step``, and the
    synthetic ray buffer. A positive ``background_loss_weight`` gives the
    step ``synthetic_background_points`` on the device."""
    from hypernerf_tpu_torch.training.optimizers import get_optimizer
    from hypernerf_tpu_torch.training.train_state import (TrainState,
                                                          make_train_step)
    cfg = flagship_config(config, **overrides)
    train_cfg = TrainConfig(**{**dict(batch_size=batch_size, lr=5e-4),
                               **TRAIN_CONFIGS.get(config, {}),
                               **(train_overrides or {})})
    torch.manual_seed(seed)
    model = NerfModel(cfg).to(device).train()
    optimizer, schedule = get_optimizer(train_cfg, model.parameters(),
                                        steps_per_epoch=1000)
    background = None
    if train_cfg.background_loss_weight > 0:
        background = torch.from_numpy(synthetic_background_points()).to(
            device)
    step_fn = make_train_step(model, optimizer, cfg, train_cfg, device,
                              schedule=schedule, background_points=background)
    rays, rgbs = synthetic_train_rays(n_rays)
    state = TrainState(step=0, model=model, optimizer=optimizer, seed=seed)
    return (state, step_fn, torch.from_numpy(rays).to(device),
            torch.from_numpy(rgbs).to(device))


def flagship_model(device, seed: int = 0, config: str = 'flagship',
                   **overrides) -> NerfModel:
    """The NerfModel of ``config`` (with ``overrides`` of its NerfConfig)
    with this package's init drawn from ``seed``, on ``device``, in eval
    mode."""
    torch.manual_seed(seed)
    return NerfModel(flagship_config(config, **overrides)).to(device).eval()


SE3_HEAD_BOUNDS = {'warp_field.w_net.logit.weight': 0.1,
                   'warp_field.w_net.logit.bias': 0.3,
                   'warp_field.v_net.logit.weight': 0.02,
                   'warp_field.v_net.logit.bias': 0.05}


def load_probe_weights(model: NerfModel, seed: int = 0) -> NerfModel:
    """Overwrite every parameter of ``model`` with numpy draws from
    ``seed``, which are the same on every machine and version (torch's
    generators promise no such thing), so that the kernels can be checked
    on the card against outputs computed elsewhere.

    Weights are Xavier-uniform, biases U(+-1/sqrt(fan_in)), a GLO table
    N(0, 0.1 / dim). The warp and hyper heads are drawn large, U(0, 0.01)
    and N(0, 0.05) where the init has U(0, 1e-4) and N(0, 1e-5), so that
    the 14 warp and hyper layers move the level's output. The SE(3) /
    quaternion heads are drawn U(+-0.1) (w) and U(+-0.02) (v) with biases
    U(+-0.3) and U(+-0.05), where the init has U(0, 1e-4) and zero: rotation
    vectors of 0.1 to 1 rad, so that the retraction and its gradient show
    above any tolerance.
    """
    rs = np.random.RandomState(seed)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    state = {}
    for name, shape in shapes.items():
        if name == 'warp_field.mlp.logit.weight':
            a = rs.uniform(0.0, 0.01, shape)
        elif name in SE3_HEAD_BOUNDS:
            bound = SE3_HEAD_BOUNDS[name]
            a = rs.uniform(-bound, bound, shape)
        elif name == 'hyper_sheet_mlp.mlp.logit.weight':
            a = rs.normal(0.0, 0.05, shape)
        elif name.endswith('_embed.embed.weight'):
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


# The JAX field and template kernels' outputs and gradients at the probe
# weights. case -> (kind, config, module, rows, rows per condition row or
# window alpha, input seed); a field's module is its attribute on the model,
# a template's the level.
MODULAR_REFERENCE = os.path.join(os.path.dirname(LEVEL_REFERENCE),
                                 'fused_modular_jax_ref.npz')
MODULAR_REFERENCE_CASES = {
    'warp': ('field', 'flagship', 'warp_field', 500, None, 11),
    'warp_window': ('field', 'flagship', 'warp_field', 500, 4.5, 12),
    'sheet': ('field', 'flagship', 'hyper_sheet_mlp', 500, None, 13),
    'sheet_window': ('field', 'flagship', 'hyper_sheet_mlp', 500, 3.25, 14),
    'template': ('template', 'flagship', 'coarse', 512, 64, 15),
    'template_static': ('template', 'static', 'coarse', 512, 64, 16),
    'template_s1': ('template', 'flagship', 'fine', 100, 1, 17),
}


def modular_probe_inputs(case: str) -> dict:
    """Numpy inputs and cotangent of a ``MODULAR_REFERENCE_CASES`` case. A
    field: 'x_raw' (P, 11) [points on probe rays | GLO codes] and 'cotangent'
    (P, 8), of which the field's outputs' columns count. A template: 'x_raw' (P, 8)
    [points | hyper coordinates of deviation 0.3 (zero when static) | 0],
    'rgb_cond' (P / S, 39) and 'cotangent' (P, 4)."""
    kind, config, _, rows, per, seed = MODULAR_REFERENCE_CASES[case]
    rs = np.random.RandomState(seed + 3000)
    samples = 64
    rays = probe_inputs(-(-rows // samples), samples, seed)
    pts = (rays['origins'][:, None]
           + rays['z_vals'][..., None] * rays['directions'][:, None])
    pts = pts.reshape(-1, 3)[:rows]
    if kind == 'field':
        embed = np.repeat(rays['embed'], samples, axis=0)[:rows]
        return {'x_raw': np.concatenate([pts, embed], 1).astype(np.float32),
                'cotangent': rs.randn(rows, 8).astype(np.float32)}
    hyper = rs.randn(rows, 4) * (0.0 if config == 'static' else 0.3)
    x_raw = np.concatenate([pts, hyper, np.zeros((rows, 1))], 1)
    dirs = rs.randn(rows // per, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return {'x_raw': x_raw.astype(np.float32),
            'rgb_cond': posenc_orig(torch.from_numpy(dirs), 6).numpy(),
            'cotangent': rs.randn(rows, 4).astype(np.float32)}


# The JAX SE(3) kernels' numbers at the probe weights. A trunk case:
# (rows, warp_alpha or None, input seed) on the 'se3' model's warp field. A
# level case: (config, level, rays, samples per ray, warp_alpha or None, seed).
SE3_REFERENCE = os.path.join(os.path.dirname(LEVEL_REFERENCE),
                             'fused_se3_jax_ref.npz')
SE3_TRUNK_CASES = {'trunk': (500, None, 21), 'trunk_window': (500, 3.5, 22)}
SE3_LEVEL_CASES = {'level_se3': ('se3', 'coarse', 8, 64, None, 23),
                   'level_se3_window': ('se3', 'fine', 4, 128, 3.5, 24),
                   'level_quaternion': ('quaternion', 'coarse', 8, 64, None,
                                        25)}


def se3_probe_inputs(case: str) -> dict:
    """Numpy inputs and cotangent of an ``SE3_TRUNK_CASES`` case ('x_raw'
    (P, 11) [points on probe rays | GLO codes], 'cotangent' (P, 8) whose
    first six columns count) or of an ``SE3_LEVEL_CASES`` case (the
    ``LEVEL_INPUTS`` and 'cotangent' (R * S, 4))."""
    if case in SE3_TRUNK_CASES:
        rows, _, seed = SE3_TRUNK_CASES[case]
        rays = probe_inputs(-(-rows // 64), 64, seed)
        pts = (rays['origins'][:, None]
               + rays['z_vals'][..., None] * rays['directions'][:, None])
        embed = np.repeat(rays['embed'], 64, axis=0)
        x_raw = np.concatenate([pts.reshape(-1, 3), embed], 1)[:rows]
        cot = np.random.RandomState(seed + 3000).randn(rows, 8)
        cot[:, 6:] = 0.0
        return {'x_raw': x_raw.astype(np.float32),
                'cotangent': cot.astype(np.float32)}
    _, _, n_rays, samples, _, seed = SE3_LEVEL_CASES[case]
    inputs = probe_inputs(n_rays, samples, seed)
    inputs['cotangent'] = probe_cotangents(n_rays, samples, seed)['level']
    return inputs


# The JAX warp-Jacobian kernels' numbers at the probe weights. A case: (the
# configuration whose warp field it takes, rows, warp_alpha or None, input
# seed); the translation warp's is the flagship's.
JACOBIAN_REFERENCE = os.path.join(os.path.dirname(LEVEL_REFERENCE),
                                  'fused_jacobian_jax_ref.npz')
JACOBIAN_CASES = {'translation': ('flagship', 300, None, 41),
                  'se3': ('se3', 300, None, 42),
                  'se3_window': ('se3', 300, 3.5, 43)}


def jacobian_probe_inputs(case: str) -> dict:
    """Numpy inputs of a ``JACOBIAN_CASES`` case: 'x_raw' (P, 11) [points on
    probe rays | GLO codes] and 'cotangent' of the kernel's output, (P, 9)
    for J (translation) or (P, 24) for [w | v | dw | dv] (SE(3))."""
    config, rows, _, seed = JACOBIAN_CASES[case]
    rays = probe_inputs(-(-rows // 64), 64, seed)
    pts = (rays['origins'][:, None]
           + rays['z_vals'][..., None] * rays['directions'][:, None])
    embed = np.repeat(rays['embed'], 64, axis=0)
    x_raw = np.concatenate([pts.reshape(-1, 3), embed], 1)[:rows]
    width = 9 if config == 'flagship' else 24
    cot = np.random.RandomState(seed + 3000).randn(rows, width)
    return {'x_raw': x_raw.astype(np.float32),
            'cotangent': cot.astype(np.float32)}


def read_jacobian_reference(path: str = JACOBIAN_REFERENCE):
    """{case: {name: array}} of the warp-Jacobian reference file."""
    out = {case: {} for case in JACOBIAN_CASES}
    with np.load(path) as f:
        for key in f.files:
            case, name = key.split('/', 1)
            out[case][name] = f[key]
    return out


def read_se3_reference(path: str = SE3_REFERENCE):
    """{case: {name: array}} of the SE(3) reference file."""
    out = {case: {} for case in (*SE3_TRUNK_CASES, *SE3_LEVEL_CASES)}
    with np.load(path) as f:
        for key in f.files:
            case, name = key.split('/', 1)
            out[case][name] = f[key]
    return out


def read_modular_reference(path: str = MODULAR_REFERENCE):
    """{case: {name: array}} of the field and template reference file."""
    out = {case: {} for case in MODULAR_REFERENCE_CASES}
    with np.load(path) as f:
        for key in f.files:
            case, name = key.split('/', 1)
            out[case][name] = f[key]
    return out


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
