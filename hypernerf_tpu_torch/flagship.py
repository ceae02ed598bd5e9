"""The flagship setups: the configuration ``bench.py`` renders and trains
(NerfConfig defaults with 64 + 64 samples, bf16 matmuls) and its ``static``,
``split_glo``, ``se3``, ``quaternion``, ``elastic*``, ``anneal``, ``plane``,
``occupancy``, ``nerf_embed`` and the warp x slicing x encoding variants
``anneal_se3`` ... ``plane_anneal_quaternion`` (``CONFIGS``), a seeded model of
each, the occupancy grid ``bench.py`` starts from (``bench_grid``), LLFF
spiral-path NDC rays of a 504x378 frame, the train step's model, optimizer and
synthetic ray buffer (``flagship_train_setup``), and the probe weights and
inputs at which the kernels are held against the JAX kernels' stored outputs
and gradients (``LEVEL_REFERENCE``, ``GRAD_REFERENCE``, ``MODULAR_REFERENCE``,
``SE3_REFERENCE``, ``JACOBIAN_REFERENCE``, ``ANNEAL_REFERENCE``,
``PLANE_REFERENCE``, ``CONDITION_REFERENCE``, ``B4_REFERENCE``,
``F32_REFERENCE``, ``F32_MODULAR_REFERENCE``, ``F32_SCREW_REFERENCE``,
``F32_NERFIES_REFERENCE``, ``F32_PLANE_REFERENCE``, written by
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
from hypernerf_tpu_torch.ops.posenc import posenc, posenc_orig

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
# ``anneal`` is ``bench.py --mode anneal``: the flagship with the Nerfies
# template encoding (``use_original_embed=False``: xyz over degrees 0..10,
# hyper over 0..4, viewdirs over 0..4), windowed by the annealing alphas of
# ``compute_extra_params``, on the level kernels. ``plane`` is ``bench.py
# --mode plane``: the flagship with ``axis_aligned_plane`` slicing (no sheet;
# the hyper coordinates are the ray's 8 GLO coordinates, a 167-column
# template encoding), on the level kernels. ``occupancy`` is ``bench.py
# --mode occupancy`` / ``render_occupancy``: the flagship at 32 + 32 samples
# with the occupancy grid (G = 64, 64 probes a ray, floor 0.01, box +-2: the
# config's defaults), on the level kernels. ``nerf_embed`` is the flagship
# with the reference's per-frame appearance code on the template
# (``--use_nerf_embedding --use_alpha_condition --use_rgb_condition``): the
# shared GLO embedding as the alpha condition (8 columns) and after the view
# directions' encoding in the rgb condition (47), on the level kernels.
# The seven warp x slicing x encoding combinations (ROADMAP B.4; bench.py
# has no such modes) run on the level kernels too: ``anneal_se3`` is the
# HyperNeRF paper's deformable-sheet model (the SE(3) field with the Nerfies
# encoding), ``plane_anneal_se3`` its axis-aligned-plane model, and
# ``anneal_quaternion``, ``plane_se3``, ``plane_quaternion``, ``plane_anneal``
# and ``plane_anneal_quaternion`` the other combinations of the warp type,
# the slicing and the template encoding.
CONFIGS = {'flagship': {},
           'static': dict(use_warp=False, hyper_slice_method='none'),
           'split_glo': dict(share_glo=False),
           'se3': dict(warp_field_type='se3'),
           'quaternion': dict(warp_field_type='quaternion'),
           'elastic': dict(elastic_jacobian_samples=16),
           'elastic_se3': dict(warp_field_type='se3',
                               elastic_jacobian_samples=16),
           'elastic_quaternion': dict(warp_field_type='quaternion',
                                      elastic_jacobian_samples=16),
           'anneal': dict(use_original_embed=False),
           'plane': dict(hyper_slice_method='axis_aligned_plane'),
           'occupancy': dict(use_occupancy_grid=True, num_coarse_samples=32,
                             num_fine_samples=32),
           'nerf_embed': dict(use_nerf_embed=True, use_alpha_condition=True,
                              use_rgb_condition=True)}
_PLANE = dict(hyper_slice_method='axis_aligned_plane')
_NERFIES = dict(use_original_embed=False)
CONFIGS.update(
    anneal_se3=dict(warp_field_type='se3', **_NERFIES),
    anneal_quaternion=dict(warp_field_type='quaternion', **_NERFIES),
    plane_se3=dict(warp_field_type='se3', **_PLANE),
    plane_quaternion=dict(warp_field_type='quaternion', **_PLANE),
    plane_anneal=dict(**_PLANE, **_NERFIES),
    plane_anneal_se3=dict(warp_field_type='se3', **_PLANE, **_NERFIES),
    plane_anneal_quaternion=dict(warp_field_type='quaternion', **_PLANE,
                                 **_NERFIES))
B4_CONFIGS = ('anneal_se3', 'anneal_quaternion', 'plane_se3',
              'plane_quaternion', 'plane_anneal', 'plane_anneal_se3',
              'plane_anneal_quaternion')
# TrainConfig overrides of a configuration (``bench.py``'s elastic weight).
TRAIN_CONFIGS = {c: dict(elastic_loss_weight=0.01)
                 for c in ('elastic', 'elastic_se3', 'elastic_quaternion')}
# The step a configuration's train setup starts at: ``anneal`` (and every
# configuration with the Nerfies encoding) mid-ramp, where ``hyper_alpha`` is
# 1.5 of its 4 bands (at step 0 it is 0, every hyper feature is zero and the
# sheet gets no gradient) and ``warp_alpha`` 0.375 of the SE(3) trunk's 8.
ANNEAL_PROBE_STEP = 3750
START_STEPS = {c: ANNEAL_PROBE_STEP for c, over in CONFIGS.items()
               if over.get('use_original_embed') is False}


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


def bench_grid(cfg: NerfConfig, device, seed: int = 0) -> torch.Tensor:
    """The (G, G, G) grid ``bench.py`` renders through and first refreshes
    (``bench.py:91-92``): uniform in [0, 1), here from a ``torch.Generator``
    seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((cfg.occupancy_resolution,) * 3, generator=gen,
                      device=device)


def flagship_train_config(config: str = 'flagship',
                          batch_size: int = TRAIN_BATCH,
                          train_overrides=None) -> TrainConfig:
    """The TrainConfig of ``config``'s train step: batch ``batch_size``,
    Adam at 5e-4, ``TRAIN_CONFIGS``, then ``train_overrides``."""
    return TrainConfig(**{**dict(batch_size=batch_size, lr=5e-4),
                          **TRAIN_CONFIGS.get(config, {}),
                          **(train_overrides or {})})


def flagship_train_setup(device, seed: int = 0, batch_size: int = TRAIN_BATCH,
                         n_rays: int = TRAIN_RAYS, config: str = 'flagship',
                         train_overrides=None, mesh=None, start_step=None,
                         **overrides):
    """The train step's parts of ``config`` (with ``overrides`` of its
    NerfConfig and ``train_overrides`` of its TrainConfig, after
    ``TRAIN_CONFIGS``) on ``device``: (state, step_fn, all_rays, all_rgbs) —
    a seeded model in train mode, Adam at 5e-4 with the ``steplr`` schedule
    at 1000 steps per epoch, the step built by ``make_train_step``, the
    state at step ``start_step`` (default ``START_STEPS``: 0 but for the
    Nerfies configurations) with, where the
    configuration uses one, ``bench_grid`` as its occupancy grid, and the
    synthetic ray buffer. A positive ``background_loss_weight`` gives the
    step ``synthetic_background_points`` on the device. ``mesh``: a
    ``parallel.DataParallel`` context, whose ranks the step (and, with
    ``shard_optimizer_state``, the optimizer) spans; every rank draws the
    same weights from ``seed``."""
    from hypernerf_tpu_torch.training.optimizers import get_optimizer
    from hypernerf_tpu_torch.training.train_state import (TrainState,
                                                          make_train_step)
    cfg = flagship_config(config, **overrides)
    train_cfg = flagship_train_config(config, batch_size, train_overrides)
    torch.manual_seed(seed)
    model = NerfModel(cfg).to(device).train()
    optimizer, schedule = get_optimizer(train_cfg, model.parameters(),
                                        steps_per_epoch=1000, mesh=mesh)
    background = None
    if train_cfg.background_loss_weight > 0:
        background = torch.from_numpy(synthetic_background_points()).to(
            device)
    step_fn = make_train_step(model, optimizer, cfg, train_cfg, device,
                              schedule=schedule, background_points=background,
                              mesh=mesh)
    rays, rgbs = synthetic_train_rays(n_rays)
    grid = bench_grid(cfg, device, seed) if cfg.use_occupancy_grid else None
    if start_step is None:
        start_step = START_STEPS.get(config, 0)
    state = TrainState(step=start_step, model=model,
                       optimizer=optimizer, seed=seed, occupancy=grid)
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


def modular_probe_inputs(case: str, cases=None) -> dict:
    """Numpy inputs and cotangent of a ``MODULAR_REFERENCE_CASES`` case (or
    of ``cases``, a table of the same form). A
    field: 'x_raw' (P, 11) [points on probe rays | GLO codes] and 'cotangent'
    (P, 8), of which the field's outputs' columns count. A template: 'x_raw' (P, 8)
    [points | hyper coordinates of deviation 0.3 (zero when static) | 0],
    'rgb_cond' (P / S, 39) and 'cotangent' (P, 4)."""
    kind, config, _, rows, per, seed = (cases or
                                        MODULAR_REFERENCE_CASES)[case]
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


def jacobian_probe_inputs(case: str, cases=None) -> dict:
    """Numpy inputs of a ``JACOBIAN_CASES`` case (or of ``cases``, a dict of
    that form): 'x_raw' (P, 11) [points on probe rays | GLO codes] and
    'cotangent' of the kernel's output, (P, 9) for J (translation) or (P,
    24) for [w | v | dw | dv] (SE(3))."""
    config, rows, _, seed = (cases or JACOBIAN_CASES)[case]
    rays = probe_inputs(-(-rows // 64), 64, seed)
    pts = (rays['origins'][:, None]
           + rays['z_vals'][..., None] * rays['directions'][:, None])
    embed = np.repeat(rays['embed'], 64, axis=0)
    x_raw = np.concatenate([pts.reshape(-1, 3), embed], 1)[:rows]
    width = 9 if config == 'flagship' else 24
    cot = np.random.RandomState(seed + 3000).randn(rows, width)
    return {'x_raw': x_raw.astype(np.float32),
            'cotangent': cot.astype(np.float32)}


# The JAX kernels' numbers for the ``anneal`` configuration at the probe
# weights and the alphas of ``ANNEAL_PROBE_STEP`` (``anneal_extra_params``):
# the level kernel (level, rays, samples per ray, seed) and the template alone
# (level, rows, rows per condition row, seed), outputs and, for the stored
# cotangent, the gradients. The level has two draws of its inputs (seeds 51
# and 52): bf16 gradients of two implementations lie a few per cent apart,
# by draw and by output, and two draws show the spread.
ANNEAL_REFERENCE = os.path.join(os.path.dirname(LEVEL_REFERENCE),
                                'fused_anneal_jax_ref.npz')
ANNEAL_LEVEL_CASES = {'level': ('coarse', 8, 64, 51),
                      'level_seed52': ('coarse', 8, 64, 52)}
ANNEAL_TEMPLATE_CASES = {'template': ('coarse', 512, 64, 52)}


def anneal_extra_params() -> dict:
    """The annealing alphas of the ``anneal`` configuration at
    ``ANNEAL_PROBE_STEP`` (TrainConfig's default ramps): hyper_alpha 1.5."""
    from hypernerf_tpu_torch.training.train_state import compute_extra_params
    return compute_extra_params(flagship_config('anneal'), TrainConfig(),
                                ANNEAL_PROBE_STEP)


def anneal_condition(dirs: np.ndarray, nerf_alpha) -> np.ndarray:
    """The Nerfies condition of (N, 3) directions: posenc(dirs, 0, 4,
    identity) windowed by ``nerf_alpha``, (N, 27) float32."""
    return posenc(torch.from_numpy(dirs), 0, 4, use_identity=True,
                  alpha=nerf_alpha).numpy()


def anneal_probe_inputs(case: str) -> dict:
    """Numpy inputs and cotangent of an ``ANNEAL_LEVEL_CASES`` case (the
    ``LEVEL_INPUTS`` with the Nerfies condition and 'cotangent' (R * S, 4))
    or of an ``ANNEAL_TEMPLATE_CASES`` case ('x_raw' (P, 8) [points | hyper
    coordinates of deviation 0.3 | 0], 'rgb_cond' (P / S, 27),
    'cotangent' (P, 4))."""
    nerf_alpha = anneal_extra_params()['nerf_alpha']
    if case in ANNEAL_LEVEL_CASES:
        _, n_rays, samples, seed = ANNEAL_LEVEL_CASES[case]
        inputs = probe_inputs(n_rays, samples, seed)
        inputs['rgb_cond'] = anneal_condition(inputs['directions'],
                                              nerf_alpha)
        inputs['cotangent'] = probe_cotangents(n_rays, samples,
                                               seed)['level']
        return inputs
    _, rows, per, seed = ANNEAL_TEMPLATE_CASES[case]
    rs = np.random.RandomState(seed + 3000)
    rays = probe_inputs(-(-rows // 64), 64, seed)
    pts = (rays['origins'][:, None]
           + rays['z_vals'][..., None] * rays['directions'][:, None])
    pts = pts.reshape(-1, 3)[:rows]
    x_raw = np.concatenate([pts, rs.randn(rows, 4) * 0.3,
                            np.zeros((rows, 1))], 1)
    dirs = rs.randn(rows // per, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return {'x_raw': x_raw.astype(np.float32),
            'rgb_cond': anneal_condition(dirs, nerf_alpha),
            'cotangent': rs.randn(rows, 4).astype(np.float32)}


# The JAX kernels' numbers for the ``plane`` configuration at the probe
# weights: the level kernel (level, rays, samples per ray, seed; two draws of
# the inputs, as the anneal file has) and the template alone (level, rows,
# rows per condition row, seed), outputs and, for the stored cotangent, the
# gradients, in bf16 as the configuration runs; and the level kernel in
# float32 (``PLANE_F32_CASES``, on the first level case's inputs: the plain
# versions in float32 are held to it at 1e-4, which a bf16 check at 5e-2
# cannot resolve).
PLANE_REFERENCE = os.path.join(os.path.dirname(LEVEL_REFERENCE),
                               'fused_plane_jax_ref.npz')
PLANE_LEVEL_CASES = {'level': ('coarse', 8, 64, 61),
                     'level_seed62': ('coarse', 8, 64, 62)}
PLANE_TEMPLATE_CASES = {'template': ('coarse', 512, 64, 62)}
PLANE_F32_CASES = {'level_f32': 'level'}


def plane_probe_inputs(case: str) -> dict:
    """Numpy inputs and cotangent of a ``PLANE_LEVEL_CASES`` case (the
    ``LEVEL_INPUTS`` and 'cotangent' (R * S, 4)) or of a
    ``PLANE_TEMPLATE_CASES`` case ('x_raw' (P, 16) [points | 8 hyper
    coordinates of deviation 0.3 | 0], 'rgb_cond' (P / S, 39),
    'cotangent' (P, 4)); a ``PLANE_F32_CASES`` case takes its bf16 case's."""
    case = PLANE_F32_CASES.get(case, case)
    if case in PLANE_LEVEL_CASES:
        _, n_rays, samples, seed = PLANE_LEVEL_CASES[case]
        inputs = probe_inputs(n_rays, samples, seed)
        inputs['cotangent'] = probe_cotangents(n_rays, samples,
                                               seed)['level']
        return inputs
    _, rows, per, seed = PLANE_TEMPLATE_CASES[case]
    rs = np.random.RandomState(seed + 3000)
    rays = probe_inputs(-(-rows // 64), 64, seed)
    pts = (rays['origins'][:, None]
           + rays['z_vals'][..., None] * rays['directions'][:, None])
    pts = pts.reshape(-1, 3)[:rows]
    x_raw = np.concatenate([pts, rs.randn(rows, 8) * 0.3,
                            np.zeros((rows, 5))], 1)
    dirs = rs.randn(rows // per, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return {'x_raw': x_raw.astype(np.float32),
            'rgb_cond': posenc_orig(torch.from_numpy(dirs), 6).numpy(),
            'cotangent': rs.randn(rows, 4).astype(np.float32)}


# The JAX kernels' numbers for the ``nerf_embed`` configuration at the probe
# weights: the level kernel with both conditions (level, rays, samples per
# ray, seed; ``alpha_cond_ch`` 8, a 47-column rgb condition) and the
# template alone (level, rows, rows per condition row, seed), outputs and,
# for the stored cotangent, the gradients of every input and, to keep the
# file small, of the layers the conditions reach (CONDITION_GRAD_LAYERS: the
# alpha head and rgb layer 0, by their index in the level's and in the
# template's table) and every bias.
CONDITION_REFERENCE = os.path.join(os.path.dirname(LEVEL_REFERENCE),
                                   'fused_conditions_jax_ref.npz')
CONDITION_LEVEL_CASES = {'level': ('coarse', 4, 64, 71)}
CONDITION_TEMPLATE_CASES = {'template': ('fine', 256, 64, 72)}
CONDITION_GRAD_LAYERS = {'level': (24, 25), 'template': (10, 11)}


def condition_probe_inputs(case: str) -> dict:
    """Numpy inputs and cotangent of a ``CONDITION_LEVEL_CASES`` case (the
    ``LEVEL_INPUTS``, whose 'rgb_cond' is [posenc_orig(directions, 6) |
    embed] (47), 'alpha_cond' = embed (8), and 'cotangent' (R * S, 4)) or of
    a ``CONDITION_TEMPLATE_CASES`` case ('x_raw' (P, 8) [points | hyper
    coordinates of deviation 0.3 | 0], 'rgb_cond' (P / S, 47), 'alpha_cond'
    (P / S, 8), 'cotangent' (P, 4)): the ``use_nerf_embed`` conditions of
    the rays' GLO codes."""
    if case in CONDITION_LEVEL_CASES:
        _, n_rays, samples, seed = CONDITION_LEVEL_CASES[case]
        inputs = probe_inputs(n_rays, samples, seed)
        inputs['rgb_cond'] = np.concatenate(
            [inputs['rgb_cond'], inputs['embed']], 1)
        inputs['alpha_cond'] = inputs['embed'].copy()
        inputs['cotangent'] = probe_cotangents(n_rays, samples,
                                               seed)['level']
        return inputs
    _, rows, per, seed = CONDITION_TEMPLATE_CASES[case]
    rs = np.random.RandomState(seed + 3000)
    rays = probe_inputs(rows // per, per, seed)
    pts = (rays['origins'][:, None]
           + rays['z_vals'][..., None] * rays['directions'][:, None])
    x_raw = np.concatenate([pts.reshape(-1, 3), rs.randn(rows, 4) * 0.3,
                            np.zeros((rows, 1))], 1)
    return {'x_raw': x_raw.astype(np.float32),
            'rgb_cond': np.concatenate([rays['rgb_cond'], rays['embed']], 1),
            'alpha_cond': rays['embed'],
            'cotangent': rs.randn(rows, 4).astype(np.float32)}


# The JAX kernels' numbers for the warp x slicing x encoding combinations
# (B4_CONFIGS) at the probe weights: the level kernel of four of them
# (configuration, level, rays, samples per ray, seed) at the alphas of
# ``b4_extra_params`` (the windows partly on, so that they matter), and the
# template alone in the Nerfies plane layout (configuration, level, rows,
# rows per condition row, seed), outputs and, for the stored cotangent, the
# gradients of every input, every bias and, to keep the file small, the
# weights of the layers the new variants change most (``b4_grad_layers``:
# the warp's first layer and its heads, the template's first layer and its
# skip layer, which read the encoding).
B4_REFERENCE = os.path.join(os.path.dirname(LEVEL_REFERENCE),
                            'fused_b4_jax_ref.npz')
B4_LEVEL_CASES = {'anneal_se3': ('anneal_se3', 'coarse', 4, 64, 81),
                  'plane_se3': ('plane_se3', 'coarse', 4, 64, 82),
                  'plane_anneal_se3': ('plane_anneal_se3', 'coarse', 4, 64,
                                       83),
                  'plane_quaternion': ('plane_quaternion', 'fine', 4, 64,
                                       84)}
B4_TEMPLATE_CASES = {'template_nerfies_plane': ('plane_anneal', 'coarse', 256,
                                                64, 85)}
# plane_se3's encoding is posenc_orig, which has no annealing: its trunk's
# window is probed at this warp_alpha (of 8 bands).
B4_PLANE_SE3_WARP_ALPHA = 3.5


def b4_extra_params(config: str) -> dict:
    """The alphas a B.4 configuration's probes take: those of
    ``ANNEAL_PROBE_STEP`` with the Nerfies encoding (warp_alpha 0.375,
    hyper_alpha 1.5), ``B4_PLANE_SE3_WARP_ALPHA`` for ``plane_se3``, none
    for ``plane_quaternion``."""
    from hypernerf_tpu_torch.training.train_state import compute_extra_params
    if config == 'plane_se3':
        return {'warp_alpha': B4_PLANE_SE3_WARP_ALPHA}
    return compute_extra_params(flagship_config(config), TrainConfig(),
                                ANNEAL_PROBE_STEP)


def b4_grad_layers(case: str):
    """The layers whose dW a B.4 case's file keeps, by their index in the
    level's (or the template's) table."""
    if case in B4_TEMPLATE_CASES:
        return (0, 5)
    over = CONFIGS[B4_LEVEL_CASES[case][0]]
    screw = 'warp_field_type' in over
    t0 = (9 if screw else 7) + (0 if 'hyper_slice_method' in over else 7)
    return (0, *((7, 8) if screw else (6,)), t0, t0 + 5)


def b4_probe_inputs(case: str) -> dict:
    """Numpy inputs and cotangent of a ``B4_LEVEL_CASES`` case (the
    ``LEVEL_INPUTS``, with the Nerfies condition where the configuration
    has that encoding, and 'cotangent' (R * S, 4)) or of a
    ``B4_TEMPLATE_CASES`` case ('x_raw' (P, 16) [points | 8 hyper
    coordinates of deviation 0.3 | 0], 'rgb_cond' (P / S, 27),
    'cotangent' (P, 4))."""
    if case in B4_LEVEL_CASES:
        config, _, n_rays, samples, seed = B4_LEVEL_CASES[case]
        inputs = probe_inputs(n_rays, samples, seed)
        if CONFIGS[config].get('use_original_embed') is False:
            inputs['rgb_cond'] = anneal_condition(
                inputs['directions'], b4_extra_params(config)['nerf_alpha'])
        inputs['cotangent'] = probe_cotangents(n_rays, samples,
                                               seed)['level']
        return inputs
    config, _, rows, per, seed = B4_TEMPLATE_CASES[case]
    rs = np.random.RandomState(seed + 3000)
    rays = probe_inputs(rows // per, per, seed)
    pts = (rays['origins'][:, None]
           + rays['z_vals'][..., None] * rays['directions'][:, None])
    x_raw = np.concatenate([pts.reshape(-1, 3), rs.randn(rows, 8) * 0.3,
                            np.zeros((rows, 5))], 1)
    return {'x_raw': x_raw.astype(np.float32),
            'rgb_cond': anneal_condition(
                rays['directions'], b4_extra_params(config)['nerf_alpha']),
            'cotangent': rs.randn(rows, 4).astype(np.float32)}


# The JAX level kernel's numbers at ``compute_dtype='float32'`` (the train
# CLI's ``--precision 32``) on the flagship at the probe weights: the level
# forward and its VJP for a stored cotangent (level, rays, samples per ray,
# seed), in interpret mode. To keep the file small, dW of F32_GRAD_LAYERS
# alone (the first and skip layers of each field and of the template, the
# heads, the bottleneck and rgb layer 0; by index in the level's table) and
# every db.
F32_REFERENCE = os.path.join(os.path.dirname(LEVEL_REFERENCE),
                             'fused_f32_jax_ref.npz')
F32_LEVEL_CASES = {'level': ('fine', 64, 128, 81)}
F32_GRAD_LAYERS = (0, 5, 6, 7, 12, 13, 14, 23, 24, 25, 29)


def f32_probe_inputs(case: str) -> dict:
    """Numpy ``LEVEL_INPUTS`` and 'cotangent' (R * S, 4) of a
    ``F32_LEVEL_CASES`` case."""
    _, n_rays, samples, seed = F32_LEVEL_CASES[case]
    inputs = probe_inputs(n_rays, samples, seed)
    inputs['cotangent'] = probe_cotangents(n_rays, samples, seed)['level']
    return inputs


# The JAX field and template kernels' numbers at ``compute_dtype='float32'``
# (the per-module path of ``--precision 32``) at the probe weights, in
# interpret mode: ``MODULAR_REFERENCE_CASES``' form (a window alpha is
# None: float32 takes no window row). To keep the file small, a template
# keeps dW of F32_MODULAR_TEMPLATE_DW alone (its first and skip layers,
# the alpha head, rgb layer 0 and the rgb head), a field every dW; every db.
F32_MODULAR_REFERENCE = os.path.join(os.path.dirname(LEVEL_REFERENCE),
                                     'fused_f32_modular_jax_ref.npz')
F32_MODULAR_CASES = {
    'warp': ('field', 'flagship', 'warp_field', 300, None, 91),
    'sheet': ('field', 'flagship', 'hyper_sheet_mlp', 300, None, 92),
    'template': ('template', 'flagship', 'coarse', 256, 64, 93),
    'template_static': ('template', 'static', 'coarse', 256, 64, 94),
    'template_s1': ('template', 'flagship', 'fine', 100, 1, 95),
}
F32_MODULAR_TEMPLATE_DW = (0, 5, 10, 11, 15)


def read_f32_modular_reference(path: str = F32_MODULAR_REFERENCE):
    """{case: {name: array}} of the float32 per-module reference file."""
    out = {case: {} for case in F32_MODULAR_CASES}
    with np.load(path) as f:
        for key in f.files:
            case, name = key.split('/', 1)
            out[case][name] = f[key]
    return out


# The JAX level and SE(3) trunk kernels' numbers at
# ``compute_dtype='float32'`` with the screw warps (``--precision 32
# --warp_field se3`` or ``quaternion``) at the probe weights, in interpret
# mode. A level case: (configuration, level, rays, samples per ray,
# warp_alpha or None, input seed, heads); a trunk case (the 'se3'
# model's warp field): (rows, warp_alpha or None, input seed, heads).
# heads 'probe' keeps ``load_probe_weights``' heads (rotation vectors of
# 0.1 to 1 rad); 'init' redraws them at the init's scale
# (``near_init_heads``: |w| near 1e-3, where the retraction's b2 = (t -
# sin t) / t cancels in float32). To keep the file small, a level keeps dW
# of F32_SCREW_GRAD_LAYERS alone (the trunk's first, skip and logit
# layers and both heads, the sheet's first and skip layers and head, the
# template's first layer, alpha head, rgb layer 0 and rgb head; by index
# in the screw level's table), a trunk dW of F32_SCREW_TRUNK_DW; every db.
F32_SCREW_REFERENCE = os.path.join(os.path.dirname(LEVEL_REFERENCE),
                                   'fused_f32_screw_jax_ref.npz')
F32_SCREW_LEVEL_CASES = {
    'level_se3_window': ('se3', 'fine', 4, 128, 3.5, 111, 'probe'),
    'level_quaternion': ('quaternion', 'coarse', 8, 64, None, 112, 'probe'),
    'level_se3_init': ('se3', 'coarse', 8, 64, None, 113, 'init'),
}
F32_SCREW_TRUNK_CASES = {'trunk': (500, None, 114, 'probe'),
                         'trunk_window': (500, 3.5, 115, 'probe')}
F32_SCREW_GRAD_LAYERS = (0, 5, 6, 7, 8, 9, 14, 15, 16, 25, 26, 31)
F32_SCREW_TRUNK_DW = (0, 5, 6, 7, 8)


def near_init_heads(model: NerfModel, seed: int = 0) -> NerfModel:
    """Redraw the SE(3) / quaternion warp's w and v heads at the init's
    scale from numpy: weights U(0, 1e-4), biases zero (``SE3Field``'s
    init), so that the rotation vectors are small as at the start of
    training."""
    rs = np.random.RandomState(seed + 7000)
    state = model.state_dict()
    for head in ('w_net', 'v_net'):
        name = f'warp_field.{head}.logit'
        shape = tuple(state[name + '.weight'].shape)
        state[name + '.weight'] = torch.from_numpy(
            rs.uniform(0.0, 1e-4, shape).astype(np.float32))
        state[name + '.bias'] = torch.zeros_like(state[name + '.bias'])
    model.load_state_dict(state)
    return model


def f32_screw_model(config: str, heads: str, device='cpu') -> NerfModel:
    """The float32 ``config`` model at the probe weights, its warp heads as
    ``heads`` says ('probe' or 'init')."""
    model = load_probe_weights(flagship_model(device, config=config,
                                              compute_dtype='float32'))
    return near_init_heads(model) if heads == 'init' else model


def f32_screw_probe_inputs(case: str) -> dict:
    """Numpy inputs and cotangent of an ``F32_SCREW_LEVEL_CASES`` case (the
    ``LEVEL_INPUTS`` and 'cotangent' (R * S, 4)) or of an
    ``F32_SCREW_TRUNK_CASES`` case ('x_raw' (P, 11) [points on probe rays |
    GLO codes], 'cotangent' (P, 8) whose first six columns count)."""
    if case in F32_SCREW_TRUNK_CASES:
        rows, _, seed, _ = F32_SCREW_TRUNK_CASES[case]
        rays = probe_inputs(-(-rows // 64), 64, seed)
        pts = (rays['origins'][:, None]
               + rays['z_vals'][..., None] * rays['directions'][:, None])
        embed = np.repeat(rays['embed'], 64, axis=0)
        x_raw = np.concatenate([pts.reshape(-1, 3), embed], 1)[:rows]
        cot = np.random.RandomState(seed + 3000).randn(rows, 8)
        cot[:, 6:] = 0.0
        return {'x_raw': x_raw.astype(np.float32),
                'cotangent': cot.astype(np.float32)}
    _, _, n_rays, samples, _, seed, _ = F32_SCREW_LEVEL_CASES[case]
    inputs = probe_inputs(n_rays, samples, seed)
    inputs['cotangent'] = probe_cotangents(n_rays, samples, seed)['level']
    return inputs


def read_f32_screw_reference(path: str = F32_SCREW_REFERENCE):
    """{case: {name: array}} of the float32 screw-warp reference file."""
    out = {case: {} for case in (*F32_SCREW_LEVEL_CASES,
                                 *F32_SCREW_TRUNK_CASES)}
    with np.load(path) as f:
        for key in f.files:
            case, name = key.split('/', 1)
            out[case][name] = f[key]
    return out


# The JAX kernels' numbers at ``compute_dtype='float32'`` on the sheet
# tables' Nerfies layout, window rows and conditions (``--precision 32``
# with ``anneal``, ``anneal_se3``, ``nerf_embed`` and its 8-column
# condition without view directions; the JAX kernels refuse a 0-column
# condition, a zero-width block, which the JAX model renders on its dense
# modules) at the probe weights, in interpret mode, at the
# alphas of ANNEAL_PROBE_STEP (``f32_nerfies_extra``: the window rows
# mid-ramp). A level case: (configuration, NerfConfig overrides, level,
# rays, samples per ray, seed); a template case (the template alone, kernel
# A its backward): (configuration, overrides, level, rows, rows per
# condition row, seed); a field case (a field alone with a window row):
# ``F32_MODULAR_CASES``' form, its window alpha the fifth entry. To keep
# the file small, dW of ``f32_nerfies_grad_layers`` alone; every db.
F32_NERFIES_REFERENCE = os.path.join(os.path.dirname(LEVEL_REFERENCE),
                                     'fused_f32_nerfies_jax_ref.npz')
_EMBED = dict(use_nerf_embed=True, use_alpha_condition=True,
              use_rgb_condition=True)
F32_NERFIES_LEVEL_CASES = {
    'level_anneal': ('anneal', {}, 'fine', 4, 128, 121),
    'level_anneal_se3': ('anneal_se3', {}, 'coarse', 4, 64, 122),
    'level_nerf_embed': ('nerf_embed', {}, 'fine', 4, 64, 123),
    'level_embed_only': ('nerf_embed', dict(use_viewdirs=False), 'coarse', 4,
                         64, 124),
}
F32_NERFIES_TEMPLATE_CASES = {
    'template_anneal': ('anneal', {}, 'coarse', 256, 64, 126),
    'template_anneal_embed': ('anneal', _EMBED, 'fine', 256, 64, 127),
    'template_nerf_embed': ('nerf_embed', {}, 'fine', 256, 64, 128),
}
F32_NERFIES_FIELD_CASES = {
    'warp_window': ('field', 'flagship', 'warp_field', 300, 4.5, 129),
    'sheet_window': ('field', 'flagship', 'hyper_sheet_mlp', 300, 3.5, 130),
}


def f32_nerfies_model(case: str, device='cpu') -> NerfModel:
    """The float32 model of an F32_NERFIES case at the probe weights."""
    if case in F32_NERFIES_FIELD_CASES:
        config, over = F32_NERFIES_FIELD_CASES[case][1], {}
    else:
        config, over = (F32_NERFIES_LEVEL_CASES.get(case)
                        or F32_NERFIES_TEMPLATE_CASES[case])[:2]
    return load_probe_weights(flagship_model(
        device, config=config, compute_dtype='float32', **over))


def f32_nerfies_extra(case: str) -> dict:
    """The alphas of an F32_NERFIES level or template case: those of
    ANNEAL_PROBE_STEP (nerf_alpha 10, hyper_alpha 1.5 of the Nerfies
    template's 4 bands, warp_alpha 0.375 of the trunk's 8; a configuration
    without the Nerfies encoding has none)."""
    from hypernerf_tpu_torch.training.train_state import compute_extra_params
    config, over = (F32_NERFIES_LEVEL_CASES.get(case)
                    or F32_NERFIES_TEMPLATE_CASES[case])[:2]
    return compute_extra_params(flagship_config(config, **over),
                                TrainConfig(), ANNEAL_PROBE_STEP)


def f32_nerfies_grad_layers(case: str):
    """The layers whose dW an F32_NERFIES case's file keeps, by index in
    the level's (or the template's) table: the template's first layer, its
    alpha head and rgb layer 0 (and a level's sheet head), which the
    layout, the window row and the conditions reach; every layer of a
    field."""
    if case in F32_NERFIES_FIELD_CASES:
        return tuple(range(7))
    if case in F32_NERFIES_TEMPLATE_CASES:
        return (0, 10, 11)
    screw = 'warp_field_type' in CONFIGS[F32_NERFIES_LEVEL_CASES[case][0]]
    t0 = 16 if screw else 14
    return (t0 - 1, t0, t0 + 10, t0 + 11)


def f32_nerfies_conditions(model: NerfModel, dirs, embed, nerf_alpha):
    """The (alpha, rgb) conditions ``model.get_condition_inputs`` gives
    rays of (N, 3) ``dirs`` and (N, 8) nerf embedding ``embed``, as numpy:
    alpha None or (N, 8), rgb (N, C), C of 0 included."""
    cfg = model.config
    alpha, rgb = None, []
    if cfg.use_viewdirs:
        rgb.append(posenc_orig(torch.from_numpy(dirs), cfg.dir_freq).numpy()
                   if cfg.use_original_embed
                   else anneal_condition(dirs, nerf_alpha))
    if cfg.use_nerf_embed:
        if cfg.use_alpha_condition:
            alpha = embed.copy()
        if cfg.use_rgb_condition:
            rgb.append(embed)
    rgb = (np.concatenate(rgb, 1) if rgb
           else np.zeros((dirs.shape[0], 0), np.float32))
    return alpha, rgb.astype(np.float32)


def f32_nerfies_probe_inputs(case: str, model: NerfModel = None) -> dict:
    """Numpy inputs and cotangent of an F32_NERFIES case (``model``: its
    ``f32_nerfies_model``, made when None). A level case: the
    ``LEVEL_INPUTS`` with the model's rgb condition of the rays and, with
    one, 'alpha_cond' (R, 8), and 'cotangent' (R * S, 4). A template case:
    'x_raw' (P, 8) [points | hyper coordinates of deviation 0.3 | 0],
    'rgb_cond' (P / S, C), 'alpha_cond' (P / S, 8) with one, 'cotangent'
    (P, 4). A field case: ``modular_probe_inputs``'."""
    if case in F32_NERFIES_FIELD_CASES:
        return modular_probe_inputs(case, F32_NERFIES_FIELD_CASES)
    model = model or f32_nerfies_model(case)
    nerf_alpha = f32_nerfies_extra(case).get('nerf_alpha')
    if case in F32_NERFIES_LEVEL_CASES:
        *_, n_rays, samples, seed = F32_NERFIES_LEVEL_CASES[case]
        inputs = probe_inputs(n_rays, samples, seed)
        alpha, inputs['rgb_cond'] = f32_nerfies_conditions(
            model, inputs['directions'], inputs['embed'], nerf_alpha)
        if alpha is not None:
            inputs['alpha_cond'] = alpha
        inputs['cotangent'] = probe_cotangents(n_rays, samples,
                                               seed)['level']
        return inputs
    *_, rows, per, seed = F32_NERFIES_TEMPLATE_CASES[case]
    rs = np.random.RandomState(seed + 3000)
    rays = probe_inputs(rows // per, per, seed)
    pts = (rays['origins'][:, None]
           + rays['z_vals'][..., None] * rays['directions'][:, None])
    x_raw = np.concatenate([pts.reshape(-1, 3), rs.randn(rows, 4) * 0.3,
                            np.zeros((rows, 1))], 1)
    alpha, rgb = f32_nerfies_conditions(model, rays['directions'],
                                         rays['embed'], nerf_alpha)
    out = {'x_raw': x_raw.astype(np.float32), 'rgb_cond': rgb,
           'cotangent': rs.randn(rows, 4).astype(np.float32)}
    if alpha is not None:
        out['alpha_cond'] = alpha
    return out


# The JAX kernels' numbers at ``compute_dtype='float32'`` for the plane
# tables (table codes 3 to 8, axis_aligned_plane: the ray's 8 GLO
# coordinates are the hyper coordinates), at the probe weights, in interpret
# mode, at the alphas of ANNEAL_PROBE_STEP (``f32_plane_extra``). A level
# case: (configuration, level, rays, samples per ray, seed, gradients or
# not): outputs at every code, gradients at codes 3 (``plane``) and 6
# (``plane_anneal``); a template case (the template alone, kernel A its
# backward, in each plane layout): (configuration, level, rows, rows per
# condition row, seed). To keep the file small, dW of
# ``f32_plane_grad_layers`` alone; every db.
F32_PLANE_REFERENCE = os.path.join(os.path.dirname(LEVEL_REFERENCE),
                                   'fused_f32_plane_jax_ref.npz')
F32_PLANE_LEVEL_CASES = {
    'level_plane': ('plane', 'fine', 4, 128, 141, True),
    'level_plane_anneal': ('plane_anneal', 'coarse', 4, 64, 142, True),
    'out_plane_se3': ('plane_se3', 'coarse', 4, 64, 143, False),
    'out_plane_quaternion': ('plane_quaternion', 'fine', 4, 64, 144, False),
    'out_plane_anneal_se3': ('plane_anneal_se3', 'fine', 4, 64, 145, False),
    'out_plane_anneal_quaternion': ('plane_anneal_quaternion', 'coarse', 4,
                                    64, 146, False),
}
F32_PLANE_TEMPLATE_CASES = {
    'template_plane': ('plane', 'fine', 256, 64, 147),
    'template_plane_anneal': ('plane_anneal', 'coarse', 256, 64, 148),
}


def f32_plane_model(case: str, device='cpu') -> NerfModel:
    """The float32 model of an F32_PLANE case at the probe weights."""
    config = (F32_PLANE_LEVEL_CASES.get(case)
              or F32_PLANE_TEMPLATE_CASES[case])[0]
    return load_probe_weights(flagship_model(device, config=config,
                                             compute_dtype='float32'))


def f32_plane_extra(case: str) -> dict:
    """The alphas of an F32_PLANE case: those of ANNEAL_PROBE_STEP (as
    ``f32_nerfies_extra``; the posenc_orig plane layout has none but a
    screw warp's warp_alpha)."""
    from hypernerf_tpu_torch.training.train_state import compute_extra_params
    config = (F32_PLANE_LEVEL_CASES.get(case)
              or F32_PLANE_TEMPLATE_CASES[case])[0]
    return compute_extra_params(flagship_config(config), TrainConfig(),
                                ANNEAL_PROBE_STEP)


def f32_plane_grad_layers(case: str):
    """The layers whose dW an F32_PLANE case's file keeps, by index in the
    level's (or the template's) table: the template's first layer (the
    plane encoding's), its alpha head and rgb layer 0, a level's warp's
    first layer, and the posenc_orig template's skip (K = 448)."""
    if case in F32_PLANE_TEMPLATE_CASES:
        return (0, 5, 10, 11) if case == 'template_plane' else (0, 10, 11)
    screw = 'warp_field_type' in CONFIGS[F32_PLANE_LEVEL_CASES[case][0]]
    t0 = 9 if screw else 7
    return (0, t0, t0 + 10, t0 + 11)


def f32_plane_probe_inputs(case: str, model: NerfModel = None) -> dict:
    """Numpy inputs and cotangent of an F32_PLANE case (``model``: its
    ``f32_plane_model``, made when None). A level case: the
    ``LEVEL_INPUTS`` with the model's rgb condition of the rays and
    'cotangent' (R * S, 4). A template case: 'x_raw' (P, 16) [points | 8
    hyper coordinates of deviation 0.3 | 0], 'rgb_cond' (P / S, C),
    'cotangent' (P, 4)."""
    model = model or f32_plane_model(case)
    nerf_alpha = f32_plane_extra(case).get('nerf_alpha')
    if case in F32_PLANE_LEVEL_CASES:
        _, _, n_rays, samples, seed, _ = F32_PLANE_LEVEL_CASES[case]
        inputs = probe_inputs(n_rays, samples, seed)
        inputs['rgb_cond'] = f32_nerfies_conditions(
            model, inputs['directions'], inputs['embed'], nerf_alpha)[1]
        inputs['cotangent'] = probe_cotangents(n_rays, samples,
                                               seed)['level']
        return inputs
    _, _, rows, per, seed = F32_PLANE_TEMPLATE_CASES[case]
    rs = np.random.RandomState(seed + 3000)
    rays = probe_inputs(rows // per, per, seed)
    pts = (rays['origins'][:, None]
           + rays['z_vals'][..., None] * rays['directions'][:, None])
    x_raw = np.concatenate([pts.reshape(-1, 3), rs.randn(rows, 8) * 0.3,
                            np.zeros((rows, 5))], 1)
    return {'x_raw': x_raw.astype(np.float32),
            'rgb_cond': f32_nerfies_conditions(
                model, rays['directions'], rays['embed'], nerf_alpha)[1],
            'cotangent': rs.randn(rows, 4).astype(np.float32)}


def read_f32_plane_reference(path: str = F32_PLANE_REFERENCE):
    """{case: {name: array}} of the float32 plane-table reference file."""
    out = {case: {} for case in (*F32_PLANE_LEVEL_CASES,
                                 *F32_PLANE_TEMPLATE_CASES)}
    with np.load(path) as f:
        for key in f.files:
            case, name = key.split('/', 1)
            out[case][name] = f[key]
    return out


def read_f32_nerfies_reference(path: str = F32_NERFIES_REFERENCE):
    """{case: {name: array}} of the float32 Nerfies-layout reference
    file."""
    out = {case: {} for case in (*F32_NERFIES_LEVEL_CASES,
                                 *F32_NERFIES_TEMPLATE_CASES,
                                 *F32_NERFIES_FIELD_CASES)}
    with np.load(path) as f:
        for key in f.files:
            case, name = key.split('/', 1)
            out[case][name] = f[key]
    return out


def read_f32_reference(path: str = F32_REFERENCE):
    """{case: {name: array}} of the float32 reference file."""
    out = {case: {} for case in F32_LEVEL_CASES}
    with np.load(path) as f:
        for key in f.files:
            case, name = key.split('/', 1)
            out[case][name] = f[key]
    return out


def read_b4_reference(path: str = B4_REFERENCE):
    """{case: {name: array}} of the B.4 reference file."""
    out = {case: {} for case in (*B4_LEVEL_CASES, *B4_TEMPLATE_CASES)}
    with np.load(path) as f:
        for key in f.files:
            case, name = key.split('/', 1)
            out[case][name] = f[key]
    return out


def read_condition_reference(path: str = CONDITION_REFERENCE):
    """{case: {name: array}} of the conditions' reference file."""
    out = {case: {} for case in (*CONDITION_LEVEL_CASES,
                                 *CONDITION_TEMPLATE_CASES)}
    with np.load(path) as f:
        for key in f.files:
            case, name = key.split('/', 1)
            out[case][name] = f[key]
    return out


def read_plane_reference(path: str = PLANE_REFERENCE):
    """{case: {name: array}} of the plane reference file."""
    out = {case: {} for case in (*PLANE_LEVEL_CASES, *PLANE_TEMPLATE_CASES,
                                 *PLANE_F32_CASES)}
    with np.load(path) as f:
        for key in f.files:
            case, name = key.split('/', 1)
            out[case][name] = f[key]
    return out


def read_anneal_reference(path: str = ANNEAL_REFERENCE):
    """{case: {name: array}} of the anneal reference file."""
    out = {case: {} for case in (*ANNEAL_LEVEL_CASES,
                                 *ANNEAL_TEMPLATE_CASES)}
    with np.load(path) as f:
        for key in f.files:
            case, name = key.split('/', 1)
            out[case][name] = f[key]
    return out


# The JAX Jacobian kernels' numbers at ``compute_dtype='float32'`` (rows 14
# to 17 at ``--precision 32``) at the probe weights, in interpret mode, full
# width: ``JACOBIAN_CASES``' form, their own seeds; each case's output, and
# for the stored cotangent 'dx', every dW / db of the field's layers and,
# for the trunk, the side channel's 'jac_se3' / 'jac_quaternion'.
F32_JACOBIAN_REFERENCE = os.path.join(os.path.dirname(LEVEL_REFERENCE),
                                      'fused_f32_jacobian_jax_ref.npz')
F32_JACOBIAN_CASES = {'translation': ('flagship', 300, None, 151),
                      'se3': ('se3', 300, None, 152),
                      'se3_window': ('se3', 300, 3.5, 153)}


def f32_jacobian_model(case: str, device='cpu') -> NerfModel:
    """The float32 model of an ``F32_JACOBIAN_CASES`` case at the probe
    weights."""
    return load_probe_weights(flagship_model(
        device, config=F32_JACOBIAN_CASES[case][0], compute_dtype='float32'))


def read_jacobian_reference(path: str = JACOBIAN_REFERENCE, cases=None):
    """{case: {name: array}} of the warp-Jacobian reference file (or of
    ``path`` with ``cases``, a dict of ``JACOBIAN_CASES``' form: the
    float32 file with ``F32_JACOBIAN_CASES``)."""
    out = {case: {} for case in (cases or JACOBIAN_CASES)}
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
