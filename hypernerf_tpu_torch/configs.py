"""Configuration dataclasses for the model and training system.

The reference resolves its configuration from a flat argparse namespace
(reference opt.py) with much of the architecture hardcoded inside
``NerfModel.__init__`` (reference hypernerf/models.py:134-207). Here the
full architecture is an explicit, hashable, frozen dataclass so it can be a
static argument to jit and be serialized next to checkpoints (so eval never
drifts from training flags, unlike the reference's duplicated eval parser,
eval.py:20-74).

This is the port's own copy of ``hypernerf_tpu/configs.py``: same field
names and defaults, so a ``nerf_config.json`` written by either package
loads in the other (``tests/test_torch_imports.py`` holds the two together).
The ``use_pallas*`` and ``pallas_*`` fields of ``NerfConfig`` select and tune
the JAX package's TPU kernels; here they are inert and kept only so that
configs round-trip. The port's kernels take no such switches.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class NerfConfig:
    """Architecture + rendering configuration for NerfModel.

    Field defaults mirror the reference's resolved defaults
    (models.py:111-207 with train.py:48-67 / opt.py flag defaults).
    """
    # Metadata embeddings (per-frame latent codes).
    num_embeddings: int = 100
    glo_dim: int = 8
    share_glo: bool = True

    # Scene / sampling.
    near: float = 0.0
    far: float = 1.0
    num_coarse_samples: int = 64
    num_fine_samples: int = 128
    noise_std: Optional[float] = 1.0
    use_stratified_sampling: bool = True
    use_linear_disparity: bool = False
    use_sample_at_infinity: bool = True
    use_white_background: bool = False

    # Warp field.
    use_warp: bool = True
    warp_field_type: str = 'translation'  # 'translation' | 'se3' | 'quaternion'
    warp_depth: int = 6
    warp_width: int = 128
    warp_freq: int = 10  # posenc_orig freqs for the translation field
    warp_min_deg: int = 0  # nerfies posenc degrees for the SE(3) field
    warp_max_deg: int = 8

    # Hyper-space slicing.
    hyper_slice_method: str = 'bendy_sheet'  # 'none'|'axis_aligned_plane'|'bendy_sheet'
    hyper_slice_out_dim: int = 4
    hyper_sheet_depth: int = 6
    hyper_sheet_width: int = 64
    hyper_sheet_freq: int = 7
    hyper_sheet_use_residual: bool = False

    # Template NeRF MLP.
    trunk_depth: int = 8
    trunk_width: int = 256
    rgb_branch_depth: int = 4
    rgb_branch_width: int = 128
    skips: Tuple[int, ...] = (4,)
    alpha_channels: int = 1
    rgb_channels: int = 3

    # Conditioning.
    use_viewdirs: bool = True
    use_nerf_embed: bool = False
    use_alpha_condition: bool = False
    use_rgb_condition: bool = False

    # Positional encoding. use_original_embed=True is the reference's live
    # path (plain NeRF fourier features, models.py:204); False enables the
    # Nerfies windowed encoding with coarse-to-fine annealing via extra_params.
    use_original_embed: bool = True
    xyz_freq: int = 10
    dir_freq: int = 6
    hyper_freq: int = 6
    spatial_point_min_deg: int = 0
    spatial_point_max_deg: int = 10
    hyper_point_min_deg: int = 0
    hyper_point_max_deg: int = 4
    viewdir_min_deg: int = 0
    viewdir_max_deg: int = 4

    # Compute dtype for the MLP matmuls ('bfloat16' keeps the MXU fed;
    # params, encodings and compositing stay fp32).
    compute_dtype: str = 'bfloat16'
    # Run the template MLP through the fused Pallas kernel on TPU backends
    # (falls back to the XLA path on CPU / for init automatically).
    use_pallas: bool = True
    # Also run the warp field / hyper sheet through the fused field kernel.
    use_pallas_fields: bool = True
    # Fuse warp + hyper sheet + template into ONE kernel per level (the
    # flagship translation+bendy_sheet config; falls back otherwise).
    use_pallas_level: bool = True
    pallas_tile: int = 1024
    # Backward tile for the fields backward kernel (the level backward is
    # split: the template backward runs at tile 512 — its VMEM ceiling —
    # and the lean fields backward fits 1024 comfortably).
    pallas_bwd_tile: int = 1024
    # Software-pipelined level backward: one kernel interleaving the
    # template backward of tile i with the fields backward of tile i-1
    # (fused_level._make_pipelined_bwd_kernel) — Mosaic overlaps the
    # alternating independent streams, hiding the lane-starved fields work
    # under the 256-wide template matmuls. Both stages run at
    # pallas_bwd_tile. Numerics identical to the split backward. Default on
    # since round 3 (flagship 76.9k -> 83.4k rays/s; se3/quaternion/plane/
    # anneal variants parity-checked on device and in interpret tests).
    pallas_pipelined_bwd: bool = True
    # Same pipelining for the level forward (fields tile i interleaved
    # with template tile i-1). Default off: measured ~neutral (+0.4%
    # step) because BOTH forward streams stall on the same resource (the
    # per-layer f32 epilogue VPU work), unlike the backward pair whose
    # mixes are complementary — root-caused with per-kernel A/B in
    # BENCHMARKS.md "Pipelined FORWARD: measured root cause".
    pallas_pipelined_fwd: bool = False
    # Half-tile interleaved level forward: each grid step runs TWO
    # independent half-tile streams (fields + template each) alternated
    # op-group by op-group. Symmetric streams, so one half's matmul starts
    # while the other sits in its f32 epilogue — the lever pallas_pipelined
    # _fwd couldn't pull (its fields stream is too small to cover the
    # template's VPU slots). Bit-identical numerics (row-blocked matmuls).
    pallas_interleaved_fwd: bool = False
    # Run the fused kernels' hidden-layer epilogues (bias+relu) in the
    # compute dtype instead of fp32. At bf16 the f32 add/max/convert trio
    # costs ~one matmul-time per 256-wide layer on the VPU — the measured
    # forward roof (BENCHMARKS.md round 4); this trades it for one convert
    # plus two half-width ops at the cost of one bias rounding per layer.
    # Exact no-op at compute_dtype float32.
    pallas_bf16_epilogue: bool = False
    # Elastic-loss Jacobian subsampling: with K > 0 the fused-path warp
    # Jacobian is evaluated at only K points per ray, drawn proportional to
    # the rendering weights (an unbiased importance estimator of the
    # weighted elastic penalty: W * mean_k e_k, W = sum of weights). 0 =
    # every sample (exact; ~2.5x step cost at 64+64). 16 recovers most of
    # the speed at regularizer-grade fidelity.
    elastic_jacobian_samples: int = 0
    # Run the fused kernels under the Pallas interpreter on non-TPU
    # backends (testing only: lets the CPU suite exercise the MODEL-level
    # fused dispatch, tests/test_fused_model_interpret.py). Use tiny tiles.
    pallas_interpret: bool = False

    # Occupancy-grid guided coarse sampling (ops/occupancy.py; OFF by
    # default for reference parity). The grid EMA-tracks the model's own
    # density and reshapes the coarse sampling distribution toward occupied
    # space — sample counts stay static (TPU), placement concentrates.
    use_occupancy_grid: bool = False
    occupancy_resolution: int = 64
    occupancy_probes: int = 64      # uniform PDF bins probed per ray
    occupancy_floor: float = 0.01   # uniform support floor in the PDF
    # World-space bounding box of the grid ((min,)*3, (max,)*3).
    occupancy_bbox_min: float = -2.0
    occupancy_bbox_max: float = 2.0

    def __post_init__(self):
        if self.hyper_slice_method not in ('none', 'axis_aligned_plane',
                                           'bendy_sheet'):
            raise ValueError(
                f'Unknown hyper_slice_method {self.hyper_slice_method!r}')
        if self.warp_field_type not in ('translation', 'se3',
                                        'quaternion'):
            raise ValueError(
                f'Unknown warp_field_type {self.warp_field_type!r}')
        if self.use_nerf_embed and not (self.use_alpha_condition
                                        or self.use_rgb_condition):
            raise ValueError('use_nerf_embed requires use_alpha_condition '
                             'or use_rgb_condition.')
        if self.use_occupancy_grid and self.use_linear_disparity:
            # The occupancy probe bins are parameterized in linear depth
            # (ops/occupancy.sample_occupancy_rays); silently ignoring the
            # disparity flag would change sampling semantics underfoot.
            raise ValueError('use_occupancy_grid parameterizes probe bins '
                             'in linear depth and does not support '
                             'use_linear_disparity.')

    @property
    def has_hyper(self) -> bool:
        return self.hyper_slice_method != 'none'

    @property
    def has_hyper_embed(self) -> bool:
        return self.has_hyper

    @property
    def hyper_use_warp_embed(self) -> bool:
        # share_GLO=True means the hyper/nerf branches reuse the warp
        # embedding (models.py:167-168; the False path NameErrors in the
        # reference — here it cleanly selects separate embeddings).
        return self.share_glo and self.use_warp

    @property
    def nerf_use_warp_embed(self) -> bool:
        return self.share_glo and self.use_warp

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> 'NerfConfig':
        data = json.loads(text)
        if 'skips' in data:
            data['skips'] = tuple(data['skips'])
        return cls(**data)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-system configuration (mirrors opt.py flag defaults)."""
    root_dir: str = ''
    dataset_name: str = 'llff'
    img_wh: Tuple[int, int] = (504, 378)
    spheric_poses: bool = False
    use_nerfies_meta: bool = True

    loss_type: str = 'mse'
    # Nerfies elastic regularization (Park et al. 2021 §3.4) on the warp
    # Jacobian's singular values; 0 = off (the reference default — its warp
    # field cannot produce Jacobians at all, warping.py:122). Enabling it
    # keeps the level kernels for the render and adds the warp Jacobian
    # through its own kernels (models/nerf.py `return_warp_jacobian`).
    elastic_loss_weight: float = 0.0
    elastic_loss_scale: float = 0.03
    # Nerfies background regularization (§3.5): known-static 3-D points
    # (an (N, 3) .npy, e.g. COLMAP sparse points) are penalized for moving
    # under the warp. 0 / empty path = off (the reference has no such loss).
    background_loss_weight: float = 0.0
    background_loss_scale: float = 0.001
    background_points_path: str = ''
    background_points_per_step: int = 1024
    batch_size: int = 2048
    chunk: int = 8192  # eval render tile (device-side lax.map tile size)
    num_epochs: int = 20
    max_steps: Optional[int] = None  # overrides num_epochs when set
    lr: float = 5e-4
    optimizer: str = 'adam'  # 'sgd' | 'adam' | 'radam' | 'ranger'
    momentum: float = 0.9
    weight_decay: float = 0.0
    # ZeRO-1: shard the optimizer moments over the data mesh axis (the
    # reference's >1-GPU default is fairscale ddp_sharded — sharded
    # optimizer state + gradient allreduce, train.py:229). The update math
    # is elementwise per-parameter, so the step is bit-identical to the
    # replicated update (asserted by tests/test_train.py); each device
    # stores 1/N of every divisible moment leaf.
    shard_optimizer_state: bool = False
    lr_scheduler: str = 'steplr'  # 'steplr' | 'cosine' | 'poly'
    warmup_multiplier: float = 1.0
    warmup_epochs: int = 0
    decay_step: Tuple[int, ...] = (20,)
    decay_gamma: float = 0.1
    poly_exp: float = 0.9

    # Coarse-to-fine posenc annealing (active when use_original_embed=False).
    warp_alpha_steps: int = 80000
    hyper_alpha_steps: int = 10000

    # Occupancy-grid refresh cadence (steps) and EMA decay per refresh
    # (active when NerfConfig.use_occupancy_grid).
    occupancy_update_every: int = 16
    occupancy_decay: float = 0.95
    # Metadata ids probed per refresh (max across ids): >1 keeps a moving
    # object visible to the grid before the EMA has cycled through frames.
    occupancy_probe_ids: int = 4

    exp_name: str = 'exp'
    ckpt_dir: str = 'ckpts'
    log_dir: str = 'logs'
    ckpt_path: Optional[str] = None    # full-state resume
    weight_path: Optional[str] = None  # weights-only warm start
    prefixes_to_ignore: Tuple[str, ...] = ('loss',)

    seed: int = 0
    ckpt_every_steps: Optional[int] = None  # default: every epoch
    # Retention: keep the best k checkpoints by val/psnr plus the latest
    # (None = keep everything, the reference's save_top_k=-1 default).
    ckpt_keep_top_k: Optional[int] = None
    val_check_interval: float = 0.25
    num_sanity_val_steps: int = 1
    log_every: int = 100
    # Trace steps [profile_start, profile_start + profile_steps) with
    # jax.profiler into <log_dir>/<exp_name>/profile (0 disables).
    profile_steps: int = 0
    profile_start: int = 10

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> 'TrainConfig':
        data = json.loads(text)
        for k in ('img_wh', 'decay_step', 'prefixes_to_ignore'):
            if k in data and data[k] is not None:
                data[k] = tuple(data[k])
        return cls(**data)
