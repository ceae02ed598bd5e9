"""One level: warp field + hyper sheet + template for every sample, forward
and backward. The warp field is the translation field, or the SE(3) or the
quaternion field (the trunk of ``fused_se3``, then the retraction inside the
kernels); ``warp_scales`` is the latter two's optional ``warp_alpha`` window
row (``fused_se3.se3_encoding_scales``; a row of ones and None give the same
numbers). The template encodes as the ``Level`` says: posenc_orig, or the
Nerfies encoding of the anneal configurations with ``tmpl_scales``, its
window row at ``nerf_alpha`` and ``hyper_alpha``
(``fused_mlp.template_scales``; None: fully on). A level without a sheet
(``Level.hyper`` None: axis_aligned_plane slicing, with any warp) takes the
ray's 8 GLO coordinates as its hyper coordinates, in the template's plane
layout or its Nerfies plane layout (raw rows of 16 columns); its kernels
are their own instantiations, one table code each (``level_table``,
``common.TABLE_CODES``). Both window rows, the trunk's and the template's,
go into one call where the level has both.
The template takes the rgb condition at any width its layout covers and,
where its alpha head takes one, the alpha condition (``fused_mlp``'s
module docstring), both per ray.

``fused_level`` is the wrapper. On CUDA tensors it launches the hand-written
Hopper kernel of ``csrc/level_fwd.cuh`` (one source per warp type,
``level_fwd_{trans,se3,quat}.cu``, behind the entry point of
``csrc/fused_level.cu``; it replaces the TPU kernel
``hypernerf_tpu/ops/pallas/fused_level.py`` ``_fused``); on CPU tensors it
runs ``fused_level_plain``, the same function composed from this package's
modules, whose rounding points are the kernel's (models/modules.py). On a
CUDA tensor it launches the kernel or raises. The kernel's three stages
also run alone on its block for the per-module path
(``csrc/modular_fwd.cu``). ``forward_plan`` models the
kernel's tiles, column plan and weight stream in Python, ``stage_plan`` a
per-module kernel's, ``fields_bwd_plan`` kernel B's and ``field_bwd_plan``
a field alone backward's on kernel B's block.

When a gradient is wanted the call goes through ``FusedLevelFn``: its
forward also keeps ``raw_t``, the template's raw input [warped | hyper], and
its backward runs the template backward (``fused_template_bwd``, kernel A's
sequence in ``csrc/template_*.cu``) and then the fields backward
(``fused_fields_bwd``, kernel B: ``csrc/fields_bwd.cuh``, one source per
warp type, ``fields_bwd_{trans,se3,quat}.cu``), stitched through
``dx_t`` = d[warped | hyper] as the JAX package's split backward is. Each has
a plain version written out explicitly, with the kernels' rounding points
(the cotangent is rounded to the compute dtype before every product, a
hidden layer's db sums the rounded cotangent, heads' db the fp32 one).

Bound and design: see the notes at the top of the ``csrc/*.cu`` sources.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from hypernerf_tpu_torch.kernels import build, common
from hypernerf_tpu_torch.kernels.fused_field import (field_layers,
                                                     fused_field_bwd_plain,
                                                     fused_field_plain)
from hypernerf_tpu_torch.kernels import f32
from hypernerf_tpu_torch.kernels.fused_mlp import (check_covered as
                                                   _check_template_covered,
                                                   check_f32_covered as
                                                   _check_f32_template_covered,
                                                   cond_args,
                                                   f32_template_args,
                                                   fused_template_bwd,
                                                   fused_template_bwd_plain,
                                                   fused_template_plain,
                                                   kernel_scales,
                                                   kernel_template_layers,
                                                   raw_pad, template_layers)
from hypernerf_tpu_torch.kernels.fused_se3 import (check_covered as
                                                   _check_se3_covered,
                                                   fused_se3_bwd_plain,
                                                   fused_se3_plain,
                                                   se3_layers)
from hypernerf_tpu_torch.models.modules import HyperSheetMLP, NerfMLP
from hypernerf_tpu_torch.models.warping import SE3Field, TranslationField

FLAGSHIP = common.FLAGSHIP


class Level(NamedTuple):
    """The modules of one level and the template's encoding (its bands and
    layout, as ``fused_mlp.Template`` has them). ``hyper`` is None in the
    plane configuration: the hyper coordinates are the embedding."""
    warp: Union[TranslationField, SE3Field]  # or its QuaternionField
    hyper: Optional[HyperSheetMLP]
    template: NerfMLP
    xyz_freq: int
    hyper_freq: int
    nerfies: bool = False


def _raw_fields(z_vals, origins, directions, embed):
    """(P, 3 + E) fp32 raw rows [o + z d | the ray's embedding]."""
    r, s = z_vals.shape
    pts = origins[:, None, :] + z_vals[..., None] * directions[:, None, :]
    emb = embed[:, None, :].expand(r, s, embed.shape[-1])
    return torch.cat([pts, emb.to(pts.dtype)], dim=-1).reshape(r * s, -1)


def _screw(level: Level) -> bool:
    """Whether the level's warp is the SE(3) or the quaternion field."""
    return level.warp.kind != 'translation'


def level_table(level: Level) -> str:
    """The compiled layer table the level's kernels take (a key of
    ``common.TABLE_CODES``): its warp type's with the sheet, or without it
    its warp type's over the template's plane layout."""
    if level.hyper is not None:
        return level.warp.kind
    plane = 'nerfies_plane' if level.nerfies else 'plane'
    kind = level.warp.kind
    return plane if kind == 'translation' else f'{plane}_{kind}'


def _check_sheet(level: Level) -> None:
    if level.hyper is not None and level.hyper.use_residual:
        raise NotImplementedError(common.NOT_COVERED + '; the sheet\'s '
                                  'residual runs on the per-module path')


def _warp_owner_layers(level: Level):
    """(the module that owns the warp's packed blobs, its layers)."""
    if _screw(level):
        return level.warp, se3_layers(level.warp)
    return level.warp.mlp, field_layers(level.warp.mlp)


def fused_level_plain(level: Level, z_vals, origins, directions, embed,
                      rgb_cond, return_raw_t: bool = False, warp_scales=None,
                      tmpl_scales=None, alpha_cond=None):
    """Plain PyTorch level forward: the plain warp field (or the plain SE(3)
    trunk and the retraction's values), hyper sheet and template
    (``fused_field_plain``, ``fused_se3_plain``, ``fused_template_plain``)
    chained.

    Args:
      z_vals: (R, S) depths; origins / directions: (R, 3); embed: (R, E)
        per-ray warp/hyper embedding; rgb_cond: (R, C) per-ray rgb condition
        (C may be 0); alpha_cond: (R, Ca) per-ray alpha condition or None.

    Returns:
      (R * S, 4) fp32 [rgb logits (3) | raw sigma]; with ``return_raw_t``
      also the template's raw input (R * S, 8) fp32 [warped | hyper | 0]
      ((R * S, 16) in the plane configuration: [warped | embed | 0]).
    """
    fused_level_plain.calls += 1
    _check_sheet(level)
    x_raw = _raw_fields(z_vals, origins, directions, embed)
    if _screw(level):
        wv = fused_se3_plain(level.warp, x_raw, warp_scales).to(x_raw.dtype)
        warped = level.warp.retract(wv[:, :3], wv[:, 3:], x_raw[:, :3])
    else:
        warped = x_raw[:, :3] + fused_field_plain(
            level.warp.mlp, level.warp.n_freq, x_raw).to(x_raw.dtype)
    if level.hyper is None:  # axis_aligned_plane: the embedding
        hyper = x_raw[:, 3:]
    else:
        hyper = fused_field_plain(level.hyper.mlp, level.hyper.n_freq, x_raw)
    raw_t = torch.cat([warped, hyper], dim=-1).to(
        torch.promote_types(x_raw.dtype, torch.float32))
    raw_t = F.pad(raw_t, (0, raw_pad(level) - raw_t.shape[-1]))
    out = fused_template_plain(level, raw_t, rgb_cond, tmpl_scales,
                               alpha_cond)
    return (out, raw_t) if return_raw_t else out


fused_level_plain.calls = 0


def _sheet_layers(level: Level):
    return [] if level.hyper is None else field_layers(level.hyper.mlp)


def level_layers(level: Level):
    """Every Linear of the level in kernel order with its input segments."""
    return (_warp_owner_layers(level)[1] + _sheet_layers(level)
            + template_layers(level.template))


def _dtypes(level: Level) -> set:
    """The compute dtypes of the level's modules."""
    t = level.template
    mlps = [level.warp.trunk if _screw(level) else level.warp.mlp, t.trunk,
            t.rgb_branch]
    if level.hyper is not None:
        mlps.append(level.hyper.mlp)
    return {m.dtype for m in mlps} | {t.dtype}


def _is_f32(level: Level) -> bool:
    return _dtypes(level) == {torch.float32}


def _check_f32_covered(level: Level) -> None:
    """Raise unless the float32 kernels cover the level: every table (the
    translation warp, or the SE(3) / quaternion trunk that
    ``fused_se3.check_covered`` admits; the bendy sheet, or none: the plane
    tables; the template ``check_f32_covered`` admits, posenc_orig or
    Nerfies, with 4 hyper coordinates or, without a sheet, the plane's 8)
    at the flagship widths."""
    _check_f32_template_covered(level)
    if _screw(level):
        _check_se3_covered(level.warp)
        have = dict(embed=level.warp.embed_ch)
    else:
        mlp = level.warp.mlp
        have = dict(embed=mlp.hidden(0).in_features
                    - 3 * (1 + 2 * level.warp.n_freq),
                    warp_freq=level.warp.n_freq)
    if level.hyper is not None:
        have.update(hyper_sheet_freq=level.hyper.n_freq,
                    hyper_out=level.hyper.mlp.logit.out_features)
    if (have != {k: FLAGSHIP[k] for k in have}
            or (level.hyper is not None and level.hyper.use_residual)):
        raise NotImplementedError(f'{common.NOT_COVERED}; got {have}')


def _check_covered(level: Level) -> None:
    if _is_f32(level):
        return _check_f32_covered(level)
    _check_template_covered(level)
    t = level.template
    keys = ('embed', 'warp_freq') + (('hyper_sheet_freq', 'hyper_out')
                                      if level.hyper is not None else ())
    flagship = {k: FLAGSHIP[k] for k in keys}
    if _screw(level):
        _check_se3_covered(level.warp)
        warp_mlp = level.warp.trunk
        del flagship['warp_freq']
        have = dict(embed=level.warp.embed_ch)
    else:
        warp_mlp = level.warp.mlp
        have = dict(embed=warp_mlp.hidden(0).in_features
                    - 3 * (1 + 2 * level.warp.n_freq),
                    warp_freq=level.warp.n_freq)
    mlps = [warp_mlp, t.trunk, t.rgb_branch]
    if level.hyper is not None:
        have.update(hyper_sheet_freq=level.hyper.n_freq,
                    hyper_out=level.hyper.mlp.logit.out_features)
        mlps.append(level.hyper.mlp)
    dtypes = {m.dtype for m in mlps} | {t.dtype}
    if (have != flagship or dtypes != {torch.bfloat16}
            or (level.hyper is not None and level.hyper.use_residual)):
        raise NotImplementedError(f'{common.NOT_COVERED}; got {have}, '
                                  f'{dtypes}')


def pack_level(level: Level):
    """The level kernels' bf16 weight and bias blobs and the (n_pad, k_pad)
    of each layer: the three modules' own packed blobs
    (``common.pack_layers``, cached on each module and following its
    parameters' version counters, so the warp and the sheet that two levels
    share are packed once) joined, the joined blobs cached on the template.
    """
    return _pack_level(level, torch.bfloat16)


def pack_level_f32(level: Level, transposed: bool = False):
    """``pack_level``'s fp32 blobs, the float32 kernels' (cached apart);
    with ``transposed`` the weight blob holds each layer as (k_pad, n_pad),
    how the float32 forward reads it."""
    return _pack_level(level, torch.float32, transposed)


def _pack_level(level: Level, dtype, transposed: bool = False):
    check = lambda: _check_covered(level)
    owners = [_warp_owner_layers(level)]
    if level.hyper is not None:
        owners.append((level.hyper.mlp, field_layers(level.hyper.mlp)))
    owners.append((level.template, kernel_template_layers(level.template)))
    subs = [common.packed(owner, layers, check, dtype)
            for owner, layers in owners]
    key = tuple(sub['key'] for sub in subs)
    attr = '_packed_level' + common.packed_attr(dtype)[len('_packed'):]
    cached = getattr(level.template, attr, None)
    if cached is None or cached['key'] != key:
        check()
        pairs = [pair for sub in subs for pair in sub['packed']]
        cached = dict(
            key=key, packed=pairs,
            shapes=[shape for sub in subs for shape in sub['shapes']],
            w=torch.cat([sub['w'] for sub in subs]),
            b=torch.cat([sub['b'] for sub in subs]))
        object.__setattr__(level.template, attr, cached)
    if transposed and 'wt' not in cached:
        cached['wt'] = torch.cat([w.t().reshape(-1)
                                  for w, _ in cached['packed']]).contiguous()
    return cached['wt' if transposed else 'w'], cached['b'], cached['shapes']


def _level_params(level: Level):
    """[weight, bias] of every Linear of the level, in kernel order."""
    return common.layer_params(level_layers(level))


def _n_field_layers(level: Level) -> int:
    return len(_warp_owner_layers(level)[1]) + len(_sheet_layers(level))


def _warp_launch_args(level: Level, shapes, warp_scales, dev):
    """(the table's code, the padded window row or None) for a level
    kernel, after the packed ``shapes`` were checked against that compiled
    table (``level_table``)."""
    common.check_layout(shapes, slice(None), level_table(level))
    return _warp_row(level, shapes, warp_scales, dev)


def _warp_row(level: Level, shapes, warp_scales, dev):
    """(the code of the level's table, its trunk's window row padded to
    the packed first layer's columns, or None)."""
    table = level_table(level)
    if not _screw(level):
        if warp_scales is not None:
            raise ValueError('the translation warp takes no window row')
        return common.TABLE_CODES[table], None
    return common.TABLE_CODES[table], common.padded_scales(
        warp_scales, level.warp.trunk.hidden(0).in_features, shapes[0][1],
        dev)


def _ptr(t):
    return None if t is None else t.data_ptr()


# The forward kernel's plan (csrc/level_fwd.cuh), modelled here for the tests
# and for chip_smoke.py, which holds it to the compiled one
# (``hn_fused_level_fwd_plan``). A block is FWD_GROUPS consumer warpgroups,
# each with its own tile of FWD_TILE_ROWS rows x FWD_TILE_COLS bf16 columns
# (six 64-column boxes, 128-byte swizzle), and a producer warpgroup (one
# thread issues the loads; setmaxnreg hands its registers to the consumers)
# that streams each layer's (n_pad, k_pad) weight from the packed blob
# through a ring of FWD_STAGES stages: one load per 64-column box of K and
# 128-row half of N. The levels of the plane layout's tables
# (``common.PLANE_TABLES``), and their template alone, take tiles of
# PLANE_TILE_COLS columns (the template's 192-column encoding beside its 256
# hidden ones), which leave room for a ring of one stage fewer
# (``block_stages``); the Nerfies plane layout's 128 columns take the
# level's tiles.
FWD_TILE_ROWS, FWD_GROUPS, FWD_STAGES = 64, 2, 6
FWD_BOX_COLS, FWD_STAGE_ROWS, FWD_TILE_COLS = 64, 128, 384
PLANE_TILE_COLS = 256 + common.PLANE_ENC_PAD
FWD_STAGE_BYTES = FWD_STAGE_ROWS * 2 * FWD_BOX_COLS
FWD_THREADS = 128 * (FWD_GROUPS + 1)
# Per-row fp32 scratch of a warpgroup: in (12), raw (8), head (8), sigma,
# ray.
FWD_ROW_BYTES = 4 * (12 + 8 + 8 + 1 + 1)
# Every layer's bf16 bias, kept in shared memory: the SE(3) table's 4264.
FWD_BIAS_BYTES = 2 * 4264


def block_stages(cols: int) -> int:
    """The ring's stages of a block with tiles of ``cols`` columns
    (``TmplBlock``): one fewer for the plane layout's wider tiles."""
    return FWD_STAGES - 1 if cols > FWD_TILE_COLS else FWD_STAGES


def fwd_smem_bytes(groups: int = FWD_GROUPS,
                   cols: int = FWD_TILE_COLS) -> int:
    """Dynamic shared memory of a block of ``groups`` consumer warpgroups
    with tiles of ``cols`` columns (``Block::kSmemBytes``)."""
    stages = block_stages(cols)
    return (1024 + groups * FWD_TILE_ROWS * 2 * cols
            + stages * FWD_STAGE_BYTES
            + groups * FWD_TILE_ROWS * FWD_ROW_BYTES
            + FWD_BIAS_BYTES + 2 * stages * 8)


FWD_SMEM_BYTES = fwd_smem_bytes()
PLANE_SMEM_BYTES = fwd_smem_bytes(FWD_GROUPS, PLANE_TILE_COLS)
# The tile's column plan: where each field's encoding (and the rgb
# condition) sits; a hidden layer writes [0, n), its input starts at 0
# unless it is a field's first layer, which reads the encoding.
FWD_ENC_COL = dict(warp=128, hyper=64, template=256, cond=128)


def forward_in_cols(warp: str = 'translation'):
    """The first tile column of every layer's input, in layer order, in the
    table ``warp`` (a key of ``common.TABLE_CODES``)."""
    h0 = 7 if common.table_warp(warp) == 'translation' else 9  # after warp
    if not common.table_has_sheet(warp):  # the warp, then the template
        cols = [0] * (h0 + 16)
        cols[0], cols[h0] = FWD_ENC_COL['warp'], FWD_ENC_COL['template']
        return cols
    cols = [0] * (h0 + 7 + 16)
    cols[0], cols[h0], cols[h0 + 7] = (FWD_ENC_COL['warp'],
                                       FWD_ENC_COL['hyper'],
                                       FWD_ENC_COL['template'])
    return cols


def forward_loads(shapes, first: int = 0):
    """[(layer, box of K, half of N, box rows)]: the weight loads of one
    pair of row tiles, in the producer's (and the consumers') order: each
    layer's 64-column boxes of K, each as its 128-row halves of N.
    ``shapes`` are those of layers ``first``, ``first + 1``, ... ."""
    return [(first + l, kb, nb, min(n, FWD_STAGE_ROWS))
            for l, (n, k) in enumerate(shapes)
            for kb in range(-(-k // FWD_BOX_COLS))
            for nb in range(-(-n // FWD_STAGE_ROWS))]


def forward_maps(shapes):
    """[(first layer, layers, n, k)]: one 2-d tensor map per run of
    consecutive layers of one shape, a (layers x n, k) view of the blob at
    the run's first layer."""
    maps = []
    for l, shape in enumerate(shapes):
        if l and shapes[l - 1] == shape:
            first, count, n, k = maps[-1]
            maps[-1] = (first, count + 1, n, k)
        else:
            maps.append((l, 1, *shape))
    return maps


def _plan(shapes, in_cols, first: int = 0, groups: int = FWD_GROUPS,
          cols: int = FWD_TILE_COLS):
    config = [FWD_TILE_ROWS, groups, block_stages(cols), FWD_STAGE_BYTES,
              fwd_smem_bytes(groups, cols), 128 * (groups + 1), cols,
              len(forward_maps(shapes))]
    return dict(config=config, in_cols=in_cols,
                loads=forward_loads(shapes, first))


def forward_plan(warp: str, shapes):
    """The compiled plan's fields (``hn_fused_level_fwd_plan``) of table
    ``warp``: config, in_cols and loads."""
    cols = PLANE_TILE_COLS if warp in common.PLANE_TABLES else FWD_TILE_COLS
    return _plan(shapes, forward_in_cols(warp), cols=cols)


# The per-module forward kernels (csrc/modular_fwd.cu) each run one stage of
# the level forward on its block: the stage's layers of the translation
# table (a per-module sheet or template is those layers whatever the warp),
# or, for 'se3', the SE(3) / quaternion trunk's of the SE(3) table (the
# screw warp's stage without its retraction), or, for 'template_plane', the
# plane layout's template, layers 7..22 of the plane table, on its level's
# block (PLANE_TILE_COLS, a ring of 5 stages), or, for
# 'template_nerfies_plane', the Nerfies plane layout's, layers 7..22 of its
# table, on the level's block, from the stage's own blob, with the level's
# ring and column plan. Stage -> (first layer, end), the
# code ``hn_modular_fwd_plan`` takes, and the block: (consumer warpgroups,
# tile columns). A field reads and writes the first 256 (warp) or 128
# (sheet) columns of a tile, so three or four tiles fit a block; the trunk
# takes the warp field's block. The Jacobians' forwards (csrc/tangents_fwd.cu)
# run the warp field ('warp_tangents') or the trunk ('se3_tangents') with
# their point-tangent streams on the same block: TANGENT_STREAMS rows a
# point (``tangent_row``), 16 points a tile; their plans, the code
# ``hn_tangents_fwd_plan`` takes, add those two numbers to the config.
MODULE_STAGES = {'warp': (0, 7), 'sheet': (7, 14), 'template': (14, 30),
                 'se3': (0, 9), 'warp_tangents': (0, 7),
                 'se3_tangents': (0, 9), 'template_plane': (7, 23),
                 'template_nerfies_plane': (7, 23)}
MODULE_STAGE_CODES = {'warp': 0, 'sheet': 1, 'template': 2, 'se3': 3,
                      'template_plane': 4, 'template_nerfies_plane': 5}
# The table whose layers a plane template's stage runs.
MODULE_STAGE_TABLES = {'template_plane': 'plane',
                       'template_nerfies_plane': 'nerfies_plane'}
TANGENT_STAGE_CODES = {'warp_tangents': 0, 'se3_tangents': 1}
TANGENT_STREAMS = 4  # the primal row, then d / d p_k for k = 0, 1, 2
MODULE_BLOCKS = {'warp': (3, 256), 'sheet': (4, 128),
                 'template': (FWD_GROUPS, FWD_TILE_COLS), 'se3': (3, 256),
                 'warp_tangents': (3, 256), 'se3_tangents': (3, 256),
                 'template_plane': (FWD_GROUPS, PLANE_TILE_COLS),
                 'template_nerfies_plane': (FWD_GROUPS, FWD_TILE_COLS)}


def stage_plan(stage: str, shapes):
    """The compiled plan's fields of a per-module kernel
    (``hn_modular_fwd_plan``) or a Jacobian's forward
    (``hn_tangents_fwd_plan``): config, in_cols and loads of the stage's
    layers; ``shapes`` are the stage's own blob's (n_pad, k_pad), in
    order."""
    first, end = MODULE_STAGES[stage]
    if len(shapes) != end - first:
        raise ValueError(f'{stage}: {len(shapes)} layers, want '
                         f'{end - first}')
    groups, cols = MODULE_BLOCKS[stage]
    in_cols = forward_in_cols('se3' if stage.startswith('se3') else
                              MODULE_STAGE_TABLES.get(stage, 'translation'))
    plan = _plan(shapes, in_cols[first:end], first, groups, cols)
    if stage in TANGENT_STAGE_CODES:
        plan['config'] += [TANGENT_STREAMS, FWD_TILE_ROWS // TANGENT_STREAMS]
    return plan


def _compiled_plan(fn_name: str, code: int, n_layers: int, n_config=8):
    config = (ctypes.c_int * n_config)()
    in_cols = (ctypes.c_int * n_layers)()
    max_loads = 1024
    loads = (ctypes.c_int * (4 * max_loads))()
    n = getattr(build.library(), fn_name)(
        code, ctypes.addressof(config), ctypes.addressof(in_cols),
        ctypes.addressof(loads), max_loads)
    if not 0 <= n <= max_loads:
        raise RuntimeError(f'{fn_name}: {n} loads')
    return dict(config=list(config), in_cols=list(in_cols),
                loads=[tuple(loads[4 * i:4 * i + 4]) for i in range(n)])


def compiled_forward_plan(warp: str = 'translation'):
    """``forward_plan``'s fields as the compiled kernel reports them
    (``hn_fused_level_fwd_plan``)."""
    return _compiled_plan('hn_fused_level_fwd_plan',
                          common.TABLE_CODES[warp],
                          len(common.kernel_layout(warp)))


def compiled_stage_plan(stage: str):
    """``stage_plan``'s fields as the compiled kernel reports them
    (``hn_modular_fwd_plan``, or ``hn_tangents_fwd_plan`` for a Jacobian's
    forward)."""
    first, end = MODULE_STAGES[stage]
    if stage in TANGENT_STAGE_CODES:
        return _compiled_plan('hn_tangents_fwd_plan',
                              TANGENT_STAGE_CODES[stage], end - first, 10)
    return _compiled_plan('hn_modular_fwd_plan', MODULE_STAGE_CODES[stage],
                          end - first)


def forward_stream_bytes(shapes, n_points: int,
                         groups: int = FWD_GROUPS) -> int:
    """Weight bytes one call reads from L2: each block reads the whole blob
    (in-bounds bytes; a box's zero fill is not read) once per step of
    ``groups`` row tiles (a pair in the level; a per-module kernel: its
    stage's shapes and block)."""
    tiles = -(-n_points // FWD_TILE_ROWS)
    return -(-tiles // groups) * sum(2 * n * k for n, k in shapes)


# Kernel B's plan (csrc/fields_bwd.cuh), modelled here for the tests and for
# chip_smoke.py, which holds it to the compiled one
# (``hn_fused_fields_bwd_plan``). A block tile is FB_TILE_ROWS rows, FB_GROUPS
# consumer warpgroups of 64 rows each; a field's stored layer outputs live
# in a pool of FB_SLOTS slabs (64 bf16 columns x 128 rows, FB_SLAB_BYTES), one
# slab per 64-column box; the weights stream by TMA through a ring of
# FB_STAGES stages, one 64-column box of K of a layer a stage.
FB_TILE_ROWS, FB_GROUPS, FB_STAGES, FB_SLOTS = 128, 2, 4, 8
FB_SLAB_BYTES = FB_STAGE_BYTES = 128 * 128
FB_SPILL_SLABS = 10  # device-memory scratch slabs a block
FB_GRAD_COPIES = 4  # gradient buffers: block b adds into copy b % 4
FB_THREADS = 128 * (FB_GROUPS + 1)
# Per-row fp32 scratch: in (12), z | direction (4), acc (20), a head's
# cotangent (8), the SE(3) rows (16), and the ray (int).
FB_ROWS_BYTES = FB_TILE_ROWS * 4 * (12 + 4 + 20 + 8 + 16 + 1)
FB_BUFS = ('enc', 'h0', 'h1', 'h2', 'h3', 'h4', 'h5', 'T', 'skip', 'lo')
FB_SMEM_BYTES = (1024 + FB_SLOTS * FB_SLAB_BYTES + FB_STAGES * FB_STAGE_BYTES
                 + FB_ROWS_BYTES + (2 * FB_STAGES + len(FB_BUFS)) * 8)
# Where each buffer of a field lives (csrc/fields_bwd.cuh ``buf_plan``):
# (forward slots per 64-column box, the scratch slab its first box is
# spilled to as it is written or -1, the walk-back layer after which it is
# reloaded or -1, the reload slots). A cotangent g_i overwrites h_i, d enc
# the encoding where layer 0 reads it; 'skip' holds the skip layer's part of
# d enc. 'lo' is where a cotangent held as two bf16 halves keeps its low
# half, a double buffer never spilled: g_i's in the forward slots for odd i,
# in the reload slots for even i (``lo_slot``). Only 'warp_tangents', the
# translation warp field with its three point-tangent streams walked back
# for its Jacobian (``hn_fused_jacobian_bwd``), holds its cotangent so; its
# d enc goes to fp32 row scratch, so it stores no 'skip'. The fields in the
# C table's order (fields_bwd.cuh: kSheet, kTransWarp, kSe3Warp,
# kTransJac) are FB_FIELDS.
_NONE = ((-1, -1), -1, -1, (-1, -1))
FB_PLANS = {
    'sheet': [((s, -1), -1, -1, (-1, -1)) for s in range(7)]
    + [_NONE, ((7, -1), -1, -1, (-1, -1)), _NONE],
    'translation': [((0, 1), 0, 2, (6, 7)), ((2, 3), 2, 3, (2, 3)),
                    ((4, 5), 4, 4, (4, 5)), ((6, 7), 6, 5, (6, 7)),
                    ((2, 3), -1, -1, (-1, -1)), ((4, 5), -1, -1, (-1, -1)),
                    ((6, 7), -1, -1, (-1, -1)), _NONE,
                    ((0, 1), -1, -1, (-1, -1)), _NONE],
    'se3': [((0, -1), -1, -1, (-1, -1)), ((1, 2), 0, 3, (6, 7)),
            ((3, 4), 2, 4, (2, 3)), ((5, 6), 4, 5, (4, 5)),
            ((7, 1), 6, 6, (6, 7)), ((2, 3), -1, -1, (-1, -1)),
            ((4, 5), -1, -1, (-1, -1)), ((6, 7), -1, -1, (-1, -1)),
            ((1, -1), -1, -1, (-1, -1)), _NONE],
    'warp_tangents': [((6, 7), 8, 1, (0, 1)), ((0, 1), 0, 2, (4, 5)),
                      ((2, 3), 2, 3, (0, 1)), ((0, 1), 4, 4, (4, 5)),
                      ((2, 3), 6, 5, (0, 1)), ((4, 5), -1, -1, (-1, -1)),
                      ((0, 1), -1, -1, (-1, -1)), _NONE, _NONE,
                      ((2, 3), -1, -1, (6, 7))],
}
FB_FIELDS = ('sheet', 'translation', 'se3', 'warp_tangents')


def lo_slot(plan: str, i: int, box: int) -> int:
    """The slot of box ``box`` of cotangent g_i's low half (fields_bwd.cuh
    ``lo_slot``): the 'lo' row's forward slots for odd i, its reload slots
    for even i."""
    fwd, _, _, reload = FB_PLANS[plan][FB_BUFS.index('lo')]
    return fwd[box] if i % 2 else reload[box]


# The plan's config as the entry points report it (``fb::plan_config``).
FB_CONFIG = (FB_TILE_ROWS, FB_GROUPS, FB_STAGES, FB_STAGE_BYTES,
             FB_SMEM_BYTES, FB_THREADS, FB_SLOTS, FB_SPILL_SLABS,
             FB_GRAD_COPIES)


def _fb_table(field: str):
    """FB_PLANS[field] as the entry points report it: six ints a buffer."""
    return [v for fwd, spill, after, reload in FB_PLANS[field]
            for v in (*fwd, spill, after, *reload)]


def _warp_field(warp: str) -> str:
    return 'se3' if warp in ('se3', 'quaternion') else 'translation'


def fields_bwd_fields(warp: str):
    """The fields kernel B of table ``warp`` walks back, in its order."""
    field = _warp_field(common.table_warp(warp))
    return ('sheet', field) if common.table_has_sheet(warp) else (field,)


def fields_bwd_loads(warp: str, shapes):
    """[(layer, box of K, box rows)]: a block tile's weight loads in the
    producer's (and the consumers') order: the sheet's six hidden layers
    forward, then backward (none in a table without a sheet), then the
    warp's (the SE(3) trunk's seven)."""
    screw = common.table_warp(warp) != 'translation'
    h0, nw = (9, 7) if screw else (7, 6)
    sheet = ([] if not common.table_has_sheet(warp) else
             [h0 + i for i in range(6)] + [h0 + i for i in range(5, -1, -1)])
    order = sheet + list(range(nw)) + list(range(nw - 1, -1, -1))
    return [(l, kb, min(shapes[l][0], FB_STAGE_BYTES // 128))
            for l in order for kb in range(-(-shapes[l][1] // 64))]


def fields_bwd_plan(warp: str, shapes):
    """The compiled plan's fields (``hn_fused_fields_bwd_plan``) of table
    ``warp``: config, table (the sheet's buffer plan, then the warp
    field's, six ints a buffer; a table without a sheet: the warp field's
    alone) and loads."""
    table = [v for field in fields_bwd_fields(warp)
             for v in _fb_table(field)]
    return dict(config=list(FB_CONFIG), table=table,
                loads=fields_bwd_loads(warp, shapes))


def _compiled_fb_plan(fn_name: str, code: int, n_fields: int):
    config = (ctypes.c_int * len(FB_CONFIG))()
    table = (ctypes.c_int * (n_fields * 6 * len(FB_BUFS)))()
    max_loads = 256
    loads = (ctypes.c_int * (3 * max_loads))()
    n = getattr(build.library(), fn_name)(
        code, ctypes.addressof(config), ctypes.addressof(table),
        ctypes.addressof(loads), max_loads)
    if not 0 <= n <= max_loads:
        raise RuntimeError(f'{fn_name}: {n} loads')
    return dict(config=list(config), table=list(table),
                loads=[tuple(loads[3 * i:3 * i + 3]) for i in range(n)])


def compiled_fields_bwd_plan(warp: str = 'translation'):
    """``fields_bwd_plan``'s fields as the compiled kernel reports them
    (``hn_fused_fields_bwd_plan``)."""
    return _compiled_fb_plan('hn_fused_fields_bwd_plan',
                             common.TABLE_CODES[warp],
                             len(fields_bwd_fields(warp)))


def fields_bwd_grad_copies(shapes, device):
    """Kernel B's zeroed fp32 gradient buffers, (FB_GRAD_COPIES, [dW | db]
    of ``shapes`` in the packed layout), and the length of the dW part;
    their sum over the first dimension is the gradient."""
    n_w = sum(n * k for n, k in shapes)
    n_b = sum(n for n, _ in shapes)
    return torch.zeros((FB_GRAD_COPIES, n_w + n_b), dtype=torch.float32,
                       device=device), n_w


def fields_bwd_stream_bytes(warp: str, shapes, n_points: int) -> int:
    """Weight bytes one call of kernel B reads from L2: each block tile
    reads its loads' in-bounds bytes once."""
    return _stream_bytes(fields_bwd_loads(warp, shapes), shapes, 0, n_points)


def _stream_bytes(loads, shapes, first: int, n_points: int) -> int:
    tiles = -(-n_points // FB_TILE_ROWS)
    return tiles * sum(2 * rows * min(64, shapes[l - first][1] - 64 * kb)
                       for l, kb, rows in loads)


# A field alone backward (csrc/fields_bwd_alone.cuh) runs kernel B's block,
# ring and slab pool on one field from the field's own blob, with kernel B's
# buffer plan of that field: the pool is empty when a field starts either
# way, the sheet fits it, the warp field and the trunk spill. The fields: the
# warp field and the sheet of the translation table (layers
# MODULE_STAGES['warp'] or ['sheet'], ``hn_fused_field_bwd``), the SE(3)
# trunk (layers MODULE_STAGES['se3'] of the SE(3) table,
# ``hn_fused_se3_bwd``), the trunk with its three point-tangent streams
# (``hn_fused_se3_jacobian_bwd``: a block tile of 32 points x 4 streams,
# ``tangent_row``), and the warp field with its tangent streams, the
# translation Jacobian's backward (``hn_fused_jacobian_bwd``, the same rows;
# its cotangent in two halves has a plan of its own, 'warp_tangents'). Each
# field's record: ``code``, what
# ``hn_fused_field_bwd_plan`` takes; ``plan``, its row of FB_PLANS;
# ``stage``, its layers (a key of MODULE_STAGES); ``streams``, the rows of a
# point (with the tangents, the primal row and d / d p_k, k < 3);
# ``streamed``, the layers a block tile streams (the six hidden layers, and
# the trunk's logit). The tangents differ from the trunk alone only by their
# streams, so they share its plan code.
class FieldBwd(NamedTuple):
    code: int
    plan: str
    stage: str
    streams: int
    streamed: int


FIELD_BWD = {'warp': FieldBwd(0, 'translation', 'warp', 1, 6),
             'sheet': FieldBwd(1, 'sheet', 'sheet', 1, 6),
             'se3': FieldBwd(2, 'se3', 'se3', 1, 7),
             'se3_tangents': FieldBwd(2, 'se3', 'se3', TANGENT_STREAMS, 7),
             'warp_tangents': FieldBwd(3, 'warp_tangents', 'warp',
                                       TANGENT_STREAMS, 6)}


def tangent_row(point: int, stream: int) -> int:
    """The tile row of stream ``stream`` of point ``point`` with the
    tangent streams (csrc/level_fwd.cuh ``tan_row``; < 16 points in a
    forward tile of 64 rows, < 32 in a backward block tile of 128): row 16 w
    + 4 s + q of a warpgroup is stream s of its point 4 w + q, so a lane's
    two accumulator rows are streams s and s + 2 of one point and the primal
    row of a tangent row's point and columns is on lane & 15 of its warp."""
    return ((point >> 2) << 4) | (stream << 2) | (point & 3)


def field_bwd_spills(field: str) -> bool:
    """Whether the field alone's plan spills (and the kernel wants a
    scratch of FB_SPILL_SLABS slabs a block)."""
    return any(spill >= 0 for _, spill, _, _ in
               FB_PLANS[FIELD_BWD[field].plan])


def field_bwd_loads(field: str, shapes):
    """[(layer, box of K, box rows)]: a block tile's weight loads of the
    field alone, the layer numbered in its table (the translation table's,
    or the SE(3) table's for the trunk): its streamed layers forward, then
    backward. ``shapes`` are the field's own blob's."""
    first = MODULE_STAGES[FIELD_BWD[field].stage][0]
    n = FIELD_BWD[field].streamed
    order = list(range(n)) + list(range(n - 1, -1, -1))
    return [(first + l, kb, min(shapes[l][0], FB_STAGE_BYTES // 128))
            for l in order for kb in range(-(-shapes[l][1] // 64))]


def field_bwd_plan(field: str, shapes):
    """The compiled plan's fields of a field alone backward
    (``hn_fused_field_bwd_plan``): config, table (the field's buffer plan,
    six ints a buffer) and loads."""
    first, end = MODULE_STAGES[FIELD_BWD[field].stage]
    if len(shapes) != end - first:
        raise ValueError(f'{field}: {len(shapes)} layers, want '
                         f'{end - first}')
    return dict(config=list(FB_CONFIG),
                table=_fb_table(FIELD_BWD[field].plan),
                loads=field_bwd_loads(field, shapes))


def launch_field_bwd(field: str, fn_name: str, counted, lead, x_raw, scales,
                     g, w_blob, b_blob, shapes):
    """Launch a field alone backward on kernel B's block (``fn_name``,
    after the ``lead`` arguments) and add one to ``counted.launches``: its
    rows' grid (a point is FIELD_BWD[field].streams rows), FB_GRAD_COPIES
    zeroed gradient copies, and a per-block spill scratch where the field's
    plan spills. Returns dx_raw and the copies' sum split into (dW, db) in
    the packed layout."""
    dev, p = x_raw.device, x_raw.shape[0]
    dx_raw = torch.empty_like(x_raw)
    grads, n_w = fields_bwd_grad_copies(shapes, dev)
    if p:
        with torch.cuda.device(dev):
            blocks = build.library().hn_fused_fields_bwd_blocks(
                FIELD_BWD[field].streams * p)
        if blocks <= 0:
            raise RuntimeError('hn_fused_fields_bwd_blocks: no device')
        scratch = (torch.empty((blocks * FB_SPILL_SLABS * FB_SLAB_BYTES,),
                               dtype=torch.uint8, device=dev)
                   if field_bwd_spills(field) else None)
        common.launch(fn_name, dev, *lead, x_raw.data_ptr(), _ptr(scales),
                      g.data_ptr(), w_blob.data_ptr(), b_blob.data_ptr(),
                      dx_raw.data_ptr(), grads.data_ptr(), _ptr(scratch), p,
                      blocks)
        counted.launches += 1
    grads = grads.sum(0)
    return dx_raw, grads[:n_w], grads[n_w:]


def compiled_field_bwd_plan(field: str):
    """``field_bwd_plan``'s fields as the compiled kernel reports them
    (``hn_fused_field_bwd_plan``)."""
    return _compiled_fb_plan('hn_fused_field_bwd_plan',
                             FIELD_BWD[field].code, 1)


def field_bwd_stream_bytes(field: str, shapes, n_points: int) -> int:
    """Weight bytes one call of a field alone backward on ``n_points``
    points reads from L2: each block tile reads its loads' in-bounds bytes
    once (with the tangents a point is four rows)."""
    return _stream_bytes(field_bwd_loads(field, shapes), shapes,
                         MODULE_STAGES[FIELD_BWD[field].stage][0],
                         FIELD_BWD[field].streams * n_points)


def _f32_launch_args(level: Level, z_vals, origins, directions, embed,
                     warp_scales):
    """The float32 kernels' packed fp32 blobs of the level, checked against
    the compiled float32 table of the level (``level_table``), the table
    code and the trunk's padded window row or None, after the ray inputs
    were checked."""
    w_blob, b_blob, shapes = pack_level_f32(level)
    wt_blob = pack_level_f32(level, transposed=True)[0]
    _check_covered(level)
    f32.check_layout(shapes, warp=level_table(level))
    _check_ray_inputs(z_vals, origins, directions, embed)
    code, scales = _warp_row(level, shapes, warp_scales, z_vals.device)
    return w_blob, wt_blob, b_blob, shapes, code, scales


def _launch_forward(level: Level, z_vals, origins, directions, embed,
                    rgb_cond, want_raw_t: bool, warp_scales=None,
                    tmpl_scales=None, alpha_cond=None):
    """Launch the forward kernel; (out, raw_t or None)."""
    if _is_f32(level):
        _, wt_blob, b_blob, _, code, scales = _f32_launch_args(
            level, z_vals, origins, directions, embed, warp_scales)
        cond, tmpl_scales, alpha = f32_template_args(
            level, rgb_cond, tmpl_scales, alpha_cond, z_vals.shape[0],
            z_vals.device)
        return f32.fused_level_f32(wt_blob, b_blob, z_vals, origins,
                                   directions, embed, cond, want_raw_t, code,
                                   scales, tmpl_scales, alpha)
    w_blob, b_blob, shapes = pack_level(level)
    dev = z_vals.device
    code, scales = _warp_launch_args(level, shapes, warp_scales, dev)
    tmpl_scales = kernel_scales(level, tmpl_scales, dev)
    r, s = z_vals.shape
    _check_ray_inputs(z_vals, origins, directions, embed)
    rgbc, alphac, aw = cond_args(level, rgb_cond, alpha_cond, r, dev)
    out = torch.empty((r * s, 4), dtype=torch.float32, device=dev)
    raw_t = torch.empty((r * s, raw_pad(level)), dtype=torch.float32,
                        device=dev) if want_raw_t else None
    common.launch('hn_fused_level_fwd', dev, code, z_vals.data_ptr(),
                  origins.data_ptr(), directions.data_ptr(), embed.data_ptr(),
                  rgbc.data_ptr(), _ptr(alphac), _ptr(aw), _ptr(scales),
                  _ptr(tmpl_scales), w_blob.data_ptr(), b_blob.data_ptr(),
                  out.data_ptr(), _ptr(raw_t), r, s, rgbc.shape[1])
    fused_level.launches += 1
    return out, raw_t


def _check_ray_inputs(z_vals, origins, directions, embed) -> None:
    r, s = z_vals.shape
    for name, t, shape in (('z_vals', z_vals, (r, s)),
                           ('origins', origins, (r, 3)),
                           ('directions', directions, (r, 3)),
                           ('embed', embed, (r, FLAGSHIP['embed']))):
        build.check_tensor(name, t, shape, torch.float32, z_vals.device)


def _forward(level: Level, z_vals, origins, directions, embed, rgb_cond,
             want_raw_t: bool, warp_scales=None, tmpl_scales=None,
             alpha_cond=None):
    """(out, raw_t or None): the plain version on CPU tensors, the kernel on
    CUDA tensors."""
    if common.runs_plain(z_vals, 'fused_level'):
        res = fused_level_plain(level, z_vals, origins, directions, embed,
                                rgb_cond, return_raw_t=want_raw_t,
                                warp_scales=warp_scales,
                                tmpl_scales=tmpl_scales,
                                alpha_cond=alpha_cond)
        return res if want_raw_t else (res, None)
    return _launch_forward(level, z_vals, origins, directions, embed,
                           rgb_cond, want_raw_t, warp_scales, tmpl_scales,
                           alpha_cond)


def fused_level(level: Level, z_vals, origins, directions, embed,
                rgb_cond, warp_scales=None, tmpl_scales=None,
                alpha_cond=None) -> torch.Tensor:
    """Level forward; (R * S, 4) fp32 [rgb logits | raw sigma].

    CPU tensors take ``fused_level_plain``; CUDA tensors launch the kernel
    (flagship widths, any template layout, bf16) or raise.
    Differentiable in every argument (``alpha_cond``: the per-ray alpha
    condition, or None) and in the level's parameters (``FusedLevelFn``);
    the window rows are schedule constants.
    """
    params = _level_params(level)
    inputs = (z_vals, origins, directions, embed, rgb_cond)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (*inputs, alpha_cond, *params)):
        return FusedLevelFn.apply(level, warp_scales, tmpl_scales, *inputs,
                                  alpha_cond, *params)
    return _forward(level, *inputs, want_raw_t=False,
                    warp_scales=warp_scales, tmpl_scales=tmpl_scales,
                    alpha_cond=alpha_cond)[0]


fused_level.launches = 0


class FusedLevelFn(torch.autograd.Function):
    """The level with its hand-written backward: the forward keeps the
    inputs and ``raw_t``; the backward runs the template backward, then the
    fields backward on its ``dx_t``. Gradients of ``warp`` and ``hyper``
    parameters shared by two levels add up in autograd."""

    @staticmethod
    def forward(ctx, level, warp_scales, tmpl_scales, z_vals, origins,
                directions, embed, rgb_cond, alpha_cond, *params):
        inputs = [t.detach() for t in (z_vals, origins, directions, embed,
                                       rgb_cond)]
        alpha_cond = None if alpha_cond is None else alpha_cond.detach()
        with torch.no_grad():
            out, raw_t = _forward(level, *inputs, want_raw_t=True,
                                  warp_scales=warp_scales,
                                  tmpl_scales=tmpl_scales,
                                  alpha_cond=alpha_cond)
        ctx.level, ctx.warp_scales = level, warp_scales
        ctx.tmpl_scales, ctx.alpha_cond = tmpl_scales, alpha_cond
        ctx.save_for_backward(*inputs, raw_t)
        return out

    @staticmethod
    def backward(ctx, g):
        z_vals, origins, directions, embed, rgb_cond, raw_t = \
            ctx.saved_tensors
        level, alpha_cond = ctx.level, ctx.alpha_cond
        g = g.contiguous()
        with torch.no_grad():
            dx_t, d_rgb_cond, t_grads, d_alpha = fused_template_bwd(
                level, raw_t, rgb_cond, g, ctx.tmpl_scales, alpha_cond)
            d_z, d_o, d_d, d_embed, f_grads = fused_fields_bwd(
                level, z_vals, origins, directions, embed, dx_t,
                ctx.warp_scales)
        if d_alpha is not None:
            d_alpha = d_alpha.to(alpha_cond.dtype)
        return (None, None, None, d_z, d_o, d_d, d_embed,
                d_rgb_cond.to(rgb_cond.dtype), d_alpha, *f_grads, *t_grads)


# ---------------------------------------------------------------------------
# The fields backward: plain version and kernel wrapper. (The template
# backward is ``fused_mlp.fused_template_bwd``.)


def fused_fields_bwd_plain(level: Level, z_vals, origins, directions, embed,
                           dx_t, warp_scales=None):
    """Plain fields backward: the plain backward of the warp field and of the
    hyper sheet (``fused_field_bwd_plain``) from ``dx_t``, then the rays'.
    With the SE(3) or the quaternion warp: the retraction's hand-derived VJP
    from d warped to (d w, d v, d points), then the plain trunk backward
    (``fused_se3_bwd_plain``) from [d w | d v]; the points get no residual
    part. Without a sheet (the plane configuration) d hyper, dx_t[:, 3:11],
    is added to the warp field's d embed, as the JAX kernel's
    ``d_emb = d_emb_w + d_hyper``.

    Args:
      dx_t: (P, 8) fp32 cotangent of [warped | hyper | 0] ((P, 16) without a
        sheet).

    Returns:
      d z_vals (R, S), d origins, d directions (R, 3), d embed (R, E), and
      [dW, db, ...] of the warp then the hyper layers in kernel order.
    """
    fused_fields_bwd_plain.calls += 1
    _check_sheet(level)
    r, s = z_vals.shape
    x_raw = _raw_fields(z_vals, origins, directions, embed)
    if _screw(level):
        wv = fused_se3_plain(level.warp, x_raw, warp_scales)
        d_w, d_v, d_direct = level.warp.retract_bwd(
            wv[:, :3], wv[:, 3:], x_raw[:, :3].to(wv.dtype), dx_t[:, :3])
        dx_w, grads_w = fused_se3_bwd_plain(
            level.warp, x_raw, F.pad(torch.cat([d_w, d_v], dim=-1), (0, 2)),
            warp_scales)
    else:
        d_direct = dx_t[:, :3]
        dx_w, grads_w = fused_field_bwd_plain(
            level.warp.mlp, level.warp.n_freq, x_raw, dx_t[:, :3])
    e = embed.shape[-1]
    if level.hyper is None:  # the embedding is the hyper coordinates
        d_pts = (d_direct + dx_w[:, :3]).reshape(r, s, 3)
        d_emb = (dx_w[:, 3:] + dx_t[:, 3:3 + e]).reshape(r, s, -1)
        grads_h = []
    else:
        n_hyper = level.hyper.mlp.logit.out_features
        dx_h, grads_h = fused_field_bwd_plain(
            level.hyper.mlp, level.hyper.n_freq, x_raw,
            dx_t[:, 3:3 + n_hyper])
        d_pts = ((d_direct + dx_w[:, :3]) + dx_h[:, :3]).reshape(r, s, 3)
        d_emb = (dx_w[:, 3:] + dx_h[:, 3:]).reshape(r, s, -1)
    d_z = (d_pts * directions[:, None, :]).sum(-1)
    d_o = d_pts.sum(1)
    d_d = (d_pts * z_vals[..., None]).sum(1)
    return d_z, d_o, d_d, d_emb.sum(1), grads_w + grads_h


fused_fields_bwd_plain.calls = 0


def fused_fields_bwd(level: Level, z_vals, origins, directions, embed, dx_t,
                     warp_scales=None):
    """Fields backward (see ``fused_fields_bwd_plain``): CPU tensors take
    the plain version, CUDA tensors launch kernel B (``csrc/fields_bwd.cuh``,
    whose plan ``fields_bwd_plan`` models) or raise. The kernel reads the
    level's one weight blob (``pack_level``) and spills the warp field's
    first layer outputs to a per-block scratch it is given."""
    if common.runs_plain(z_vals, 'fused_fields_bwd'):
        return fused_fields_bwd_plain(level, z_vals, origins, directions,
                                      embed, dx_t, warp_scales)
    if _is_f32(level):
        return _fields_bwd_f32(level, z_vals, origins, directions, embed,
                               dx_t, warp_scales)
    w_blob, b_blob, shapes = pack_level(level)
    dev, f32 = z_vals.device, torch.float32
    code, scales = _warp_launch_args(level, shapes, warp_scales, dev)
    r, s = z_vals.shape
    _check_ray_inputs(z_vals, origins, directions, embed)
    build.check_tensor('dx_t', dx_t, (r * s, raw_pad(level)), f32, dev)
    nf = _n_field_layers(level)
    with torch.cuda.device(dev):
        blocks = build.library().hn_fused_fields_bwd_blocks(r * s)
    if blocks <= 0:
        raise RuntimeError('hn_fused_fields_bwd_blocks: no device')
    d_z = torch.empty((r, s), dtype=f32, device=dev)
    # [d origins (3) | d directions (3) | d embed (8)] per ray, added to by
    # every tile that holds samples of the ray.
    d_ray = torch.zeros((r, 6 + FLAGSHIP['embed']), dtype=f32, device=dev)
    # [dW | db] in the packed layout; every block adds its tiles' into one
    # of the copies.
    grads, n_w = fields_bwd_grad_copies(shapes[:nf], dev)
    # The per-block slabs the plan spills the warp's first layers to.
    scratch = torch.empty((blocks * FB_SPILL_SLABS * FB_SLAB_BYTES,),
                          dtype=torch.uint8, device=dev)
    common.launch('hn_fused_fields_bwd', dev, code, z_vals.data_ptr(),
                  origins.data_ptr(), directions.data_ptr(), embed.data_ptr(),
                  dx_t.data_ptr(), _ptr(scales), w_blob.data_ptr(),
                  b_blob.data_ptr(), d_z.data_ptr(), d_ray.data_ptr(),
                  grads.data_ptr(), scratch.data_ptr(), r, s, blocks)
    fused_fields_bwd.launches += 1
    grads = grads.sum(0)
    layers = level_layers(level)[:nf]
    return (d_z, d_ray[:, :3].contiguous(), d_ray[:, 3:6].contiguous(),
            d_ray[:, 6:].contiguous(),
            common.unpack_grads(grads[:n_w], grads[n_w:], layers,
                                shapes[:nf]))


fused_fields_bwd.launches = 0


def _fields_bwd_f32(level: Level, z_vals, origins, directions, embed, dx_t,
                    warp_scales):
    """Kernel B at float32 (``f32.fused_fields_bwd_f32``) on the field
    layers of the level's fp32 blobs; returns as ``fused_fields_bwd``."""
    w_blob, wt_blob, b_blob, shapes, code, scales = _f32_launch_args(
        level, z_vals, origins, directions, embed, warp_scales)
    r, s = z_vals.shape
    build.check_tensor('dx_t', dx_t, (r * s, raw_pad(level)), torch.float32,
                       z_vals.device)
    nf = _n_field_layers(level)
    d_z, d_ray, grads = f32.fused_fields_bwd_f32(
        w_blob, wt_blob, b_blob, shapes[:nf], z_vals, origins, directions,
        embed, dx_t, code, scales)
    n_w = sum(n * k for n, k in shapes[:nf])
    layers = level_layers(level)[:nf]
    return (d_z, d_ray[:, :3].contiguous(), d_ray[:, 3:6].contiguous(),
            d_ray[:, 6:].contiguous(),
            common.unpack_grads(grads[:n_w], grads[n_w:], layers,
                                shapes[:nf]))
