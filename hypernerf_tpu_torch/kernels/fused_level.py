"""One level: warp field + hyper sheet + template for every sample, forward
and backward. The warp field is the translation field, or the SE(3) or the
quaternion field (the trunk of ``fused_se3``, then the retraction inside the
kernels); ``warp_scales`` is the latter two's optional ``warp_alpha`` window
row (``fused_se3.se3_encoding_scales``; a row of ones and None give the same
numbers).

``fused_level`` is the wrapper. On CUDA tensors it launches the hand-written
Hopper kernel of ``csrc/level_fwd.cuh`` (one source per warp type,
``level_fwd_{trans,se3,quat}.cu``, behind the entry point of
``csrc/fused_level.cu``; it replaces the TPU kernel
``hypernerf_tpu/ops/pallas/fused_level.py`` ``_fused``); on CPU tensors it
runs ``fused_level_plain``, the same function composed from this package's
modules, whose rounding points are the kernel's (models/modules.py). On a
CUDA tensor it launches the kernel or raises. ``forward_plan`` models the
kernel's tiles, column plan and weight stream in Python, ``fields_bwd_plan``
kernel B's.

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
from typing import NamedTuple, Union

import torch
import torch.nn.functional as F

from hypernerf_tpu_torch.kernels import build, common
from hypernerf_tpu_torch.kernels.fused_field import (field_layers,
                                                     fused_field_bwd_plain,
                                                     fused_field_plain)
from hypernerf_tpu_torch.kernels.fused_mlp import (fused_template_bwd,
                                                   fused_template_bwd_plain,
                                                   fused_template_plain,
                                                   template_layers)
from hypernerf_tpu_torch.kernels.fused_se3 import (check_covered as
                                                   _check_se3_covered,
                                                   fused_se3_bwd_plain,
                                                   fused_se3_plain,
                                                   se3_layers)
from hypernerf_tpu_torch.models.modules import HyperSheetMLP, NerfMLP
from hypernerf_tpu_torch.models.warping import SE3Field, TranslationField

FLAGSHIP = common.FLAGSHIP
RAW_T_PAD = 8  # columns of raw_t and dx_t: [warped (3) | hyper (4) | 0]


class Level(NamedTuple):
    """The modules of one level and the template's encoding bands."""
    warp: Union[TranslationField, SE3Field]  # or its QuaternionField
    hyper: HyperSheetMLP
    template: NerfMLP
    xyz_freq: int
    hyper_freq: int


def _raw_fields(z_vals, origins, directions, embed):
    """(P, 3 + E) fp32 raw rows [o + z d | the ray's embedding]."""
    r, s = z_vals.shape
    pts = origins[:, None, :] + z_vals[..., None] * directions[:, None, :]
    emb = embed[:, None, :].expand(r, s, embed.shape[-1])
    return torch.cat([pts, emb.to(pts.dtype)], dim=-1).reshape(r * s, -1)


def _screw(level: Level) -> bool:
    """Whether the level's warp is the SE(3) or the quaternion field."""
    return level.warp.kind != 'translation'


def _warp_owner_layers(level: Level):
    """(the module that owns the warp's packed blobs, its layers)."""
    if _screw(level):
        return level.warp, se3_layers(level.warp)
    return level.warp.mlp, field_layers(level.warp.mlp)


def fused_level_plain(level: Level, z_vals, origins, directions, embed,
                      rgb_cond, return_raw_t: bool = False, warp_scales=None):
    """Plain PyTorch level forward: the plain warp field (or the plain SE(3)
    trunk and the retraction's values), hyper sheet and template
    (``fused_field_plain``, ``fused_se3_plain``, ``fused_template_plain``)
    chained.

    Args:
      z_vals: (R, S) depths; origins / directions: (R, 3); embed: (R, E)
        per-ray warp/hyper embedding; rgb_cond: (R, C) per-ray condition.

    Returns:
      (R * S, 4) fp32 [rgb logits (3) | raw sigma]; with ``return_raw_t``
      also the template's raw input (R * S, 8) fp32 [warped | hyper | 0].
    """
    fused_level_plain.calls += 1
    if level.hyper.use_residual:
        raise NotImplementedError(common.NOT_COVERED + '; the sheet\'s '
                                  'residual runs on the per-module path')
    x_raw = _raw_fields(z_vals, origins, directions, embed)
    if _screw(level):
        wv = fused_se3_plain(level.warp, x_raw, warp_scales).to(x_raw.dtype)
        warped = level.warp.retract(wv[:, :3], wv[:, 3:], x_raw[:, :3])
    else:
        warped = x_raw[:, :3] + fused_field_plain(
            level.warp.mlp, level.warp.n_freq, x_raw).to(x_raw.dtype)
    hyper = fused_field_plain(level.hyper.mlp, level.hyper.n_freq, x_raw)
    raw_t = torch.cat([warped, hyper], dim=-1).float()
    raw_t = F.pad(raw_t, (0, RAW_T_PAD - raw_t.shape[-1]))
    out = fused_template_plain(level, raw_t, rgb_cond)
    return (out, raw_t) if return_raw_t else out


fused_level_plain.calls = 0


def level_layers(level: Level):
    """Every Linear of the level in kernel order with its input segments."""
    return (_warp_owner_layers(level)[1] + field_layers(level.hyper.mlp)
            + template_layers(level.template))


def _check_covered(level: Level) -> None:
    t = level.template
    flagship = dict(FLAGSHIP)
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
    have.update(hyper_sheet_freq=level.hyper.n_freq,
                hyper_out=level.hyper.mlp.logit.out_features,
                xyz_freq=level.xyz_freq, hyper_freq=level.hyper_freq,
                rgb_cond=t.rgb_branch.hidden(0).in_features
                - t.bottleneck.out_features)
    dtypes = {m.dtype for m in (warp_mlp, level.hyper.mlp, t.trunk,
                                t.rgb_branch)} | {t.dtype}
    if (have != flagship or dtypes != {torch.bfloat16}
            or level.hyper.use_residual):
        raise NotImplementedError(f'{common.NOT_COVERED}; got {have}, '
                                  f'{dtypes}')


def pack_level(level: Level):
    """The level kernels' bf16 weight and bias blobs and the (n_pad, k_pad)
    of each layer: the three modules' own packed blobs
    (``common.pack_layers``, cached on each module and following its
    parameters' version counters, so the warp and the sheet that two levels
    share are packed once) joined, the joined blobs cached on the template.
    """
    check = lambda: _check_covered(level)
    subs = [common.packed(owner, layers, check) for owner, layers in (
        _warp_owner_layers(level),
        (level.hyper.mlp, field_layers(level.hyper.mlp)),
        (level.template, template_layers(level.template)))]
    key = tuple(sub['key'] for sub in subs)
    cached = getattr(level.template, '_packed_level', None)
    if cached is None or cached['key'] != key:
        check()
        pairs = [pair for sub in subs for pair in sub['packed']]
        cached = dict(
            key=key, packed=pairs,
            shapes=[shape for sub in subs for shape in sub['shapes']],
            w=torch.cat([sub['w'] for sub in subs]),
            b=torch.cat([sub['b'] for sub in subs]))
        object.__setattr__(level.template, '_packed_level', cached)
    return cached['w'], cached['b'], cached['shapes']


def _level_params(level: Level):
    """[weight, bias] of every Linear of the level, in kernel order."""
    return common.layer_params(level_layers(level))


def _n_field_layers(level: Level) -> int:
    return len(_warp_owner_layers(level)[1]) + level.hyper.mlp.depth + 1


def _warp_launch_args(level: Level, shapes, warp_scales, dev):
    """(the warp type's code, the padded window row or None) for a level
    kernel, after the packed ``shapes`` were checked against that type's
    compiled table."""
    kind = level.warp.kind
    common.check_layout(shapes, slice(None), kind)
    if not _screw(level):
        if warp_scales is not None:
            raise ValueError('the translation warp takes no window row')
        return common.WARP_CODES[kind], None
    return common.WARP_CODES[kind], common.padded_scales(
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
# 128-row half of N.
FWD_TILE_ROWS, FWD_GROUPS, FWD_STAGES = 64, 2, 6
FWD_BOX_COLS, FWD_STAGE_ROWS, FWD_TILE_COLS = 64, 128, 384
FWD_STAGE_BYTES = FWD_STAGE_ROWS * 2 * FWD_BOX_COLS
FWD_THREADS = 128 * (FWD_GROUPS + 1)
# Per-row fp32 scratch of a warpgroup: in (12), raw (8), head (8), sigma,
# ray.
FWD_ROW_BYTES = 4 * (12 + 8 + 8 + 1 + 1)
# Every layer's bf16 bias, kept in shared memory: the SE(3) table's 4264.
FWD_BIAS_BYTES = 2 * 4264
FWD_SMEM_BYTES = (1024 + FWD_GROUPS * FWD_TILE_ROWS * 2 * FWD_TILE_COLS
                  + FWD_STAGES * FWD_STAGE_BYTES
                  + FWD_GROUPS * FWD_TILE_ROWS * FWD_ROW_BYTES
                  + FWD_BIAS_BYTES + 2 * FWD_STAGES * 8)
# The tile's column plan: where each field's encoding (and the rgb
# condition) sits; a hidden layer writes [0, n), its input starts at 0
# unless it is a field's first layer, which reads the encoding.
FWD_ENC_COL = dict(warp=128, hyper=64, template=256, cond=128)


def forward_in_cols(warp: str = 'translation'):
    """The first tile column of every layer's input, in layer order."""
    h0 = 7 if warp == 'translation' else 9  # the sheet's first layer
    cols = [0] * (h0 + 7 + 16)
    cols[0], cols[h0], cols[h0 + 7] = (FWD_ENC_COL['warp'],
                                       FWD_ENC_COL['hyper'],
                                       FWD_ENC_COL['template'])
    return cols


def forward_loads(shapes):
    """[(layer, box of K, half of N, box rows)]: the weight loads of one
    pair of row tiles, in the producer's (and the consumers') order: each
    layer's 64-column boxes of K, each as its 128-row halves of N."""
    return [(l, kb, nb, min(n, FWD_STAGE_ROWS))
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


def forward_plan(warp: str, shapes):
    """The compiled plan's fields (``hn_fused_level_fwd_plan``): config,
    in_cols and loads."""
    config = [FWD_TILE_ROWS, FWD_GROUPS, FWD_STAGES, FWD_STAGE_BYTES,
              FWD_SMEM_BYTES, FWD_THREADS, FWD_TILE_COLS,
              len(forward_maps(shapes))]
    return dict(config=config, in_cols=forward_in_cols(warp),
                loads=forward_loads(shapes))


def compiled_forward_plan(warp: str = 'translation'):
    """``forward_plan``'s fields as the compiled kernel reports them
    (``hn_fused_level_fwd_plan``)."""
    n_layers = len(common.kernel_layout(warp))
    config = (ctypes.c_int * 8)()
    in_cols = (ctypes.c_int * n_layers)()
    max_loads = 1024
    loads = (ctypes.c_int * (4 * max_loads))()
    n = build.library().hn_fused_level_fwd_plan(
        common.WARP_CODES[warp], ctypes.addressof(config),
        ctypes.addressof(in_cols), ctypes.addressof(loads), max_loads)
    if not 0 <= n <= max_loads:
        raise RuntimeError(f'hn_fused_level_fwd_plan: {n} loads')
    return dict(config=list(config), in_cols=list(in_cols),
                loads=[tuple(loads[4 * i:4 * i + 4]) for i in range(n)])


def forward_stream_bytes(shapes, n_points: int) -> int:
    """Weight bytes one call reads from L2: each block reads the whole blob
    (in-bounds bytes; a box's zero fill is not read) once per pair of row
    tiles."""
    tiles = -(-n_points // FWD_TILE_ROWS)
    return -(-tiles // FWD_GROUPS) * sum(2 * n * k for n, k in shapes)


# Kernel B's plan (csrc/fields_bwd.cuh), modelled here for the tests and for
# chip_smoke.py, which holds it to the compiled one
# (``hn_fused_fields_bwd_plan``). A block tile is FB_TILE_ROWS rows, FB_GROUPS
# consumer warpgroups of 64 rows each; a field's stored layer outputs live
# in a pool of FB_SLOTS slabs (64 bf16 columns x 128 rows, FB_SLAB_BYTES), one
# slab per 64-column box; the weights stream by TMA through a ring of
# FB_STAGES stages, one 64-column box of K of a layer a stage.
FB_TILE_ROWS, FB_GROUPS, FB_STAGES, FB_SLOTS = 128, 2, 4, 8
FB_SLAB_BYTES = FB_STAGE_BYTES = 128 * 128
FB_SPILL_SLABS = 8  # device-memory scratch slabs a block
FB_GRAD_COPIES = 4  # gradient buffers: block b adds into copy b % 4
FB_THREADS = 128 * (FB_GROUPS + 1)
# Per-row fp32 scratch: in (12), z | direction (4), acc (20), a head's
# cotangent (8), the SE(3) rows (16), and the ray (int).
FB_ROWS_BYTES = FB_TILE_ROWS * 4 * (12 + 4 + 20 + 8 + 16 + 1)
FB_BUFS = ('enc', 'h0', 'h1', 'h2', 'h3', 'h4', 'h5', 'T', 'skip')
FB_SMEM_BYTES = (1024 + FB_SLOTS * FB_SLAB_BYTES + FB_STAGES * FB_STAGE_BYTES
                 + FB_ROWS_BYTES + (2 * FB_STAGES + len(FB_BUFS)) * 8)
# Where each buffer of a field lives (csrc/fields_bwd.cuh ``buf_plan``):
# (forward slots per 64-column box, the scratch slab its first box is
# spilled to as it is written or -1, the walk-back layer after which it is
# reloaded or -1, the reload slots). A cotangent g_i overwrites h_i, d enc
# the encoding where layer 0 reads it; 'skip' holds the skip layer's part of
# d enc.
_NONE = ((-1, -1), -1, -1, (-1, -1))
FB_PLANS = {
    'sheet': [((s, -1), -1, -1, (-1, -1)) for s in range(7)]
    + [_NONE, ((7, -1), -1, -1, (-1, -1))],
    'translation': [((0, 1), 0, 2, (6, 7)), ((2, 3), 2, 3, (2, 3)),
                    ((4, 5), 4, 4, (4, 5)), ((6, 7), 6, 5, (6, 7)),
                    ((2, 3), -1, -1, (-1, -1)), ((4, 5), -1, -1, (-1, -1)),
                    ((6, 7), -1, -1, (-1, -1)), _NONE,
                    ((0, 1), -1, -1, (-1, -1))],
    'se3': [((0, -1), -1, -1, (-1, -1)), ((1, 2), 0, 3, (6, 7)),
            ((3, 4), 2, 4, (2, 3)), ((5, 6), 4, 5, (4, 5)),
            ((7, 1), 6, 6, (6, 7)), ((2, 3), -1, -1, (-1, -1)),
            ((4, 5), -1, -1, (-1, -1)), ((6, 7), -1, -1, (-1, -1)),
            ((1, -1), -1, -1, (-1, -1))],
}


def _warp_field(warp: str) -> str:
    return 'translation' if warp == 'translation' else 'se3'


def fields_bwd_loads(warp: str, shapes):
    """[(layer, box of K, box rows)]: a block tile's weight loads in the
    producer's (and the consumers') order: the sheet's six hidden layers
    forward, then backward, then the warp's (the SE(3) trunk's seven)."""
    h0 = 7 if warp == 'translation' else 9
    nw = 6 if warp == 'translation' else 7
    order = ([h0 + i for i in range(6)] + [h0 + i for i in range(5, -1, -1)]
             + list(range(nw)) + list(range(nw - 1, -1, -1)))
    return [(l, kb, min(shapes[l][0], FB_STAGE_BYTES // 128))
            for l in order for kb in range(-(-shapes[l][1] // 64))]


def fields_bwd_plan(warp: str, shapes):
    """The compiled plan's fields (``hn_fused_fields_bwd_plan``): config,
    table (the sheet's buffer plan, then the warp field's, six ints a
    buffer) and loads."""
    config = [FB_TILE_ROWS, FB_GROUPS, FB_STAGES, FB_STAGE_BYTES,
              FB_SMEM_BYTES, FB_THREADS, FB_SLOTS, FB_SPILL_SLABS,
              FB_GRAD_COPIES]
    table = [v for field in ('sheet', _warp_field(warp))
             for fwd, spill, after, reload in FB_PLANS[field]
             for v in (*fwd, spill, after, *reload)]
    return dict(config=config, table=table,
                loads=fields_bwd_loads(warp, shapes))


def compiled_fields_bwd_plan(warp: str = 'translation'):
    """``fields_bwd_plan``'s fields as the compiled kernel reports them
    (``hn_fused_fields_bwd_plan``)."""
    config = (ctypes.c_int * 9)()
    table = (ctypes.c_int * (2 * 6 * len(FB_BUFS)))()
    max_loads = 256
    loads = (ctypes.c_int * (3 * max_loads))()
    n = build.library().hn_fused_fields_bwd_plan(
        common.WARP_CODES[warp], ctypes.addressof(config),
        ctypes.addressof(table), ctypes.addressof(loads), max_loads)
    if not 0 <= n <= max_loads:
        raise RuntimeError(f'hn_fused_fields_bwd_plan: {n} loads')
    return dict(config=list(config), table=list(table),
                loads=[tuple(loads[3 * i:3 * i + 3]) for i in range(n)])


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
    tiles = -(-n_points // FB_TILE_ROWS)
    return tiles * sum(2 * rows * min(64, shapes[l][1] - 64 * kb)
                       for l, kb, rows in fields_bwd_loads(warp, shapes))


def _launch_forward(level: Level, z_vals, origins, directions, embed,
                    rgb_cond, want_raw_t: bool, warp_scales=None):
    """Launch the forward kernel; (out, raw_t or None)."""
    w_blob, b_blob, shapes = pack_level(level)
    dev = z_vals.device
    code, scales = _warp_launch_args(level, shapes, warp_scales, dev)
    r, s = z_vals.shape
    rgbc = rgb_cond.detach().to(torch.bfloat16).contiguous()
    _check_ray_inputs(z_vals, origins, directions, embed)
    build.check_tensor('rgb_cond', rgbc, (r, FLAGSHIP['rgb_cond']),
                       torch.bfloat16, dev)
    out = torch.empty((r * s, 4), dtype=torch.float32, device=dev)
    raw_t = torch.empty((r * s, RAW_T_PAD), dtype=torch.float32,
                        device=dev) if want_raw_t else None
    common.launch('hn_fused_level_fwd', dev, code, z_vals.data_ptr(),
                  origins.data_ptr(), directions.data_ptr(), embed.data_ptr(),
                  rgbc.data_ptr(), _ptr(scales), w_blob.data_ptr(),
                  b_blob.data_ptr(),
                  out.data_ptr(), _ptr(raw_t),
                  r, s)
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
             want_raw_t: bool, warp_scales=None):
    """(out, raw_t or None): the plain version on CPU tensors, the kernel on
    CUDA tensors."""
    if common.runs_plain(z_vals, 'fused_level'):
        res = fused_level_plain(level, z_vals, origins, directions, embed,
                                rgb_cond, return_raw_t=want_raw_t,
                                warp_scales=warp_scales)
        return res if want_raw_t else (res, None)
    return _launch_forward(level, z_vals, origins, directions, embed,
                           rgb_cond, want_raw_t, warp_scales)


def fused_level(level: Level, z_vals, origins, directions, embed,
                rgb_cond, warp_scales=None) -> torch.Tensor:
    """Level forward; (R * S, 4) fp32 [rgb logits | raw sigma].

    CPU tensors take ``fused_level_plain``; CUDA tensors launch the kernel
    (flagship widths, bf16) or raise. Differentiable in every argument and
    in the level's parameters (``FusedLevelFn``).
    """
    params = _level_params(level)
    inputs = (z_vals, origins, directions, embed, rgb_cond)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (*inputs, *params)):
        return FusedLevelFn.apply(level, warp_scales, *inputs, *params)
    return _forward(level, *inputs, want_raw_t=False,
                    warp_scales=warp_scales)[0]


fused_level.launches = 0


class FusedLevelFn(torch.autograd.Function):
    """The level with its hand-written backward: the forward keeps the
    inputs and ``raw_t``; the backward runs the template backward, then the
    fields backward on its ``dx_t``. Gradients of ``warp`` and ``hyper``
    parameters shared by two levels add up in autograd."""

    @staticmethod
    def forward(ctx, level, warp_scales, z_vals, origins, directions, embed,
                rgb_cond, *params):
        inputs = [t.detach() for t in (z_vals, origins, directions, embed,
                                       rgb_cond)]
        with torch.no_grad():
            out, raw_t = _forward(level, *inputs, want_raw_t=True,
                                  warp_scales=warp_scales)
        ctx.level, ctx.warp_scales = level, warp_scales
        ctx.save_for_backward(*inputs, raw_t)
        return out

    @staticmethod
    def backward(ctx, g):
        z_vals, origins, directions, embed, rgb_cond, raw_t = \
            ctx.saved_tensors
        level = ctx.level
        g = g.contiguous()
        with torch.no_grad():
            dx_t, d_rgb_cond, t_grads = fused_template_bwd(level, raw_t,
                                                           rgb_cond, g)
            d_z, d_o, d_d, d_embed, f_grads = fused_fields_bwd(
                level, z_vals, origins, directions, embed, dx_t,
                ctx.warp_scales)
        return (None, None, d_z, d_o, d_d, d_embed,
                d_rgb_cond.to(rgb_cond.dtype), *f_grads, *t_grads)


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
    part.

    Args:
      dx_t: (P, 8) fp32 cotangent of [warped | hyper | 0].

    Returns:
      d z_vals (R, S), d origins, d directions (R, 3), d embed (R, E), and
      [dW, db, ...] of the warp then the hyper layers in kernel order.
    """
    fused_fields_bwd_plain.calls += 1
    if level.hyper.use_residual:
        raise NotImplementedError(common.NOT_COVERED + '; the sheet\'s '
                                  'residual runs on the per-module path')
    r, s = z_vals.shape
    x_raw = _raw_fields(z_vals, origins, directions, embed)
    n_hyper = level.hyper.mlp.logit.out_features
    if _screw(level):
        wv = fused_se3_plain(level.warp, x_raw, warp_scales)
        d_w, d_v, d_direct = level.warp.retract_bwd(
            wv[:, :3], wv[:, 3:], x_raw[:, :3].float(), dx_t[:, :3])
        dx_w, grads_w = fused_se3_bwd_plain(
            level.warp, x_raw, F.pad(torch.cat([d_w, d_v], dim=-1), (0, 2)),
            warp_scales)
    else:
        d_direct = dx_t[:, :3]
        dx_w, grads_w = fused_field_bwd_plain(
            level.warp.mlp, level.warp.n_freq, x_raw, dx_t[:, :3])
    dx_h, grads_h = fused_field_bwd_plain(
        level.hyper.mlp, level.hyper.n_freq, x_raw, dx_t[:, 3:3 + n_hyper])
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
    w_blob, b_blob, shapes = pack_level(level)
    dev, f32 = z_vals.device, torch.float32
    code, scales = _warp_launch_args(level, shapes, warp_scales, dev)
    r, s = z_vals.shape
    _check_ray_inputs(z_vals, origins, directions, embed)
    build.check_tensor('dx_t', dx_t, (r * s, RAW_T_PAD), f32, dev)
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
