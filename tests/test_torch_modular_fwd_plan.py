"""The per-module forward kernels' plan (``csrc/modular_fwd.cu``: a field
alone and the template alone, each one stage of the level forward of
``csrc/level_fwd.cuh`` run on its block; modelled by
``fused_level.stage_plan``) on the CPU: the tensor maps over each module's
own packed blob, each stage's column plan in the 384-column tile, the
window row's columns, the weight stream through the ring for row counts
that are no multiple of a pair of tiles, the level's schedule as its
stages' schedules in turn, shared memory, and the C entry points' ctypes
signatures.

The card holds each compiled stage plan to this model (``chip_smoke.py``
phase 8, ``compiled_stage_plan``) and the kernels' numbers to their plain
versions and to the level kernel; these tests hold the model to the rules
the kernels rely on. All checks are exact.
"""

import ctypes
import importlib
import re

import numpy as np
import pytest
import torch

from hypernerf_tpu_torch.flagship import flagship_model, load_probe_weights
from hypernerf_tpu_torch.kernels import build, common
from hypernerf_tpu_torch.kernels.fused_level import (
    FWD_BIAS_BYTES, FWD_BOX_COLS, FWD_SMEM_BYTES, FWD_STAGE_ROWS,
    FWD_TILE_COLS, FWD_TILE_ROWS, MODULE_BLOCKS, MODULE_STAGE_CODES,
    MODULE_STAGES, forward_in_cols, forward_loads, forward_maps,
    forward_plan, forward_stream_bytes, fwd_smem_bytes, pack_level,
    stage_plan)
from test_torch_level_fwd_plan import (CONDITIONS, _RecordingLibrary,
                                      _run_ring, _tma_box)

ff = importlib.import_module('hypernerf_tpu_torch.kernels.fused_field')
fl_module = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
fm = importlib.import_module('hypernerf_tpu_torch.kernels.fused_mlp')

# The stages of the translation table; the SE(3) trunk's stage is held in
# test_torch_se3_stage_plan.py. 'template_plane' is the plane configuration's
# template alone (layers 7..22 of its table, a block of two 448-column tiles
# and a ring of 5 stages), 'template_nerfies_plane' the plane_anneal
# configuration's (layers 7..22 of its table, the level's block).
STAGES = ['warp', 'sheet', 'template']
PLANE_STAGES = {'template_plane': 'plane',
                'template_nerfies_plane': 'plane_anneal'}
ALL_STAGES = STAGES + list(PLANE_STAGES)
SMS = 132  # an H100's SMs: the persistent grid's width


def _probe(config='flagship'):
    return load_probe_weights(flagship_model('cpu', config=config))


def _config(stage):
    return PLANE_STAGES.get(stage, 'flagship')


def _stage_owner(stage, config=None):
    """(module that owns the stage's blob, its layers) as the wrappers pack
    them."""
    probe = _probe(config or _config(stage))
    if stage.startswith('template'):
        template = probe._template('fine')
        return template, fm.kernel_template_layers(template)
    mlp = (probe.warp_field if stage == 'warp' else probe.hyper_sheet_mlp).mlp
    return mlp, ff.field_layers(mlp)


def _stage_blob(stage, config=None):
    owner, layers = _stage_owner(stage, config)
    w, b, shapes = common.pack_layers(owner, layers)
    return owner, w, b, shapes


# ---------------------------------------------------------------------------
# The blobs and their tensor maps.


@pytest.mark.parametrize('stage', ALL_STAGES)
def test_stage_blob_is_the_level_blob_slice(stage):
    """A module's own packed blob is the level blob's run of the stage's
    layers, weights and biases alike: the per-module kernel reads layer l
    where the level kernel would, less the stage's first offsets."""
    level = _probe(_config(stage)).level('fine')
    w_level, b_level, shapes = pack_level(level)
    first, end = MODULE_STAGES[stage]
    _, w, b, stage_shapes = _stage_blob(stage)
    assert stage_shapes == shapes[first:end]
    w0 = sum(n * k for n, k in shapes[:first])
    b0 = sum(n for n, _ in shapes[:first])
    assert torch.equal(w, w_level[w0:w0 + w.numel()])
    assert torch.equal(b, b_level[b0:b0 + b.numel()])


@pytest.mark.parametrize('stage,config', [
    ('warp', 'flagship'), ('sheet', 'flagship'), ('template', 'flagship'),
    ('template', 'static'), ('template_plane', 'plane'),
    ('template_nerfies_plane', 'plane_anneal')])
def test_tensor_maps_cover_each_stage(stage, config):
    """Over the stage's own blob (the static template's included) every map
    starts 256-byte aligned with a row stride of whole 16 bytes, and each
    layer's loads, read box by box with the zero fill past a map's edge,
    rebuild exactly that layer's packed weight and nothing past k_pad."""
    owner, w_blob, _, shapes = _stage_blob(stage, config)
    packed = owner._packed['packed']
    first = MODULE_STAGES[stage][0]
    offsets = np.cumsum([0] + [n * k for n, k in shapes])
    maps = forward_maps(shapes)
    assert sum(count for _, count, _, _ in maps) == len(shapes)
    loads = stage_plan(stage, shapes)['loads']
    assert {l for l, _, _, _ in loads} == set(range(first,
                                                   first + len(shapes)))
    for m0, count, n, k in maps:
        assert (2 * offsets[m0]) % 256 == 0 and (2 * k) % 16 == 0
        view = w_blob[offsets[m0]:offsets[m0] + count * n * k].view(
            count * n, k)
        for i in range(m0, m0 + count):
            n_boxes = -(-k // FWD_BOX_COLS)
            rebuilt = torch.zeros((n, n_boxes * FWD_BOX_COLS),
                                  dtype=w_blob.dtype)
            for l, kb, nb, rows in loads:
                if l != first + i:
                    continue
                r0 = nb * FWD_STAGE_ROWS
                rebuilt[r0:r0 + rows,
                        kb * FWD_BOX_COLS:(kb + 1) * FWD_BOX_COLS] = _tma_box(
                    view, kb * FWD_BOX_COLS, (i - m0) * n + r0, rows)
            assert torch.equal(rebuilt[:, :k], packed[i][0])
            assert not rebuilt[:, k:].any()


def test_stage_bounds_are_map_runs():
    """Each stage starts and ends a run of same-shape layers of the level's
    table (the C kernels' static_assert ``whole_runs``), so the per-module
    maps are the level's maps of those layers and no run is split; the
    stages cover the table in order."""
    shapes = pack_level(_probe().level('fine'))[2]
    starts = {m0 for m0, _, _, _ in forward_maps(shapes)}
    bounds = sorted({b for stage in STAGES for b in MODULE_STAGES[stage]})
    assert bounds == [0, 7, 14, 30] and len(shapes) == 30
    assert all(b in starts for b in bounds[:-1])
    level_maps = forward_maps(shapes)
    for stage in STAGES:
        first, end = MODULE_STAGES[stage]
        mine = [(m0 + first, c, n, k)
                for m0, c, n, k in forward_maps(shapes[first:end])]
        assert mine == [m for m in level_maps if first <= m[0] < end]


# ---------------------------------------------------------------------------
# The column plan.


@pytest.mark.parametrize('stage', ALL_STAGES)
def test_stage_column_plan(stage):
    """Run the stage alone over a symbolic tile of its block's width (384
    columns for the template, 448 for the plane configuration's, 256 for the
    warp field, 128 for the sheet):
    its first layer reads the encoding at its column, every other layer
    reads the stage's last hidden output from column 0 (then the skip's
    encoding, or the rgb branch's condition beside the bottleneck), every K
    segment starts on a 64-column box, and nothing is written or read past
    the tile (the C kernels' static_assert ``fits_columns``)."""
    owner, layers = _stage_owner(stage)
    shapes = common.pack_layers(owner, layers)[2]
    plan = stage_plan(stage, shapes)
    cols = MODULE_BLOCKS[stage][1]
    assert plan['config'][6] == cols and cols % FWD_BOX_COLS == 0
    first = MODULE_STAGES[stage][0]
    table = fl_module.MODULE_STAGE_TABLES.get(stage, 'translation')
    assert plan['in_cols'] == forward_in_cols(table)[first:
                                                      first + len(shapes)]
    enc_col = plan['in_cols'][0]
    assert enc_col % FWD_BOX_COLS == 0 and all(
        c == 0 for c in plan['in_cols'][1:])
    enc_w = shapes[0][1]
    tile = [None] * cols
    assert enc_col + enc_w <= cols
    tile[enc_col:enc_col + enc_w] = ['enc'] * enc_w
    last = None
    for i, ((n, k), (_, segs)) in enumerate(zip(shapes, layers)):
        template = stage.startswith('template')
        if template and i == 10:  # the condition after bneck
            cond_w = shapes[11][1] - shapes[9][0]
            assert shapes[9][0] % FWD_BOX_COLS == 0
            tile[shapes[9][0]:shapes[9][0] + cond_w] = ['cond'] * cond_w
        start = plan['in_cols'][i]
        at, want = start, []
        for j, (_, padded) in enumerate(segs):
            assert at % FWD_BOX_COLS == 0, (i, at)
            if i == 0:
                want += ['enc'] * padded
            elif j == 0:
                want += [('h', last)] * padded
            else:
                want += ['cond' if template and i == 11
                         else 'enc'] * padded
            at += padded
        assert at - start == k
        assert start + -(-k // FWD_BOX_COLS) * FWD_BOX_COLS <= cols
        assert tile[start:start + k] == want, (stage, i)
        if n > 8:  # a hidden layer: bf16 in place over [0, n)
            assert n <= cols
            tile[:n] = [('h', i)] * n
            last = i


@pytest.mark.parametrize('stage', ['warp', 'sheet'])
@pytest.mark.parametrize('alpha', [None, 0.45])
def test_window_row_columns(stage, alpha):
    """The field kernel's encoding (encode_posenc as the C loops write it:
    identity at column c < 3, sin and cos of band k of channel c at 3 + 3 k
    + c and 3 + 3 F + 3 k + c, the embedding after them, zeros to the padded
    width; each feature rounded to bf16, times the window weight of its
    column, rounded again) equals the plain version's rounded encoding,
    window and all; the C source indexes the window by those columns."""
    probe = _probe()
    field = probe.warp_field if stage == 'warp' else probe.hyper_sheet_mlp
    mlp, n_freq = field.mlp, field.n_freq
    enc = mlp.hidden(0).in_features
    kp = common.pad16(enc)
    rs = np.random.RandomState(3)
    x_raw = torch.from_numpy(np.concatenate(
        [rs.randn(53, 3) * 0.7, rs.randn(53, 8) * 0.1], axis=1).astype(
            np.float32))
    scales = None if alpha is None else ff.encoding_scales(
        n_freq, 8, alpha * n_freq)
    padded = common.padded_scales(scales, enc, kp, x_raw.device)
    feat = torch.zeros(53, kp)
    feat[:, :3] = x_raw[:, :3]
    for q in range(3 * n_freq):
        arg = x_raw[:, q % 3] * 2.0 ** (q // 3)
        feat[:, 3 + q] = torch.sin(arg)
        feat[:, 3 + 3 * n_freq + q] = torch.cos(arg)
    feat[:, 3 + 6 * n_freq:enc] = x_raw[:, 3:]
    got = feat.to(torch.bfloat16)
    if padded is not None:
        got = (got.float() * padded).to(torch.bfloat16)
    want = ff._encode(mlp, n_freq, x_raw, scales)[1]
    assert torch.equal(got[:, :enc], want)
    assert not got[:, enc:].float().any()
    src = (build.CSRC / 'level_fwd.cuh').read_text()
    body = src[src.index('void posenc_row('):src.index('void encode_posenc(')]
    for expr in (r'kPairs = CH \* F,',
                 r'x_at\(g.xs, r, COL \+ CH \+ q\), window_feature\(sn, '
                 r'CH \+ q, scales\)',
                 r'x_at\(g.xs, r, COL \+ CH \+ kPairs \+ q\),\s+'
                 r'window_feature\(cs, CH \+ kPairs \+ q, scales\)',
                 r'const int c = f < CH \? f : f \+ 2 \* kPairs;',
                 r'window_feature\(v, c, scales\)'):
        assert re.search(expr, body), expr


# ---------------------------------------------------------------------------
# The weight stream.


def _block0_steps(n_points, groups):
    """Steps of ``groups`` row tiles that block 0 of the persistent grid
    takes."""
    steps = -(-(-(-n_points // FWD_TILE_ROWS)) // groups)
    return len(range(0, steps, min(steps, SMS)))


@pytest.mark.parametrize('stage', ALL_STAGES)
@pytest.mark.parametrize('n_points', [481, 37 * 13, 2 * SMS * 128 + 70])
def test_stage_loads_through_the_ring(stage, n_points):
    """Block 0's producer issues the stage's loads once per step of its
    block's tiles it takes (a step whose rows end inside it, or past P,
    included: every warpgroup runs every layer), and all of its consumer
    warpgroups take them in that order; through the ring with random
    interleavings no consumer reads a stage early or late, no fill
    overtakes a consumer, nothing deadlocks."""
    shapes = _stage_blob(stage)[3]
    plan = stage_plan(stage, shapes)
    groups = plan['config'][1]
    steps = _block0_steps(n_points, groups)
    assert steps == 1 if n_points < 1000 else steps >= 2
    order = plan['loads'] * steps
    ends = {i for i in range(len(order))
            if i + 1 == len(order) or order[i + 1][0] != order[i][0]}
    for seed in range(2):
        assert _run_ring(order, ends, np.random.default_rng(seed),
                         groups, plan['config'][2]) == len(order)


@pytest.mark.parametrize('warp', ['translation', 'se3', 'quaternion'])
def test_level_schedule_is_its_stages_in_turn(warp):
    """The level kernel's loads and column plan are its warp stage's, then
    the per-module sheet's and template's (shifted by the SE(3) table's two
    extra warp layers), as the level kernel calls the same stage functions
    in turn."""
    config = {'translation': 'flagship'}.get(warp, warp)
    shapes = pack_level(load_probe_weights(flagship_model(
        'cpu', config=config)).level('fine'))[2]
    level = forward_plan(warp, shapes)
    shift = len(shapes) - 30
    parts, cols = [], []
    for stage in STAGES:
        first, end = MODULE_STAGES[stage]
        plan = stage_plan(stage, _stage_blob(stage)[3])
        if stage == 'warp':
            if shift:  # the SE(3) trunk: the level's own warp stage
                plan = dict(loads=forward_loads(shapes[:end + shift]),
                            in_cols=level['in_cols'][:end + shift])
            parts += plan['loads']
            cols += plan['in_cols']
            continue
        parts += [(l + shift, kb, nb, rows)
                  for l, kb, nb, rows in plan['loads']]
        cols += plan['in_cols']
    assert parts == level['loads']
    assert cols == level['in_cols']


def test_stream_bytes_of_the_stages():
    """A per-module call reads its stage's blob once per pair of tiles:
    the template 1,392,640 bytes, the warp 206,848, the sheet 58,368 (with
    their padding); the three add up to the level's 1,657,856."""
    sizes = {stage: sum(2 * n * k for n, k in _stage_blob(stage)[3])
             for stage in STAGES}
    assert sizes == {'template': 1392640, 'warp': 206848, 'sheet': 58368}
    assert sum(sizes.values()) == 1657856
    shapes = _stage_blob('template')[3]
    assert forward_stream_bytes(shapes, 8192 * 128) == 8192 * 1392640
    shapes = _stage_blob('warp')[3]
    assert forward_stream_bytes(shapes, 8192 * 128, 3) == 5462 * 206848


# ---------------------------------------------------------------------------
# Shared memory and the C entry points.


def test_shared_memory_fits():
    """Each per-module block fits an H100 block's 227 KB: its tiles (the
    template two of 48 KB, the warp field three of 32 KB, the sheet four of
    16 KB), the ring, the row scratch, the bias table (a stage's biases at
    its own offset, in 16-byte pieces) and the barriers."""
    assert FWD_SMEM_BYTES <= 232448
    sizes = {stage: fwd_smem_bytes(*MODULE_BLOCKS[stage]) for stage in STAGES}
    assert sizes == {'warp': 229296, 'sheet': 204208,
                     'template': FWD_SMEM_BYTES}
    assert max(sizes.values()) <= 232448
    # The plane configuration's template: two 56 KB tiles, 5 stages; the
    # Nerfies plane layout's: the level's block.
    assert fwd_smem_bytes(*MODULE_BLOCKS['template_plane']) == 221600
    assert fwd_smem_bytes(*MODULE_BLOCKS['template_nerfies_plane']) == \
        FWD_SMEM_BYTES
    shapes = pack_level(_probe().level('fine'))[2]
    for stage in STAGES:
        first, end = MODULE_STAGES[stage]
        b0 = 2 * sum(n for n, _ in shapes[:first])
        b1 = 2 * sum(n for n, _ in shapes[:end])
        assert b0 % 16 == 0 and (b1 - b0) % 16 == 0
        assert b1 <= FWD_BIAS_BYTES
        assert 2 * _stage_blob(stage)[2].numel() == b1 - b0


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _check_kinds(name, args):
    argtypes = build._SIGNATURES[name][0]
    assert len(args) == len(argtypes), name
    for i, (a, kind) in enumerate(zip(args, argtypes)):
        if kind in (ctypes.c_int, ctypes.c_longlong):
            assert isinstance(a, int) and not isinstance(a, bool), (name, i)
        else:
            assert a is None or isinstance(a, int), (name, i)


@torch.no_grad()
def test_launches_match_the_c_signatures(monkeypatch):
    """The field wrapper (window off and on), the template wrapper (S = 13
    and 1) and ``compiled_stage_plan`` pass their entry points as many
    arguments as ``build``'s ctypes signatures declare, of the declared
    kinds; the two launches keep their signatures."""
    p_, i_, l_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    assert build._SIGNATURES['hn_fused_field_fwd'] == ([i_] + [p_] * 5
                                                       + [l_, p_], i_)
    assert build._SIGNATURES['hn_fused_template_fwd'] == (
        [p_] * 8 + [l_, i_, i_, p_], i_)
    assert build._SIGNATURES['hn_modular_fwd_plan'] == ([i_] + [p_] * 3
                                                        + [i_], i_)
    fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
    probe = _probe()
    layout = pack_level(probe.level('fine'))[2]
    lib = _RecordingLibrary()
    monkeypatch.setattr(build, 'library', lambda: lib)
    monkeypatch.setattr(common, 'kernel_layout', lambda w='translation':
                        layout)
    monkeypatch.setattr(common, 'runs_plain', lambda t, name: False)
    monkeypatch.setattr(torch.cuda, 'device', lambda d: _Null())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: type('S', (), {'cuda_stream': 7}))
    rs = np.random.RandomState(0)
    x11 = torch.from_numpy(rs.rand(37 * 13, 11).astype(np.float32))
    x8 = torch.from_numpy(rs.rand(37 * 13, 8).astype(np.float32))
    field = probe.warp_field
    ff._forward(field.mlp, field.n_freq, x11, None)
    ff._forward(field.mlp, field.n_freq, x11,
                ff.encoding_scales(field.n_freq, 8, 4.5))
    sheet = probe.hyper_sheet_mlp
    ff._forward(sheet.mlp, sheet.n_freq, x11, None)
    level = probe.level('coarse')
    fm._forward(level, x8, torch.rand(37, 39))
    fm._forward(level, x8, torch.rand(37 * 13, 39))
    for stage in STAGES:
        fl.compiled_stage_plan(stage)
    names = [n for n, _ in lib.calls]
    assert names == ['hn_fused_field_fwd'] * 3 + [
        'hn_fused_template_fwd'] * 2 + ['hn_modular_fwd_plan'] * 3
    for name, args in lib.calls:
        _check_kinds(name, args)
    (_, w0), (_, w1), (_, s0), (_, t13), (_, t1) = lib.calls[:5]
    assert (w0[0], w1[0], s0[0]) == (0, 0, 1)
    assert w0[2] is None and w1[2] is not None and s0[2] is None
    assert w0[-2:] == (37 * 13, 7)
    assert t13[-4:] == (37 * 13, 13, 39, 7)
    assert t1[-4:] == (37 * 13, 1, 39, 7)
    # No alpha condition, nor its weights; posenc_orig: no window row.
    assert t13[2:5] == (None,) * 3 and t1[2:5] == (None,) * 3
    assert [args[0] for _, args in lib.calls[5:]] == [
        MODULE_STAGE_CODES[s] for s in STAGES]
    assert all(args[-1] == 1024 for _, args in lib.calls[5:])


@torch.no_grad()
def test_plane_template_launch_matches_the_c_signature(monkeypatch):
    """The plane configuration's template alone launches its own entry
    point, ``hn_fused_template_fwd_plane`` (hn_fused_template_fwd's
    arguments, raw rows of 16 columns, no window row), checks its blob
    against the plane table's layers 7..22, and refuses rows of 8 columns;
    its compiled stage plan is stage code 4."""
    p_, i_, l_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    assert build._SIGNATURES['hn_fused_template_fwd_plane'] == (
        [p_] * 8 + [l_, i_, i_, p_], i_)
    fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
    probe = _probe('plane')
    layout = pack_level(probe.level('fine'))[2]
    lib = _RecordingLibrary()
    monkeypatch.setattr(build, 'library', lambda: lib)
    monkeypatch.setattr(common, 'kernel_layout', lambda w='translation':
                        layout if w == 'plane' else None)
    monkeypatch.setattr(common, 'runs_plain', lambda t, name: False)
    monkeypatch.setattr(torch.cuda, 'device', lambda d: _Null())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: type('S', (), {'cuda_stream': 7}))
    rs = np.random.RandomState(0)
    x16 = torch.from_numpy(rs.rand(37 * 13, 16).astype(np.float32))
    level = probe.level('coarse')
    fm._forward(level, x16, torch.rand(37, 39))
    fl.compiled_stage_plan('template_plane')
    with pytest.raises(ValueError, match='x_raw'):
        fm._forward(level, x16[:, :8].contiguous(), torch.rand(37, 39))
    (name, args), (plan_name, plan) = lib.calls
    assert name == 'hn_fused_template_fwd_plane'
    _check_kinds(name, args)
    assert args[2:5] == (None,) * 3 and args[-4:] == (37 * 13, 13, 39, 7)
    assert plan_name == 'hn_modular_fwd_plan'
    assert plan[0] == MODULE_STAGE_CODES['template_plane'] == 4


@torch.no_grad()
def test_nerfies_plane_template_launch_matches_the_c_signature(monkeypatch):
    """The plane_anneal configuration's template alone launches the plane
    templates' entry point, ``hn_fused_template_fwd_plane``, with its window
    row (128 fp32, which selects the Nerfies plane layout in the C entry
    point), raw rows of 16 columns and its 27-column condition, checks its
    blob against layers 7..22 of its table and refuses rows of 8 columns;
    its compiled stage plan is stage code 5."""
    fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
    probe = _probe('plane_anneal')
    layout = pack_level(probe.level('fine'))[2]
    lib = _RecordingLibrary()
    monkeypatch.setattr(build, 'library', lambda: lib)
    monkeypatch.setattr(common, 'kernel_layout', lambda w='translation':
                        layout if w == 'nerfies_plane' else None)
    monkeypatch.setattr(common, 'runs_plain', lambda t, name: False)
    monkeypatch.setattr(torch.cuda, 'device', lambda d: _Null())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: type('S', (), {'cuda_stream': 7}))
    rs = np.random.RandomState(0)
    x16 = torch.from_numpy(rs.rand(37 * 13, 16).astype(np.float32))
    level = probe.level('coarse')
    assert fm.layout(level) == 'nerfies_plane'
    row = fm.template_scales(level, 10.0, 1.5)
    fm._forward(level, x16, torch.rand(37, 27), row)
    fl.compiled_stage_plan('template_nerfies_plane')
    with pytest.raises(ValueError, match='x_raw'):
        fm._forward(level, x16[:, :8].contiguous(), torch.rand(37, 27), row)
    (name, args), (plan_name, plan) = lib.calls
    assert name == 'hn_fused_template_fwd_plane'
    _check_kinds(name, args)
    assert args[2:4] == (None,) * 2 and args[4] is not None
    assert args[-4:] == (37 * 13, 13, 27, 7)
    assert plan_name == 'hn_modular_fwd_plan'
    assert plan[0] == MODULE_STAGE_CODES['template_nerfies_plane'] == 5


@pytest.mark.parametrize('stage', ALL_STAGES)
def test_stage_plan_model(stage):
    """``stage_plan``: the level's tile height and ring, the stage's block
    (warpgroups, shared memory, threads, tile columns), its own tensor maps
    and in_cols; it refuses a blob of another stage's length."""
    shapes = _stage_blob(stage)[3]
    plan = stage_plan(stage, shapes)
    groups, cols = {'warp': (3, 256), 'sheet': (4, 128),
                    'template': (2, 384), 'template_plane': (2, 448),
                    'template_nerfies_plane': (2, 384)}[stage]
    stages = 5 if stage == 'template_plane' else 6
    assert plan['config'] == [64, groups, stages, 16384,
                              fwd_smem_bytes(groups, cols),
                              128 * (groups + 1), cols,
                              {'warp': 4, 'sheet': 3}.get(stage, 9)]
    assert plan['in_cols'][0] == {'warp': 128, 'sheet': 64}.get(stage, 256)
    # The plane template's first and skip layers read one more box.
    assert len(plan['loads']) == {'warp': 16, 'sheet': 8, 'template': 89,
                                  'template_plane': 93,
                                  'template_nerfies_plane': 89}[stage]
    with pytest.raises(ValueError):
        stage_plan(stage, shapes[:-1])


@pytest.mark.parametrize('case', sorted(CONDITIONS))
@torch.no_grad()
def test_template_launch_passes_each_condition(case, monkeypatch):
    """The template alone takes the conditions as the level forward does
    (``test_torch_level_fwd_plan.test_launch_passes_each_condition``): the
    rgb condition at its width with one row per S rows (S = 13 and 1), the
    alpha condition and the alpha head's condition columns or two null
    pointers, a Nerfies window row only with the Nerfies layout; its blob is
    the flagship template's table, layers 14..29, whatever the conditions."""
    config, over, rgb_w, alpha_w = CONDITIONS[case]
    level = load_probe_weights(flagship_model(
        'cpu', config=config, **over)).level('coarse')
    layout = pack_level(level)[2]
    assert layout == pack_level(_probe().level('coarse'))[2]
    lib = _RecordingLibrary()
    monkeypatch.setattr(build, 'library', lambda: lib)
    monkeypatch.setattr(common, 'kernel_layout', lambda w='translation':
                        layout)
    monkeypatch.setattr(common, 'runs_plain', lambda t, name: False)
    monkeypatch.setattr(torch.cuda, 'device', lambda d: _Null())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: type('S', (), {'cuda_stream': 7}))
    rs = np.random.RandomState(2)
    x8 = torch.from_numpy(rs.rand(37 * 13, 8).astype(np.float32))
    for rows in (37, 37 * 13):
        ac = torch.rand(rows, 8) if alpha_w else None
        fm._forward(level, x8, torch.rand(rows, rgb_w), alpha_cond=ac)
    assert [n for n, _ in lib.calls] == ['hn_fused_template_fwd'] * 2
    for (name, args), per in zip(lib.calls, (13, 1)):
        _check_kinds(name, args)
        assert args[-4:] == (37 * 13, per, rgb_w, 7)
        assert (args[2] is None, args[3] is None) == (not alpha_w,) * 2
        assert (args[4] is None) == (config != 'anneal')
