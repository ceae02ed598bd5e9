"""The SE(3) / quaternion trunk alone, forward (``csrc/modular_fwd.cu``'s
trunk stage: the level forward's screw-warp stage of ``csrc/level_fwd.cuh``
without its retraction, run on the warp field's block of three 256-column
tiles; modelled by ``fused_level.stage_plan('se3', ...)``) on the CPU: the
trunk's own blob as the SE(3) level blob's slice, the tensor maps over it,
the column plan, the window row's columns, the weight stream through the
ring at ragged row counts, the level's warp stage as this stage, shared
memory, and the launch's ctypes arguments.

The card holds the compiled stage plan to this model (``chip_smoke.py``
phase 10, ``compiled_stage_plan('se3')``) and the kernel's numbers to its
plain version and to the stored JAX numbers; these tests hold the model to
the rules the kernel relies on. All checks are exact.
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
    FWD_BOX_COLS, FWD_STAGE_ROWS, MODULE_BLOCKS, MODULE_STAGE_CODES,
    MODULE_STAGES, forward_in_cols, forward_maps, forward_plan,
    fwd_smem_bytes, pack_level, stage_plan)
from test_torch_level_fwd_plan import _RecordingLibrary, _run_ring, _tma_box

fs = importlib.import_module('hypernerf_tpu_torch.kernels.fused_se3')
fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')

SMS = 132  # an H100's SMs: the persistent grid's width
FIRST, END = 0, 9  # the trunk's layers of the SE(3) table


def _probe(config='se3'):
    return load_probe_weights(flagship_model('cpu', config=config))


def _trunk_blob(config='se3'):
    """(field, weight blob, bias blob, shapes) as ``fused_se3_wv`` packs
    them."""
    field = _probe(config).warp_field
    w, b, shapes = common.pack_layers(field, fs.se3_layers(field))
    return field, w, b, shapes


@pytest.mark.parametrize('config', ['se3', 'quaternion'])
def test_trunk_blob_is_the_level_blob_slice(config):
    """The trunk's own packed blob is the SE(3) level blob's run of layers
    0..8, weights and biases alike: the trunk kernel reads layer l where the
    level kernel would."""
    level = _probe(config).level('fine')
    w_level, b_level, shapes = pack_level(level)
    assert MODULE_STAGES['se3'] == (FIRST, END) and len(shapes) == 32
    _, w, b, trunk_shapes = _trunk_blob(config)
    assert trunk_shapes == shapes[FIRST:END]
    assert torch.equal(w, w_level[:w.numel()])
    assert torch.equal(b, b_level[:b.numel()])


def test_tensor_maps_cover_the_trunk():
    """Over the trunk's own blob every map starts 256-byte aligned with a
    row stride of whole 16 bytes, and each layer's loads, read box by box
    with the zero fill past a map's edge, rebuild exactly that layer's
    packed weight and nothing past k_pad."""
    field, w_blob, _, shapes = _trunk_blob()
    packed = field._packed['packed']
    offsets = np.cumsum([0] + [n * k for n, k in shapes])
    maps = forward_maps(shapes)
    assert [(m0, c) for m0, c, _, _ in maps] == [(0, 1), (1, 4), (5, 1),
                                                 (6, 1), (7, 2)]
    loads = stage_plan('se3', shapes)['loads']
    assert {l for l, _, _, _ in loads} == set(range(FIRST, END))
    for m0, count, n, k in maps:
        assert (2 * offsets[m0]) % 256 == 0 and (2 * k) % 16 == 0
        view = w_blob[offsets[m0]:offsets[m0] + count * n * k].view(
            count * n, k)
        for i in range(m0, m0 + count):
            n_boxes = -(-k // FWD_BOX_COLS)
            rebuilt = torch.zeros((n, n_boxes * FWD_BOX_COLS),
                                  dtype=w_blob.dtype)
            for l, kb, nb, rows in loads:
                if l != i:
                    continue
                r0 = nb * FWD_STAGE_ROWS
                rebuilt[r0:r0 + rows,
                        kb * FWD_BOX_COLS:(kb + 1) * FWD_BOX_COLS] = _tma_box(
                    view, kb * FWD_BOX_COLS, (i - m0) * n + r0, rows)
            assert torch.equal(rebuilt[:, :k], packed[i][0])
            assert not rebuilt[:, k:].any()


def test_trunk_bounds_are_map_runs():
    """The trunk starts and ends a run of same-shape layers of the SE(3)
    level's table (the C kernel's static_assert ``whole_runs``): its maps
    are the level's maps of layers 0..8, and the sheet starts a run."""
    shapes = pack_level(_probe().level('fine'))[2]
    level_maps = forward_maps(shapes)
    starts = {m0 for m0, _, _, _ in level_maps}
    assert FIRST in starts and END in starts
    mine = forward_maps(shapes[FIRST:END])
    assert mine == [m for m in level_maps if m[0] < END]


def test_trunk_column_plan():
    """Run the trunk over a symbolic tile of its block's 256 columns: layer
    0 reads the encoding at column 128 (64 columns), every other layer reads
    the last hidden output from column 0 (the skip layer then the
    encoding, the heads the trunk logit), every K segment starts on a
    64-column box, and nothing is written or read past the tile (the C
    kernel's static_assert ``fits_columns``)."""
    field, _, _, shapes = _trunk_blob()
    layers = fs.se3_layers(field)
    plan = stage_plan('se3', shapes)
    cols = MODULE_BLOCKS['se3'][1]
    assert plan['config'][6] == cols == 256
    assert plan['in_cols'] == forward_in_cols('se3')[FIRST:END]
    assert plan['in_cols'] == [128] + [0] * 8
    enc_w = shapes[0][1]
    assert enc_w == 64
    tile = [None] * cols
    tile[128:128 + enc_w] = ['enc'] * enc_w
    last = None
    for i, ((n, k), (_, segs)) in enumerate(zip(shapes, layers)):
        start = plan['in_cols'][i]
        at, want = start, []
        for j, (_, padded) in enumerate(segs):
            assert at % FWD_BOX_COLS == 0, (i, at)
            want += (['enc'] if i == 0 or j > 0 else [('h', last)]) * padded
            at += padded
        assert at - start == k
        assert start + -(-k // FWD_BOX_COLS) * FWD_BOX_COLS <= cols
        assert tile[start:start + k] == want, i
        if n > 8:  # a hidden layer or the trunk logit: bf16 over [0, n)
            assert n <= cols
            tile[:n] = [('h', i)] * n
            last = i
    assert last == 6  # both heads read the trunk logit


@pytest.mark.parametrize('alpha', [None, 3.5])
def test_window_row_columns(alpha):
    """The trunk kernel's encoding (encode_se3_tile as the C loop writes it:
    sin of band b = 3 k + c at column b, argument pts[c] 2^k, cos at 24 + b,
    the embedding at 48.., zeros to 64; each rounded to bf16, times the
    window weight of its column, rounded again) equals the plain version's
    rounded encoding, window and all; the C source indexes the window by
    those columns."""
    field = _probe().warp_field
    rs = np.random.RandomState(5)
    x_raw = torch.from_numpy(np.concatenate(
        [rs.randn(53, 3) * 0.7, rs.randn(53, 8) * 0.1], axis=1).astype(
            np.float32))
    scales = None if alpha is None else fs.se3_encoding_scales(field, alpha)
    enc = field.trunk.hidden(0).in_features
    padded = common.padded_scales(scales, enc, 64, x_raw.device)
    feat = torch.zeros(53, 64)
    for b in range(24):
        arg = x_raw[:, b % 3] * 2.0 ** (field.min_deg + b // 3)
        feat[:, b] = torch.sin(arg)
        feat[:, 24 + b] = torch.cos(arg)
    feat[:, 48:56] = x_raw[:, 3:]
    got = feat.to(torch.bfloat16)
    if padded is not None:
        got = (got.float() * padded).to(torch.bfloat16)
    want = fs._encode(field, x_raw, scales)[1]
    assert enc == 56 and torch.equal(got[:, :enc], want)
    assert not got[:, enc:].float().any()
    src = (build.CSRC / 'level_fwd.cuh').read_text()
    body = src[src.index('void encode_se3_tile('):
               src.index('void load_condition(')]
    for expr in (r'sincosf\(se3_band_arg\(in\[r\], b\), &sn, &cs\)',
                 r'x_at\(g.xs, r, kWarpEnc \+ b\), window_feature\(sn, b, '
                 r'scales\)',
                 r'x_at\(g.xs, r, kWarpEnc \+ kSe3Trig \+ b\),\s+'
                 r'window_feature\(cs, kSe3Trig \+ b, scales\)',
                 r'window_feature\(v, 2 \* kSe3Trig \+ f, scales\)'):
        assert re.search(expr, body), expr
    trunk = src[src.index('void trunk_stage('):src.index('void screw_stage(')]
    assert 'encode_se3_tile(g, scales);' in trunk and 'retract<' not in trunk


def _block0_steps(n_points, groups):
    steps = -(-(-(-n_points // 64)) // groups)
    return len(range(0, steps, min(steps, SMS)))


@pytest.mark.parametrize('n_points', [481, 37 * 13, 2 * SMS * 128 + 70])
def test_trunk_loads_through_the_ring(n_points):
    """Block 0's producer issues the trunk's 18 loads once per step of
    three row tiles it takes (a step whose rows end inside it, or past P,
    included), and its three consumer warpgroups take them in that order;
    through the ring with random interleavings no consumer reads a stage
    early or late, no fill overtakes a consumer, nothing deadlocks."""
    shapes = _trunk_blob()[3]
    plan = stage_plan('se3', shapes)
    groups = plan['config'][1]
    assert groups == 3 and len(plan['loads']) == 18
    steps = _block0_steps(n_points, groups)
    assert steps == 1 if n_points < 1000 else steps >= 2
    order = plan['loads'] * steps
    ends = {i for i in range(len(order))
            if i + 1 == len(order) or order[i + 1][0] != order[i][0]}
    for seed in range(2):
        assert _run_ring(order, ends, np.random.default_rng(seed),
                         groups) == len(order)


@pytest.mark.parametrize('warp', ['se3', 'quaternion'])
def test_level_warp_stage_is_the_trunk(warp):
    """The SE(3) / quaternion level kernel's first loads and column plan are
    the trunk stage's (the level calls trunk_stage, then retracts)."""
    shapes = pack_level(_probe(warp).level('fine'))[2]
    level = forward_plan(warp, shapes)
    plan = stage_plan('se3', shapes[FIRST:END])
    n = len(plan['loads'])
    assert level['loads'][:n] == plan['loads']
    assert level['loads'][n][0] == END
    assert level['in_cols'][FIRST:END] == plan['in_cols']


def test_trunk_plan_model():
    """``stage_plan('se3')``: the level's tile height and ring, the warp
    field's block (three warpgroups, 256 columns), five tensor maps, the
    trunk's biases copied in 16-byte pieces; it refuses a blob of another
    length."""
    _, _, b, shapes = _trunk_blob()
    plan = stage_plan('se3', shapes)
    assert MODULE_BLOCKS['se3'] == MODULE_BLOCKS['warp'] == (3, 256)
    assert plan['config'] == [64, 3, 6, 16384, fwd_smem_bytes(3, 256), 512,
                              256, 5]
    assert fwd_smem_bytes(3, 256) <= 232448
    assert (2 * b.numel()) % 16 == 0 and b.numel() == 912
    with pytest.raises(ValueError):
        stage_plan('se3', shapes[:-1])


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@torch.no_grad()
def test_launch_matches_the_c_signature(monkeypatch):
    """``fused_se3_wv`` on a device tensor (window off and on) passes
    ``hn_fused_se3_fwd`` the trunk's own blobs, the window row or None and
    the row count, of the declared kinds; ``compiled_stage_plan('se3')``
    passes ``hn_modular_fwd_plan`` stage code 3."""
    p_, i_, l_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    assert build._SIGNATURES['hn_fused_se3_fwd'] == ([p_] * 5 + [l_, p_],
                                                     i_)
    assert MODULE_STAGE_CODES['se3'] == 3
    field, w, b, shapes = _trunk_blob()
    layout = pack_level(_probe().level('fine'))[2]
    lib = _RecordingLibrary()
    monkeypatch.setattr(build, 'library', lambda: lib)
    monkeypatch.setattr(common, 'kernel_layout', lambda w='translation':
                        layout)
    monkeypatch.setattr(common, 'runs_plain', lambda t, name: False)
    monkeypatch.setattr(torch.cuda, 'device', lambda d: _Null())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: type('S', (), {'cuda_stream': 7}))
    x = torch.from_numpy(np.random.RandomState(0).rand(481, 11).astype(
        np.float32))
    fs._forward(field, x, None)
    fs._forward(field, x, fs.se3_encoding_scales(field, 3.5))
    fl.compiled_stage_plan('se3')
    assert [n for n, _ in lib.calls] == ['hn_fused_se3_fwd'] * 2 + [
        'hn_modular_fwd_plan']
    (_, off), (_, on), (_, plan) = lib.calls
    for args in (off, on):
        assert len(args) == 7
        assert args[0] == x.data_ptr() and args[2] == w.data_ptr()
        assert args[3] == b.data_ptr() and args[-2:] == (481, 7)
        assert all(isinstance(a, int) for i, a in enumerate(args) if i != 1)
    assert off[1] is None and isinstance(on[1], int)
    assert plan[0] == 3 and plan[-1] == 1024 and len(plan) == 5
