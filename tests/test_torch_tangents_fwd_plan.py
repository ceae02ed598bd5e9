"""The warp Jacobians' forwards (``csrc/tangents_fwd.cu``: the level
forward's block of ``csrc/level_fwd.cuh`` run on the translation warp field
or on the SE(3) trunk with three point-tangent streams, 16 points x 4
streams a tile; modelled by ``fused_level.stage_plan('warp_tangents' |
'se3_tangents', ...)``) on the CPU: their blobs and tensor maps as the
per-module forwards' of the same networks, the column plan, the tile's rows
(``tangent_row``) against the ``wgmma`` m64 accumulator's lanes and the
epilogue's mask word run lane by lane, the encoding that shares a point's
sincos between its four rows against the plain versions' ``_encode_streams``
(bit for bit, with and without the window row), the weight loads through
the ring at 1001 and 262,144 points, the output assembly against the plain
versions, and each launch against its C entry point.

The card holds the compiled plans to this model (``chip_smoke.py`` phases 13
and 14, ``compiled_stage_plan``) and the kernels' numbers to their plain
versions and to the stored JAX numbers; these tests hold the model to the
rules the kernels rely on. All checks are exact.
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
    FWD_BOX_COLS, FWD_STAGE_ROWS, FWD_TILE_ROWS, MODULE_BLOCKS,
    MODULE_STAGES, TANGENT_STAGE_CODES, TANGENT_STREAMS, forward_in_cols,
    forward_maps, forward_stream_bytes, fwd_smem_bytes, stage_plan,
    tangent_row)
from test_torch_level_fwd_plan import (_check_kinds, _RecordingLibrary,
                                       _run_ring, _tma_box)
from test_torch_modular_fwd_plan import _Null
from test_torch_se3_bwd_plan import _c_expr

ff = importlib.import_module('hypernerf_tpu_torch.kernels.fused_field')
fj = importlib.import_module('hypernerf_tpu_torch.kernels.fused_jacobian')
fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
fs = importlib.import_module('hypernerf_tpu_torch.kernels.fused_se3')
fsj = importlib.import_module('hypernerf_tpu_torch.kernels.fused_se3_jacobian')

KINDS = ['warp_tangents', 'se3_tangents']
PER_MODULE = {'warp_tangents': 'warp', 'se3_tangents': 'se3'}
SMS = 132  # an H100's SMs: the persistent grid's width
POINTS = FWD_TILE_ROWS // TANGENT_STREAMS  # 16 points a tile
SRC = build.CSRC / 'tangents_fwd.cu'


def _field(kind):
    config = 'elastic' if kind == 'warp_tangents' else 'elastic_se3'
    return load_probe_weights(flagship_model('cpu', config=config)).warp_field


def _blob(kind, field=None):
    """(weight blob, bias blob, shapes) as the kernel's wrapper packs
    them."""
    field = field or _field(kind)
    if kind == 'warp_tangents':
        return common.pack_layers(field.mlp, ff.field_layers(field.mlp))
    return common.pack_layers(field, fs.se3_layers(field))


def _rows(p, seed):
    rs = np.random.RandomState(seed)
    return torch.from_numpy(np.concatenate(
        [rs.randn(p, 3) * 0.7, rs.randn(p, 8) * 0.1], axis=1).astype(
            np.float32))


def _c_body(name, end):
    src = SRC.read_text()
    return src[src.index(name):src.index(end)]


# ---------------------------------------------------------------------------
# The blobs, the tensor maps and the column plan.


@pytest.mark.parametrize('kind', KINDS)
def test_plan_is_the_per_module_stage(kind):
    """A Jacobian's forward reads the network's own blob (the per-module
    forward's: the warp field alone's, the trunk alone's) through the same
    tensor maps, loads and column plan on the same block; its config adds
    4 rows a point and 16 points a tile. It refuses a blob of another
    length."""
    w, b, shapes = _blob(kind)
    field = _field(kind)
    level = load_probe_weights(flagship_model(
        'cpu', config=PER_MODULE[kind].replace('warp', 'flagship'))).level(
            'fine')
    w_level, b_level, level_shapes = fl.pack_level(level)
    assert shapes == level_shapes[:len(shapes)]  # the level's first layers
    plan = stage_plan(kind, shapes)
    alone = stage_plan(PER_MODULE[kind], shapes)
    assert MODULE_STAGES[kind] == MODULE_STAGES[PER_MODULE[kind]]
    assert MODULE_BLOCKS[kind] == MODULE_BLOCKS[PER_MODULE[kind]] == (3, 256)
    assert plan['config'][:8] == alone['config']
    assert plan['config'][8:] == [TANGENT_STREAMS, POINTS] == [4, 16]
    assert plan['loads'] == alone['loads'] and plan['in_cols'] == alone[
        'in_cols']
    assert plan['config'] == [64, 3, 6, 16384, fwd_smem_bytes(3, 256), 512,
                              256, len(forward_maps(shapes)), 4, 16]
    assert fwd_smem_bytes(3, 256) <= 232448
    with pytest.raises(ValueError):
        stage_plan(kind, shapes[:-1])


@pytest.mark.parametrize('kind', KINDS)
def test_tensor_maps_cover_the_network(kind):
    """Over the network's own blob every map starts 256-byte aligned with a
    row stride of whole 16 bytes, and each layer's loads, read box by box
    with the zero fill past a map's edge, rebuild exactly that layer's
    packed weight and nothing past k_pad."""
    field = _field(kind)
    w_blob, _, shapes = _blob(kind, field)
    owner = field.mlp if kind == 'warp_tangents' else field
    packed = owner._packed['packed']
    offsets = np.cumsum([0] + [n * k for n, k in shapes])
    loads = stage_plan(kind, shapes)['loads']
    assert {l for l, _, _, _ in loads} == set(range(len(shapes)))
    for m0, count, n, k in forward_maps(shapes):
        assert (2 * offsets[m0]) % 256 == 0 and (2 * k) % 16 == 0
        view = w_blob[offsets[m0]:offsets[m0] + count * n * k].view(
            count * n, k)
        for i in range(m0, m0 + count):
            rebuilt = torch.zeros((n, -(-k // FWD_BOX_COLS) * FWD_BOX_COLS),
                                  dtype=w_blob.dtype)
            for l, kb, nb, rows in loads:
                if l == i:
                    r0 = nb * FWD_STAGE_ROWS
                    rebuilt[r0:r0 + rows, kb * FWD_BOX_COLS:
                            (kb + 1) * FWD_BOX_COLS] = _tma_box(
                        view, kb * FWD_BOX_COLS, (i - m0) * n + r0, rows)
            assert torch.equal(rebuilt[:, :k], packed[i][0])
            assert not rebuilt[:, k:].any()


@pytest.mark.parametrize('kind', KINDS)
def test_column_plan(kind):
    """Layer 0 reads the encoding at column 128 (80 columns of the warp
    field, 64 of the trunk), every other layer the last hidden output from
    column 0 (the skip layer then the encoding); every K segment starts on
    a box, every hidden layer is 128 wide (its tangent mask is one 32-bit
    word a lane), and nothing passes the tile's 256 columns."""
    shapes = _blob(kind)[2]
    plan = stage_plan(kind, shapes)
    base = 'translation' if kind == 'warp_tangents' else 'se3'
    first, end = MODULE_STAGES[kind]
    assert plan['in_cols'] == forward_in_cols(base)[first:end]
    assert plan['in_cols'] == [128] + [0] * (end - 1)
    assert shapes[0][1] == (80 if kind == 'warp_tangents' else 64)
    assert shapes[5][1] == 128 + shapes[0][1]  # [h4 | enc], contiguous
    for i, (n, k) in enumerate(shapes):
        assert plan['in_cols'][i] % FWD_BOX_COLS == 0
        assert plan['in_cols'][i] + -(-k // FWD_BOX_COLS) * FWD_BOX_COLS <= 256
        assert n in (128, 8) and (n == 8) == (i >= end - (
            1 if kind == 'warp_tangents' else 2))


# ---------------------------------------------------------------------------
# The tile's rows and the epilogue's mask word.


def _lane_rows(warp, lane):
    """The two tile rows of a lane's m64 accumulator fragment."""
    return 16 * warp + lane // 4, 16 * warp + lane // 4 + 8


def test_tile_rows_against_the_accumulator():
    """``tangent_row`` is the C source's ``tan_row`` (``tan_stream`` and
    ``tan_point`` invert it); a tile's 64 rows hold its 16 points' four
    streams once each; a lane's two accumulator rows are streams s and s +
    2 of one point, stream 0 on lanes 0..15, and lane & 15 of the same warp
    holds that point's primal row at the same columns."""
    a, b, row_expr = _c_expr('tan_row')
    r_name, _, stream_expr = _c_expr('tan_stream')
    _, _, point_expr = _c_expr('tan_point')
    rows = {}
    for q in range(POINTS):
        for s in range(TANGENT_STREAMS):
            r = eval(row_expr, {a: q, b: s})
            assert r == tangent_row(q, s)
            assert eval(stream_expr, {r_name: r}) == s
            assert eval(point_expr, {r_name: r}) == q
            rows[r] = (q, s)
    assert sorted(rows) == list(range(FWD_TILE_ROWS))
    for warp in range(4):
        for lane in range(32):
            r0, r1 = _lane_rows(warp, lane)
            (q0, s0), (q1, s1) = rows[r0], rows[r1]
            assert q0 == q1 and s1 == s0 + 2 and (s0 == 0) == (lane < 16)
            src = _lane_rows(warp, lane & 15)[0]
            assert rows[src] == (q0, 0) and (lane & 15) % 4 == lane % 4


def _epilogue_by_lanes(acc, bias, relu):
    """``tangent_hidden``'s epilogue over one 64 x 128 tile as its 128
    threads run it: lanes 0..15 add the bias to their first row; each lane
    packs bit 2 j + e for column 8 j + 2 t + e of its first row (> 0),
    takes lane & 15's word by a shuffle (all ones for a linear layer), and
    writes both rows zeroed where the bit is clear, rounded."""
    out = torch.full_like(acc, float('nan'))
    for warp in range(4):
        vals, words = {}, []
        for lane in range(32):
            (r0, r1), t, word = _lane_rows(warp, lane), lane % 4, 0
            for j in range(16):
                for e in range(2):
                    c = 8 * j + 2 * t + e
                    v = acc[r0, c] + (bias[c] if lane < 16 else 0.0)
                    vals[r0, c], vals[r1, c] = v, acc[r1, c]
                    if v > 0:
                        word |= 1 << (2 * j + e)
            words.append(word)
        for lane in range(32):
            on = words[lane & 15] if relu else 0xffffffff
            (r0, r1), t = _lane_rows(warp, lane), lane % 4
            for j in range(16):
                for e in range(2):
                    c, bit = 8 * j + 2 * t + e, (on >> (2 * j + e)) & 1
                    for r in (r0, r1):
                        out[r, c] = vals[r, c] if bit else 0.0
    return out.to(torch.bfloat16)


@pytest.mark.parametrize('relu', [True, False])
def test_mask_word_epilogue(relu):
    """The lanes' epilogue gives each primal row bf16([relu](acc + b)) and
    each tangent row bf16(acc * [its primal row's acc + b > 0]) (unmasked
    for the linear trunk logit), the streams' rule: on the primal rows the
    mask word is the ReLU. The C source biases, packs, shuffles and masks
    as mirrored here, one shuffle a layer."""
    rs = np.random.RandomState(3)
    acc = torch.from_numpy(rs.randn(64, 128).astype(np.float32))
    bias = torch.from_numpy(rs.randn(128).astype(np.float32) * 0.3)
    got = _epilogue_by_lanes(acc, bias, relu)
    want = torch.empty_like(acc)
    for q in range(POINTS):
        p = tangent_row(q, 0)
        pre = acc[p] + bias
        want[p] = torch.relu(pre) if relu else pre
        for s in range(1, TANGENT_STREAMS):
            r = tangent_row(q, s)
            want[r] = acc[r] * (pre > 0) if relu else acc[r]
    assert torch.equal(got, want.to(torch.bfloat16))
    body = _c_body('void tangent_hidden(', 'void tangent_head(')
    for expr in (r'const float primal = lane < 16 \? 1\.f : 0\.f;',
                 r'd\[4 \* j\] \+= primal \* __low2float\(b\);',
                 r'd\[4 \* j \+ 1\] \+= primal \* __high2float\(b\);',
                 r'on \|= \(d\[4 \* j\] > 0\.f \? 1u : 0u\) << \(2 \* j\);',
                 r'on \|= \(d\[4 \* j \+ 1\] > 0\.f \? 1u : 0u\) << '
                 r'\(2 \* j \+ 1\);',
                 r'on = __shfl_sync\(0xffffffffu, on, lane & 15\);',
                 r'masked_round\(e\[0\], e\[1\], on, 2 \* j\)',
                 r'masked_round\(e\[2\], e\[3\], on, 2 \* j\)',
                 r'masked_round\(e\[4\], e\[5\], on, 2 \* j \+ 2\)',
                 r'masked_round\(e\[6\], e\[7\], on, 2 \* j \+ 2\)'):
        assert re.search(expr, body), expr
    assert body.count('__shfl_sync') == 1


# ---------------------------------------------------------------------------
# The encoding: a point's sincos shared by its four rows.


def _streams_mirror(x_raw, n_freq, min_deg, enc_pad, ident, scales=None):
    """The C encoding of (P, 11) rows as (P, 4, enc_pad) bf16, stream s of
    point p at [p, s]: per band b = 3 k + c (``band_streams``) one sincos of
    pts[c] 2^(min_deg + k); the primal row takes sin and cos rounded (times
    the window row, rounded again), tangent row 1 + c takes ldexp(cos, m)
    and -ldexp(sin, m) times the window row, rounded once, the other two
    tangent rows zeros; then the rest (identity and embedding on the primal
    row, e_k on tangent row k with ``ident``, zeros)."""
    p, nb = x_raw.shape[0], 3 * n_freq
    out = torch.zeros((p, 4, enc_pad), dtype=torch.bfloat16)
    sc = (torch.ones(enc_pad) if scales is None else scales)
    off = 3 if ident else 0

    def window(v, f):  # window_feature
        v = v.to(torch.bfloat16)
        return v if scales is None else (v.float() * sc[f]).to(
            torch.bfloat16)

    def tangent(v, f):  # tangent_feature
        return (v if scales is None else v * sc[f]).to(torch.bfloat16)

    for b in range(nb):
        m = min_deg + b // 3
        arg = torch.ldexp(x_raw[:, b % 3], torch.tensor(m))
        sn, cs = torch.sin(arg), torch.cos(arg)
        c_sin, c_cos = off + b, off + nb + b
        out[:, 0, c_sin], out[:, 0, c_cos] = window(sn, c_sin), window(
            cs, c_cos)
        k = b % 3
        out[:, 1 + k, c_sin] = tangent(torch.ldexp(cs, torch.tensor(m)),
                                       c_sin)
        out[:, 1 + k, c_cos] = tangent(-torch.ldexp(sn, torch.tensor(m)),
                                       c_cos)
    for f in range(enc_pad - 2 * nb):
        col = f if (ident and f < 3) else f + 2 * nb
        prim = x_raw[:, f] if ident and f < 11 else (
            x_raw[:, 3 + f] if not ident and f < 8 else torch.zeros(p))
        out[:, 0, col] = window(prim, col)
        if ident and f < 3:
            out[:, 1 + f, col] = 1.0
    return out


@pytest.mark.parametrize('kind,alpha', [('warp_tangents', None),
                                        ('se3_tangents', None),
                                        ('se3_tangents', 3.5)])
def test_shared_sincos_encoding(kind, alpha):
    """The kernel's encoding (mirrored) equals the plain versions'
    ``_encode_streams`` bit for bit on the primal row and the three tangent
    rows, the zero pad included, with and without the window row; the C
    loops compute one sincos a point and band and write every column of
    every stream."""
    field = _field(kind)
    x = _rows(53, 11)
    if kind == 'warp_tangents':
        _, enc, tan = fj._encode_streams(field.mlp, 10, x)
        got = _streams_mirror(x, 10, 0, 80, True)
    else:
        scales = None if alpha is None else fs.se3_encoding_scales(field,
                                                                   alpha)
        _, enc, tan = fsj._encode_streams(field, x, scales)
        padded = common.padded_scales(scales, 56, 64, x.device)
        got = _streams_mirror(x, 8, field.min_deg, 64, False, padded)
    width = enc.shape[1]
    assert torch.equal(got[:, 0, :width], enc)
    for k in range(3):
        assert torch.equal(got[:, 1 + k, :width], tan[k])
    assert not got[:, :, width:].float().any()
    band = _c_body('void band_streams(', 'void encode_se3_streams(')
    assert band.count('sincosf(') == 1
    for expr in (r'window_feature\(sn, f_sin, scales\)',
                 r'window_feature\(cs, f_cos, scales\)',
                 r'tangent_feature\(ldexpf\(cs, m\), f_sin, scales\)',
                 r'tangent_feature\(-ldexpf\(sn, m\), f_cos, scales\)',
                 r'const bool on = b % 3 == s - 1;'):
        assert re.search(expr, band), expr
    se3 = _c_body('void encode_se3_streams(', 'void encode_warp_streams(')
    assert re.search(r'band_streams\(g, q, b, se3_band_arg\(in\[q\], b\), '
                     r'kSe3MinDeg \+ b / 3,', se3)
    assert 'e < kTilePoints * kSe3Trig' in se3 and 'e < kRows * kRest' in se3
    warp = _c_body('void encode_warp_streams(', 'void write_jacobian(')
    assert re.search(r'band_streams\(g, q, b, in\[q\]\[b % 3\] \* pow2\(b / '
                     r'3\), b / 3,', warp)
    assert 'e < kTilePoints * kPairs' in warp and 'e < kRows * kRest' in warp


# ---------------------------------------------------------------------------
# The weight stream, and the output.


def _block0_steps(n_points, groups=3):
    steps = -(-(-(-TANGENT_STREAMS * n_points // FWD_TILE_ROWS)) // groups)
    return len(range(0, steps, min(steps, SMS)))


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('n_points', [1001, 1 << 18])
def test_loads_through_the_ring(kind, n_points):
    """Block 0's producer issues the network's loads once per step of three
    tiles (48 points) it takes, the last step's rows past 4 P included,
    and its three consumer warpgroups take them in that order; through the
    ring with random interleavings no consumer reads a stage early or late,
    no fill overtakes a consumer, nothing deadlocks. The weight bytes a
    call streams from L2 count a step per 48 points."""
    shapes = _blob(kind)[2]
    plan = stage_plan(kind, shapes)
    assert plan['config'][1] == 3
    assert len(plan['loads']) == (16 if kind == 'warp_tangents' else 18)
    steps = _block0_steps(n_points)
    assert steps == (1 if n_points == 1001 else 42)
    order = plan['loads'] * steps
    ends = {i for i in range(len(order))
            if i + 1 == len(order) or order[i + 1][0] != order[i][0]}
    assert _run_ring(order, ends, np.random.default_rng(n_points % 7),
                     3) == len(order)
    blob = sum(2 * n * k for n, k in shapes)
    assert forward_stream_bytes(shapes, 4 * n_points, 3) == -(
        -n_points // 48) * blob


def _tile_heads(kind, field, x):
    """rows.head of every tile as the kernel leaves it: the plain version's
    per-row head outputs (translation: the tangent rows' J columns; the
    trunk: [w | v] of every row) at their tile rows."""
    p = x.shape[0]
    n_tiles = -(-p // POINTS)
    head = torch.full((n_tiles, 64, 8), float('nan'))
    if kind == 'warp_tangents':
        mlp = field.mlp
        _, enc, tan = fj._encode_streams(mlp, 10, x)
        _, t, _, _ = fj.streams_forward(mlp, enc, fj.stream_rows(tan))
        rows = [None] + list(common.prod(t, mlp.logit.weight.t(),
                                         mlp.dtype)[:, :3].reshape(3, p, 3))
    else:
        _, enc, tan = fsj._encode_streams(field, x, None)
        trunk4, _, _, _ = fsj._trunk_streams(field, enc, tan)
        w4, v4 = fsj._heads(field, trunk4, p)
        rows = list(torch.cat([w4, v4], -1).reshape(4, p, 6))
    for pt in range(p):
        tile, q = divmod(pt, POINTS)
        for s in range(4):
            if rows[s] is not None:
                head[tile, tangent_row(q, s), :rows[s].shape[1]] = rows[s][pt]
    return head


def _write_by_threads(kind, head, p):
    """``write_jacobian`` / ``write_tangents`` of every tile as the C loops
    index it; NaN where nothing is written."""
    width = 9 if kind == 'warp_tangents' else 24
    out = torch.full((p * width,), float('nan'))
    for tile in range(head.shape[0]):
        p0, h = tile * POINTS, head[tile]
        if kind == 'warp_tangents':
            for e in range(POINTS * 9):
                q, i, k = e // 9, e % 9 // 3, e % 3
                if p0 + q < p:
                    out[p0 * 9 + e] = (1.0 if i == k else 0.0) + h[
                        tangent_row(q, 1 + k), i]
            continue
        for tid in range(128):
            q, part = tid // 6, tid % 6
            if tid >= POINTS * 6 or p0 + q >= p:
                continue
            for c4 in range(4):
                col = 4 * part + c4
                if col < 6:
                    v = h[tangent_row(q, 0), col]
                else:
                    d = col - 6 if col < 15 else col - 15
                    v = h[tangent_row(q, 1 + d % 3),
                          (0 if col < 15 else 3) + d // 3]
                out[4 * (6 * (p0 + q) + part) + c4] = v
    return out.reshape(p, width)


@pytest.mark.parametrize('kind', KINDS)
def test_output_assembly(kind):
    """The kernels' writes of the heads' rows give the plain versions'
    outputs bit for bit (J = I + the tangent rows' heads; [w | v] of the
    primal row, dw and dv column k from tangent row k) at a ragged 37
    points, every point written once and nothing past P; the C source
    indexes the rows as mirrored."""
    field = _field(kind)
    x = _rows(37, 5)
    got = _write_by_threads(kind, _tile_heads(kind, field, x), 37)
    if kind == 'warp_tangents':
        want = fj.fused_jacobian_plain(field.mlp, 10, x)
    else:
        want = fsj.fused_se3_jacobian_plain(field, x)
    assert torch.equal(got, want)
    jac = _c_body('void write_jacobian(', 'void write_tangents(')
    assert re.search(r'jac\[p0 \* 9 \+ e\] = \(i == k \? 1\.f : 0\.f\) \+ '
                     r'rw\.head\[tan_row\(q, 1 \+ k\)\]\[i\];', jac)
    tng = _c_body('void write_tangents(', 'void tangent_stage(')
    for expr in (r'v\[c4\] = rw\.head\[tan_row\(q, 0\)\]\[col\];',
                 r'v\[c4\] = rw\.head\[tan_row\(q, 1 \+ k\)\]\[\(col < 15 \? '
                 r'0 : 3\) \+ i\];',
                 r'reinterpret_cast<float4\*>\(out\)\[6 \* \(p0 \+ q\) \+ '
                 r'part\]'):
        assert re.search(expr, tng), expr


# ---------------------------------------------------------------------------
# The launches.


def _c_params(name):
    """The parameter count of extern "C" entry point ``name``."""
    src = SRC.read_text()
    m = re.search(r'extern "C" int ' + name + r'\(([^)]*)\)', src)
    return len(m.group(1).split(','))


@torch.no_grad()
def test_launches_match_the_c_signatures(monkeypatch):
    """``fused_warp_jacobian``'s and ``fused_se3_wv_tangents``' forwards
    (window off and on) pass their entry points the network's own blobs,
    the window row or None and the point count, as many arguments as the C
    source and ``build``'s ctypes signatures declare, of the declared kinds;
    ``compiled_stage_plan`` passes ``hn_tangents_fwd_plan`` codes 0 and 1."""
    p_, i_, l_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sig = build._SIGNATURES
    assert sig['hn_fused_jacobian_fwd'] == ([p_] * 4 + [l_, p_], i_)
    assert sig['hn_fused_se3_jacobian_fwd'] == ([p_] * 5 + [l_, p_], i_)
    assert sig['hn_tangents_fwd_plan'] == ([i_] + [p_] * 3 + [i_], i_)
    for name in ('hn_fused_jacobian_fwd', 'hn_fused_se3_jacobian_fwd',
                 'hn_tangents_fwd_plan'):
        assert _c_params(name) == len(sig[name][0])
    assert TANGENT_STAGE_CODES == {'warp_tangents': 0, 'se3_tangents': 1}
    assert 'if (which == 0)' in SRC.read_text()
    warp, trunk = _field('warp_tangents'), _field('se3_tangents')
    layouts = {w: fl.pack_level(load_probe_weights(flagship_model(
        'cpu', config=c)).level('fine'))[2]
        for w, c in (('translation', 'flagship'), ('se3', 'se3'))}
    lib = _RecordingLibrary()
    monkeypatch.setattr(build, 'library', lambda: lib)
    monkeypatch.setattr(common, 'kernel_layout',
                        lambda w='translation': layouts[w])
    monkeypatch.setattr(common, 'runs_plain', lambda t, name: False)
    monkeypatch.setattr(torch.cuda, 'device', lambda d: _Null())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: type('S', (), {'cuda_stream': 7}))
    x = _rows(1001, 2)
    fj._forward(warp.mlp, 10, x)
    fsj._forward(trunk, x, None)
    fsj._forward(trunk, x, fs.se3_encoding_scales(trunk, 3.5))
    for kind in KINDS:
        fl.compiled_stage_plan(kind)
    assert [n for n, _ in lib.calls] == [
        'hn_fused_jacobian_fwd', 'hn_fused_se3_jacobian_fwd',
        'hn_fused_se3_jacobian_fwd', 'hn_tangents_fwd_plan',
        'hn_tangents_fwd_plan']
    for name, args in lib.calls:
        _check_kinds(name, args)
    (_, j), (_, off), (_, on) = lib.calls[:3]
    w, b, _ = _blob('warp_tangents', warp)
    assert j[:3] == (x.data_ptr(), w.data_ptr(), b.data_ptr())
    assert j[-2:] == (1001, 7)
    tw, tb, _ = _blob('se3_tangents', trunk)
    for args in (off, on):
        assert args[0] == x.data_ptr() and args[2:4] == (tw.data_ptr(),
                                                         tb.data_ptr())
        assert args[-2:] == (1001, 7)
    assert off[1] is None and isinstance(on[1], int)
    assert [args[0] for _, args in lib.calls[3:]] == [0, 1]
    assert all(args[-1] == 1024 for _, args in lib.calls[3:])
