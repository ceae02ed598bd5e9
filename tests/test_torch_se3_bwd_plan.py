"""The SE(3) trunk alone, backward, and the trunk with its point-tangent
streams, backward (``csrc/se3_bwd_alone.cu`` and ``csrc/se3_tangents_bwd.cu``:
kernel B's block, slab pool and buffer plan of ``csrc/fields_bwd.cuh`` run on
the trunk from its own blob, ``csrc/fields_bwd_alone.cuh``; modelled by
``fused_level.field_bwd_plan('se3' | 'se3_tangents', ...)``) on the CPU: the
plan against kernel B's trunk row, the slab pool replayed through a block
tile (every live output kept, each stored once, a clobbering plan caught),
the tensor maps over the trunk's blob, the weight stream through the ring at
ragged row counts, the bytes streamed, the dW / db flush covering each
weight once, the tangent streams' row layout (each point's four streams on
its rows, the primal row on the lane that hands a tangent row its ReLU
mask, g's 24 columns to their streams), db over the primal rows alone, the
mask word of a lane, and the launches' ctypes arguments with no transposed
blob.

The card holds the compiled plans to this model (``chip_smoke.py`` phases 10
and 14, ``compiled_field_bwd_plan``) and the kernels' numbers to their plain
versions; these tests hold the model to the rules the kernels rely on. All
checks are exact.
"""

import ctypes
import importlib
import inspect
import re

import numpy as np
import pytest
import torch

from hypernerf_tpu_torch.flagship import flagship_model, load_probe_weights
from hypernerf_tpu_torch.kernels import build, common
from hypernerf_tpu_torch.kernels.fused_level import (
    FB_CONFIG, FB_GRAD_COPIES, FB_PLANS, FB_SLAB_BYTES, FB_SMEM_BYTES,
    FB_SPILL_SLABS, FB_STAGE_BYTES, FB_TILE_ROWS, FIELD_BWD, MODULE_STAGES,
    field_bwd_loads, field_bwd_plan, field_bwd_spills,
    field_bwd_stream_bytes, fields_bwd_stream_bytes, forward_maps,
    pack_level, tangent_row)
from test_torch_fields_bwd_plan import (BUF, _check_kinds, _events, _Null,
                                        _RecordingLibrary, _run_pool,
                                        _run_ring, _unit_flush)
from test_torch_level_fwd_plan import _tma_box

fs = importlib.import_module('hypernerf_tpu_torch.kernels.fused_se3')
fj = importlib.import_module('hypernerf_tpu_torch.kernels.fused_se3_jacobian')
fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')

FIELDS = ('se3', 'se3_tangents')
SMS = 132  # an H100's SMs: the persistent grid's width
ENTRY = {'se3': 'hn_fused_se3_bwd', 'se3_tangents': 'hn_fused_se3_jacobian_bwd'}


def _probe():
    return load_probe_weights(flagship_model('cpu', config='se3'))


def _blob(field=None):
    """(the SE(3) field, weight blob, bias blob, shapes) as the backward
    wrappers pack them."""
    field = field or _probe().warp_field
    w, b, shapes = common.pack_layers(field, fs.se3_layers(field))
    return field, w, b, shapes


def _level_shapes():
    return pack_level(_probe().level('fine'))[2]


# ---------------------------------------------------------------------------
# The plan: kernel B's block and its buffer plan of the trunk.


@pytest.mark.parametrize('field', FIELDS)
def test_plan_model(field):
    """``field_bwd_plan``: kernel B's config, kernel B's buffer plan row of
    the SE(3) trunk, the trunk's six hidden layers and its logit forward then
    backward (28 loads), numbered in the SE(3) table, whose first nine
    layers are the trunk's own blob; it refuses a blob of another length.
    The tangents run the trunk's plan on their 4 rows a point."""
    shapes = _blob()[3]
    assert shapes == _level_shapes()[:9]
    assert MODULE_STAGES['se3'] == (0, 9)
    plan = field_bwd_plan(field, shapes)
    assert plan['config'] == list(FB_CONFIG)
    assert plan['table'] == [v for fwd, spill, after, reload in FB_PLANS['se3']
                             for v in (*fwd, spill, after, *reload)]
    loads = plan['loads']
    assert len(loads) == 28
    layers = [l for l, _, _ in loads]
    assert layers[:14] == sorted(layers[:14])
    assert layers[14:] == sorted(layers[14:], reverse=True)
    assert set(layers) == set(range(7))
    assert FIELD_BWD[field].streams == (4 if field == 'se3_tangents' else 1)
    with pytest.raises(ValueError):
        field_bwd_plan(field, shapes[:-1])


def test_entry_points_run_the_trunk_on_kernel_b_block():
    """The two sources instantiate fields_bwd_alone.cuh's kernel for
    kernel B's trunk field, without and with the tangent streams; the plan
    entry point reports the trunk's row for code 2, both ways."""
    for src, tan in (('se3_bwd_alone.cu', 'false'),
                     ('se3_tangents_bwd.cu', 'true')):
        text = (build.CSRC / src).read_text()
        assert f'launch_field_bwd<fb::kSe3Warp, {tan}>' in text
        assert '#include "fields_bwd_alone.cuh"' in text
    assert FIELD_BWD['se3'].code == FIELD_BWD['se3_tangents'].code == 2
    assert FIELD_BWD['se3'].plan == FIELD_BWD['se3_tangents'].plan == 'se3'
    assert not (build.CSRC / 'fused_se3_bwd.cu').exists()
    assert not (build.CSRC / 'fused_se3_jacobian_bwd.cu').exists()


@pytest.mark.parametrize('field', FIELDS)
def test_pool_keeps_every_live_output(field):
    """Replay a block tile of the trunk alone (its recompute with the
    logit, the two heads' step, the walk-back and the encoding's VJP) on
    the slab pool with its plan: every layer reads, as input, dW operand,
    ReLU mask and cotangent, the buffer it wants where the plan puts it,
    and every reload brings back a spilled output. The tangent streams
    change rows, not buffers: the same replay holds."""
    _run_pool(_events(FIELD_BWD[field].plan, _blob()[3]))


@pytest.mark.parametrize('field', FIELDS)
def test_every_output_stored_once(field):
    """Each stored output (enc, h0..h5, the logit T) is written once, box by
    box; the trunk spills (its 15 slabs do not fit the pool's 8), into
    scratch slabs of its own inside the block's FB_SPILL_SLABS."""
    stored = _run_pool(_events(FIELD_BWD[field].plan, _blob()[3]))
    outputs = [k for k in stored if k[0] in BUF and k[0] != 'skip']
    assert all(len(stored[k]) == 1 for k in outputs)
    assert {k[0] for k in outputs} == {'enc', 'T',
                                       *[f'h{i}' for i in range(6)]}
    assert field_bwd_spills(field)
    used = [spill + b for fwd, spill, _, _ in FB_PLANS['se3'] if spill >= 0
            for b in range(sum(s >= 0 for s in fwd))]
    assert len(used) == len(set(used)) and all(0 <= s < FB_SPILL_SLABS
                                               for s in used)


def test_clobbering_plan_fails():
    """The replay sees a fault: moving the top hidden output onto the slot
    of an output that the walk-back still reads is caught."""
    saved = FB_PLANS['se3']
    bad = list(saved)
    fwd, spill, after, reload = bad[BUF['h5']]
    bad[BUF['h5']] = ((saved[BUF['h4']][0][0], fwd[1]), spill, after, reload)
    FB_PLANS['se3'] = bad
    try:
        with pytest.raises(AssertionError):
            _run_pool(_events('se3', _blob()[3]))
    finally:
        FB_PLANS['se3'] = saved


# ---------------------------------------------------------------------------
# The weight stream.


def test_tensor_maps_cover_layers_0_to_8():
    """Over the trunk's own blob the maps cover its nine layers (the heads'
    map too, which the maps must end on: layer 9 of the level starts
    another), each starting 256-byte aligned with a row stride of whole 16
    bytes; each streamed layer's forward loads (and its backward loads, the
    same boxes), read with the zero fill past a map's edge, rebuild exactly
    that layer's packed weight."""
    field, w_blob, _, shapes = _blob()
    packed = field._packed['packed']
    offsets = np.cumsum([0] + [n * k for n, k in shapes])
    maps = forward_maps(shapes)
    covered = [l for m0, count, _, _ in maps for l in range(m0, m0 + count)]
    assert covered == list(range(9))
    level_maps = forward_maps(_level_shapes())
    assert any(m0 == 9 for m0, _, _, _ in level_maps)
    loads = field_bwd_loads('se3', shapes)
    assert loads == field_bwd_loads('se3_tangents', shapes)
    half = len(loads) // 2
    assert sorted(loads[:half]) == sorted(loads[half:])
    for m0, count, n, k in maps:
        assert (2 * offsets[m0]) % 256 == 0 and (2 * k) % 16 == 0
        view = w_blob[offsets[m0]:offsets[m0] + count * n * k].view(
            count * n, k)
        for i in range(m0, min(m0 + count, 7)):
            rebuilt = torch.zeros((n, -(-k // 64) * 64), dtype=w_blob.dtype)
            for l, kb, rows in loads[:half]:
                if l == i:
                    assert rows == n <= FB_STAGE_BYTES // 128
                    rebuilt[:, kb * 64:(kb + 1) * 64] = _tma_box(
                        view, kb * 64, (i - m0) * n, rows)
            assert torch.equal(rebuilt[:, :k], packed[i][0])
            assert not rebuilt[:, k:].any()


def _block0_tiles(n_rows):
    tiles = -(-n_rows // FB_TILE_ROWS)
    return len(range(0, tiles, min(tiles, SMS)))


@pytest.mark.parametrize('field', FIELDS)
@pytest.mark.parametrize('n_points', [481, 37 * 13, 2 * SMS * 128 + 70])
def test_loads_through_the_ring(field, n_points):
    """Block 0's producer issues the trunk's loads once per block tile it
    takes (a point is four rows with the tangents; a tile whose rows end
    inside it included), and both consumer warpgroups take them in that
    order; through the ring with random interleavings no consumer reads a
    stage early or late, no fill overtakes a consumer, nothing
    deadlocks."""
    rows = FIELD_BWD[field].streams * n_points
    tiles = _block0_tiles(rows)
    if n_points < 1000:
        assert tiles == 1
    else:
        assert tiles == (3 if field == 'se3' else 9)
    order = field_bwd_loads(field, _blob()[3]) * min(tiles, 3)
    ends = {i for i in range(len(order))
            if i + 1 == len(order) or order[i + 1][0] != order[i][0]
            or order[i + 1][1] <= order[i][1]}
    for seed in range(2):
        assert _run_ring(order, ends,
                         np.random.default_rng(seed)) == len(order)


def test_stream_bytes():
    """A block tile reads the trunk's hidden weights and its logit twice
    (forward and backward); the trunk alone reads what kernel B's SE(3)
    variant reads for its warp field; the tangents read it once per 32
    points: at the train step's 262,144 points, what the trunk alone reads
    at 1 M rows."""
    shapes = _blob()[3]
    streamed = sum(2 * n * k for n, k in shapes[:7])
    got = field_bwd_stream_bytes('se3', shapes, 16384 * 128)
    assert got == 16384 * 2 * streamed
    level = _level_shapes()
    sheet = sum(2 * n * k for n, k in level[9:15])
    assert got == fields_bwd_stream_bytes('se3', level, 16384 * 128) \
        - 16384 * 2 * sheet
    assert field_bwd_stream_bytes('se3', shapes, 481) == 4 * 2 * streamed
    assert field_bwd_stream_bytes('se3_tangents', shapes, 262144) == \
        field_bwd_stream_bytes('se3', shapes, 4 * 262144) == \
        8192 * 2 * streamed


# ---------------------------------------------------------------------------
# The dW / db flush.


def test_dw_flush_covers_each_weight_once():
    """Every weight and bias of the trunk's nine layers is added once per
    block tile: the hidden layers' and the logit's 64 x 64 units, the two
    heads' tasks of head_back (one thread per (head, input) over its three
    outputs, one db per (head, output)); each gradient copy starts 16-byte
    aligned for the vector adds."""
    shapes = _blob()[3]
    for l, (n, k) in enumerate(shapes):
        if l >= 7:
            assert (n, k) == (8, 128)
            continue
        for dw, db in _unit_flush(n, k):
            assert set(dw) == {(a, b) for a in range(n) for b in range(k)}
            assert set(dw.values()) == {1}
            assert set(db) == set(range(n)) and set(db.values()) == {1}
    # head_back: 2 x 128 (head, input) columns, one thread each, 256
    # threads; db: 2 x 3 threads.
    tasks = [(t // 128, t % 128, n) for t in range(2 * 128) for n in range(3)]
    assert len(set(tasks)) == 2 * 3 * 128 == len(tasks)
    per_copy = sum(n * k + n for n, k in shapes)
    assert per_copy % 4 == 0
    grads, n_w = fl.fields_bwd_grad_copies(shapes, 'cpu')
    assert grads.shape == (FB_GRAD_COPIES, per_copy) and n_w % 4 == 0


# ---------------------------------------------------------------------------
# The tangent streams' rows.


def _c_expr(name):
    """The return expression of level_fwd.cuh's constexpr ``name`` (which
    fields_bwd.cuh's tangent streams use)."""
    src = (build.CSRC / 'level_fwd.cuh').read_text()
    m = re.search(r'constexpr int ' + name + r'\(int (\w+)(?:, int (\w+))?\) '
                  r'\{\s+return ([^;]+);', src)
    return m.group(1), m.group(2), m.group(3)


def test_tangent_row_layout():
    """``tangent_row`` is the C source's ``tan_row`` (and ``tan_stream`` its
    stream); it puts every stream of every point of
    a block tile on a row of its own, 16 points a warpgroup, four a warp;
    a lane's two accumulator rows (lane / 4 and lane / 4 + 8 of its warp's
    16) hold one point, lanes 0..15 its primal row, and lane & 15 holds the
    primal row of the point and columns of every lane: the tangent rows'
    mask is one shuffle."""
    a, b, expr = _c_expr('tan_row')
    for q in range(32):
        for s in range(4):
            assert eval(expr, {a: q, b: s}) == tangent_row(q, s)
    a, _, stream_expr = _c_expr('tan_stream')
    rows = {tangent_row(q, s): (q, s) for q in range(32) for s in range(4)}
    assert sorted(rows) == list(range(FB_TILE_ROWS))
    for r, (q, s) in rows.items():
        assert eval(stream_expr, {a: r}) == s
        assert r // 64 == q // 16  # the point's warpgroup holds its streams
    for group in range(2):
        for warp in range(4):
            for lane in range(32):
                base = 64 * group + 16 * warp
                lo, hi = rows[base + lane // 4], rows[base + lane // 4 + 8]
                assert lo[0] == hi[0] and hi[1] == lo[1] + 2
                assert (lo[1] == 0) == (lane < 16)
                src = rows[base + (lane & 15) // 4]
                assert src == (lo[0], 0)
                # The same columns: the accumulator's column 2 (lane % 4).
                assert (lane & 15) % 4 == lane % 4


def _stacked(g, p):
    """fused_se3_jacobian_bwd_plain's ``stacked``: the heads' cotangents of
    the 4P rows, block s of stream s."""
    def stacked(primal, tangent):
        return torch.cat([primal, tangent.reshape(p, 3, 3).permute(2, 0, 1)
                          .reshape(-1, 3)])
    return {'w': stacked(g[:, 0:3], g[:, 6:15]),
            'v': stacked(g[:, 3:6], g[:, 15:24])}


# fields_bwd_alone.cuh's ``tangent_rows``: where column ``col`` of g goes.
C_TANGENT_ROWS = (
    'const bool is_v = col < 6 ? col >= 3 : col >= 15; '
    'const int d = col < 6 ? col % 3 : (col - (is_v ? 15 : 6)); '
    'const int s = col < 6 ? 0 : 1 + d % 3, out = col < 6 ? d : d / 3;')


def _c_tangent_rows():
    """(column, stream, head, output) of g's 24 columns: C_TANGENT_ROWS,
    which must be the C source's lines, in Python."""
    src = (build.CSRC / 'fields_bwd_alone.cuh').read_text()
    body = src[src.index('void tangent_rows('):]
    assert C_TANGENT_ROWS in ' '.join(body.split())
    cols = []
    for col in range(24):
        is_v = col >= 3 if col < 6 else col >= 15
        d = col % 3 if col < 6 else col - (15 if is_v else 6)
        cols.append((col, 0 if col < 6 else 1 + d % 3, 'v' if is_v else 'w',
                     d if col < 6 else d // 3))
    return cols


def test_g_columns_to_their_streams():
    """Every column of the (P, 24) cotangent goes to one (stream, head,
    output), as the plain version's ``stacked`` lays them out: the C
    source's ``tangent_rows`` arithmetic, evaluated, against it."""
    p = 5
    g = torch.arange(p * 24, dtype=torch.float32).reshape(p, 24)
    want = _stacked(g, p)
    cols = _c_tangent_rows()
    assert len({(s, h, o) for _, s, h, o in cols}) == 24
    for col, s, head, out in cols:
        for q in range(p):
            assert want[head][s * p + q, out] == g[q, col]


def test_db_sums_the_primal_rows_alone():
    """back_layer's and head_back's db rows with the tangents are the 32
    primal rows of a block tile (each half's 16 in back_layer's pairs of
    lanes); and the plain version's db does not move when only the
    tangent rows' cotangents do, while its dW does."""
    back = {h * 64 + tangent_row(q, 0) for h in range(2) for q in range(16)}
    head = {tangent_row(q, 0) for q in range(32)}
    primal = {r for r in range(FB_TILE_ROWS) if (r >> 2) & 3 == 0}
    assert back == head == primal and len(primal) == 32
    src = (build.CSRC / 'fields_bwd.cuh').read_text()
    assert 'half * 64 + tan_row(q, 0)' in src
    assert 'g[tan_row(q, 0) * stride + n]' in src
    field = _probe().warp_field
    rs = np.random.RandomState(3)
    p = 23
    x = torch.from_numpy(rs.uniform(-1, 1, (p, 11)).astype(np.float32))
    g = torch.from_numpy(rs.randn(p, 24).astype(np.float32))
    g2 = g.clone()
    g2[:, 6:] = torch.from_numpy(rs.randn(p, 18).astype(np.float32))
    _, a = fj.fused_se3_jacobian_bwd_plain(field, x, g)
    _, b = fj.fused_se3_jacobian_bwd_plain(field, x, g2)
    for i in range(0, len(a), 2):
        assert torch.equal(a[i + 1], b[i + 1])  # db
        assert not torch.equal(a[i], b[i])      # dW


def test_mask_word_fits_a_register():
    """A tangent row's ReLU mask goes from its primal row's lane by one
    shuffle of a 32-bit word (a bit per column of the lane's fragment: 2 x
    N / 8 columns of an N-wide layer), so no mask bits take shared memory:
    every hidden layer of the trunk has N <= 128, and the block's shared
    memory is kernel B's."""
    shapes = _blob()[3]
    assert all(2 * (n // 8) <= 32 for n, _ in shapes[:7])
    assert FB_SMEM_BYTES <= 232448
    assert fl.FB_CONFIG[4] == FB_SMEM_BYTES
    src = (build.CSRC / 'fields_bwd.cuh').read_text()
    assert 'on = __shfl_sync(0xffffffffu, on, lane & 15);' in src
    assert '__shfl_sync(0xffffffffu, m[0], lane & 15)' in src


# ---------------------------------------------------------------------------
# The launches.


@pytest.mark.parametrize('field', FIELDS)
@torch.no_grad()
def test_launch_matches_the_c_signature(field, monkeypatch):
    """``fused_se3_bwd`` / ``fused_se3_jacobian_bwd`` on a device tensor ask
    kernel B's grid for the rows (4 a point with the tangents), then pass
    the entry point eight pointers (the trunk's one weight blob, no
    transposed one; FB_GRAD_COPIES gradient copies; a spill scratch of
    blocks x FB_SPILL_SLABS slabs) and the sizes, of the declared kinds; the
    copies are summed into the gradients, and the wrapper's count rises by
    one. ``compiled_field_bwd_plan`` passes ``hn_fused_field_bwd_plan`` the
    field's code."""
    name = ENTRY[field]
    assert build._SIGNATURES[name] == (
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_void_p], ctypes.c_int)
    assert f'{name}_blocks' not in build._SIGNATURES
    se3 = _probe().warp_field
    layout = _level_shapes()
    lib = _RecordingLibrary(blocks=3)
    monkeypatch.setattr(build, 'library', lambda: lib)
    monkeypatch.setattr(common, 'kernel_layout', lambda w='translation':
                        layout)
    monkeypatch.setattr(common, 'runs_plain', lambda t, name: False)
    monkeypatch.setattr(torch.cuda, 'device', lambda d: _Null())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: type('S', (), {'cuda_stream': 7}))
    allocated = []

    def recording(real):
        def alloc(*args, **kwargs):
            t = real(*args, **kwargs)
            allocated.append(t)
            return t
        return alloc
    monkeypatch.setattr(torch, 'empty', recording(torch.empty))
    monkeypatch.setattr(torch, 'zeros', recording(torch.zeros))
    rs = np.random.RandomState(1)
    p = 37 * 13
    x = torch.from_numpy(rs.rand(p, 11).astype(np.float32))
    width = 24 if field == 'se3_tangents' else 8
    g = torch.from_numpy(rs.rand(p, width).astype(np.float32))
    scales = fs.se3_encoding_scales(se3, 3.5)
    bwd = fj.fused_se3_jacobian_bwd if field == 'se3_tangents' \
        else fs.fused_se3_bwd
    launches = bwd.launches
    dx, grads = bwd(se3, x, g, scales)
    assert bwd.launches == launches + 1
    fl.compiled_field_bwd_plan(field)
    assert [n for n, _ in lib.calls] == ['hn_fused_fields_bwd_blocks', name,
                                         'hn_fused_field_bwd_plan']
    (_, blocks_args), (_, launch), (_, plan) = lib.calls
    assert blocks_args == (FIELD_BWD[field].streams * p,)
    _check_kinds(name, launch)
    w, b, shapes = common.pack_layers(se3, fs.se3_layers(se3))
    assert launch[0] == x.data_ptr() and launch[2] == g.data_ptr()
    assert launch[1] is not None  # the padded window row
    assert launch[3] == w.data_ptr() and launch[4] == b.data_ptr()
    assert launch[5] == dx.data_ptr()
    assert launch[-3:] == (p, 3, 7)
    copies = [t for t in allocated if t.dim() == 2
              and t.shape[0] == FB_GRAD_COPIES]
    assert len(copies) == 1 and launch[6] == copies[0].data_ptr()
    assert copies[0].shape[1] == sum(n * k + n for n, k in shapes)
    scratch = [t for t in allocated if t.dtype == torch.uint8]
    assert [t.numel() for t in scratch] == [3 * FB_SPILL_SLABS
                                            * FB_SLAB_BYTES]
    assert launch[7] == scratch[0].data_ptr()
    _check_kinds('hn_fused_field_bwd_plan', plan)
    assert plan[0] == FIELD_BWD[field].code and plan[-1] == 256
    assert len(grads) == 18 and dx.shape == x.shape
    assert 'wt' not in se3._packed


def test_no_transposed_blob():
    """The cotangent product reads the streamed weights MN-major, so the
    trunk's backwards pack no transposed weight blob: the launch arguments
    have no such option, and the tangent wrapper's are the trunk's (a
    float32 trunk's add the transposed blob its float32 kernels read,
    tangents included since rows 16 and 17 have float32 kernels)."""
    assert list(inspect.signature(fs._launch_args).parameters) == [
        'field', 'x_raw', 'scales']
    assert list(inspect.signature(fj._launch_args).parameters) == [
        'field', 'x_raw', 'scales']
    assert fj._launch_args is fs._launch_args
