"""A field alone, backward (``csrc/fields_bwd_alone.cu``: kernel B's block,
slab pool and buffer plan of ``csrc/fields_bwd.cuh`` run on one field of the
translation table from the field's own blob; modelled by
``fused_level.field_bwd_plan``) on the CPU: the plan's config and table
against kernel B's, the slab pool replayed through a block tile of the
field alone (every live output kept, each stored once, a clobbering plan
caught), the weight stream through the ring at ragged row counts, the
tensor maps over the field's blob, the dW / db flush covering each weight
once, the weight bytes streamed, and the launch's ctypes arguments with no
transposed blob.

The card holds the compiled plan to this model (``chip_smoke.py`` phase 8,
``compiled_field_bwd_plan``) and the kernel's numbers to its plain version
and to the stored JAX gradients; these tests hold the model to the rules the
kernel relies on. All checks are exact.
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
    FB_CONFIG, FB_GRAD_COPIES, FB_PLANS, FB_SLAB_BYTES, FB_SPILL_SLABS,
    FB_STAGE_BYTES, FB_TILE_ROWS, FIELD_BWD, MODULE_STAGES, field_bwd_loads, field_bwd_plan, field_bwd_spills,
    field_bwd_stream_bytes, fields_bwd_stream_bytes, forward_maps,
    pack_level)
from test_torch_fields_bwd_plan import (BUF, _check_kinds, _events, _Null,
                                        _RecordingLibrary, _run_pool,
                                        _run_ring, _unit_flush)
from test_torch_level_fwd_plan import _tma_box

ff = importlib.import_module('hypernerf_tpu_torch.kernels.fused_field')
fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')

FIELDS = ('warp', 'sheet')
SMS = 132  # an H100's SMs: the persistent grid's width


def _probe():
    return load_probe_weights(flagship_model('cpu'))


def _field(name, probe=None):
    probe = probe or _probe()
    return probe.warp_field if name == 'warp' else probe.hyper_sheet_mlp


def _blob(name):
    """(mlp, weight blob, bias blob, shapes) as ``fused_field_bwd`` packs
    them."""
    mlp = _field(name).mlp
    w, b, shapes = common.pack_layers(mlp, ff.field_layers(mlp))
    return mlp, w, b, shapes


def _level_shapes():
    return pack_level(_probe().level('fine'))[2]


# ---------------------------------------------------------------------------
# The plan: kernel B's block and its buffer plan of the field.


@pytest.mark.parametrize('field', FIELDS)
def test_plan_model(field):
    """``field_bwd_plan``: kernel B's config, the field's row of kernel B's
    buffer plan (the sheet's and the translation warp's), the field's six
    hidden layers forward then backward (14 loads for the sheet, 28 for the
    warp), numbered in the translation table; it refuses a blob of another
    length. The field's own shapes are the level's rows of the field."""
    shapes = _blob(field)[3]
    first, end = MODULE_STAGES[field]
    assert shapes == _level_shapes()[first:end]
    plan = field_bwd_plan(field, shapes)
    assert plan['config'] == list(FB_CONFIG)
    want = [v for fwd, spill, after, reload in
            FB_PLANS[FIELD_BWD[field].plan]
            for v in (*fwd, spill, after, *reload)]
    assert plan['table'] == want
    loads = plan['loads']
    assert len(loads) == {'warp': 28, 'sheet': 14}[field]
    layers = [l for l, _, _ in loads]
    assert layers[:len(layers) // 2] == sorted(layers[:len(layers) // 2])
    assert layers[len(layers) // 2:] == sorted(layers[len(layers) // 2:],
                                               reverse=True)
    assert {l for l in layers} == set(range(first, first + 6))
    with pytest.raises(ValueError):
        field_bwd_plan(field, shapes[:-1])


def test_entry_point_reports_kernel_b_rows():
    """fields_bwd_alone.cu's plan entry point reports the field's row of
    kernel B's ``buf_plan`` table (the same device code reads it), the
    warp field for code 0, the sheet for code 1, the SE(3) trunk's row
    for code 2 (the trunk alone, and with its tangents, which differ only
    by their streams) and the translation Jacobian's own row for code 3."""
    assert {f: (r.code, r.plan) for f, r in FIELD_BWD.items()} == {
        'warp': (0, 'translation'), 'sheet': (1, 'sheet'),
        'se3': (2, 'se3'), 'se3_tangents': (2, 'se3'),
        'warp_tangents': (3, 'warp_tangents')}
    assert FIELD_BWD['se3']._replace(streams=4) == FIELD_BWD['se3_tangents']
    src = (build.CSRC / 'fields_bwd_alone.cu').read_text()
    body = src[src.index('int hn_fused_field_bwd_plan('):]
    assert re.search(r'which == 0\) \{\s+plan_table\(kTransWarp, table\)',
                     body)
    assert 'plan_table(kSheet, table)' in body
    assert 'plan_table(kSe3Warp, table)' in body
    assert re.search(r'which == 3\) \{\s+plan_table\(kTransJac, table\)',
                     body)
    assert 'which > 3) return -1' in body


@pytest.mark.parametrize('field', FIELDS)
def test_pool_keeps_every_live_output(field):
    """Replay a block tile of the field alone (its recompute, head step,
    walk-back and encoding VJP, no other field) on the slab pool with its
    plan: every layer reads, as input, dW operand, ReLU mask and cotangent,
    the buffer it wants where the plan puts it, and every reload brings back
    a spilled output."""
    _run_pool(_events(FIELD_BWD[field].plan, _level_shapes()))


@pytest.mark.parametrize('field', FIELDS)
def test_every_output_stored_once(field):
    """Each stored layer output (enc, h0..h5) is written once, box by box,
    in the recompute; only the warp field spills (its 14 slabs do not fit
    the pool's 8; the sheet's 7 do), and then into scratch slabs of its own
    inside the block's FB_SPILL_SLABS."""
    stored = _run_pool(_events(FIELD_BWD[field].plan, _level_shapes()))
    outputs = [k for k in stored if k[0] in BUF and k[0] != 'skip']
    assert all(len(stored[k]) == 1 for k in outputs)
    assert {k[0] for k in outputs} == {'enc', *[f'h{i}' for i in range(6)]}
    assert field_bwd_spills(field) == (field == 'warp')
    used = [spill + b for fwd, spill, _, _ in
            FB_PLANS[FIELD_BWD[field].plan] if spill >= 0
            for b in range(sum(s >= 0 for s in fwd))]
    assert len(used) == len(set(used)) and all(0 <= s < FB_SPILL_SLABS
                                               for s in used)


@pytest.mark.parametrize('field', FIELDS)
def test_clobbering_plan_fails(field):
    """The replay sees a fault: moving the top hidden output onto the slot
    of an output that the walk-back still reads is caught."""
    name = FIELD_BWD[field].plan
    saved = FB_PLANS[name]
    bad = list(saved)
    fwd, spill, after, reload = bad[BUF['h5']]
    bad[BUF['h5']] = ((saved[BUF['h4']][0][0], fwd[1]), spill, after,
                      reload)
    FB_PLANS[name] = bad
    try:
        with pytest.raises(AssertionError):
            _run_pool(_events(name, _level_shapes()))
    finally:
        FB_PLANS[name] = saved


# ---------------------------------------------------------------------------
# The weight stream.


@pytest.mark.parametrize('field', FIELDS)
def test_tensor_maps_cover_each_hidden_layer(field):
    """Over the field's own blob every map starts 256-byte aligned with a
    row stride of whole 16 bytes, and each hidden layer's forward loads
    (and its backward loads, the same boxes), read with the zero fill past
    a map's edge, rebuild exactly that layer's packed weight."""
    mlp, w_blob, _, shapes = _blob(field)
    packed = mlp._packed['packed']
    first = MODULE_STAGES[field][0]
    offsets = np.cumsum([0] + [n * k for n, k in shapes])
    loads = field_bwd_loads(field, shapes)
    half = len(loads) // 2
    assert sorted(loads[:half]) == sorted(loads[half:])
    for m0, count, n, k in forward_maps(shapes):
        assert (2 * offsets[m0]) % 256 == 0 and (2 * k) % 16 == 0
        view = w_blob[offsets[m0]:offsets[m0] + count * n * k].view(
            count * n, k)
        for i in range(m0, min(m0 + count, 6)):
            rebuilt = torch.zeros((n, -(-k // 64) * 64), dtype=w_blob.dtype)
            for l, kb, rows in loads[:half]:
                if l == first + i:
                    assert rows == n <= FB_STAGE_BYTES // 128
                    rebuilt[:, kb * 64:(kb + 1) * 64] = _tma_box(
                        view, kb * 64, (i - m0) * n, rows)
            assert torch.equal(rebuilt[:, :k], packed[i][0])
            assert not rebuilt[:, k:].any()


def _block0_tiles(n_points):
    tiles = -(-n_points // FB_TILE_ROWS)
    return len(range(0, tiles, min(tiles, SMS)))


@pytest.mark.parametrize('field', FIELDS)
@pytest.mark.parametrize('n_points', [481, 37 * 13, 2 * SMS * 128 + 70])
def test_loads_through_the_ring(field, n_points):
    """Block 0's producer issues the field's loads once per block tile it
    takes (a tile whose rows end inside it included), and both consumer
    warpgroups take them in that order; through the ring with random
    interleavings no consumer reads a stage early or late, no fill
    overtakes a consumer, nothing deadlocks."""
    tiles = _block0_tiles(n_points)
    assert tiles == 1 if n_points < 1000 else tiles == 3
    order = field_bwd_loads(field, _blob(field)[3]) * tiles
    ends = {i for i in range(len(order))
            if i + 1 == len(order) or order[i + 1][0] != order[i][0]
            or order[i + 1][1] <= order[i][1]}
    for seed in range(2):
        assert _run_ring(order, ends,
                         np.random.default_rng(seed)) == len(order)


def test_stream_bytes():
    """A block tile reads the field's hidden weights twice (forward and
    backward); the warp and the sheet alone read what kernel B reads with
    the translation warp."""
    total = 0
    for field in FIELDS:
        shapes = _blob(field)[3]
        hidden = sum(2 * n * k for n, k in shapes if n > 8)
        got = field_bwd_stream_bytes(field, shapes, 16384 * 128)
        assert got == 16384 * 2 * hidden
        assert field_bwd_stream_bytes(field, shapes, 481) == 4 * 2 * hidden
        total += got
    assert total == fields_bwd_stream_bytes('translation', _level_shapes(),
                                            16384 * 128)


# ---------------------------------------------------------------------------
# The dW / db flush.


@pytest.mark.parametrize('field', FIELDS)
def test_dw_flush_covers_each_weight_once(field):
    """Every weight and bias of the field's seven layers is added once per
    block tile: the hidden layers' 64 x 64 units, the head's tasks (one per
    (output, input) and one db per output) of head_back; each gradient copy
    starts 16-byte aligned for the vector adds."""
    shapes = _blob(field)[3]
    n_out = {'warp': 3, 'sheet': 4}[field]
    for l, (n, k) in enumerate(shapes):
        if l == 6:
            assert n == 8
            tasks = [(t // k, t % k) for t in range(n_out * k)]
            assert sorted(tasks) == [(a, b) for a in range(n_out)
                                     for b in range(k)]
            continue
        for dw, db in _unit_flush(n, k):
            assert set(dw) == {(a, b) for a in range(n) for b in range(k)}
            assert set(dw.values()) == {1}
            assert set(db) == set(range(n)) and set(db.values()) == {1}
    per_copy = sum(n * k + n for n, k in shapes)
    assert per_copy % 4 == 0
    grads, n_w = fl.fields_bwd_grad_copies(shapes, 'cpu')
    assert grads.shape == (FB_GRAD_COPIES, per_copy) and n_w % 4 == 0


# ---------------------------------------------------------------------------
# The launch.


@pytest.mark.parametrize('field', FIELDS)
@torch.no_grad()
def test_launch_matches_the_c_signature(field, monkeypatch):
    """``fused_field_bwd`` on a device tensor asks kernel B's grid for the
    rows, then passes ``hn_fused_field_bwd`` eight pointers (the field's one
    weight blob, no transposed one; FB_GRAD_COPIES gradient copies; a
    spill scratch of blocks x FB_SPILL_SLABS slabs for the warp field, None
    for the sheet) and the sizes, of the declared kinds; the copies are
    summed into the gradients, and the wrapper's count rises by one.
    ``compiled_field_bwd_plan`` passes ``hn_fused_field_bwd_plan`` the
    field's code."""
    assert build._SIGNATURES['hn_fused_field_bwd'] == (
        [ctypes.c_int] + [ctypes.c_void_p] * 8
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p], ctypes.c_int)
    assert build._SIGNATURES['hn_fused_field_bwd_plan'] == (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int],
        ctypes.c_int)
    assert 'hn_fused_field_bwd_blocks' not in build._SIGNATURES
    f = _field(field)
    mlp, n_freq = f.mlp, f.n_freq
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
    g = torch.from_numpy(rs.rand(p, 8).astype(np.float32))
    scales = ff.encoding_scales(n_freq, 8, 0.45 * n_freq)
    launches = ff.fused_field_bwd.launches
    dx, grads = ff.fused_field_bwd(mlp, n_freq, x, g, scales)
    assert ff.fused_field_bwd.launches == launches + 1
    fl.compiled_field_bwd_plan(field)
    assert [n for n, _ in lib.calls] == ['hn_fused_fields_bwd_blocks',
                                         'hn_fused_field_bwd',
                                         'hn_fused_field_bwd_plan']
    (_, blocks_args), (_, launch), (_, plan) = lib.calls
    assert blocks_args == (p,)
    _check_kinds('hn_fused_field_bwd', launch)
    w, b, shapes = common.pack_layers(mlp, ff.field_layers(mlp))
    assert launch[0] == FIELD_BWD[field].code
    assert launch[1] == x.data_ptr() and launch[3] == g.data_ptr()
    assert launch[2] is not None  # the padded window row
    assert launch[4] == w.data_ptr() and launch[5] == b.data_ptr()
    assert launch[6] == dx.data_ptr()
    assert launch[-3:] == (p, 3, 7)
    copies = [t for t in allocated if t.dim() == 2
              and t.shape[0] == FB_GRAD_COPIES]
    assert len(copies) == 1 and launch[7] == copies[0].data_ptr()
    scratch = [t for t in allocated if t.dtype == torch.uint8]
    if field == 'warp':
        assert [t.numel() for t in scratch] == [3 * FB_SPILL_SLABS
                                                * FB_SLAB_BYTES]
        assert launch[8] == scratch[0].data_ptr()
    else:
        assert scratch == [] and launch[8] is None
    _check_kinds('hn_fused_field_bwd_plan', plan)
    assert plan[0] == FIELD_BWD[field].code and plan[-1] == 256
    assert len(grads) == 14 and dx.shape == x.shape


@pytest.mark.parametrize('field', FIELDS)
@torch.no_grad()
def test_no_transposed_blob(field, monkeypatch):
    """The cotangent product reads the streamed weights MN-major, so the
    field backward packs no transposed weight blob: its launch arguments
    have no such option and the field's pack cache holds none after a
    backward launch."""
    assert list(inspect.signature(ff._launch_args).parameters) == [
        'mlp', 'n_freq', 'x_raw', 'scales']
    f = _field(field)
    monkeypatch.setattr(build, 'library', lambda: _RecordingLibrary(1))
    monkeypatch.setattr(common, 'kernel_layout', lambda w='translation':
                        _level_shapes())
    monkeypatch.setattr(common, 'runs_plain', lambda t, name: False)
    monkeypatch.setattr(torch.cuda, 'device', lambda d: _Null())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: type('S', (), {'cuda_stream': 7}))
    x = torch.rand(37, 11)
    ff.fused_field_bwd(f.mlp, f.n_freq, x, torch.rand(37, 8))
    assert 'wt' not in f.mlp._packed
    w = f.mlp._packed['w']
    assert w.numel() == sum(n * k for n, k in f.mlp._packed['shapes'])
