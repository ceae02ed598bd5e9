"""The translation warp's Jacobian backward (``csrc/warp_tangents_bwd.cu``:
kernel B's block, ring and slab pool of ``csrc/fields_bwd.cuh`` run on the
warp field with its three point-tangent streams, ``csrc/fields_bwd_alone.cuh``;
modelled by ``fused_level.field_bwd_plan('warp_tangents', ...)``) on the CPU:
its plan row against the model, the slab pool replayed through a block tile
with both bf16 halves of the cotangent (no live output or half clobbered,
a clobbering plan caught), the weight loads through the ring, the bytes
streamed, the dW flush covering each weight once with no db, g's nine
columns to their tangent rows, d enc's band columns to the fp32 rows and
the pullback from them, the halves' rounding against ``split_cotangent``,
db and d embed exactly zero, and the launch's ctypes arguments with no
transposed blob.

The card holds the compiled plan to this model (``chip_smoke.py`` phase 13,
``compiled_field_bwd_plan``) and the kernel's numbers to its plain version
and to the stored JAX gradients; these tests hold the model to the rules the
kernel relies on. All checks are exact unless a tolerance is stated.
"""

import ctypes
import importlib
import inspect

import numpy as np
import pytest
import torch

from hypernerf_tpu_torch.flagship import flagship_model, load_probe_weights
from hypernerf_tpu_torch.kernels import build, common, f32
from hypernerf_tpu_torch.kernels.fused_level import (
    FB_BUFS, FB_CONFIG, FB_FIELDS, FB_GRAD_COPIES, FB_PLANS, FB_SLAB_BYTES,
    FB_SLOTS, FB_SPILL_SLABS, FB_STAGE_BYTES, FB_TILE_ROWS, FIELD_BWD,
    MODULE_STAGES, field_bwd_loads, field_bwd_plan, field_bwd_spills,
    field_bwd_stream_bytes, lo_slot, tangent_row)
from test_torch_fields_bwd_plan import (BUF, _check_kinds, _Null,
                                        _RecordingLibrary, _run_pool,
                                        _run_ring, _unit_flush)

ff = importlib.import_module('hypernerf_tpu_torch.kernels.fused_field')
fj = importlib.import_module('hypernerf_tpu_torch.kernels.fused_jacobian')
fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')

PLAN = 'warp_tangents'
SMS = 132  # an H100's SMs: the persistent grid's width
WIDTH, BANDS = 128, 10  # the warp field's width, posenc_orig's bands


def _mlp():
    return load_probe_weights(flagship_model('cpu', config='elastic')) \
        .warp_field.mlp


def _shapes(mlp=None):
    mlp = mlp or _mlp()
    return common.pack_layers(mlp, ff.field_layers(mlp))[2]


# ---------------------------------------------------------------------------
# The plan.


def test_plan_model():
    """``field_bwd_plan('warp_tangents', ...)``: kernel B's config, the
    Jacobian's own row of the buffer plan (the C table's fourth), the warp
    field's six hidden layers forward then backward (28 loads, layers 0..5 of
    the translation table, the field's own blob), 4 rows a point; it refuses
    a blob of another length."""
    shapes = _shapes()
    assert FIELD_BWD[PLAN] == (3, PLAN, 'warp', 4, 6)
    assert MODULE_STAGES['warp'] == (0, 7)
    assert FB_FIELDS.index(PLAN) == FIELD_BWD[PLAN].code == 3
    plan = field_bwd_plan(PLAN, shapes)
    assert plan['config'] == list(FB_CONFIG)
    assert plan['table'] == [v for fwd, spill, after, reload in FB_PLANS[PLAN]
                             for v in (*fwd, spill, after, *reload)]
    assert len(plan['table']) == 6 * len(FB_BUFS)
    loads = plan['loads']
    assert len(loads) == 28
    layers = [l for l, _, _ in loads]
    assert layers[:14] == sorted(layers[:14])
    assert layers[14:] == sorted(layers[14:], reverse=True)
    assert set(layers) == set(range(6))
    assert loads == field_bwd_loads('warp', shapes)
    with pytest.raises(ValueError):
        field_bwd_plan(PLAN, shapes[:-1])


def test_entry_point():
    """warp_tangents_bwd.cu instantiates fields_bwd_alone.cuh's kernel for
    the Jacobian's field with the tangent streams, refuses a window row, and
    the plan entry point reports that field's row for code 3; the old
    mma.sync sources are gone, and no source keeps their device code."""
    text = (build.CSRC / 'warp_tangents_bwd.cu').read_text()
    assert 'launch_field_bwd<fb::kTransJac, true>' in text
    assert '#include "fields_bwd_alone.cuh"' in text
    assert 'if (scales != nullptr) return (int)cudaErrorInvalidValue;' in text
    for gone in ('fused_jacobian_bwd.cu', 'field_bwd.cuh', 'jacobian.cuh',
                 'fused_jacobian.cu', 'fused_se3_jacobian.cu',
                 'level_bwd.cuh'):
        assert not (build.CSRC / gone).exists()
    src = (build.CSRC / 'fields_bwd.cuh').read_text()
    assert 'kTransJac = 3' in src
    for path in build._sources():
        text = path.read_text()
        for name in ('split_bf', 'gemm_split', 'jac_dx_split',
                     'jac_dw_split', 'mma.sync', 'mma_bf16', 'ldg32',
                     'lds32(', 'tiles_per_warp', 'struct Cfg', 'jac_layer',
                     'jac_head', 'encode_trans_streams', 'JC<'):
            assert name not in text, (path.name, name)


# ---------------------------------------------------------------------------
# The slab pool through a block tile, with the cotangent's two halves.


def _loc(buf, box, i, plan=PLAN):
    """fields_bwd.cuh's slot_at: the slot of ``buf``'s box at walk-back
    layer i."""
    fwd, _, after, reload = FB_PLANS[plan][BUF[buf]]
    return reload[box] if after > i else fwd[box]


def _jac_events(plan=PLAN):
    """The Jacobian kernel's block tile as slot events (as in
    test_torch_fields_bwd_plan's ``_events``): the recompute with its
    spills; the head step (h5 read for dW and its mask, g5's high half over
    it, its low half into the lo row); per walk-back layer i, dW reading g_i
    (both halves) and the layer's inputs, a barrier, then g W box by box in
    the order the kernel runs it: box kb + 1's product (reading g_i's two
    halves) goes out before box kb's epilogue reads its mask and writes
    g_(i-1)'s halves; the encoding's boxes go to the fp32 rows; then the
    reloads the plan issues after layer i."""
    wb, eb = WIDTH // 64, 2  # boxes of a hidden output, of the encoding
    ins = [[('enc', b) for b in range(eb)]] + [
        [(f'h{i - 1}', b) for b in range(wb)] for i in range(1, 5)] + [
        [('h4', b) for b in range(wb)] + [('enc', b) for b in range(eb)]]
    ev = []

    def spill(buf, n):
        fwd, at, _, _ = FB_PLANS[plan][BUF[buf]]
        if at >= 0:
            ev.extend(('spill', buf, b, fwd[b]) for b in range(n))

    for b in range(eb):
        ev.append(('w', FB_PLANS[plan][BUF['enc']][0][b], ('enc', b)))
    spill('enc', eb)
    for i in range(6):
        for buf, b in ins[i]:
            ev.append(('r', FB_PLANS[plan][BUF[buf]][0][b], (buf, b)))
        for b in range(wb):
            ev.append(('w', FB_PLANS[plan][BUF[f'h{i}']][0][b], (f'h{i}', b)))
        spill(f'h{i}', wb)
    for b in range(wb):
        s = _loc('h5', b, 6, plan)
        ev.append(('r', s, ('h5', b)))
    for b in range(wb):
        s = _loc('h5', b, 6, plan)
        ev.append(('r', s, ('h5', b)))  # the mask, read before the write
        ev.append(('w', s, ('g5', b)))
        ev.append(('w', lo_slot(plan, 5, b), ('g5lo', b)))

    def g_reads(i):
        for b in range(wb):
            ev.append(('r', _loc(f'h{i}', b, i + 1, plan), (f'g{i}', b)))
            ev.append(('r', lo_slot(plan, i, b), (f'g{i}lo', b)))

    for i in range(5, -1, -1):
        g_reads(i)  # dW
        for buf, b in ins[i]:
            ev.append(('r', _loc(buf, b, i, plan), (buf, b)))
        g_reads(i)  # box 0's product
        for kb, (buf, b) in enumerate(ins[i]):
            if kb + 1 < len(ins[i]):
                g_reads(i)  # box kb + 1's product
            if buf == 'enc':
                continue  # d enc's part: fp32 rows
            s = _loc(buf, b, i, plan)
            ev.append(('r', s, (buf, b)))  # the mask
            ev.append(('w', s, (f'g{i - 1}', b)))
            ev.append(('w', lo_slot(plan, i - 1, b), (f'g{i - 1}lo', b)))
        for buf in FB_BUFS:
            fwd, _, after, reload = FB_PLANS[plan][BUF[buf]]
            if after == i:
                n = eb if buf == 'enc' else wb
                ev.extend(('reload', buf, b, reload[b]) for b in range(n))
    return ev


def test_pool_keeps_every_live_output():
    """Replay a block tile of the Jacobian's backward on the slab pool with
    its plan: every read (input, dW operand, ReLU mask, either half of a
    cotangent) finds what it wants where the plan puts it, and every reload
    brings back a spilled output. Only the low halves double-buffer: the
    high half of g_(i-1) goes over h_(i-1), whose mask it reads first."""
    stored = _run_pool(_jac_events())
    outputs = [k for k in stored if k[0] in BUF]
    assert {k[0] for k in outputs} == {'enc', *[f'h{i}' for i in range(6)]}
    assert all(len(stored[k]) == 1 for k in outputs)
    lows = {k: v for k, v in stored.items() if k[0].endswith('lo')}
    assert len(lows) == 6 * 2 and all(len(v) == 1 for v in lows.values())


def test_lo_row_is_a_double_buffer():
    """The lo row: g_i's low half in the forward slots for odd i, in the
    reload slots for even i, never spilled or reloaded (fields_bwd.cuh
    ``lo_slot``); so a layer's new low half never lands on the one its
    products read. Kernel B's other fields have no lo row."""
    fwd, spill, after, reload = FB_PLANS[PLAN][BUF['lo']]
    assert (spill, after) == (-1, -1)
    assert set(fwd).isdisjoint(reload)
    for i in range(1, 6):
        assert {lo_slot(PLAN, i, b) for b in range(2)}.isdisjoint(
            {lo_slot(PLAN, i - 1, b) for b in range(2)})
    assert [lo_slot(PLAN, 5, b) for b in range(2)] == list(fwd)
    assert [lo_slot(PLAN, 4, b) for b in range(2)] == list(reload)
    src = (build.CSRC / 'fields_bwd.cuh').read_text()
    assert ('return i % 2 ? buf_plan(f, kLo).fwd[box] : '
            'buf_plan(f, kLo).reload[box];') in src
    for plan in ('sheet', 'translation', 'se3'):
        assert FB_PLANS[plan][BUF['lo']] == ((-1, -1), -1, -1, (-1, -1))
    # The Jacobian's d enc goes to the fp32 rows: no skip buffer.
    assert FB_PLANS[PLAN][BUF['skip']] == ((-1, -1), -1, -1, (-1, -1))


@pytest.mark.parametrize('bad', ['one_lo', 'enc_over_g0', 'h3_over_h5'])
def test_clobbering_plan_fails(bad):
    """The replay sees a fault: low halves that do not alternate, the
    encoding reloaded onto g_0's high half, h3 kept in h5's slots."""
    saved = FB_PLANS[PLAN]
    rows = list(saved)
    if bad == 'one_lo':
        fwd, spill, after, _ = rows[BUF['lo']]
        rows[BUF['lo']] = (fwd, spill, after, fwd)
    elif bad == 'enc_over_g0':
        fwd, spill, after, _ = rows[BUF['enc']]
        rows[BUF['enc']] = (fwd, spill, after, (4, 5))
    else:
        fwd, spill, after, reload = rows[BUF['h3']]
        rows[BUF['h3']] = (rows[BUF['h5']][0], -1, -1, (-1, -1))
    FB_PLANS[PLAN] = rows
    try:
        with pytest.raises(AssertionError):
            _run_pool(_jac_events())
    finally:
        FB_PLANS[PLAN] = saved


def test_spills_fit_the_scratch():
    """The Jacobian spills the encoding and h0..h3 (ten slabs: its pool
    holds g_i's two halves, an input and the encoding), each into scratch
    slabs of its own inside the block's FB_SPILL_SLABS."""
    assert field_bwd_spills(PLAN)
    used = [spill + b for fwd, spill, _, _ in FB_PLANS[PLAN] if spill >= 0
            for b in range(sum(s >= 0 for s in fwd))]
    assert sorted(used) == list(range(10)) == list(range(FB_SPILL_SLABS))
    slots = [s for fwd, _, _, _ in FB_PLANS[PLAN] for s in fwd if s >= 0]
    assert all(0 <= s < FB_SLOTS for s in slots)


# ---------------------------------------------------------------------------
# The weight stream.


def _block0_tiles(n_rows):
    tiles = -(-n_rows // FB_TILE_ROWS)
    return len(range(0, tiles, min(tiles, SMS)))


@pytest.mark.parametrize('n_points', [1001, 2 * SMS * 32 + 9])
def test_loads_through_the_ring(n_points):
    """Block 0's producer issues the warp field's loads once per block tile
    of 32 points it takes, and both consumer warpgroups take them in that
    order: through the ring with random interleavings no consumer reads a
    stage early or late, no fill overtakes a consumer, nothing
    deadlocks."""
    tiles = _block0_tiles(4 * n_points)
    assert tiles == (1 if n_points < 2000 else 3)
    order = field_bwd_loads(PLAN, _shapes()) * tiles
    ends = {i for i in range(len(order))
            if i + 1 == len(order) or order[i + 1][0] != order[i][0]
            or order[i + 1][1] <= order[i][1]}
    for seed in range(2):
        assert _run_ring(order, ends,
                         np.random.default_rng(seed)) == len(order)


def test_stream_bytes():
    """A block tile reads the field's hidden weights twice (forward and
    backward), once per 32 points: at the train step's 262,144 points, what
    the warp field alone reads at 1 M rows."""
    shapes = _shapes()
    hidden = sum(2 * n * k for n, k in shapes[:6])
    assert field_bwd_stream_bytes(PLAN, shapes, 262144) == \
        field_bwd_stream_bytes('warp', shapes, 4 * 262144) == \
        8192 * 2 * hidden


# ---------------------------------------------------------------------------
# The flush: dW once a block tile, no db.


def _dead(i, kb):
    """fields_bwd.cuh's jac_dead: input box kb of layer i is an encoding box
    past posenc's 63 columns."""
    enc_first = 0 if i == 0 else 2 if i == 5 else None
    return enc_first is not None and kb >= enc_first and \
        (kb - enc_first) * 64 >= 63


def test_dead_boxes_are_zero():
    """The encoding's second box (its embedding columns 63.. and the pad)
    is dead in the Jacobian's walk-back: layer 0's input box 1 and layer
    5's box 3, and no other. Its tangent rows' encoding is zero and the
    primal rows carry no cotangent, so the plain version's dW over those
    columns is exactly zero (the kernel skips those units, which the zeroed
    gradient copies keep at zero) and its d enc there reaches nothing; the
    kernel releases their ring stages unread."""
    dead = [(i, kb) for i in range(6) for kb in range(4 if i == 5 else 2)
            if _dead(i, kb)]
    assert dead == [(0, 1), (5, 3)]
    mlp = _mlp()
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.uniform(-1, 1, (29, 11)).astype(np.float32))
    g = torch.from_numpy(rs.randn(29, 9).astype(np.float32))
    _, grads = fj.fused_jacobian_bwd_plain(mlp, BANDS, x, g)
    assert not grads[0][:, 63:].any()
    assert not grads[10][:, WIDTH + 63:].any()
    assert grads[0][:, :63].abs().sum() > 0
    src = ' '.join((build.CSRC / 'fields_bwd.cuh').read_text().split())
    for line in ('return f == kTransJac && in_buf(f, i, kb) == kEnc && '
                 'in_box(f, i, kb) * kBoxCols >= kWarpPts;',
                 'if (jac_dead(F, I, unit(m) % NI)) continue;',
                 'if (jac_dead(F, I, kb)) continue;',
                 'if (kb + 1 < NI && jac_dead(F, I, kb + 1)) skip_box();'):
        assert line in src, line


def test_dw_flush_covers_each_weight_once_and_no_db():
    """Every weight of the field's seven layers but the dead box's is added
    once per block tile (the hidden layers' 64 x 64 units, the dead ones
    skipped, the head's one task per (input, part) over its three outputs);
    the kernel adds no db (it is exactly zero, and the zeroed copies keep it
    so); each gradient copy starts 16-byte aligned for the vector adds."""
    shapes = _shapes()
    for l, (n, k) in enumerate(shapes[:6]):
        live = {(a, b) for a in range(n) for b in range(k)
                if not _dead(l, b // 64)}
        for dw, _ in _unit_flush(n, k):
            got = {key: v for key, v in dw.items()
                   if not _dead(l, key[1] // 64)}
            assert set(got) == live
            assert set(got.values()) == {1}
    assert shapes[6] == (8, WIDTH)
    tasks = [(t % WIDTH, t // WIDTH) for t in range(2 * WIDTH)]
    assert len(set(tasks)) == 2 * WIDTH  # (input, part of the 128 rows)
    src = (build.CSRC / 'fields_bwd.cuh').read_text()
    assert 'if (!kJac && ib == 0) {' in src
    assert 'if (!kJac && t < kHeads * n_out) {' in src
    per_copy = sum(n * k + n for n, k in shapes)
    assert per_copy % 4 == 0
    grads, n_w = fl.fields_bwd_grad_copies(shapes, 'cpu')
    assert grads.shape == (FB_GRAD_COPIES, per_copy) and n_w % 4 == 0


# ---------------------------------------------------------------------------
# The rows: g's columns, d enc's band columns, the pullback.


C_JAC_ROWS = ('rw.hg[R0 + tan_row(e / kW, 1 + e % kW % 3)][e % kW / 3] = '
              'gv[i];')


def test_g_columns_to_their_tangent_rows():
    """fields_bwd_alone.cuh's ``tangent_rows`` for the Jacobian puts g[:, 3
    i + k] on row ``tangent_row(q, 1 + k)``, head column i, the primal rows'
    head cotangent zero: the plain version's ``g_out`` (tangent row k takes
    column k of dJ), evaluated, against it."""
    src = (build.CSRC / 'fields_bwd_alone.cuh').read_text()
    body = ' '.join(src[src.index('void tangent_rows('):].split())
    assert C_JAC_ROWS in body
    assert 'rw.hg[R0 + tan_row(c.tid / 3, 0)][c.tid % 3] = 0.f;' in body
    p, kw = 16, 9
    g = torch.arange(p * kw, dtype=torch.float32).reshape(p, kw)
    hg = torch.full((64, 3), float('nan'))
    for e in range(p * kw):
        hg[tangent_row(e // kw, 1 + e % kw % 3), e % kw // 3] = g.view(-1)[e]
    for t in range(p * 3):
        hg[tangent_row(t // 3, 0), t % 3] = 0.0
    want = fj.stream_rows(g.reshape(p, 3, 3).permute(2, 0, 1))  # (3p, 3)
    for q in range(p):
        assert torch.equal(hg[tangent_row(q, 0)], torch.zeros(3))
        for k in range(3):
            assert torch.equal(hg[tangent_row(q, 1 + k)], want[k * p + q])


def _enc_rows_model():
    """jac_enc_rows, in Python: for each lane, row half and column of the
    lane's m64n64 fragment of encoding box 0, the (row, acc index) it
    writes, if any."""
    writes = {}
    for lane in range(32):
        t = lane & 3
        for h in range(2):
            r = (lane >> 2) + 8 * h  # a warp's row
            k = ((r >> 2) & 3) - 1
            if k < 0:
                continue
            for j in range(8):
                for e in range(2):
                    col = 8 * j + 2 * t + e
                    if col < 3 or col >= 63 or col % 3 != k:
                        continue
                    writes.setdefault((r, (col - 3) // 3), []).append(col)
    return writes


def test_enc_rows_keep_each_band_column_once():
    """d enc's two parts reach the fp32 rows by jac_enc_rows: each tangent
    row of channel k gets its 20 values once, sin band j at index j from
    column 3 + 3 j + k, cos band j at 10 + j from column 33 + 3 j + k (the
    columns ``tangent_encode_dp`` reads), all in encoding box 0, and nothing
    else; no primal row takes any. The C source holds the same
    arithmetic."""
    src = ' '.join((build.CSRC / 'fields_bwd.cuh').read_text().split())
    for line in ('const int col = 8 * j + 2 * t + e;',
                 'if (col < 3 || col >= kWarpPts || col % 3 != k) continue;',
                 'float& a = acc[(col - 3) / 3];'):
        assert line in src, line
    writes = _enc_rows_model()
    for r in range(16):
        k = ((r >> 2) & 3) - 1
        got = {idx: cols for (rr, idx), cols in writes.items() if rr == r}
        if k < 0:
            assert not got
            continue
        assert sorted(got) == list(range(2 * BANDS))
        for j in range(BANDS):
            assert got[j] == [3 + 3 * j + k]
            assert got[BANDS + j] == [3 + 3 * BANDS + 3 * j + k]


def test_pullback_from_the_rows():
    """jac_vjp's d pts from the 20 fp32 values a tangent row keeps (each
    band's two halves of channel k's bands split between two lanes) is
    ``tangent_encode_dp``'s on the whole tangent cotangent (relative 1e-6,
    fp32 sums in another order)."""
    rs = np.random.RandomState(5)
    p, enc = 37, 80
    pts = torch.from_numpy(rs.uniform(-1.5, 1.5, (p, 3)).astype(np.float32))
    g_enc = torch.from_numpy(rs.randn(3, p, enc).astype(np.float32))
    sin, cos = common.posenc_trig(pts, BANDS)
    nb = 3 * BANDS
    want = fj.tangent_encode_dp(g_enc[..., 3:3 + nb],
                                g_enc[..., 3 + nb:3 + 2 * nb], sin, cos,
                                BANDS)
    acc = torch.zeros(3, p, 2 * BANDS)
    for j in range(BANDS):
        for k in range(3):
            acc[k, :, j] = g_enc[k, :, 3 + 3 * j + k]
            acc[k, :, BANDS + j] = g_enc[k, :, 3 + nb + 3 * j + k]
    half = (BANDS + 1) // 2
    got = torch.zeros(p, 3)
    for c in range(3):
        parts = []
        for lo, hi in ((0, half), (half, BANDS)):
            dx = torch.zeros(p)
            for k in range(lo, hi):
                f = 2.0 ** k
                sn, cs = torch.sin(pts[:, c] * f), torch.cos(pts[:, c] * f)
                dx = dx + (-sn * (acc[c, :, k] * f)
                           - cs * (acc[c, :, BANDS + k] * f)) * f
            parts.append(dx)
        got[:, c] = parts[0] + parts[1]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(
        want.abs().max()))
    src = ' '.join((build.CSRC / 'fields_bwd_alone.cuh').read_text().split())
    assert ('dx += (-sn * (g[k] * f) - cs * (g[kWarpF + k] * f)) * f;'
            in src)


# ---------------------------------------------------------------------------
# The halves' rounding; db and d embed.


def test_halves_are_split_cotangent():
    """mask_split's two halves, hi = bf16(v) and lo = bf16(v - hi) with v -
    hi exact in fp32, sum to ``split_cotangent``'s value bit for bit, and a
    product that reads both into one fp32 sum is the plain version's
    product of that value (up to the order of the sums); the mask zeroes
    both halves."""
    rs = np.random.RandomState(2)
    v = torch.from_numpy((rs.randn(4096) * 10.0 ** rs.uniform(
        -6, 3, 4096)).astype(np.float32))
    hi = v.to(torch.bfloat16).float()
    lo = (v - hi).to(torch.bfloat16).float()
    assert torch.equal((v - hi) + hi, v)  # the difference is exact
    assert torch.equal(hi + lo, fj.split_cotangent(v, torch.bfloat16))
    assert (lo.abs() <= hi.abs() * 2.0 ** -8).all()
    err = ((hi + lo) - v).abs() / v.abs()
    assert err.max() <= 2.0 ** -16
    w = torch.from_numpy(rs.randn(4096).astype(np.float32)).to(
        torch.bfloat16).float()
    two = (hi * w).double().sum() + (lo * w).double().sum()
    one = ((hi + lo).double() * w.double()).sum()
    assert abs(float(two - one)) <= 1e-9 * float((v.abs() * w.abs()).sum())
    src = ' '.join((build.CSRC / 'fields_bwd.cuh').read_text().split())
    assert 'hi = pack_bf(v0, v1); lo = pack_bf(lo_half(v0), lo_half(v1));' \
        in src
    assert 'return round_bf(v) + round_bf(lo_half(v));' in src


def test_db_and_d_embed_are_zero():
    """Only J carries a cotangent, and biases and the embedding reach it
    only through the ReLU masks: the plain backward's every db and its d
    embed are exactly zero, and its dW moves with g."""
    mlp = _mlp()
    rs = np.random.RandomState(3)
    p = 23
    x = torch.from_numpy(rs.uniform(-1, 1, (p, 11)).astype(np.float32))
    g = torch.from_numpy(rs.randn(p, 9).astype(np.float32))
    dx, grads = fj.fused_jacobian_bwd_plain(mlp, BANDS, x, g)
    dx2, grads2 = fj.fused_jacobian_bwd_plain(mlp, BANDS, x, 2 * g)
    assert torch.equal(dx[:, 3:], torch.zeros(p, 8))
    for i in range(0, len(grads), 2):
        assert not grads[i + 1].any()
        assert torch.allclose(grads2[i], 2 * grads[i], rtol=1e-2,
                              atol=1e-6)
    assert dx[:, :3].abs().max() > 0


# ---------------------------------------------------------------------------
# The launch.


@torch.no_grad()
def test_launch_matches_the_c_signature(monkeypatch):
    """``fused_jacobian_bwd`` on a device tensor asks kernel B's grid for
    4 rows a point, then passes ``hn_fused_jacobian_bwd`` eight pointers
    (x_raw, no window row, g, the field's one weight blob and its biases, no
    transposed blob, dx_raw, FB_GRAD_COPIES gradient copies, a spill scratch
    of blocks x FB_SPILL_SLABS slabs) and the sizes, of the declared kinds;
    the copies are summed into the gradients, and the wrapper's count rises
    by one. ``compiled_field_bwd_plan`` passes the plan entry point code
    3."""
    name = 'hn_fused_jacobian_bwd'
    assert build._SIGNATURES[name] == (
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_void_p], ctypes.c_int)
    assert f'{name}_blocks' not in build._SIGNATURES
    mlp = _mlp()
    layout = fl.pack_level(load_probe_weights(flagship_model(
        'cpu', config='elastic')).level('fine'))[2]
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
    g = torch.from_numpy(rs.rand(p, 9).astype(np.float32))
    launches = fj.fused_jacobian_bwd.launches
    dx, grads = fj.fused_jacobian_bwd(mlp, BANDS, x, g)
    assert fj.fused_jacobian_bwd.launches == launches + 1
    fl.compiled_field_bwd_plan(PLAN)
    assert [n for n, _ in lib.calls] == ['hn_fused_fields_bwd_blocks', name,
                                         'hn_fused_field_bwd_plan']
    (_, blocks_args), (_, launch), (_, plan) = lib.calls
    assert blocks_args == (4 * p,)
    _check_kinds(name, launch)
    w, b, shapes = common.pack_layers(mlp, ff.field_layers(mlp))
    assert launch[0] == x.data_ptr() and launch[1] is None
    assert launch[2] == g.data_ptr()
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
    assert plan[0] == 3 and plan[-1] == 256
    assert len(grads) == 14 and dx.shape == x.shape
    assert 'wt' not in mlp._packed


def test_no_transposed_blob(monkeypatch):
    """The cotangent product reads the streamed weights MN-major, so the
    Jacobian packs one weight blob for both kernels: the launch arguments
    have no transposed option, and a bf16 field's packed blobs hold no
    transposed form after them; a float32 field's (rows 14 and 15 have
    float32 kernels) add the transposed blob the float32 kernels read,
    cached apart (the layouts' checks, which need the library, stubbed)."""
    assert list(inspect.signature(fj._launch_args).parameters) == [
        'mlp', 'n_freq', 'x_raw']
    monkeypatch.setattr(common, 'check_layout', lambda *a, **k: None)
    monkeypatch.setattr(f32, 'check_layout', lambda *a, **k: None)
    for dtype in ('bfloat16', 'float32'):
        mlp = flagship_model('cpu', config='elastic',
                             compute_dtype=dtype).warp_field.mlp
        blobs = fj._launch_args(mlp, 10, torch.zeros(4, 11))
        assert len(blobs) == (4 if dtype == 'float32' else 3)
        packed = getattr(mlp, common.packed_attr(mlp.dtype))
        assert ('wt' in packed) == (dtype == 'float32')
    assert FB_STAGE_BYTES == 128 * 128
