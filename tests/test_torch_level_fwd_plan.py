"""The level forward kernel's plan (``csrc/level_fwd.cuh``, modelled in
``kernels/fused_level.py``) on the CPU: the tensor maps over
``pack_level``'s blob, the activation tile's column plan, the 128-byte
swizzle the epilogue writes and ``wgmma`` reads, the weight stream's order
through the ring, and the C entry points' ctypes signatures.

The card holds the compiled plan to this model (``chip_smoke.py`` phase 3,
``compiled_forward_plan``) and the kernel's numbers to its plain version;
these tests hold the model to the rules the kernel relies on. All checks
are exact (integers and copies of bf16 weights).
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
    FWD_BIAS_BYTES, FWD_BOX_COLS, FWD_ENC_COL, FWD_GROUPS, FWD_SMEM_BYTES,
    FWD_STAGE_ROWS, FWD_STAGES, FWD_TILE_COLS, FWD_TILE_ROWS,
    PLANE_SMEM_BYTES, PLANE_TILE_COLS, block_stages, forward_in_cols,
    forward_loads, forward_maps, forward_plan, forward_stream_bytes,
    fwd_smem_bytes, level_layers, pack_level)
from hypernerf_tpu_torch.kernels.fused_mlp import (alpha_cond_weight,
                                                   kernel_template_layers)

fused_level_module = importlib.import_module(
    'hypernerf_tpu_torch.kernels.fused_level')

# The level tables by the configuration whose level has them; 'plane*' are
# the levels without a sheet with the template's plane layout (its 192-column
# encoding on tiles of PLANE_TILE_COLS columns), 'nerfies_plane*' with its
# Nerfies plane layout (128 columns, the level's tiles).
WARPS = {'translation': 'flagship', 'se3': 'se3', 'quaternion': 'quaternion',
         'plane': 'plane', 'plane_se3': 'plane_se3',
         'plane_quaternion': 'plane_quaternion',
         'nerfies_plane': 'plane_anneal',
         'nerfies_plane_se3': 'plane_anneal_se3',
         'nerfies_plane_quaternion': 'plane_anneal_quaternion'}
# Each table's tensor maps (runs of layers of one shape) and weight loads of
# a pair of row tiles.
MAPS = {'translation': 16, 'se3': 17, 'quaternion': 17, 'plane': 13,
        'plane_se3': 14, 'plane_quaternion': 14, 'nerfies_plane': 13,
        'nerfies_plane_se3': 14, 'nerfies_plane_quaternion': 14}
LOADS = {'translation': 113, 'se3': 115, 'quaternion': 115, 'plane': 109,
         'plane_se3': 111, 'plane_quaternion': 111, 'nerfies_plane': 105,
         'nerfies_plane_se3': 107, 'nerfies_plane_quaternion': 107}
BOX_BYTES = FWD_TILE_ROWS * 2 * FWD_BOX_COLS  # 64 rows of 128 bytes


def _level(warp):
    return load_probe_weights(flagship_model(
        'cpu', config=WARPS[warp])).level('fine')


def _first_layers(warp):
    """(first sheet layer, first template layer); without a sheet both
    are the template's."""
    h0 = 7 if common.table_warp(warp) == 'translation' else 9
    return (h0, h0 + 7) if common.table_has_sheet(warp) else (h0, h0)


def _tile_cols(warp):
    return PLANE_TILE_COLS if warp in common.PLANE_TABLES else FWD_TILE_COLS


# ---------------------------------------------------------------------------
# The tensor maps over the packed blob.


def _tma_box(view, c0, r0, rows):
    """A TMA box of ``view`` (a 2-d map's (rows, cols)) at column c0, row
    r0, FWD_BOX_COLS wide: out-of-range elements read as zero."""
    box = torch.zeros((rows, FWD_BOX_COLS), dtype=view.dtype)
    part = view[r0:r0 + rows, c0:c0 + FWD_BOX_COLS]
    box[:part.shape[0], :part.shape[1]] = part
    return box


@pytest.mark.parametrize('warp', list(WARPS))
def test_tensor_maps_cover_every_layer(warp):
    """Every map's base is 256-byte aligned and its row stride a multiple of
    16 bytes; each layer's loads cover exactly [0, k_pad) x [0, n_pad), and
    the blob read box by box (zero fill past a map's edge) is each layer's
    packed weight."""
    level = _level(warp)
    w_blob, _, shapes = pack_level(level)
    packed = level.template._packed_level['packed']
    offsets = np.cumsum([0] + [n * k for n, k in shapes])
    maps = forward_maps(shapes)
    assert sum(count for _, count, _, _ in maps) == len(shapes)
    assert len(maps) == MAPS[warp]
    loads = forward_loads(shapes)
    for first, count, n, k in maps:
        assert (2 * offsets[first]) % 256 == 0
        assert (2 * k) % 16 == 0
        assert all(shapes[first + i] == (n, k) for i in range(count))
        view = w_blob[offsets[first]:offsets[first] + count * n * k].view(
            count * n, k)
        for layer in range(first, first + count):
            mine = [(kb, nb, rows) for l, kb, nb, rows in loads
                    if l == layer]
            n_boxes = -(-k // FWD_BOX_COLS)
            assert [(kb, nb) for kb, nb, _ in mine] == [
                (kb, nb) for kb in range(n_boxes)
                for nb in range(-(-n // FWD_STAGE_ROWS))]
            assert (n_boxes - 1) * FWD_BOX_COLS < k <= n_boxes * FWD_BOX_COLS
            rebuilt = torch.zeros((n, n_boxes * FWD_BOX_COLS),
                                  dtype=w_blob.dtype)
            for kb, nb, rows in mine:
                assert rows == min(n, FWD_STAGE_ROWS)
                r0 = nb * FWD_STAGE_ROWS
                rebuilt[r0:r0 + rows,
                        kb * FWD_BOX_COLS:(kb + 1) * FWD_BOX_COLS] = _tma_box(
                    view, kb * FWD_BOX_COLS, (layer - first) * n + r0, rows)
            assert torch.equal(rebuilt[:, :k], packed[layer][0])
            assert not rebuilt[:, k:].any()  # the zero fill past k_pad


def test_stream_bytes():
    """Each pair of row tiles reads the whole blob once: 8192 x 128 rows
    are 8192 pairs of 1,657,856 bytes."""
    shapes = pack_level(_level('translation'))[2]
    assert sum(2 * n * k for n, k in shapes) == 1657856
    assert forward_stream_bytes(shapes, 8192 * 128) == 8192 * 1657856
    assert forward_stream_bytes(shapes, 37 * 13) == 4 * 1657856  # 8 tiles
    assert forward_stream_bytes(shapes, 64 * 3) == 2 * 1657856


# ---------------------------------------------------------------------------
# The kernel's sequence of steps, modelled: ('encode', field) writes that
# field's encoding at its column, ('layer', l) runs layer l (a hidden layer
# writes [0, n), a head writes fp32 rows), ('cond',) writes the rgb
# condition beside the bottleneck.


def _program(warp, n_layers):
    h0, t0 = _first_layers(warp)
    sheet = ([('encode', 'hyper')] + [('layer', l) for l in range(h0, t0)]
             if t0 > h0 else [])
    return ([('encode', 'warp')] + [('layer', l) for l in range(h0)]
            + sheet + [('encode', 'template')]
            + [('layer', l) for l in range(t0, t0 + 10)] + [('cond',)]
            + [('layer', l) for l in range(t0 + 10, n_layers)])


def _fields(warp, n_layers):
    """Each layer's field."""
    h0, t0 = _first_layers(warp)
    return (['warp'] * h0 + ['hyper'] * (t0 - h0)
            + ['template'] * (n_layers - t0))


@pytest.mark.parametrize('warp', list(WARPS))
def test_column_plan(warp):
    """Run the kernel's sequence over a symbolic tile: every layer reads
    exactly its input segments (the field's last hidden output, then the
    encoding or the condition of a skip / rgb layer), each starting on a
    64-column box, inside the tile; so no write overwrites a column that a
    later layer of the same field still reads. The column plan is the C
    one's (``forward_in_cols``)."""
    level = _level(warp)
    shapes = pack_level(level)[2]
    h0, t0 = _first_layers(warp)
    # The packed segments: the template's encoding in its compiled slots.
    layers = level_layers(level)[:t0] + kernel_template_layers(
        level.template)
    in_cols = forward_in_cols(warp)
    field = _fields(warp, len(shapes))
    enc_width = {'warp': shapes[0][1], 'hyper': shapes[h0][1],
                 'template': shapes[t0][1],
                 'cond': shapes[t0 + 11][1] - shapes[t0 + 9][0]}
    cols = _tile_cols(warp)
    tile = [None] * cols
    last_hidden = {}
    for step in _program(warp, len(shapes)):
        if step[0] in ('encode', 'cond'):
            name = step[1] if step[0] == 'encode' else 'cond'
            c0 = FWD_ENC_COL[name]
            assert c0 % FWD_BOX_COLS == 0
            assert c0 + enc_width[name] <= cols
            tile[c0:c0 + enc_width[name]] = [('enc', name)] * enc_width[name]
            continue
        l = step[1]
        n, k = shapes[l]
        segs = layers[l][1]
        assert sum(padded for _, padded in segs) == k
        # What the layer must read: its field's encoding (first layer), else
        # the last hidden output of the field, then the skip's encoding (or
        # the rgb branch's condition).
        if l in (0, h0, t0):
            want = [('enc', field[l])] * k
        else:
            src = last_hidden[field[l]]
            want = [('h', src)] * segs[0][1]
            assert segs[0][1] == shapes[src][0]
            if len(segs) > 1:
                extra = 'cond' if l == t0 + 11 else field[l]
                want += [('enc', extra)] * segs[1][1]
        start = in_cols[l]
        starts, at = [], start
        for _, padded in segs:
            starts.append(at)
            at += padded
        assert all(c % FWD_BOX_COLS == 0 for c in starts), (l, starts)
        assert start + k <= cols
        assert tile[start:start + k] == want, l
        if n > 8:  # a hidden layer: bf16 out, in place over [0, n)
            tile[:n] = [('h', l)] * n
            last_hidden[field[l]] = l
    # Every layer ran once, in table order.
    ran = [s[1] for s in _program(warp, len(shapes)) if s[0] == 'layer']
    assert ran == list(range(len(shapes)))


# ---------------------------------------------------------------------------
# The 128-byte swizzle.


def _x_at(r, c):
    """The byte offset in the tile that level_fwd.cuh's x_at gives."""
    return ((c >> 6) * BOX_BYTES + r * 128
            + ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1))


def _sw128_desc(addr, lbo, sbo):
    """wgmma.cuh's sw128_desc."""
    d = (addr & 0x3FFFF) >> 4
    d |= ((lbo >> 4) & 0x3FFF) << 16
    d |= ((sbo >> 4) & 0x3FFF) << 32
    return d | (1 << 62)


def _wgmma_reads(desc, m, k):
    """Where a K-major `wgmma` operand with 128-byte swizzle finds element
    (row m, column k < 16) of its 64 x 16 (or N x 16) slice: the
    descriptor's start plus (m // 8) strides of SBO and (m % 8) rows of 128
    bytes, then the hardware's swizzle of address bits [4, 7) by [7, 10)."""
    assert desc >> 62 == 1  # 128-byte swizzle
    start = (desc & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    u = start + (m // 8) * sbo + (m % 8) * 128 + 2 * k
    return u ^ (((u >> 7) & 7) << 4)


def test_swizzle_is_a_bijection_on_the_tile():
    addrs = {_x_at(r, c) for r in range(FWD_TILE_ROWS)
             for c in range(FWD_TILE_COLS)}
    assert addrs == set(range(0, FWD_TILE_ROWS * FWD_TILE_COLS * 2, 2))


def test_swizzle_matches_the_descriptor_convention():
    """A tile 1024-byte aligned in shared memory: the element the
    descriptor of box b, k16 step kk (``sw128_desc(X + b * 8192 + kk * 32,
    16, 1024)``, as level_fwd.cuh builds it) reads at (m, k) is the one
    x_at put at (m, 64 b + 16 kk + k); and wgmma.cuh builds the descriptor
    the way modelled here."""
    base = 1024 * 37
    for b in range(FWD_TILE_COLS // FWD_BOX_COLS):
        for kk in range(4):
            desc = _sw128_desc(base + b * BOX_BYTES + kk * 32, 16, 1024)
            for m in range(FWD_TILE_ROWS):
                for k in range(16):
                    assert _wgmma_reads(desc, m, k) == base + _x_at(
                        m, b * FWD_BOX_COLS + kk * 16 + k)
    src = (build.CSRC / 'wgmma.cuh').read_text()
    body = src[src.index('uint64_t sw128_desc'):]
    body = body[:body.index('return d;')]
    for expr in (r'\(smem_addr\(p\) & 0x3FFFF\) >> 4',
                 r'\(lbo >> 4\) & 0x3FFF\) << 16',
                 r'\(sbo >> 4\) & 0x3FFF\) << 32', r'1 << 62'):
        assert re.search(expr, body), expr


@pytest.mark.parametrize('n', [256, 128, 64])
def test_epilogue_writes_each_output_where_x_at_puts_it(n):
    """hidden()'s stores: for each pair of n8 groups (j, j + 1) of half h a
    warp issues one stmatrix x4 whose matrix m holds rows 16 warp + 8 (m %
    2) .. + 7 of group j + m / 2, lane l giving the address of row l % 8 of
    matrix l / 8; row i of a matrix holds the fragments of lanes 4 i .. 4 i
    + 3 (columns 2 (l % 4), + 1), which are accumulator entries d[h][4 j' +
    2 (m % 2) + e] of those lanes. Every output lands where x_at puts it,
    once."""
    halves, width = (2, 128) if n > 128 else (1, n)
    seen = set()
    for warp in range(4):
        for h in range(halves):
            for j in range(0, width // 8, 2):
                addr = {}
                for lane in range(32):
                    i7, jo = lane & 7, lane >> 4
                    row = (16 * warp + i7 + (lane & 8)) * 128
                    jj = j + jo
                    addr[lane] = (row + (h * 2 + (j >> 3)) * BOX_BYTES
                                  + (((jj & 7) ^ i7) << 4))
                for m in range(4):
                    for i in range(8):
                        for t in range(4):
                            for e in range(2):
                                # lane 4 i + t's d[h][4 j' + 2 (m % 2) + e]
                                jp = j + (m >> 1)
                                r = 16 * warp + i + 8 * (m & 1)
                                col = h * 128 + 8 * jp + 2 * t + e
                                got = addr[8 * m + i] + 2 * (2 * t + e)
                                assert got == _x_at(r, col)
                                seen.add((r, col))
    assert len(seen) == FWD_TILE_ROWS * n


def test_tma_fills_weights_in_the_layout_wgmma_reads():
    """A weight box (up to 128 rows of 64 columns) lands, under TMA's
    128-byte swizzle, where the B descriptor of k16 step kk (start + 32 kk,
    SBO 1024) reads it."""
    base = 1024 * 11
    for kk in range(4):
        desc = _sw128_desc(base + kk * 32, 16, 1024)
        for n in range(FWD_STAGE_ROWS):
            for k in range(16):
                col = 16 * kk + k
                tma = n * 128 + ((((2 * col) >> 4) ^ (n & 7)) << 4) \
                    + ((2 * col) & 15)
                assert _wgmma_reads(desc, n, k) == base + tma


# ---------------------------------------------------------------------------
# The weight stream through the ring.


def _consumer_order(warp, shapes, pairs):
    """The loads in the order a consumer warpgroup takes them: per pair of
    tiles, its sequence's layers, each as (box of K) x (half of N), both
    halves' accumulators growing together."""
    out = []
    for _ in range(pairs):
        for step in _program(warp, len(shapes)):
            if step[0] == 'layer':
                n, k = shapes[step[1]]
                out += [(step[1], kb, nb, min(n, FWD_STAGE_ROWS))
                        for kb in range(-(-k // FWD_BOX_COLS))
                        for nb in range(-(-n // FWD_STAGE_ROWS))]
    return out


def _run_ring(order, layer_ends, rng, groups=FWD_GROUPS, stages=FWD_STAGES):
    """Simulate the ring protocol with the producer and groups x 4 consumer
    warps taking turns at random, through ``stages`` stages. Returns the
    number of fills. Raises on a deadlock, on a consumer that reads a stage
    holding another load, or on a fill that overtakes a consumer still using
    the stage."""
    total = len(order)
    holder = [None] * stages          # load index each stage holds
    fills = [0] * stages              # completed fills (full barrier phases)
    released = [set() for _ in range(total)]
    warps = [(g, w) for g in range(groups) for w in range(4)]
    # Each warp: next load to take, the load it still holds (released after
    # the next product is issued, as wgmma_wait<1> lets it, or at the end of
    # its layer).
    nxt = {wp: 0 for wp in warps}
    held = {wp: None for wp in warps}
    produced = 0
    while produced < total or any(nxt[wp] < total or held[wp] is not None
                                  for wp in warps):
        moves = []
        if produced < total:
            s = produced % stages
            prev = produced - stages
            if prev < 0 or len(released[prev]) == len(warps):
                moves.append(('fill', None))
        for wp in warps:
            i = nxt[wp]
            if i < total:
                s = i % stages
                # try_wait.parity(i // stages & 1): the phase of this fill
                # has completed and no later one can have (the producer
                # waits for this warp's release of load i first).
                if fills[s] > i // stages:
                    assert fills[s] == i // stages + 1
                    moves.append(('take', wp))
            elif held[wp] is not None:
                moves.append(('end', wp))
        if not moves:
            raise AssertionError(f'deadlock at {produced} fills, {nxt}')
        kind, wp = moves[rng.integers(len(moves))]
        if kind == 'fill':
            s = produced % stages
            if holder[s] is not None:
                assert len(released[holder[s]]) == len(warps)
            holder[s] = produced
            fills[s] += 1
            produced += 1
        elif kind == 'take':
            i = nxt[wp]
            assert holder[i % stages] == i and order[i] is not None
            if held[wp] is not None:
                released[held[wp]].add(wp)
            held[wp] = i
            nxt[wp] = i + 1
            if i in layer_ends:  # wgmma_wait<0>, then release
                released[i].add(wp)
                held[wp] = None
        else:
            released[held[wp]].add(wp)
            held[wp] = None
    assert all(len(r) == len(warps) for r in released)
    return produced


@pytest.mark.parametrize('warp', list(WARPS))
def test_load_schedule_and_ring(warp):
    """The producer's loads (``forward_loads``, repeated per pair of tiles)
    are the order each consumer takes them over two pairs; through the ring
    of FWD_STAGES stages (the plane layout's levels' 5) with random
    interleavings no
    consumer reads a stage before its load landed or after it was refilled,
    no fill overtakes a stage's consumers, and nothing deadlocks."""
    shapes = pack_level(_level(warp))[2]
    producer = forward_loads(shapes) * 2
    consumer = _consumer_order(warp, shapes, 2)
    assert producer == consumer
    assert len(forward_loads(shapes)) == LOADS[warp]
    layer_ends = {i for i in range(len(producer))
                  if i + 1 == len(producer)
                  or producer[i + 1][0] != producer[i][0]}
    stages = block_stages(_tile_cols(warp))
    assert stages == (5 if warp in common.PLANE_TABLES else FWD_STAGES)
    for seed in range(3):
        assert _run_ring(producer, layer_ends, np.random.default_rng(seed),
                         stages=stages) == len(producer)


def test_shared_memory_fits():
    """Two 48 KB activation tiles, the ring, the row scratch, the biases of
    the larger layer table and the barriers fit an H100 block's 227 KB; the
    tile holds every column the plan uses. The plane layout's two 56 KB
    tiles do with a ring of 5 stages (221,600 bytes), not with 6 (238,000),
    whatever the warp (the SE(3) trunk's rows take the same row scratch);
    every table's biases fit the largest table's room."""
    assert FWD_SMEM_BYTES == 221616 <= 232448
    assert max(FWD_ENC_COL.values()) + 128 <= FWD_TILE_COLS
    assert PLANE_SMEM_BYTES == 221600 <= 232448
    assert FWD_ENC_COL['template'] + 192 == PLANE_TILE_COLS == 448
    assert PLANE_SMEM_BYTES + FWD_STAGE_ROWS * 2 * FWD_BOX_COLS + 16 \
        == 238000 > 232448
    for cols in (128, 256, FWD_TILE_COLS, PLANE_TILE_COLS):
        for groups in (2, 3, 4):
            if groups * cols <= 2 * PLANE_TILE_COLS:
                assert fwd_smem_bytes(groups, cols) <= 232448, (groups, cols)
    biases = {warp: 2 * sum(n for n, _ in pack_level(_level(warp))[2])
              for warp in WARPS}
    assert FWD_BIAS_BYTES == max(biases.values()) == biases['se3']
    assert biases['plane_se3'] < FWD_BIAS_BYTES
    assert all(b % 16 == 0 for b in biases.values())  # 16-byte copies


# ---------------------------------------------------------------------------
# The C entry points' arguments.


class _RecordingLibrary:
    """Stands in for the kernel library: records each entry point's
    arguments and returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def _check_kinds(name, args):
    argtypes = build._SIGNATURES[name][0]
    assert len(args) == len(argtypes), name
    for i, (a, kind) in enumerate(zip(args, argtypes)):
        if kind in (ctypes.c_int, ctypes.c_longlong):
            assert isinstance(a, int) and not isinstance(a, bool), (name, i)
        else:
            assert a is None or isinstance(a, int), (name, i)


@pytest.mark.parametrize('warp', list(WARPS))
@torch.no_grad()
def test_launch_and_plan_match_the_c_signatures(warp, monkeypatch):
    """``_launch_forward`` passes ``hn_fused_level_fwd`` and
    ``compiled_forward_plan`` passes ``hn_fused_level_fwd_plan`` as many
    arguments as ``build``'s ctypes signatures declare, of the declared
    kinds; the launch keeps its entry point's signature."""
    assert build._SIGNATURES['hn_fused_level_fwd'] == (
        [ctypes.c_int] + [ctypes.c_void_p] * 13
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int)
    assert build._SIGNATURES['hn_fused_level_fwd_plan'] == (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int],
        ctypes.c_int)
    level = _level(warp)
    shapes = pack_level(level)[2]
    lib = _RecordingLibrary()
    monkeypatch.setattr(build, 'library', lambda: lib)
    monkeypatch.setattr(common, 'kernel_layout', lambda w='translation':
                        shapes)
    monkeypatch.setattr(torch.cuda, 'device', lambda d: _Null())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: type('S', (), {'cuda_stream': 7}))
    rays, samples = 3, 5
    cond = 27 if warp in common.NERFIES_PLANE_TABLES else 39
    rs = np.random.RandomState(0)
    args = [torch.from_numpy(rs.rand(*shape).astype(np.float32))
            for shape in ((rays, samples), (rays, 3), (rays, 3), (rays, 8),
                          (rays, cond))]
    fused_level_module._launch_forward(level, *args, want_raw_t=True,
                                       warp_scales=None)
    fused_level_module.compiled_forward_plan(warp)
    names = [n for n, _ in lib.calls]
    assert names == ['hn_fused_level_fwd', 'hn_fused_level_fwd_plan']
    (_, launch), (_, plan) = lib.calls
    _check_kinds('hn_fused_level_fwd', launch)
    assert launch[0] == common.TABLE_CODES[warp]
    assert launch[-4:] == (rays, samples, cond, 7)  # the rgb condition's
    assert launch[6] is None and launch[7] is None  # no alpha condition
    assert launch[8] is None  # no trunk window row
    # The template's window row: none with posenc_orig, a row of ones with
    # the Nerfies plane layout, whose tables take one.
    assert (launch[9] is None) == (warp not in common.NERFIES_PLANE_TABLES)
    _check_kinds('hn_fused_level_fwd_plan', plan)
    assert plan[0] == common.TABLE_CODES[warp] and plan[-1] == 1024


def test_each_template_layout_is_its_own_instantiation():
    """The template's layout is a template parameter (a layout struct of
    level_common.cuh): the three warp types' sources compile the posenc_orig
    layout alone, and each other (warp, layout) pair is compiled once, in
    its own source (two warp types a source where both are screw warps);
    ``hn_fused_level_fwd`` sends a window row to the Nerfies layout's
    instantiation of codes 0..2, requires one for codes 6..8 and refuses
    one for codes 3..5; the template alone is compiled for all four."""
    src = {p.name: ' '.join(p.read_text().split())
           for p in build._sources()}
    for stem, code in (('trans', 0), ('se3', 1), ('quat', 2)):
        assert f'launch_level_fwd<{code}, OrigEnc>(' in src[
            f'level_fwd_{stem}.cu']
        assert 'NerfEnc' not in src[f'level_fwd_{stem}.cu']
        assert 'PlaneEnc' not in src[f'level_fwd_{stem}.cu']
    pairs = {'anneal': ((0, 'NerfEnc'),),
             'anneal_screw': ((1, 'NerfEnc'), (2, 'NerfEnc')),
             'plane': ((0, 'PlaneEnc'),),
             'plane_screw': ((1, 'PlaneEnc'), (2, 'PlaneEnc')),
             'nerf_plane': ((0, 'NerfPlaneEnc'),),
             'nerf_plane_screw': ((1, 'NerfPlaneEnc'), (2, 'NerfPlaneEnc'))}
    for stem, want in pairs.items():
        text = src[f'level_fwd_{stem}.cu']
        assert re.findall(r'launch_level_fwd<(\d), (\w+)>\(', text) == [
            (str(c), layout) for c, layout in want]
    assert sorted(n for n, text in src.items()
                  if 'launch_level_fwd<' in text) == sorted(
        f'level_fwd_{s}.cu' for s in (*pairs, 'quat', 'se3', 'trans'))
    entry = src['fused_level.cu']
    assert ('(warp_type >= 3 && (tmpl_scales != nullptr) != '
            '(warp_type >= 6))') in entry
    for code, (plain, nerfies) in enumerate((('trans', 'anneal'),
                                             ('se3', 'anneal_se3'),
                                             ('quat', 'anneal_quat'))):
        assert (f'case {code}: return (tmpl_scales ? hn_level_fwd_{nerfies} '
                f': hn_level_fwd_{plain})(') in entry
    for code, name in enumerate(('plane', 'plane_se3', 'plane_quat',
                                 'nerf_plane', 'nerf_plane_se3',
                                 'nerf_plane_quat'), 3):
        assert f'case {code}: return hn_level_fwd_{name}(' in entry
    template = src['modular_fwd.cu']
    assert ('if (scales) return hn_template_fwd_anneal(' in template
            and 'return lf::launch_template<OrigEnc>(' in template)
    assert 'return lf::launch_template<NerfEnc>(' in src[
        'template_fwd_anneal.cu']
    plane = src['template_fwd_plane.cu']
    assert ('if (scales) return hn_template_fwd_nerf_plane(' in plane
            and 'return lf::launch_template<PlaneEnc>(' in plane)
    assert 'return lf::launch_template<NerfPlaneEnc>(' in src[
        'level_fwd_nerf_plane.cu']
    assert 'bool nerfies' not in src['level_fwd.cuh']
    assert 'TmplEnc<' not in ' '.join(src.values())


@pytest.mark.parametrize('config', ['anneal_se3', 'plane_anneal_se3',
                                    'plane_anneal_quaternion'])
@torch.no_grad()
def test_launch_passes_both_window_rows(config, monkeypatch):
    """A screw warp with the Nerfies encoding takes the trunk's window row
    (64 fp32, ``warp_alpha``) and the template's (128 fp32, ``nerf_alpha`` /
    ``hyper_alpha``) in one call of its table's code."""
    model = load_probe_weights(flagship_model('cpu', config=config))
    level = model.level('coarse')
    shapes = pack_level(level)[2]
    lib = _RecordingLibrary()
    monkeypatch.setattr(build, 'library', lambda: lib)
    monkeypatch.setattr(common, 'kernel_layout', lambda w='translation':
                        shapes)
    monkeypatch.setattr(torch.cuda, 'device', lambda d: _Null())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: type('S', (), {'cuda_stream': 7}))
    rays, samples = 3, 5
    rs = np.random.RandomState(2)
    args = [torch.from_numpy(rs.rand(*shape).astype(np.float32))
            for shape in ((rays, samples), (rays, 3), (rays, 3), (rays, 8),
                          (rays, 27))]
    warp_row, tmpl_row = model.window_rows(
        {'warp_alpha': 0.375, 'nerf_alpha': 10.0, 'hyper_alpha': 1.5},
        torch.device('cpu'))
    fused_level_module._launch_forward(level, *args, want_raw_t=True,
                                       warp_scales=warp_row,
                                       tmpl_scales=tmpl_row)
    (name, launch), = lib.calls
    _check_kinds(name, launch)
    table = fused_level_module.level_table(level)
    assert launch[0] == common.TABLE_CODES[table]
    assert launch[0] % 3 == common.WARP_CODES[level.warp.kind]
    assert launch[8] is not None and launch[9] is not None
    assert launch[-4:] == (rays, samples, 27, 7)


def test_template_waits_for_the_warp_rows():
    """Each row of rows.raw (the warped point) is written by one thread (the
    retraction, or the translation warp's residual) and the template's
    encoding reads every row: a level without a sheet, whose stage would
    otherwise put a barrier between the two, has one of its own. (Without
    it the screw warps' longer retraction made the race show on the card:
    one output in 200 off by up to 0.1.)"""
    text = ' '.join((build.CSRC / 'level_fwd.cuh').read_text().split())
    body = text[text.index('level_fwd_kernel(const __grid_constant__'):]
    body = body[:body.index('template_stage<T, L>(')]
    assert ('if constexpr (!L::kPlane) sheet_stage<T>(g, ring, Bs); else '
            'g.sync();') in body
    assert body.index('screw_stage<T, kWarp>(') < body.index('else g.sync();')


def test_build_log_keeps_each_sources_seconds():
    """``build.nvcc_seconds`` reads each source's wall seconds from the
    sections ``build.build`` writes, and skips the link's."""
    log = ('== a.cu\nnvcc 12.5 s\nptxas info : Used 96 registers\n\n'
           '== b.cu\nnvcc 40.0 s\n\n== link\n\n')
    assert build.nvcc_seconds(log) == {'a.cu': 12.5, 'b.cu': 40.0}
    assert build.nvcc_seconds('') == {}


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize('warp', list(WARPS))
def test_plan_model(warp):
    """``forward_plan``: the config the C entry point reports and the column
    plan (every field's first layer at its encoding, the rest at 0)."""
    shapes = pack_level(_level(warp))[2]
    plan = forward_plan(warp, shapes)
    smem, stages = ((PLANE_SMEM_BYTES, 5) if warp in common.PLANE_TABLES
                    else (FWD_SMEM_BYTES, 6))
    assert plan['config'] == [64, 2, stages, 16384, smem, 384,
                              _tile_cols(warp), len(forward_maps(shapes))]
    h0, t0 = _first_layers(warp)
    want = {0: 128, t0: 256}
    if h0 < t0:
        want[h0] = 64
    assert {l: c for l, c in enumerate(plan['in_cols']) if c} == want
    assert len(plan['in_cols']) == len(shapes)


# The template's condition cases (the ``use_nerf_embed`` settings and
# ``use_viewdirs=False``): name -> (configuration, overrides, rgb condition
# width, alpha condition width).
CONDITIONS = {
    'nerf_embed': ('nerf_embed', {}, 47, 8),
    'embed_only': ('nerf_embed', dict(use_viewdirs=False), 8, 8),
    'alpha_only': ('nerf_embed', dict(use_rgb_condition=False), 39, 8),
    'no_viewdirs': ('flagship', dict(use_viewdirs=False), 0, 0),
    'anneal_embed': ('anneal', dict(use_nerf_embed=True,
                                    use_alpha_condition=True,
                                    use_rgb_condition=True), 35, 8)}


@pytest.mark.parametrize('case', sorted(CONDITIONS))
@torch.no_grad()
def test_launch_passes_each_condition(case, monkeypatch):
    """The level forward takes the template's conditions as arguments of
    the call (``Cond`` in csrc/level_fwd.cuh): the rgb condition at its
    width (bf16 (R, width), a null pointer at width 0, the width an int
    argument) and the alpha condition (bf16 (R, 8)) with the alpha head's
    condition columns (its 8 weights after the bottleneck's 128, bf16), or
    two null pointers. The layer table, and with it every tensor map, load
    and offset, is the flagship's whatever the conditions: the alpha head
    packs to 8 x 128 (its bottleneck columns) and rgb layer 0 to 128 x 176
    (the condition columns past the width zero)."""
    config, over, rgb_w, alpha_w = CONDITIONS[case]
    level = load_probe_weights(flagship_model(
        'cpu', config=config, **over)).level('fine')
    w_blob, _, shapes = pack_level(level)
    assert shapes == pack_level(_level('translation'))[2]
    t = level.template
    rgb0 = w_blob[sum(n * k for n, k in shapes[:25]):][:128 * 176].view(
        128, 176)
    assert torch.equal(rgb0[:, 128 + rgb_w:], torch.zeros_like(
        rgb0[:, 128 + rgb_w:]))
    assert torch.equal(rgb0[:, :128 + rgb_w], t.rgb_branch.hidden_0.weight
                       .detach()[:, :128 + rgb_w].to(torch.bfloat16))
    alpha = w_blob[sum(n * k for n, k in shapes[:24]):][:8 * 128].view(
        8, 128)
    assert torch.equal(alpha[0], t.alpha_head.weight.detach()[0, :128].to(
        torch.bfloat16))
    lib = _RecordingLibrary()
    monkeypatch.setattr(build, 'library', lambda: lib)
    monkeypatch.setattr(common, 'kernel_layout', lambda w='translation':
                        shapes)
    monkeypatch.setattr(torch.cuda, 'device', lambda d: _Null())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: type('S', (), {'cuda_stream': 7}))
    rays, samples = 3, 5
    rs = np.random.RandomState(1)
    args = [torch.from_numpy(rs.rand(*shape).astype(np.float32))
            for shape in ((rays, samples), (rays, 3), (rays, 3), (rays, 8),
                          (rays, rgb_w))]
    ac = (torch.from_numpy(rs.rand(rays, 8).astype(np.float32))
          if alpha_w else None)
    fused_level_module._launch_forward(level, *args, want_raw_t=False,
                                       alpha_cond=ac)
    (name, launch), = lib.calls
    _check_kinds(name, launch)
    assert launch[-4:] == (rays, samples, rgb_w, 7)
    assert (launch[5] == 0) == (rgb_w == 0)  # an empty tensor: null
    assert (launch[6] is None, launch[7] is None) == (not alpha_w,) * 2
    assert (launch[9] is None) == (config != 'anneal')  # the window row
    if alpha_w:
        aw = alpha_cond_weight(t)
        assert torch.equal(aw, t.alpha_head.weight.detach()[0, 128:].to(
            torch.bfloat16))
        assert alpha_cond_weight(t) is aw  # cached
    with pytest.raises(ValueError, match='alpha condition'):
        fused_level_module._launch_forward(
            level, *args, want_raw_t=False,
            alpha_cond=None if alpha_w else torch.zeros(rays, 8))
