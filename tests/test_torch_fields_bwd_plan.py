"""Kernel B's plan (``csrc/fields_bwd.cuh``, modelled in
``kernels/fused_level.py``) on the CPU: its shared memory, where each field's
stored layer outputs live through the recompute and the walk-back (the slab
pool, the spills to device memory and the reloads), the weight stream
through the ring, the dW / db flush of a block tile, and the C entry
points' ctypes signatures.

The card holds the compiled plan to this model (``chip_smoke.py`` phase 6,
``compiled_fields_bwd_plan``) and the kernel's numbers to its plain version;
these tests hold the model to the rules the kernel relies on, and the C
source's plan table to the model. All checks are exact.
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
    FB_BUFS, FB_FIELDS, FB_GRAD_COPIES, FB_GROUPS, FB_PLANS, FB_ROWS_BYTES,
    FB_SLAB_BYTES, FB_SLOTS,
    FB_SMEM_BYTES, FB_SPILL_SLABS, FB_STAGE_BYTES, FB_STAGES, FB_THREADS,
    FB_TILE_ROWS, fields_bwd_fields, fields_bwd_loads, fields_bwd_plan,
    fields_bwd_stream_bytes, level_layers, pack_level)

fused_level_module = importlib.import_module(
    'hypernerf_tpu_torch.kernels.fused_level')

# The level tables by the configuration whose level has them; the 'plane*'
# and 'nerfies_plane*' tables have no sheet: the warp field (or the SE(3) /
# quaternion trunk) alone, whatever the template's layout.
WARPS = {'translation': 'flagship', 'se3': 'se3', 'quaternion': 'quaternion',
         'plane': 'plane', 'plane_se3': 'plane_se3',
         'plane_quaternion': 'plane_quaternion',
         'nerfies_plane': 'plane_anneal',
         'nerfies_plane_se3': 'plane_anneal_se3',
         'nerfies_plane_quaternion': 'plane_anneal_quaternion'}
FIELDS = ('sheet', 'translation', 'se3')
BUF = {name: i for i, name in enumerate(FB_BUFS)}


def _level(warp):
    return load_probe_weights(flagship_model(
        'cpu', config=WARPS[warp])).level('fine')


def _shapes(warp):
    return pack_level(_level(warp))[2]


def _field_layers(field, shapes):
    """(first layer of the field in the level's table, its number of
    streamed layers: 6 hidden, 7 with the SE(3) trunk logit)."""
    if field == 'sheet':
        return (7 if len(shapes) == 30 else 9), 6
    return 0, (6 if field == 'translation' else 7)


def _warp_of(field):
    return 'se3' if field in ('se3', 'quaternion') else 'translation'


def _warp_field(table):
    """The warp field kernel B walks back in ``table``."""
    return _warp_of(common.table_warp(table))


def _n_fields(table):
    """The table's field layers: the warp's 7 or 9, the sheet's 7."""
    n = 7 if common.table_warp(table) == 'translation' else 9
    return n + 7 if common.table_has_sheet(table) else n


# ---------------------------------------------------------------------------
# Shared memory and the C source's table.


@pytest.mark.parametrize('warp', list(WARPS))
def test_shared_memory_fits(warp):
    """The slab pool, the ring, the block tile's row scratch and the
    mbarriers fit an H100 block's 227 KB; the plan's config is the model's
    constants."""
    assert FB_SMEM_BYTES <= 232448
    assert FB_SMEM_BYTES == (1024 + FB_SLOTS * FB_SLAB_BYTES
                             + FB_STAGES * FB_STAGE_BYTES + FB_ROWS_BYTES
                             + (2 * FB_STAGES + len(FB_BUFS)) * 8)
    assert FB_SLAB_BYTES == FB_TILE_ROWS * 128  # 64 bf16 columns a row
    plan = fields_bwd_plan(warp, _shapes(warp))
    assert plan['config'] == [FB_TILE_ROWS, FB_GROUPS, FB_STAGES,
                              FB_STAGE_BYTES, FB_SMEM_BYTES, FB_THREADS,
                              FB_SLOTS, FB_SPILL_SLABS, FB_GRAD_COPIES]
    n_fields = 2 if common.table_has_sheet(warp) else 1
    assert fields_bwd_fields(warp)[-1] == _warp_field(warp)
    assert len(plan['table']) == n_fields * 6 * len(FB_BUFS)


def test_plan_table_matches_the_c_source():
    """fields_bwd.cuh's ``buf_plan`` table is FB_PLANS, field by field in
    the C source's order (FB_FIELDS: kernel B's three, then the translation
    Jacobian's) and buffer by buffer (the card checks the compiled one as
    well)."""
    src = (build.CSRC / 'fields_bwd.cuh').read_text()
    body = src[src.index('fields_bwd_plan_table begin'):
               src.index('fields_bwd_plan_table end')]
    body = body[body.index('= {'):]
    body = re.sub(r'//[^\n]*', '', body)
    nums = [int(x) for x in re.findall(r'-?\d+', body)]
    assert FB_FIELDS[:3] == FIELDS
    want = [v for field in FB_FIELDS for fwd, spill, after, reload
            in FB_PLANS[field] for v in (*fwd, spill, after, *reload)]
    assert nums == want


# ---------------------------------------------------------------------------
# The slab pool through a block tile.


def _segments(field, shapes, first):
    """Per local layer i: its input boxes [(buffer, box)] and output
    buffer, from the packed shapes."""
    width = shapes[first][0]
    wb = width // 64
    enc_boxes = -(-shapes[first][1] // 64)
    layers = []
    for i in range(7 if field == 'se3' else 6):
        n, k = shapes[first + i]
        if i == 0:
            ins = [('enc', b) for b in range(enc_boxes)]
        elif i == 5:
            ins = ([('h4', b) for b in range(wb)]
                   + [('enc', b) for b in range(enc_boxes)])
            assert k == width + shapes[first][1]  # the skip input
        elif i == 6:
            ins = [('h5', b) for b in range(wb)]
        else:
            ins = [(f'h{i - 1}', b) for b in range(wb)]
        assert len(ins) == -(-k // 64), (field, i)
        assert n == width
        layers.append((ins, 'T' if i == 6 else f'h{i}'))
    return layers, wb, enc_boxes


def _loc(field, buf, box, i):
    """fields_bwd.cuh's slot_at: the slot of box ``box`` of ``buf`` when
    walk-back layer i runs."""
    fwd, _, after, reload = FB_PLANS[field][BUF[buf]]
    return reload[box] if after > i else fwd[box]


def _grad_name(buf):
    return {'enc': 'denc', 'T': 'gT'}.get(buf, 'g' + buf[1:])


def _events(field, shapes):
    """The kernel's sequence for one field on a block tile, as slot events:
    ('w', slot, content), ('r', slot, content), ('spill', buf, box, slot),
    ('reload', buf, box, slot)."""
    first, _ = _field_layers(field, shapes)
    layers, wb, enc_boxes = _segments(field, shapes, first)
    top = len(layers) - 1
    boxes = {'enc': enc_boxes, 'skip': enc_boxes}
    ev = []

    def write(buf, content, i=None):
        for b in range(boxes.get(buf, wb)):
            s = (FB_PLANS[field][BUF[buf]][0][b] if i is None
                 else _loc(field, buf, b, i))
            ev.append(('w', s, (content, b)))

    def spill(buf):
        fwd, spill_at, _, _ = FB_PLANS[field][BUF[buf]]
        if spill_at >= 0:
            for b in range(boxes.get(buf, wb)):
                ev.append(('spill', buf, b, fwd[b]))

    write('enc', 'enc')
    spill('enc')
    for ins, out in layers:
        for buf, b in ins:
            ev.append(('r', FB_PLANS[field][BUF[buf]][0][b], (buf, b)))
        write(out, out)
        spill(out)
    # The head step: the top output is read (H and mask), its cotangent
    # written over it.
    top_out = layers[top][1]
    for b in range(wb):
        s = _loc(field, top_out, b, top + 1)
        ev.append(('r', s, (top_out, b)))
        ev.append(('w', s, (_grad_name(top_out), b)))
    for i in range(top, -1, -1):
        ins, out = layers[i]
        for b in range(wb):  # g_i
            ev.append(('r', _loc(field, out, b, i + 1), (_grad_name(out), b)))
        for buf, b in ins:   # dW's H and the mask
            ev.append(('r', _loc(field, buf, b, i), (buf, b)))
        for kb, (buf, b) in enumerate(ins):  # g W over its input
            if i == 0:
                dst, content = ('enc', b), 'denc'
            elif i == 5 and kb >= wb:
                dst, content = ('skip', kb - wb), 'skip'
            else:
                dst, content = (buf, b), _grad_name(buf)
            s = _loc(field, dst[0], dst[1], i)
            ev.append(('w', s, (content, dst[1])))
        for buf in FB_BUFS:
            fwd, spill_at, after, reload = FB_PLANS[field][BUF[buf]]
            if after == i:
                for b in range(boxes.get(buf, wb)):
                    ev.append(('reload', buf, b, reload[b]))
    # The encoding's VJP reads d enc and the skip part.
    for b in range(enc_boxes):
        ev.append(('r', _loc(field, 'enc', b, 0), ('denc', b)))
        ev.append(('r', FB_PLANS[field][BUF['skip']][0][b], ('skip', b)))
    return ev


def _run_pool(events):
    """Replay the events on the pool and the scratch; raises when a read
    finds another content (something live was overwritten, or it was never
    there), or a reload finds no spill of its buffer. Returns the slot
    writes per stored layer output."""
    slots = [None] * FB_SLOTS
    scratch = {}
    stored = {}
    for e in events:
        if e[0] == 'w':
            _, s, content = e
            assert 0 <= s < FB_SLOTS
            slots[s] = content
            stored.setdefault(content, []).append(s)
        elif e[0] == 'r':
            _, s, content = e
            assert slots[s] == content, (s, slots[s], content)
        elif e[0] == 'spill':
            _, buf, b, s = e
            assert slots[s] == (buf, b)
            scratch[(buf, b)] = True
        else:
            _, buf, b, s = e
            assert scratch.get((buf, b)), (buf, b)
            slots[s] = (buf, b)
    return stored


@pytest.mark.parametrize('field', FIELDS)
def test_pool_keeps_every_live_output(field):
    """Replay a block tile's recompute and walk-back on the slab pool: every
    layer reads, as its input, dW operand, ReLU mask and cotangent, the
    buffer it wants where the plan puts it; so no write or reload overwrites
    a slab that is still live, and every reload brings back a spilled
    output. The encoding's VJP finds d enc and the skip part at the end."""
    _run_pool(_events(field, _shapes(_warp_of(field))))


@pytest.mark.parametrize('field', FIELDS)
def test_every_output_stored_once(field):
    """Each stored layer output (enc, h0..h5, T) is written once, box by
    box, in the recompute; each spilled one has scratch slabs of its own
    inside the block's FB_SPILL_SLABS and is reloaded exactly once, after a
    walk-back layer above the one that reads it."""
    shapes = _shapes(_warp_of(field))
    stored = _run_pool(_events(field, shapes))
    outputs = [k for k in stored if k[0] in FB_BUFS and k[0] != 'skip']
    assert all(len(stored[k]) == 1 for k in outputs)
    top = 6 if field == 'se3' else 5
    assert {k[0] for k in outputs} == (
        {'enc', *[f'h{i}' for i in range(6)]} | ({'T'} if top == 6 else set()))
    used = []
    for buf, (fwd, spill, after, reload) in zip(FB_BUFS, FB_PLANS[field]):
        boxes = sum(s >= 0 for s in fwd)
        if spill < 0:
            assert after == -1 and reload == (-1, -1)
            continue
        used += [spill + b for b in range(boxes)]
        assert sum(s >= 0 for s in reload) == boxes
        # Reloaded at least one layer before the layer that reads it as H.
        reader = 0 if buf == 'enc' else int(buf[1:]) + 1
        assert after >= reader + 2, (buf, after, reader)
    assert len(used) == len(set(used)) and all(0 <= s < FB_SPILL_SLABS
                                               for s in used)


@pytest.mark.parametrize('field', FIELDS)
def test_plan_fails_on_a_clobbering_plan(field):
    """The replay sees a fault: moving the top hidden output onto the slot
    of an output that the walk-back still reads is caught."""
    shapes = _shapes(_warp_of(field))
    saved = FB_PLANS[field]
    bad = list(saved)
    fwd, spill, after, reload = bad[BUF['h5']]
    h4_slot = saved[BUF['h4']][0][0]
    bad[BUF['h5']] = ((h4_slot, fwd[1]), spill, after, reload)
    FB_PLANS[field] = bad
    try:
        with pytest.raises(AssertionError):
            _run_pool(_events(field, shapes))
    finally:
        FB_PLANS[field] = saved


def test_the_warp_field_does_not_fit_without_spills():
    """Why the plan spills: the warp field keeps 14 slabs (15 with the
    SE(3) trunk) of outputs a block tile, the pool has FB_SLOTS; the sheet
    keeps 7 and spills nothing."""
    for field, warp, need in (('sheet', 'translation', 7),
                              ('translation', 'translation', 14),
                              ('se3', 'se3', 15)):
        shapes = _shapes(warp)
        first, n = _field_layers(field, shapes)
        slabs = -(-shapes[first][1] // 64) + sum(
            shapes[first + i][0] // 64 for i in range(n))
        assert slabs == need
        spills = sum(s >= 0 for _, s, _, _ in FB_PLANS[field])
        assert (spills > 0) == (need > FB_SLOTS)


# ---------------------------------------------------------------------------
# The weight stream through the ring.


def _consumer_order(warp, shapes, tiles):
    """Each consumer warpgroup's loads: per block tile the sheet's layers
    forward, then walked back, then the warp's; one stage per 64-column box
    of a layer's K, forward and backward alike."""
    out = []
    fields = ('sheet',) if common.table_has_sheet(warp) else ()
    for _ in range(tiles):
        for field in fields + (_warp_field(warp),):
            first, n = _field_layers(field, shapes)
            for l in (list(range(first, first + n))
                      + list(range(first + n - 1, first - 1, -1))):
                out += [(l, kb, min(shapes[l][0], 128))
                        for kb in range(-(-shapes[l][1] // 64))]
    return out


def _run_ring(order, layer_ends, rng, stages=FB_STAGES):
    """The ring protocol with the producer and 2 x 4 consumer warps taking
    turns at random (as in the level forward's test): a warp releases a
    stage once it has taken the next one of the layer (wgmma_wait<1>), the
    layer's last at once. Raises on a deadlock, a read of a stage that holds
    another load, or a fill over a stage not yet released by every warp."""
    total = len(order)
    holder = [None] * stages
    fills = [0] * stages
    released = [set() for _ in range(total)]
    warps = [(g, w) for g in range(FB_GROUPS) for w in range(4)]
    nxt = {wp: 0 for wp in warps}
    held = {wp: None for wp in warps}
    produced = 0
    while produced < total or any(nxt[wp] < total or held[wp] is not None
                                  for wp in warps):
        moves = []
        if produced < total:
            prev = produced - stages
            if prev < 0 or len(released[prev]) == len(warps):
                moves.append(('fill', None))
        for wp in warps:
            i = nxt[wp]
            if i < total:
                if fills[i % stages] > i // stages:
                    assert fills[i % stages] == i // stages + 1
                    moves.append(('take', wp))
            elif held[wp] is not None:
                moves.append(('end', wp))
        if not moves:
            raise AssertionError(f'deadlock at {produced} fills')
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
            assert holder[i % stages] == i
            if held[wp] is not None:
                released[held[wp]].add(wp)
            held[wp] = i
            nxt[wp] = i + 1
            if i in layer_ends:
                released[i].add(wp)
                held[wp] = None
        else:
            released[held[wp]].add(wp)
            held[wp] = None
    assert all(len(r) == len(warps) for r in released)
    return produced


@pytest.mark.parametrize('warp', list(WARPS))
def test_load_schedule_and_ring(warp):
    """The producer's loads (``fields_bwd_loads``, repeated per block tile)
    are the order each consumer takes them over two tiles: the sheet's 6
    layers forward and back, then the warp's 6 (7) forward and back, 42
    loads a tile (without a sheet: the warp's alone, 28); through the ring
    with random interleavings no consumer reads a stage early or late, no
    fill overtakes a consumer, nothing deadlocks."""
    shapes = _shapes(warp)
    producer = fields_bwd_loads(warp, shapes) * 2
    assert producer == _consumer_order(warp, shapes, 2)
    assert len(fields_bwd_loads(warp, shapes)) == (
        42 if common.table_has_sheet(warp) else 28)
    assert all(rows * 128 <= FB_STAGE_BYTES for _, _, rows in producer)
    # A run of loads of one layer, forward or backward, ends where the
    # next load belongs to another layer or the direction turns.
    ends = set()
    for i in range(len(producer)):
        if (i + 1 == len(producer) or producer[i + 1][0] != producer[i][0]
                or producer[i + 1][1] <= producer[i][1]):
            ends.add(i)
    for seed in range(3):
        assert _run_ring(producer, ends,
                         np.random.default_rng(seed)) == len(producer)


def test_stream_bytes():
    """Each block tile of 128 rows reads its 42 loads' in-bounds weight
    bytes once: at R = 16384, S = 128 that is 8.59 GB with the translation
    warp, a quarter of the per-32-row W and W^T reads of the kernel before
    (2 x 132,608 bf16 per 32 rows)."""
    shapes = _shapes('translation')
    per_tile = sum(2 * rows * min(64, shapes[l][1] - 64 * kb)
                   for l, kb, rows in fields_bwd_loads('translation', shapes))
    fields = sum(2 * n * k for n, k in shapes[:14] if n > 8)
    assert per_tile == 2 * fields
    assert fields_bwd_stream_bytes('translation', shapes,
                                   16384 * 128) == 16384 * per_tile
    assert 4 * 16384 * per_tile <= 65536 * 2 * 2 * 132608
    assert fields_bwd_stream_bytes('translation', shapes, 37 * 13) == \
        4 * per_tile


# ---------------------------------------------------------------------------
# The dW / db flush of a block tile.


def _unit_flush(n_out, k_in):
    """The (n, k) entries of a layer's dW each warpgroup adds, and the db
    entries, as back_layer does: units (out box, in box) to warpgroup
    (u + I) % 2 (here for every I parity), each thread's 4-column vector
    from its m64n64 fragment and its lane pair's, db by the unit with in
    box 0; each must cover [0, n_out) x [0, k_in) exactly once."""
    no, ni = n_out // 64, -(-k_in // 64)
    for parity in (0, 1):
        dw, db = {}, {}
        for group in range(FB_GROUPS):
            p = (group + parity) & 1
            for u in range(p, no * ni, 2):
                ob, ib = divmod(u, ni)
                for warp in range(4):
                    for lane in range(32):
                        t = lane & 3
                        odd = t & 1
                        n = ob * 64 + 16 * warp + (lane >> 2) + 8 * odd
                        for j in range(8):
                            k = ib * 64 + 8 * j + 2 * (t & ~1)
                            if k < k_in:
                                for q in range(4):
                                    dw[(n, k + q)] = dw.get((n, k + q),
                                                            0) + 1
                if ib == 0:
                    for f in range(64):
                        db[ob * 64 + f] = db.get(ob * 64 + f, 0) + 1
        yield dw, db


@pytest.mark.parametrize('warp', list(WARPS))
def test_dw_flush_covers_each_weight_once(warp):
    """Every weight and bias of the field layers is added once per block
    tile: the hidden layers' units, and the heads' tasks (one per (head,
    output, input) and one db per output) of head_back."""
    shapes = _shapes(warp)
    n_fields = _n_fields(warp)
    heads = {l for l in range(n_fields) if shapes[l][0] == 8}
    assert len(heads) == ((1 if _warp_field(warp) == 'translation' else 2)
                          + common.table_has_sheet(warp))
    for l in range(n_fields):
        n, k = shapes[l]
        if l in heads:
            n_out = (4 if l == n_fields - 1 and common.table_has_sheet(warp)
                     else 3)
            k_in = k
            tasks = [(task // k_in, task % k_in)
                     for task in range(n_out * k_in)]
            assert sorted(tasks) == [(a, b) for a in range(n_out)
                                     for b in range(k_in)]
            continue
        for dw, db in _unit_flush(n, k):
            assert set(dw) == {(a, b) for a in range(n) for b in range(k)}
            assert set(dw.values()) == {1}
            assert set(db) == set(range(n)) and set(db.values()) == {1}


def test_flush_vectors_are_the_fragments_entries():
    """The shuffle of back_layer's flush: in a lane pair (t even, t + 1) the
    even lane adds row r, columns 2t .. 2t + 3 and the odd lane row r + 8,
    columns 2t - 2 .. 2t + 1, from the m64n64 fragment (entry 4 j + e of a
    lane at row 16 warp + lane / 4 + 8 [e >= 2], column 8 j + 2 (lane % 4)
    + e % 2)."""
    frag = {}
    for lane in range(32):
        for j in range(8):
            for e in range(4):
                frag[(lane, 4 * j + e)] = (lane // 4 + 8 * (e >= 2),
                                           8 * j + 2 * (lane % 4) + e % 2)
    for lane in range(32):
        t = lane & 3
        odd = t & 1
        for j in range(8):
            mine = [4 * j + 2, 4 * j + 3] if odd else [4 * j, 4 * j + 1]
            # What the partner sends: the entries of the row it does not
            # keep (s0, s1 of the flush).
            got_from = [4 * j + 2, 4 * j + 3] if odd else [4 * j, 4 * j + 1]
            other = lane ^ 1
            got = ([frag[(other, i)] for i in got_from] + [frag[(lane, i)]
                                                           for i in mine]
                   if odd else [frag[(lane, i)] for i in mine]
                   + [frag[(other, i)] for i in got_from])
            r = lane // 4 + 8 * odd
            c0 = 8 * j + 2 * (t & ~1)
            assert got == [(r, c0 + q) for q in range(4)]


# ---------------------------------------------------------------------------
# The C entry points' arguments.


class _RecordingLibrary:
    """Stands in for the kernel library: records each entry point's
    arguments; the grid query answers ``blocks``."""

    def __init__(self, blocks):
        self.calls, self.blocks = [], blocks

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return self.blocks if name.endswith('_blocks') else 0
        return call


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


@pytest.mark.parametrize('warp', list(WARPS))
@torch.no_grad()
def test_launch_and_plan_match_the_c_signatures(warp, monkeypatch):
    """``fused_fields_bwd`` on a device tensor asks for the grid, then passes
    ``hn_fused_fields_bwd`` twelve pointers (no transposed weight blob;
    FB_GRAD_COPIES gradient buffers; the spill scratch of blocks x
    FB_SPILL_SLABS slabs) and the sizes, of the declared kinds;
    ``compiled_fields_bwd_plan`` passes
    ``hn_fused_fields_bwd_plan`` its arguments."""
    assert build._SIGNATURES['hn_fused_fields_bwd'] == (
        [ctypes.c_int] + [ctypes.c_void_p] * 12
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int)
    assert build._SIGNATURES['hn_fused_fields_bwd_plan'] == (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int],
        ctypes.c_int)
    level = _level(warp)
    shapes = pack_level(level)[2]
    lib = _RecordingLibrary(blocks=3)
    monkeypatch.setattr(build, 'library', lambda: lib)
    monkeypatch.setattr(common, 'kernel_layout', lambda w='translation':
                        shapes)
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
    rays, samples = 3, 5
    rs = np.random.RandomState(0)
    raw = 8 if common.table_has_sheet(warp) else 16  # dx_t's columns
    args = [torch.from_numpy(rs.rand(*shape).astype(np.float32))
            for shape in ((rays, samples), (rays, 3), (rays, 3), (rays, 8),
                          (rays * samples, raw))]
    out = fused_level_module.fused_fields_bwd(level, *args)
    fused_level_module.compiled_fields_bwd_plan(warp)
    names = [n for n, _ in lib.calls]
    assert names == ['hn_fused_fields_bwd_blocks', 'hn_fused_fields_bwd',
                     'hn_fused_fields_bwd_plan']
    (_, blocks_args), (_, launch), (_, plan) = lib.calls
    assert blocks_args == (rays * samples,)
    _check_kinds('hn_fused_fields_bwd', launch)
    assert launch[0] == common.TABLE_CODES[warp]
    assert launch[-4:] == (rays, samples, 3, 7)
    scratch = [t for t in allocated if t.dtype == torch.uint8]
    assert [t.numel() for t in scratch] == [3 * FB_SPILL_SLABS
                                            * FB_SLAB_BYTES]
    assert launch[12] == scratch[0].data_ptr()
    # The gradient buffer: FB_GRAD_COPIES copies of [dW | db], summed after.
    n_fields = _n_fields(warp)
    grads = [t for t in allocated if t.dim() == 2
             and t.shape[0] == FB_GRAD_COPIES]
    assert len(grads) == 1 and launch[11] == grads[0].data_ptr()
    assert grads[0].shape[1] == sum(n * k + n for n, k in shapes[:n_fields])
    assert launch[7] == pack_level(level)[0].data_ptr()
    assert launch[8] == pack_level(level)[1].data_ptr()
    _check_kinds('hn_fused_fields_bwd_plan', plan)
    assert plan[0] == common.TABLE_CODES[warp] and plan[-1] == 256
    # The outputs: d z, d o, d d, d embed and [dW, db] of the field layers.
    assert len(out) == 5 and len(out[4]) == 2 * n_fields
    assert [tuple(t.shape) for t in out[:4]] == [(rays, samples), (rays, 3),
                                                 (rays, 3), (rays, 8)]


def test_no_transposed_weight_blob():
    """The cotangent product reads the streamed weights MN-major, so the
    level keeps one weight blob: ``pack_level`` has no transposed form."""
    assert list(inspect.signature(pack_level).parameters) == ['level']
    level = _level('translation')
    w, b, shapes = pack_level(level)
    assert w.numel() == sum(n * k for n, k in shapes)
    assert len(level_layers(level)) == len(shapes) == 30
