"""``--precision 32`` on the plane tables (ROADMAP A.13.1 sub-item 3, second
half): the float32 level forward (row 1) at table codes 3 to 8
(axis_aligned_plane: no sheet, the ray's 8 GLO coordinates as the hyper
coordinates), kernel B (row 5) without the sheet, the template alone (row
8) and kernel A (row 9) in the two plane layouts, checked on the CPU.

- The gate: the six plane configurations (``plane``, ``plane_se3``,
  ``plane_quaternion``, ``plane_anneal``, ``plane_anneal_se3``,
  ``plane_anneal_quaternion``) at both levels; their fp32 blobs are the
  compiled float32 table of their code (``hn_f32_table_layout`` as
  csrc/f32_level.cu lays it out: the warp's rows, no sheet, the template's
  first layer and skip at 192 and 448 columns in the posenc_orig plane
  layout, 128 and 384 in the Nerfies one).
- The launches, run as on the card against a recording library: each C
  call with its ctypes signature's arguments; row 1 with the table code,
  raw_t of 16 columns and the template's window row where the layout is
  Nerfies; kernel A's encoding of 8 hyper coordinates into a 176-column
  (posenc_orig, 167 encoded) or 128-column (Nerfies, 127) stash; kernel B's
  warp steps and the plane rows, no sheet step; row 8 with 8 hyper
  coordinates. The new entries read from the sources.
- The plan: a plane table's shared memory within an sm_90 block's 232,448
  bytes (220,416 with the 192-column X, one block an SM); the plane
  stashes' chunks within ``STASH_BYTES``; the dW tiles of the K = 192 and
  448 layers ragged (two and four 128-column tiles, the last one partly
  past the 176 encoded columns, written zero).
- The steps of kernel A in both plane layouts and of kernel B at every
  plane code (``f32.template_bwd_steps`` / ``fields_bwd_steps``) through a
  PyTorch model of each C entry point (``TorchPlaneOps``), several chunks
  of whole rays and ragged row ranges, against the plain backward:
  relative L2 1e-5 (float32 both ways, other summation orders).
- ``tests/data/fused_f32_plane_jax_ref.npz`` (``tools/make_level_reference.py
  --only f32_plane``): its inputs redrawn, one template case recomputed
  from the JAX kernel (relative 1e-6), and the plain float32 versions held
  to every case: outputs 1e-4 of the largest entry; the template's
  gradients relative L2 1e-4; a level's gradients flow back through its
  float32 raw_t, whose rounding the template's 2^9 band amplifies (a
  near-zero ReLU can flip): each is held to 1e-2 plus twice the floor this
  file measures in float64 (the plain backward fed the float32 forward's
  raw_t against the same fed float64's), never past 5e-2, and max|d| 5e-2
  of the largest entry (``tests/test_torch_precision32_nerfies.py``'s
  rule; ``tests/test_torch_plane_f64.py`` shows the float64 levels agree
  with JAX to rounding).

One torch thread. About 45 s alone on one worker.
"""

import contextlib
import importlib
import os
import re
import sys

import numpy as np
import pytest
import torch

from hypernerf_tpu_torch.flagship import (F32_PLANE_LEVEL_CASES,
                                          F32_PLANE_TEMPLATE_CASES,
                                          LEVEL_INPUTS, f32_plane_extra,
                                          f32_plane_grad_layers,
                                          f32_plane_model,
                                          f32_plane_probe_inputs,
                                          flagship_model, load_probe_weights,
                                          read_f32_plane_reference)
from hypernerf_tpu_torch.kernels import build, common, f32
from hypernerf_tpu_torch.kernels import fused_mlp as K_mlp
from tests.test_torch_precision32 import (_RecordingLibrary, _rays, _source,
                                          as_on_the_card)
from tests.test_torch_precision32_modular import _check_signatures
from tests.test_torch_precision32_screw import TorchScrewOps

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'tools'))
import make_level_reference  # noqa: E402

# The kernels' package re-exports functions under some of its submodules'
# names: the modules themselves.
K_level = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
K_se3 = importlib.import_module('hypernerf_tpu_torch.kernels.fused_se3')
F32 = dict(compute_dtype='float32')
TOL = 1e-5
# The six plane configurations and their table codes.
CODES = {'plane': 3, 'plane_se3': 4, 'plane_quaternion': 5,
         'plane_anneal': 6, 'plane_anneal_se3': 7,
         'plane_anneal_quaternion': 8}
# Alphas mid-ramp: the xyz, the hyper coordinates' and the trunk's windows
# all partly on.
EXTRA = {'nerf_alpha': 7.5, 'hyper_alpha': 1.5, 'warp_alpha': 3.5}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a, b = torch.as_tensor(np.array(a)), torch.as_tensor(np.array(b))
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


@pytest.fixture(scope='module')
def probes():
    """Each plane configuration at float32, full width, probe weights."""
    return {c: load_probe_weights(flagship_model('cpu', config=c, **F32))
            for c in CODES}


@pytest.fixture
def recording(monkeypatch):
    lib = _RecordingLibrary()
    monkeypatch.setattr(build, 'library', lambda: lib)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: type('S', (), {'cuda_stream': 7}))
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'get_device_properties',
                        lambda device=None: type(
                            'P', (), {'multi_processor_count': 132}))
    return lib


def _windows(level, extra=EXTRA):
    """(the trunk's window row or None, the template's or None) of a level
    at the alphas ``extra``."""
    tmpl = K_mlp.template_scales(level, extra.get('nerf_alpha'),
                                 extra.get('hyper_alpha'))
    if level.warp.kind == 'translation' or 'warp_alpha' not in extra:
        return None, tmpl
    return K_se3.se3_encoding_scales(level.warp, extra['warp_alpha']), tmpl


# ---------------------------------------------------------------------------
# The gate.


@pytest.mark.parametrize('config', list(CODES))
def test_gate_admits_the_plane_tables(probes, config, monkeypatch):
    """Both levels of each plane configuration pass the float32 level gate
    and the template's; their fp32 blobs are the compiled float32 table of
    their code, 23 layers (25 with a screw warp), and no sheet."""
    monkeypatch.setattr(build, 'library', _RecordingLibrary)
    model = probes[config]
    screw = config.endswith(('se3', 'quaternion'))
    nerfies = 'anneal' in config
    for level_name in ('coarse', 'fine'):
        level = model.level(level_name)
        assert level.hyper is None
        K_level._check_covered(level)
        K_mlp.check_f32_covered(level)
        table = K_level.level_table(level)
        assert common.TABLE_CODES[table] == CODES[config]
        shapes = K_level.pack_level_f32(level)[2]
        f32.check_layout(shapes, warp=table)
        t0 = 9 if screw else 7
        assert len(shapes) == t0 + 16
        enc = 128 if nerfies else f32.PLANE_ENC
        assert shapes[t0] == (256, enc) and shapes[t0 + 5] == (256, 256 + enc)
        assert shapes[:t0] == f32.kernel_layout(
            'se3' if screw else 'translation')[:t0]
        assert K_mlp.layout(level) == ('nerfies_plane' if nerfies
                                       else 'plane')
        assert K_mlp.raw_pad(level) == common.PLANE_RAW_PAD


def test_every_table_layout_in_the_source():
    """``hn_f32_table_layout`` as the recording library reads it from the
    source for codes 0 to 8: the sheet tables' (30 and 32 layers) the
    flagship table and the trunk's rows then its rows 7..29, as before; the
    plane tables' the warp's rows and the template's at the layout's
    encoding, in the C code's order (``table_slots``)."""
    lib = _RecordingLibrary()
    src = _source('f32_level.cu')
    assert 'extern "C" int hn_f32_table_layout(int code, int* n, int* k,' \
        in src
    assert 'for (int l = code < kPlaneCodes ? 7 : 14; l < kLayers; ++l)' \
        in src
    import ctypes

    def layout(entry, *lead):
        n, k = (ctypes.c_int * 64)(), (ctypes.c_int * 64)()
        count = getattr(lib, entry)(*lead, ctypes.addressof(n),
                                    ctypes.addressof(k), 64)
        return [(n[i], k[i]) for i in range(count)]

    flag = lib._rows('kShapeN', 'kShapeK', 'kLayers')
    trunk = lib._rows('kTrunkN', 'kTrunkK', 'kTrunkLayers')
    assert len(flag) == 30 and len(trunk) == 9
    assert layout('hn_f32_table_layout', 0) == flag
    for code in (1, 2):
        assert layout('hn_f32_table_layout', code) == trunk + flag[7:]
    for code in range(3, 9):
        got = layout('hn_f32_table_layout', code)
        warp = trunk if code % 3 else flag[:7]
        enc = 192 if code < 6 else 128
        tmpl = list(flag[14:])
        tmpl[0], tmpl[5] = (256, enc), (256, 256 + enc)
        assert got == warp + tmpl, code


# ---------------------------------------------------------------------------
# The launches, the sources and the plan.


@torch.no_grad()
@pytest.mark.parametrize('config', list(CODES))
def test_level_launches_match_the_c_signatures(probes, recording, config):
    """Row 1 and its backward (A, B) as on the card at each plane code:
    ``hn_f32_level_fwd`` takes the table code, the trunk's window row with
    a screw warp and the template's in the Nerfies plane layout, and
    writes raw_t of 16 columns; kernel A encodes 8 hyper coordinates (at 6
    bands with identity, or 4 without) into a 176- or 128-column stash;
    kernel B walks back the warp alone (7 or 9 layers) and runs the plane
    rows, no sheet step; every call has its signature's arguments, the
    stream last; each wrapper counts one launch a call."""
    level = probes[config].level('fine')
    code, nerfies = CODES[config], 'anneal' in config
    screw = level.warp.kind != 'translation'
    rays, samples = 3, 8
    args = _rays(rays, samples, cond=K_mlp.cond_width(level))
    ws, ts = _windows(level)
    wrappers = (f32.fused_level_f32, f32.fused_template_bwd_f32,
                f32.fused_fields_bwd_f32)
    counts = [fn.launches for fn in wrappers]
    with as_on_the_card():
        _, raw_t = K_level._launch_forward(level, *args, want_raw_t=True,
                                           warp_scales=ws, tmpl_scales=ts)
        fwd = recording.calls[-1]
        dx_t = K_mlp.fused_template_bwd(level, raw_t, args[4],
                                        torch.zeros(rays * samples, 4),
                                        ts)[0]
        K_level.fused_fields_bwd(level, *args[:4], dx_t, ws)
    assert [fn.launches - c for fn, c in zip(wrappers, counts)] == [1, 1, 1]
    _check_signatures(recording.calls)
    name, a = fwd
    assert name == 'hn_f32_level_fwd' and a[8] == code
    assert (a[9] is None) != screw and (a[10] is None) != nerfies
    assert raw_t.shape == dx_t.shape == (rays * samples, 16)
    names = [n for n, _ in recording.calls]
    enc = [a for n, a in recording.calls if n == 'hn_f32_tmpl_encode']
    vjp = [a for n, a in recording.calls if n == 'hn_f32_tmpl_posenc_bwd']
    assert enc[0][2:5] == ((10, 8, 4) if nerfies else (10, 8, 6))
    assert enc[0][7] == (128 if nerfies else 176)
    assert enc[0][9] == int(not nerfies) == vjp[0][10]
    assert vjp[0][8] == 16  # dx_t's leading dimension
    # Kernel A's one chunk, then kernel B's: the warp's layers, no sheet.
    at = names.index('hn_f32_tmpl_posenc_bwd') + 1
    assert names[:at].count('hn_f32_reduce') == 2 * 16
    assert names[at:].count('hn_f32_reduce') == 2 * (9 if screw else 7)
    assert 'hn_f32_fields_rows' not in names[at:]
    assert 'hn_f32_screw_rows' not in names[at:]
    assert [n for n in names[at:] if n.endswith('_encode')] == [
        'hn_f32_trunk_encode' if screw else 'hn_f32_field_encode']
    rows = [a for n, a in recording.calls if n == 'hn_f32_plane_rows']
    assert len(rows) == 1 and rows[0][0] == int(screw)
    assert (rows[0][7] is None) != screw  # the retraction's direct term
    assert rows[0][6] == 16 and rows[0][13] == 8  # dx_t's ld, embedding
    if screw:
        assert [a[0] for n, a in recording.calls
                if n == 'hn_f32_retract_bwd'] == [code % 3 - 1]


@torch.no_grad()
def test_template_alone_launches_match_the_c_signatures(probes, recording):
    """Row 8 in both plane layouts (S = 8 and S = 1) as on the card:
    ``hn_f32_template_fwd`` takes raw rows of 16 columns and 8 hyper
    coordinates, the window row in the Nerfies plane layout; kernel A of
    the template alone the same stashes as the level's."""
    counts = [fn.launches for fn in (f32.fused_template_f32,
                                     f32.fused_template_bwd_f32)]
    with as_on_the_card():
        for config, rows, per in (('plane', 24, 8), ('plane_anneal', 5, 1)):
            tmpl = probes[config].template_of('coarse')
            row = _windows(probes[config].level('coarse'))[1]
            x = torch.zeros(rows, 16)
            cond = torch.zeros(rows // per, K_mlp.cond_width(tmpl))
            out = K_mlp.fused_template(tmpl, x, cond, row)
            assert out.shape == (rows, 4)
            n, a = recording.calls[-1]
            assert n == 'hn_f32_template_fwd'
            assert a[1:3] == (16, 8) and (a[5] is None) == (row is None)
            assert a[-3:-1] == (rows, per)
            dx = K_mlp.fused_template_bwd(tmpl, x, cond,
                                          torch.zeros(rows, 4), row)[0]
            assert dx.shape == (rows, 16)
    _check_signatures(recording.calls)
    assert [fn.launches - c for fn, c in zip(
        (f32.fused_template_f32, f32.fused_template_bwd_f32), counts)] == [
            2, 2]


def test_new_entries_in_the_sources():
    """The new entry points take what ``build._SIGNATURES`` declares
    (argument counts read from the C declarations); the plane tables are
    run-time arguments of the existing level forward and template alone (no
    new kernel or instantiation in f32_level.cu: the same four kernels),
    each launch with its own carve of shared memory; kernel B's plane rows
    are one new elementwise kernel."""
    level, steps = _source('f32_level.cu'), _source('f32_steps.cu')
    for src, name in ((level, 'hn_f32_table_layout'),
                      (steps, 'hn_f32_plane_rows')):
        decl = re.search(r'extern "C" int ' + name + r'\(([^)]*)\)', src)
        params = decl.group(1).split(',')
        assert len(params) == len(build._SIGNATURES[name][0]), name
    assert 'cudaStream_t' in params[-1]
    assert len(re.findall(r'__global__ void', level)) == 4
    assert ('level_fwd_f32<<<tiles_of(n_pts), kThreads, carve_bytes(c), '
            'stream>>>') in level
    assert 'allow_smem(level_fwd_f32, kPlaneSmemBytes, ready)' in level
    assert '__global__ void plane_rows_f32(' in steps
    assert len(re.findall(r'__global__ void', steps)) == 15


def test_plane_plan():
    """Shared memory: the sheet tables' carve unchanged (201,984 bytes),
    the posenc_orig plane layout's 220,416 (X of 192 features, 16 raw rows)
    and the Nerfies plane layout's 204,032, each within an sm_90 block's
    232,448 and above half of an SM's 233,472 (one block an SM, as
    before). The plane stashes: 176 (posenc_orig, 167 encoded) and 128
    (Nerfies, 127) encoding columns, float4-aligned columns, chunks of
    whole rays within STASH_BYTES at S = 128 and 192; the K = 192 and 448
    layers' dW over 2 and 4 column tiles of 128, the last ragged."""
    assert f32.LEVEL_SMEM_BYTES == f32.level_smem_bytes() == 201984
    assert f32.PLANE_SMEM_BYTES == 220416 <= f32.SMEM_LIMIT
    assert f32.level_smem_bytes(128, common.PLANE_RAW_PAD) == 204032
    assert 2 * (f32.PLANE_SMEM_BYTES + 1024) > 233472
    for nerfies, enc, width in ((False, 176, 3168), (True, 128, 3120)):
        sp = f32.template_stash(8, nerfies)
        assert f32.template_enc(8, nerfies) == enc == sp.widths['enc']
        assert sp.width == width and all(c % 4 == 0 for c in sp.col.values())
        for s in (128, 192):
            p = 16384 * s
            plan = K_mlp.chunk_plan(p, s, f32.chunk_rows(sp))
            assert plan[-1][1] == p and all((r1 - r0) % s == 0
                                            for r0, r1 in plan)
            assert 4 * sp.width * max(r1 - r0 for r0, r1 in plan) <= \
                f32.STASH_BYTES
    assert [-(-k // f32.STEP_COLS) for k in (192, 448)] == [2, 4]
    assert 192 % f32.STEP_COLS == 448 % f32.STEP_COLS == 64
    assert f32.split_count(256, 448, 16384 * 128, 132) >= 1


# ---------------------------------------------------------------------------
# The steps through a PyTorch model of each C entry point.


class TorchPlaneOps(TorchScrewOps):
    """``TorchScrewOps`` with kernel B's plane rows, the contract of
    ``hn_f32_plane_rows``."""

    def plane_rows(self, screw, z, o, d, emb, samples, dxt, dpd, g, f0,
                   scales, dz, rows):
        pts, q = self._points(z, o, d, samples)
        e = emb.shape[1]
        if screw:
            direct = dpd.clone()  # dpd may be rows' own columns
            gs = g if scales is None else g * scales
            dp = direct + common.posenc_bwd(
                gs[:, :48], common.posenc_trig(pts, 8), 3, 8, identity=False)
            d_emb = gs[:, 48:48 + e]
        else:
            n0 = 3 * (1 + 2 * f0)
            dp = dxt[:, :3] + common.posenc_bwd(
                g[:, :n0], common.posenc_trig(pts, f0), 3, f0)
            d_emb = g[:, n0:n0 + e]
        dz[:] = (dp * d[q]).sum(1)
        rows[:] = torch.cat([dp, dp * z[:, None], d_emb + dxt[:, 3:3 + e]],
                            1)


@torch.no_grad()
@pytest.mark.parametrize('config,rays,samples,max_rows,sms', [
    ('plane', 7, 13, 40, 2), ('plane', 2, 64, 1000, 400),
    ('plane_anneal', 3, 29, 60, 2), ('plane_anneal', 5, 16, 48, 2)])
def test_kernel_a_plane_steps_match_the_plain_backward(probes, config, rays,
                                                       samples, max_rows,
                                                       sms):
    """Kernel A's float32 steps in a plane layout (8 hyper coordinates,
    raw rows of 16 columns; the Nerfies plane layout with its window row)
    through ``TorchPlaneOps`` at full width (several chunks of whole rays,
    ragged row ranges) give the plain backward's dx_t, d rgb_cond and every
    dW / db: relative L2 1e-5."""
    level = probes[config].level('fine')
    args = _rays(rays, samples, cond=K_mlp.cond_width(level), seed=rays)
    ts = _windows(level)[1]
    _, raw_t = K_level.fused_level_plain(level, *args, return_raw_t=True,
                                         tmpl_scales=ts)
    g = torch.from_numpy(np.random.RandomState(samples).randn(
        rays * samples, 4).astype(np.float32))
    layers = K_mlp.kernel_template_layers(level.template)
    w_blob, b_blob, shapes = common.pack_layers(level.template, layers,
                                                dtype=torch.float32)
    wt_blob = common.pack_layers(level.template, layers, transposed=True,
                                 dtype=torch.float32)[0]
    w, wt, b, w_off, b_off, n = K_mlp.layer_views(w_blob, wt_blob, b_blob,
                                                  shapes)
    dx_t, d_cond, grads, _ = f32.template_bwd_steps(
        TorchPlaneOps(sms), w, wt, b, w_off, b_off, n, raw_t, args[4],
        samples, g, max_rows, hyper=8,
        scales=K_mlp.kernel_scales(level, ts, g.device))
    n_w = sum(a * c for a, c in shapes)
    got = [dx_t, d_cond] + K_mlp.unpack_template_grads(grads, layers, shapes,
                                                       n_w, False)
    want = K_mlp.fused_template_bwd_plain(level, raw_t, args[4], g, ts)
    errs = [_rel(a, c) for a, c in zip(got, [want[0], want[1], *want[2]])]
    assert dx_t.shape == (rays * samples, 16) and not dx_t[:, 11:].any()
    assert len(errs) == 34 and max(errs) <= TOL, errs


@torch.no_grad()
@pytest.mark.parametrize('config,rays,samples,max_rows,sms', [
    ('plane', 7, 13, 40, 2), ('plane_se3', 2, 64, 1000, 400),
    ('plane_quaternion', 3, 29, 60, 2), ('plane_anneal', 5, 16, 48, 2),
    ('plane_anneal_se3', 3, 20, 40, 2),
    ('plane_anneal_quaternion', 2, 40, 80, 2)])
def test_kernel_b_plane_steps_match_the_plain_backward(probes, config, rays,
                                                       samples, max_rows,
                                                       sms):
    """Kernel B's float32 steps at each plane code (``f32.fields_bwd_steps``:
    the warp field or the trunk with its retraction's VJP and window row,
    no sheet, the plane rows adding d hyper into d embed) through
    ``TorchPlaneOps`` at full width (ragged chunks and row ranges) give the
    plain backward's d z, d o, d d, d embed and every dW / db of the warp:
    relative L2 1e-5."""
    level = probes[config].level('fine')
    ws = _windows(level)[0]
    kws = (None if ws is None else common.padded_scales(
        ws, ws.shape[0], f32.SE3_ENC, ws.device))
    args = _rays(rays, samples, seed=rays + samples)
    dx_t = torch.from_numpy(np.random.RandomState(samples).randn(
        rays * samples, 16).astype(np.float32))
    dx_t[:, 11:] = 0.0
    w_blob, b_blob, shapes = K_level.pack_level_f32(level)
    wt_blob = K_level.pack_level_f32(level, transposed=True)[0]
    nf = K_level._n_field_layers(level)
    assert nf == (7 if level.warp.kind == 'translation' else 9)
    w, wt, b, w_off, b_off, n = K_mlp.layer_views(w_blob, wt_blob, b_blob,
                                                  shapes[:nf])
    d_z, d_ray, grads = f32.fields_bwd_steps(
        TorchPlaneOps(sms), w, wt, b, w_off, b_off, n, *args[:4], dx_t,
        max_rows, code=CODES[config], scales=kws)
    n_w = sum(a * c for a, c in shapes[:nf])
    layers = K_level.level_layers(level)[:nf]
    got = [d_z, d_ray[:, :3], d_ray[:, 3:6], d_ray[:, 6:]] + \
        common.unpack_grads(grads[:n_w], grads[n_w:], layers, shapes[:nf])
    want = K_level.fused_fields_bwd_plain(level, *args[:4], dx_t, ws)
    errs = [_rel(a, c) for a, c in zip(got, [*want[:4], *want[4]])]
    assert len(errs) == 4 + 2 * nf and max(errs) <= TOL, errs


# ---------------------------------------------------------------------------
# The stored JAX numbers.


def _plain_level(case, arrays, dtype, raw_t=None):
    """(out, raw_t, {'d_<input>', 'dw<l>', 'db<l>'}) of the plain level at
    ``dtype`` for a stored level case with gradients; the backward from
    ``raw_t`` where given (else the forward's)."""
    level = f32_plane_model(case).to(dtype).level(
        F32_PLANE_LEVEL_CASES[case][1])
    ws, ts = (None if t is None else t.to(dtype)
              for t in _windows(level, f32_plane_extra(case)))
    args = [torch.from_numpy(arrays[k]).to(dtype) for k in LEVEL_INPUTS]
    with torch.no_grad():
        out, fwd_raw = K_level.fused_level_plain(
            level, *args, return_raw_t=True, warp_scales=ws, tmpl_scales=ts)
        if 'cotangent' not in arrays:
            return out, fwd_raw, {}
        raw_t = fwd_raw if raw_t is None else raw_t.to(dtype)
        dx_t, d_cond, t_grads, _ = K_mlp.fused_template_bwd_plain(
            level, raw_t, args[4], torch.from_numpy(
                arrays['cotangent']).to(dtype), ts)
        *rays, f_grads = K_level.fused_fields_bwd_plain(level, *args[:4],
                                                        dx_t, ws)
    got = dict(zip(('d_z_vals', 'd_origins', 'd_directions', 'd_embed'),
                   rays))
    got['d_rgb_cond'] = d_cond
    for l, (dw, db) in enumerate(zip(*[iter(f_grads + t_grads)] * 2)):
        got.update({f'dw{l}': dw, f'db{l}': db})
    return out, fwd_raw, {k: v.double().numpy() for k, v in got.items()}


def _hold_grads(got, arrays, bound):
    """Every stored gradient of a case against ``got``: relative L2 at most
    ``bound(name)``, max|d| 5e-2 of the largest entry."""
    keys = [k for k in arrays if k.startswith(('d_', 'dx', 'dw', 'db'))]
    for k in keys:
        want = arrays[k]
        g = np.asarray(got[k], np.float64)
        err = np.linalg.norm(g - want) / np.linalg.norm(want)
        assert err <= bound(k), (k, err, bound(k))
        assert np.abs(g - want).max() <= 5e-2 * np.abs(want).max(), k
    return len(keys)


@torch.no_grad()
def test_stored_float32_plane_reference():
    """tests/data/fused_f32_plane_jax_ref.npz, what ``chip_smoke.py`` phase
    37 holds rows 1, 5, 8 and 9 to: its inputs redrawn from their seeds, its
    ``template_plane_anneal`` case (the Nerfies plane layout with its window
    row) recomputed from the JAX template kernel at float32 in interpret
    mode, and the plain float32 versions held to every case (the module
    docstring's rule; a level's floor measured here in float64)."""
    ref = read_f32_plane_reference()
    assert sorted(ref) == sorted((*F32_PLANE_LEVEL_CASES,
                                  *F32_PLANE_TEMPLATE_CASES))
    for case in ref:
        inputs = f32_plane_probe_inputs(case)
        if case in F32_PLANE_LEVEL_CASES and not F32_PLANE_LEVEL_CASES[
                case][-1]:
            del inputs['cotangent']
        assert sorted(k for k in ref[case] if k in inputs) == sorted(inputs)
        for k, v in inputs.items():
            np.testing.assert_array_equal(ref[case][k], v, err_msg=case)
        keep = {int(k[2:]) for k in ref[case] if k.startswith('dw')}
        assert keep == (set(f32_plane_grad_layers(case))
                        if 'cotangent' in ref[case] else set()), case
    case = 'template_plane_anneal'
    again = make_level_reference.f32_plane_case(case)
    for k, v in ref[case].items():
        if k in again:
            assert _rel(again[k], v) <= 1e-6, k
    for case, (_, level, *_) in F32_PLANE_TEMPLATE_CASES.items():
        arrays = ref[case]
        model = f32_plane_model(case)
        tmpl = model.template_of(level)
        row = _windows(model.level(level), f32_plane_extra(case))[1]
        x, cond = (torch.from_numpy(arrays[k]) for k in ('x_raw', 'rgb_cond'))
        out = K_mlp.fused_template_plain(tmpl, x, cond, row)
        assert np.abs(out.numpy() - arrays['out']).max() <= \
            1e-4 * np.abs(arrays['out']).max(), case
        dx, d_cond, grads, _ = K_mlp.fused_template_bwd_plain(
            tmpl, x, cond, torch.from_numpy(arrays['cotangent']), row)
        got = {'dx': dx, 'd_rgb_cond': d_cond}
        for l, (dw, db) in enumerate(zip(*[iter(grads)] * 2)):
            got.update({f'dw{l}': dw, f'db{l}': db})
        assert _hold_grads(got, arrays, lambda k: 1e-4) == 2 + len(
            f32_plane_grad_layers(case)) + 16, case
    for case in F32_PLANE_LEVEL_CASES:
        arrays = ref[case]
        out, raw_t, got = _plain_level(case, arrays, torch.float32)
        assert out.shape == arrays['out'].shape and raw_t.shape[1] == 16
        assert np.abs(out.numpy() - arrays['out']).max() <= \
            1e-4 * np.abs(arrays['out']).max(), case
        if not got:
            continue
        exact = _plain_level(case, arrays, torch.float64)[2]
        rounded = _plain_level(case, arrays, torch.float64, raw_t)[2]
        floor = {k: np.linalg.norm(rounded[k] - v) / max(np.linalg.norm(v),
                                                          1e-30)
                 for k, v in exact.items()}
        n = _hold_grads(got, arrays,
                        lambda k: min(1e-2 + 2 * floor[k], 5e-2))
        assert n == 5 + len(f32_plane_grad_layers(case)) + 23, case
