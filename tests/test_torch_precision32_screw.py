"""``--precision 32`` with the screw warps (ROADMAP A.13.1 sub-item 2): the
float32 level forward and kernel B at table codes 1 and 2 (the SE(3) and
the quaternion warp: the trunk, its heads and the retraction, rows 1 and
5) and the SE(3) trunk alone, forward and backward (rows 12 and 13),
checked on the CPU.

- The gate: the float32 ``se3`` and ``quaternion`` levels, their fp32
  blobs (the trunk's 9 rows, then the flagship table's from the sheet on)
  and the trunk alone are admitted; what float32 still lacks with a screw
  warp (levels without a sheet, the trunk's tangents) raised
  NotImplementedError naming A.13.1's sub-item 3 or 4 before any library
  was needed; both run now (the trunk's tangents since sub-item 4: their
  numbers are ``tests/test_torch_precision32_jacobian.py``'s), and a trunk
  of other degrees raises naming A.13. The screw levels with the Nerfies
  template (``anneal_se3``, ``anneal_quaternion``), refused before
  sub-item 3's first half, are admitted and run as on the card.
- The launches: each wrapper, run as on the card against a recording
  library, passes its C entry point (``hn_f32_level_fwd`` with the table
  code and the window row, ``hn_f32_trunk_fwd``, the trunk's steps of
  ``f32_steps.cu``) as many arguments of the kinds ``build``'s ctypes
  signature declares, and counts one launch a call; the new entries read
  from the sources.
- The steps of kernel B with the trunk (``f32.fields_bwd_steps`` at codes
  1 and 2) and of the trunk alone backward (``f32.se3_bwd_steps``) through
  a PyTorch model of each C entry point (``tests/test_torch_precision32.py``'s,
  with the trunk's steps added), with and without the window row, over
  ragged chunks, against the plain backward: relative L2 1e-5 (float32
  both ways, other summation orders).
- The port's float32 ``se3`` and ``quaternion`` models, and ``se3`` with
  ``share_glo=False``, at narrow widths with the trunk's 8 bands, against
  the JAX model at ``compute_dtype='float32'`` on the same weights
  (``convert.params_from_jax``), with and without ``warp_alpha``: outputs
  and the loss's gradients relative L2 1e-5.
- ``tests/data/fused_f32_screw_jax_ref.npz`` (``tools/make_level_reference.py
  --only f32_screw``): its windowed trunk case recomputed, and the plain
  float32 versions held to every case at full width. Outputs 1e-4 of the
  largest entry; gradients relative L2 1e-2 and 5e-2 of the largest entry
  (the float32 rule of ``tests/test_torch_precision32.py``), except where a
  level's gradient flows back through the warped point, whose bound is
  derived here: two float32 forwards round the warped point apart (the
  plain one 1.4e-7 relative from float64's), which moves the template's
  backward at its top posenc band (2^9) and can flip a ReLU whose
  pre-activation is near zero; fed the plain float32 forward's raw_t, the
  backward in float64 arithmetic alone moves the trunk's heads' gradients
  and d embed by up to 1.8e-2 (``_rounding_floor``). Each level gradient
  is held to 1e-2 plus twice that floor (two forwards, the port's and
  JAX's, each rounding), and never past 5e-2.

One torch thread. About 60 s alone on one worker.
"""

import contextlib
import importlib
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hypernerf_tpu.configs import NerfConfig as JaxNerfConfig
from hypernerf_tpu.models.nerf import NerfModel as JaxNerfModel
from hypernerf_tpu.ops.ray_dict import prepare_ray_dict as jax_ray_dict
from hypernerf_tpu.training.losses import mse_loss as jax_mse_loss
from hypernerf_tpu_torch import configs as port_configs
from hypernerf_tpu_torch.convert import params_from_jax
from hypernerf_tpu_torch.flagship import (F32_SCREW_GRAD_LAYERS,
                                          F32_SCREW_LEVEL_CASES,
                                          F32_SCREW_TRUNK_CASES,
                                          F32_SCREW_TRUNK_DW, LEVEL_INPUTS,
                                          f32_screw_model,
                                          f32_screw_probe_inputs,
                                          flagship_model, load_probe_weights,
                                          read_f32_screw_reference)
from hypernerf_tpu_torch.kernels import build, common, f32
from hypernerf_tpu_torch.kernels import fused_mlp as K_mlp
from hypernerf_tpu_torch.kernels.fused_level import (_check_covered,
                                                     fused_fields_bwd_plain,
                                                     fused_level_plain,
                                                     level_layers,
                                                     pack_level_f32)
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.ops import quaternion, rigid_body
from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
from hypernerf_tpu_torch.training.losses import mse_loss
from tests.test_torch_precision32 import (TorchF32Ops, _RecordingLibrary,
                                          _rays, _source, as_on_the_card)
from tests.test_torch_precision32_modular import _check_signatures
from tests.test_torch_train_step import ARCH, _batch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'tools'))
import make_level_reference  # noqa: E402

# The kernels' package re-exports functions under some of its submodules'
# names: the modules themselves.
K_level = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
K_se3 = importlib.import_module('hypernerf_tpu_torch.kernels.fused_se3')
K_se3_jac = importlib.import_module(
    'hypernerf_tpu_torch.kernels.fused_se3_jacobian')
F32 = dict(compute_dtype='float32')
TOL = 1e-5
WINDOW = 3.5  # warp_alpha of the trunk's 8 bands
KINDS = ('se3', 'quaternion')


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
    """The probe-weight ``se3`` and ``quaternion`` models at float32, full
    width."""
    return {kind: load_probe_weights(flagship_model('cpu', config=kind,
                                                    **F32))
            for kind in KINDS}


def _scales(field, alpha):
    """(the window row as the plain versions take it, as the kernels do)."""
    if alpha is None:
        return None, None
    row = K_se3.se3_encoding_scales(field, alpha)
    return row, common.padded_scales(row, row.shape[0], f32.SE3_ENC,
                                     row.device)


def _x_trunk(rows, seed):
    rs = np.random.RandomState(seed)
    return torch.from_numpy(np.concatenate(
        [rs.randn(rows, 3) * 0.5, rs.randn(rows, 8) * 0.1], 1).astype(
            np.float32))


# ---------------------------------------------------------------------------
# The gate.


def test_gate_admits_the_screw_warps(probes, monkeypatch):
    """Both levels of the float32 ``se3`` and ``quaternion`` models pass the
    level gate; their fp32 blobs hold the compiled screw table (the trunk's
    9 rows as csrc/f32_level.cu declares them, then the flagship table's
    rows 7..29), 32 layers; the trunk alone passes its gate and packs to
    the table's first 9 rows; the error message names what the float32
    kernels cover: the screw warps and their Jacobians."""
    monkeypatch.setattr(build, 'library', _RecordingLibrary)
    for kind in KINDS:
        model = probes[kind]
        for name in ('coarse', 'fine'):
            level = model.level(name)
            _check_covered(level)
            _, _, shapes = pack_level_f32(level)
            assert len(shapes) == 32
            assert shapes[:9] == [(128, 64)] + [(128, 128)] * 4 + [
                (128, 192), (128, 128), (8, 128), (8, 128)]
            f32.check_layout(shapes, warp=kind)
            assert f32.kernel_layout(kind)[9:] == f32.kernel_layout()[7:]
        K_se3.check_covered(model.warp_field)
        _, _, shapes = common.pack_layers(
            model.warp_field, K_se3.se3_layers(model.warp_field),
            dtype=torch.float32)
        f32.check_layout(shapes, common.SE3_LAYERS, 'se3')
    assert 'SE(3)' in common.NOT_COVERED
    assert 'Jacobians' in common.NOT_COVERED


def _refusals():
    """(label, call that must raise)."""
    x11 = torch.zeros(4, 11)

    def tangents(config, **over):
        def call():
            field = flagship_model('cpu', config=config, **over,
                                   **F32).warp_field
            with as_on_the_card():
                K_se3_jac.fused_se3_wv_tangents(field, x11)
        return call

    return [
        ('elastic_se3 of other degrees (rows 16, 17)',
         tangents('elastic_se3', warp_max_deg=6)),
        ('elastic_quaternion of other degrees',
         tangents('elastic_quaternion', warp_max_deg=6)),
    ]


@pytest.mark.parametrize('label,call', _refusals(),
                         ids=[r[0].split(' (')[0] for r in _refusals()])
def test_gate_refuses_what_is_left(label, call):
    """What float32 still lacks with a screw warp (since sub-item 4 the
    flagship trunk's tangents run: ``test_gate_admits_the_trunk_tangents``;
    a trunk of other degrees is A.13's) raises naming ROADMAP A.13 and no
    sub-item of A.13.1, and nothing falls back to a plain version."""
    with pytest.raises(NotImplementedError, match='ROADMAP item A.13') as e:
        call()
    assert 'sub-item' not in str(e.value)


@torch.no_grad()
@pytest.mark.parametrize('config', ['elastic_se3', 'elastic_quaternion'])
def test_gate_admits_the_trunk_tangents(config, recording):
    """The screw warps' elastic loss at float32, refused before sub-item 4:
    the trunk's tangents forward (row 16) and backward (row 17), with and
    without the window row, run as on the card through their float32 entry
    points, each with its signature's arguments, the trunk's 9 layers'
    dW / db reduced, one launch of each wrapper a call."""
    field = flagship_model('cpu', config=config, **F32).warp_field
    x = _x_trunk(9, 2)
    counts = [f32.fused_se3_jacobian_f32.launches,
              f32.fused_se3_jacobian_bwd_f32.launches]
    with as_on_the_card():
        for alpha in (None, WINDOW):
            row = _scales(field, alpha)[0]
            K_se3_jac.fused_se3_wv_tangents(field, x, row)
            assert (recording.calls[-1][1][1] is None) == (alpha is None)
            K_se3_jac.fused_se3_jacobian_bwd(field, x, torch.zeros(9, 24),
                                             row)
    _check_signatures(recording.calls)
    names = [n for n, _ in recording.calls]
    assert names.count('hn_f32_se3_jacobian_fwd') == 2
    assert names.count('hn_f32_reduce') == 2 * 2 * 9
    assert [f32.fused_se3_jacobian_f32.launches,
            f32.fused_se3_jacobian_bwd_f32.launches] == [c + 2
                                                         for c in counts]


@torch.no_grad()
@pytest.mark.parametrize('config', ['plane_se3', 'plane_quaternion'])
def test_gate_admits_the_plane_screw_levels(config, recording):
    """The screw levels without a sheet (the plane tables' codes 4 and 5),
    refused before sub-item 3's second half: both levels pass the gate, and
    the fine level's forward with the trunk's window row and its two
    backwards run as on the card: the plane table's code, raw_t of 16
    columns, kernel B's trunk steps with the retraction's VJP of that warp
    and the plane rows (no sheet step)."""
    model = flagship_model('cpu', config=config, **F32)
    for name in ('coarse', 'fine'):
        _check_covered(model.level(name))
    level = model.level('fine')
    row = _scales(level.warp, WINDOW)[0]
    args = _rays(cond=K_mlp.cond_width(level))
    with as_on_the_card():
        _, raw_t = K_level._launch_forward(level, *args, want_raw_t=True,
                                           warp_scales=row)
        K_mlp.fused_template_bwd(level, raw_t, args[4], torch.zeros(16, 4))
        K_level.fused_fields_bwd(level, *args[:4], torch.zeros(16, 16), row)
    _check_signatures(recording.calls)
    assert raw_t.shape == (16, 16)
    fwd = dict(recording.calls)['hn_f32_level_fwd']
    code = common.TABLE_CODES[config]
    assert fwd[8] == code and fwd[9] is not None and fwd[10] is None
    assert [a[0] for n, a in recording.calls
            if n == 'hn_f32_retract_bwd'] == [code - 4]
    assert [a[0] for n, a in recording.calls
            if n == 'hn_f32_plane_rows'] == [1]
    assert 'hn_f32_screw_rows' not in dict(recording.calls)


@torch.no_grad()
@pytest.mark.parametrize('config', ['anneal_se3', 'anneal_quaternion'])
def test_gate_admits_the_nerfies_screw_levels(config, recording):
    """The screw levels with the Nerfies template (the HyperNeRF paper's
    ``anneal_se3``, and ``anneal_quaternion``), refused before sub-item 3's
    first half: both levels pass the gate, and the fine level's forward
    with both window rows and its two backwards run as on the card: the
    table code of the warp, both window rows' pointers, kernel B's trunk
    steps with the retraction's VJP of that warp."""
    model = flagship_model('cpu', config=config, **F32)
    for name in ('coarse', 'fine'):
        _check_covered(model.level(name))
    level = model.level('fine')
    row = _scales(level.warp, WINDOW)[0]
    tmpl_row = K_mlp.template_scales(level, 10.0, 1.5)
    args = _rays(cond=K_mlp.cond_width(level))
    with as_on_the_card():
        _, raw_t = K_level._launch_forward(level, *args, want_raw_t=True,
                                           warp_scales=row,
                                           tmpl_scales=tmpl_row)
        K_mlp.fused_template_bwd(level, raw_t, args[4], torch.zeros(16, 4),
                                 tmpl_row)
        K_level.fused_fields_bwd(level, *args[:4], torch.zeros(16, 8), row)
    _check_signatures(recording.calls)
    fwd = dict(recording.calls)['hn_f32_level_fwd']
    code = common.WARP_CODES[level.warp.kind]
    assert fwd[8] == code and None not in (fwd[9], fwd[10])
    assert [a[0] for n, a in recording.calls
            if n == 'hn_f32_retract_bwd'] == [code - 1]


# ---------------------------------------------------------------------------
# The launches and the sources.


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


@torch.no_grad()
def test_launches_match_the_c_signatures(probes, recording):
    """Rows 1 and 5 at codes 1 (with the window row) and 2 (without), and
    rows 12 and 13, as on the card: every C call has its signature's
    arguments, the stream last; the level forward takes the table code and
    the window row's pointer; kernel B reduces dW / db of the trunk's 9
    layers and the sheet's 7, runs the retraction's VJP with the quaternion
    flag of its code, and sums the screw rows per ray; each wrapper counts
    one launch a call."""
    lib = recording
    wrappers = (f32.fused_level_f32, f32.fused_fields_bwd_f32,
                f32.fused_se3_f32, f32.fused_se3_bwd_f32)
    counts = [fn.launches for fn in wrappers]
    rays, samples = 3, 8
    args = _rays(rays, samples)
    with as_on_the_card():
        for code, kind, alpha in ((1, 'se3', WINDOW),
                                  (2, 'quaternion', None)):
            level = probes[kind].level('fine')
            row = _scales(level.warp, alpha)[0]
            out, raw_t = K_level._launch_forward(level, *args,
                                                 want_raw_t=True,
                                                 warp_scales=row)
            assert out.shape == (rays * samples, 4)
            name, fwd = lib.calls[-1]
            assert name == 'hn_f32_level_fwd'
            assert fwd[5] == 39 and fwd[8] == code
            assert (fwd[9] is None) == (alpha is None)
            del lib.calls[:]
            K_level.fused_fields_bwd(level, *args[:4],
                                     torch.zeros(rays * samples, 8), row)
            names = [n for n, _ in lib.calls]
            assert names.count('hn_f32_reduce') == 2 * (9 + 7)
            assert names.count('hn_f32_trunk_encode') == 1
            assert names.count('hn_f32_field_encode') == 1  # the sheet
            assert [a[0] for n, a in lib.calls
                    if n == 'hn_f32_retract_bwd'] == [code - 1]
            assert names[-2:] == ['hn_f32_screw_rows', 'hn_f32_ray_sum']
            _check_signatures(lib.calls)
            del lib.calls[:]
        field = probes['se3'].warp_field
        row = _scales(field, WINDOW)[0]
        w, v = K_se3.fused_se3_wv(field, _x_trunk(9, 1), row)
        assert w.shape == v.shape == (9, 3)
        name, a = lib.calls[-1]
        assert name == 'hn_f32_trunk_fwd' and a[1] is not None
        assert a[-2] == 9
        dx, grads = K_se3.fused_se3_bwd(field, _x_trunk(9, 1),
                                        torch.zeros(9, 8), row)
        assert dx.shape == (9, 11) and len(grads) == 18
        names = [n for n, _ in lib.calls]
        assert names.count('hn_f32_reduce') == 2 * 9
        assert names[-1] == 'hn_f32_trunk_posenc_bwd'
        _check_signatures(lib.calls)
    assert [fn.launches - c for fn, c in zip(wrappers, counts)] == [2, 2, 1,
                                                                   1]


def test_new_entries_in_the_sources():
    """The new entry points take what ``build._SIGNATURES`` declares
    (argument counts read from the C declarations, the stream last); the
    retraction and its VJP are se3_trunk.cuh's, included, not copied; the
    table code is a run-time argument of the one level forward, not an
    instantiation; the trunk alone launches with its own shared memory."""
    level, steps = _source('f32_level.cu'), _source('f32_steps.cu')
    for src, names in ((level, ('hn_f32_level_fwd', 'hn_f32_trunk_fwd',
                                'hn_f32_table_layout')),
                       (steps, ('hn_f32_trunk_encode',
                                'hn_f32_trunk_posenc_bwd',
                                'hn_f32_retract_bwd', 'hn_f32_screw_rows'))):
        for name in names:
            decl = re.search(r'extern "C" int ' + name + r'\(([^)]*)\)', src)
            params = decl.group(1).split(',')
            assert len(params) == len(build._SIGNATURES[name][0]), name
            assert 'cudaStream_t' in params[-1] or name.endswith('layout')
    for src in (level, steps):
        assert '#include "se3_trunk.cuh"' in src
        assert 'void retract(' not in src and 'void retract_bwd(' not in src
    assert 'retract<true>(w, v, p, out);' in level
    assert 'retract_bwd<true>(w, v, p, g, dw, dv, dpp);' in steps
    assert 'if (a.code == 0) {' in level
    assert ('trunk_fwd_f32<<<tiles_of(rows), kThreads, kTrunkSmemBytes, '
            'stream>>>') in level
    assert f32.SE3_STASH.width == 960 and f32.SE3_STASH.widths['enc'] == 64
    assert f32.chunk_rows(f32.SE3_STASH) == 838860
    assert all(c % 4 == 0 for c in f32.SE3_STASH.col.values())


# ---------------------------------------------------------------------------
# The steps through the PyTorch model of each C entry point.


class TorchScrewOps(TorchF32Ops):
    """``TorchF32Ops`` with the trunk's steps, each the contract of its C
    entry point (csrc/f32_steps.cu)."""

    @staticmethod
    def _points(z, o, d, samples):
        q = torch.arange(z.shape[0]) // samples
        return o[q] + z[:, None] * d[q], q

    def trunk_encode(self, x, z, o, d, emb, samples, scales, out):
        if z is None:
            pts, e = x[:, :3], x[:, 3:]
        else:
            pts, q = self._points(z, o, d, samples)
            e = emb[q]
        enc = torch.cat([*common.posenc_trig(pts, 8), e], 1)
        enc = F.pad(enc, (0, out.shape[1] - enc.shape[1]))
        out[:] = enc if scales is None else enc * scales

    def trunk_posenc_bwd(self, x, scales, g, dx):
        gs = g if scales is None else g * scales
        dx[:, :3] = common.posenc_bwd(gs[:, :48], common.posenc_trig(
            x[:, :3], 8), 3, 8, identity=False)
        dx[:, 3:11] = gs[:, 48:56]

    def retract_bwd(self, code, z, o, d, samples, wv, dxt, g_wv, dp):
        pts, _ = self._points(z, o, d, samples)
        bwd = (quaternion.quat_warp_vec_bwd if code == 2
               else rigid_body.se3_warp_vec_bwd)
        dw, dv, dpp = bwd(wv[:, :3], wv[:, 8:11], pts, dxt[:, :3])
        g_wv[:] = F.pad(torch.cat([dw, dv], 1), (0, 2))
        dp[:] = dpp

    def screw_rows(self, z, o, d, emb, samples, dpd, gt, scales, gs, f1, dz,
                   rows):
        pts, q = self._points(z, o, d, samples)
        direct = dpd.clone()  # dpd may be rows' own columns
        gts = gt if scales is None else gt * scales
        n1, e = 3 * (1 + 2 * f1), emb.shape[1]
        dp = (direct + common.posenc_bwd(
            gts[:, :48], common.posenc_trig(pts, 8), 3, 8, identity=False)) \
            + common.posenc_bwd(gs[:, :n1], common.posenc_trig(pts, f1), 3,
                                f1)
        dz[:] = (dp * d[q]).sum(1)
        rows[:] = torch.cat([dp, dp * z[:, None],
                             gts[:, 48:48 + e] + gs[:, n1:n1 + e]], 1)


@torch.no_grad()
@pytest.mark.parametrize('kind,alpha,rays,samples,max_rows,sms', [
    ('se3', WINDOW, 7, 13, 40, 2), ('se3', None, 2, 64, 1000, 400),
    ('quaternion', None, 3, 29, 60, 2), ('quaternion', WINDOW, 2, 40, 80, 2)])
def test_kernel_b_screw_steps_match_the_plain_backward(
        probes, kind, alpha, rays, samples, max_rows, sms):
    """Kernel B's float32 steps with the trunk (``f32.fields_bwd_steps`` at
    code 1 or 2) through ``TorchScrewOps`` at full width (several chunks of
    whole rays, ragged row ranges) give the plain backward's d z, d o, d d,
    d embed and every dW / db of the trunk and the sheet: relative L2
    1e-5."""
    level = probes[kind].level('fine')
    row, krow = _scales(level.warp, alpha)
    args = _rays(rays, samples, seed=rays + samples)
    dx_t = torch.from_numpy(np.random.RandomState(samples).randn(
        rays * samples, 8).astype(np.float32))
    dx_t[:, 7] = 0.0
    w_blob, b_blob, shapes = pack_level_f32(level)
    wt_blob = pack_level_f32(level, transposed=True)[0]
    nf = K_level._n_field_layers(level)
    assert nf == 16
    w, wt, b, w_off, b_off, n = K_mlp.layer_views(w_blob, wt_blob, b_blob,
                                                  shapes[:nf])
    d_z, d_ray, grads = f32.fields_bwd_steps(
        TorchScrewOps(sms), w, wt, b, w_off, b_off, n, *args[:4], dx_t,
        max_rows, code=common.WARP_CODES[kind], scales=krow)
    n_w = sum(a * c for a, c in shapes[:nf])
    got = [d_z, d_ray[:, :3], d_ray[:, 3:6], d_ray[:, 6:]] + \
        common.unpack_grads(grads[:n_w], grads[n_w:],
                            level_layers(level)[:nf], shapes[:nf])
    want = fused_fields_bwd_plain(level, *args[:4], dx_t, row)
    errs = [_rel(a, c) for a, c in zip(got, [*want[:4], *want[4]])]
    assert len(errs) == 4 + 32 and max(errs) <= TOL, errs


@torch.no_grad()
@pytest.mark.parametrize('alpha,rows,max_rows,sms', [
    (None, 300, 64, 2), (WINDOW, 97, 1000, 400), (1.0, 130, 50, 2)])
def test_trunk_alone_steps_match_the_plain_backward(probes, alpha, rows,
                                                    max_rows, sms):
    """The trunk alone backward's float32 steps (``f32.se3_bwd_steps``)
    through ``TorchScrewOps`` at full width (ragged chunks and row ranges,
    the window row off, on, and at a whole band) give the plain backward's
    dx_raw and every dW / db: relative L2 1e-5; the heads' cotangents are
    summed into the trunk logit's, unmasked."""
    field = probes['se3'].warp_field
    row, krow = _scales(field, alpha)
    layers = K_se3.se3_layers(field)
    w_blob, b_blob, shapes = common.pack_layers(field, layers,
                                                dtype=torch.float32)
    wt_blob = common.pack_layers(field, layers, transposed=True,
                                 dtype=torch.float32)[0]
    x = _x_trunk(rows, rows)
    g = torch.from_numpy(np.random.RandomState(rows + 1).randn(
        rows, 8).astype(np.float32))
    g[:, 6:] = 0.0
    w, wt, b, w_off, b_off, n = K_mlp.layer_views(w_blob, wt_blob, b_blob,
                                                  shapes)
    dx, grads = f32.se3_bwd_steps(TorchScrewOps(sms), w, wt, b, w_off,
                                  b_off, n, x, g, krow, max_rows)
    n_w = sum(a * c for a, c in shapes)
    got = [dx] + common.unpack_grads(grads[:n_w], grads[n_w:], layers,
                                     shapes)
    want_dx, want_grads = K_se3.fused_se3_bwd_plain(field, x, g, row)
    errs = [_rel(a, c) for a, c in zip(got, [want_dx, *want_grads])]
    assert len(errs) == 19 and max(errs) <= TOL, errs


# ---------------------------------------------------------------------------
# The models against the JAX model at float32.


MODELS = {'se3': dict(warp_field_type='se3'),
          'quaternion': dict(warp_field_type='quaternion'),
          'se3_split_glo': dict(warp_field_type='se3', share_glo=False)}


@pytest.fixture(scope='module')
def models():
    """{name: (port model, JAX model, flax params)} at narrow widths in
    float32 with the trunk's flagship encoding (degrees 0..8), the w, v and
    sheet heads scaled up so that the rotation and the sheet move the
    output; the port's weights converted from the flax ones."""
    out = {}
    rays = jnp.asarray(_batch()[0])
    for name, over in MODELS.items():
        cfg = {**ARCH, **over}
        jmodel = JaxNerfModel(JaxNerfConfig(use_pallas=False, **cfg))
        params = jax.device_get(jax.jit(jmodel.init)(
            {'params': jax.random.PRNGKey(3)}, jax_ray_dict(rays))['params'])
        params = jax.tree.map(np.array, params)
        for head in ('w_net', 'v_net'):
            params['warp_field'][head]['logit']['kernel'] *= 1e3
        params['hyper_sheet_mlp']['mlp']['logit']['kernel'] *= 1e4
        model = NerfModel(port_configs.NerfConfig(**cfg))
        model.load_state_dict(params_from_jax(params))
        assert model.config.compute_dtype == 'float32'
        assert model.warp_field.max_deg == 8
        out[name] = (model, jmodel, params)
    return out


@pytest.mark.parametrize('name,alpha', [
    ('se3', None), ('se3', WINDOW), ('quaternion', None),
    ('quaternion', WINDOW), ('se3_split_glo', None),
    ('se3_split_glo', WINDOW)])
def test_float32_screw_models_match_jax(models, name, alpha):
    """A deterministic render's per-ray outputs of both levels, relative
    L2 1e-5, and the loss's gradient against the JAX model at float32 (the
    JAX render and gradient jitted): relative L2 1e-5 over all parameters,
    and each parameter's max|d| 1e-4 of its largest entry."""
    model, jmodel, params = models[name]
    rays, rgbs = _batch()
    jextra = {'warp_alpha': None if alpha is None else jnp.float32(alpha)}

    def loss(p):
        out = jmodel.apply({'params': p}, jax_ray_dict(jnp.asarray(rays)),
                           jextra, deterministic=True)
        return jax_mse_loss(out, jnp.asarray(rgbs)), out

    (_, want), jgrads = jax.device_get(jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params))
    model.zero_grad(set_to_none=True)
    got = model(prepare_ray_dict(torch.from_numpy(rays)), deterministic=True,
                extra_params={'warp_alpha': alpha})
    for level in want:
        for k in ('rgb', 'depth', 'acc'):
            assert _rel(got[level][k].detach(), want[level][k]) <= TOL, \
                (level, k)
    mse_loss(got, torch.from_numpy(rgbs)).backward()
    jgrads = params_from_jax(jgrads)
    mine, theirs = [], []
    for pname, p in model.named_parameters():
        want_g = torch.as_tensor(np.asarray(jgrads[pname]))
        g = torch.zeros_like(want_g) if p.grad is None else p.grad
        assert (g - want_g).abs().max() <= \
            10 * TOL * want_g.abs().max().clamp_min(1e-30), pname
        mine.append(g.reshape(-1))
        theirs.append(want_g.reshape(-1))
    assert _rel(torch.cat(mine), torch.cat(theirs)) <= TOL
    assert any('warp_field.w_net' in k for k in jgrads)


# ---------------------------------------------------------------------------
# The stored JAX numbers.


def _plain_level_case(case, ref, dtype=torch.float32):
    """The plain level's out and gradients of a stored level case at
    ``dtype`` ({name: numpy}, named as the file names them), with the
    forward's raw_t."""
    config, level, _, _, alpha, _, heads = F32_SCREW_LEVEL_CASES[case]
    model = f32_screw_model(config, heads).to(dtype)
    lv = model.level(level)
    row = _scales(lv.warp, alpha)[0]
    row = None if row is None else row.to(dtype)
    args = [torch.from_numpy(ref[k]).to(dtype) for k in LEVEL_INPUTS]
    with torch.no_grad():
        out, raw_t = fused_level_plain(lv, *args, return_raw_t=True,
                                       warp_scales=row)
    return lv, args, row, out, raw_t


def _level_grads(lv, args, row, raw_t, cot):
    """{'d_<input>', 'db<l>', 'dw<l>'} of the plain backward from raw_t."""
    with torch.no_grad():
        dx_t, d_cond, t_grads, _ = K_mlp.fused_template_bwd_plain(
            lv, raw_t, args[4], cot)
        *rays, f_grads = fused_fields_bwd_plain(lv, *args[:4], dx_t, row)
    got = dict(zip(('d_z_vals', 'd_origins', 'd_directions', 'd_embed'),
                   rays))
    got['d_rgb_cond'] = d_cond
    for l, (dw, db) in enumerate(zip(*[iter(f_grads + t_grads)] * 2)):
        got.update({f'dw{l}': dw, f'db{l}': db})
    return {k: v.double().numpy() for k, v in got.items()}


def _rounding_floor(case, ref, raw_t32):
    """{name: relative L2} by which a float32 forward's warped point (its
    raw_t ``raw_t32``, rounded apart from float64's) moves each gradient of
    a level case, the backward in float64 arithmetic."""
    lv, args, row, _, raw_t = _plain_level_case(case, ref, torch.float64)
    cot = torch.from_numpy(ref['cotangent']).double()
    exact = _level_grads(lv, args, row, raw_t, cot)
    rounded = _level_grads(lv, args, row, raw_t32.double(), cot)
    return {k: np.linalg.norm(rounded[k] - v) / max(np.linalg.norm(v),
                                                    1e-30)
            for k, v in exact.items()}


@torch.no_grad()
def test_stored_float32_screw_reference():
    """tests/data/fused_f32_screw_jax_ref.npz, what ``chip_smoke.py`` phase
    35 holds rows 1, 5, 12 and 13 to: its inputs redrawn from their seeds,
    its windowed trunk case recomputed (the JAX trunk kernel at float32,
    interpret mode), and the plain float32 versions held to every case (the
    module docstring's rule, the rounding floor measured here in
    float64)."""
    ref = read_f32_screw_reference()
    assert sorted(ref) == sorted((*F32_SCREW_LEVEL_CASES,
                                  *F32_SCREW_TRUNK_CASES))
    for case, arrays in ref.items():
        for k, v in f32_screw_probe_inputs(case).items():
            np.testing.assert_array_equal(arrays[k], v, err_msg=case)
    case = 'trunk_window'
    again = make_level_reference.jax_se3_trunk(
        f32_screw_model('se3', 'probe'), ref[case], WINDOW)
    for k, v in again.items():
        if k in ref[case]:
            assert _rel(v, ref[case][k]) <= 1e-6, k
    for case, (rows, alpha, _, heads) in F32_SCREW_TRUNK_CASES.items():
        arrays = ref[case]
        field = f32_screw_model('se3', heads).warp_field
        row = _scales(field, alpha)[0]
        x = torch.from_numpy(arrays['x_raw'])
        out = K_se3.fused_se3_plain(field, x, row)
        dx, grads = K_se3.fused_se3_bwd_plain(
            field, x, torch.from_numpy(arrays['cotangent']), row)
        got = {'dx': dx}
        for l in range(9):
            got[f'db{l}'] = grads[2 * l + 1]
            if l in F32_SCREW_TRUNK_DW:
                got[f'dw{l}'] = grads[2 * l]
        scale = np.abs(arrays['out']).max()
        assert np.abs(out.numpy() - arrays['out']).max() <= 1e-4 * scale
        assert sorted(got) == sorted(k for k in arrays
                                     if k.startswith(('dx', 'dw', 'db')))
        for k, g in got.items():
            want = arrays[k]
            assert np.linalg.norm(g.numpy() - want) <= \
                1e-2 * np.linalg.norm(want), (case, k)
            assert np.abs(g.numpy() - want).max() <= \
                5e-2 * np.abs(want).max(), (case, k)
    for case in F32_SCREW_LEVEL_CASES:
        arrays = ref[case]
        lv, args, row, out, raw_t = _plain_level_case(case, arrays)
        scale = np.abs(arrays['out']).max()
        assert np.abs(out.numpy() - arrays['out']).max() <= 1e-4 * scale
        got = _level_grads(lv, args, row, raw_t,
                           torch.from_numpy(arrays['cotangent']))
        floor = _rounding_floor(case, arrays, raw_t)
        keys = [k for k in arrays if k.startswith(('d_', 'dw', 'db'))]
        assert len(keys) == 5 + 32 + len(F32_SCREW_GRAD_LAYERS)
        for k in keys:
            want = arrays[k]
            err = np.linalg.norm(got[k] - want) / np.linalg.norm(want)
            assert err <= min(1e-2 + 2 * floor[k], 5e-2), (case, k, err,
                                                           floor[k])
            assert np.abs(got[k] - want).max() <= \
                5e-2 * np.abs(want).max(), (case, k)
