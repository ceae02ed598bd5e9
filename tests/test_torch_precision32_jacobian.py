"""``--precision 32`` with the elastic loss (ROADMAP A.13.1 sub-item 4): the
float32 Jacobian kernels, rows 14 to 17 (``csrc/f32_tangents.cu`` and the
float32 steps of ``kernels/f32.py``), checked on the CPU.

- ``tests/data/fused_f32_jacobian_jax_ref.npz``
  (``tools/make_level_reference.py --only f32_jacobian``): each case
  recomputed (the JAX Jacobian kernels in interpret mode at float32, full
  width, 300 rows), and the plain float32 versions held to it: every
  output and gradient, and the side channel's J of both retractions,
  relative L2 1e-4 (float32 both ways, other summation orders; measured at
  most 4.1e-7).
- The gates: the float32 ``elastic``, ``elastic_se3`` (window row off and
  on) and ``elastic_quaternion`` warp fields are admitted and run their
  forward and backward as on the card before any library is needed,
  against a recording library: every launch one of the float32 entry
  points with its signature's arguments; the forward one launch; the
  backward the streams' steps (the tangent rows' masks from the primal
  rows, which repeat; db over no row for J, over the primal rows for the
  trunk); each wrapper counts one launch a call; no plain version runs.
  Other bands still raise naming A.13.
- The steps of rows 15 and 17 (``f32.jacobian_bwd_steps``, the trunk's
  with ``trunk=True``) through a PyTorch model of each C entry point
  (``TorchJacobianOps``: ``test_torch_precision32_screw.TorchScrewOps`` with
  the three stream steps) against the plain backward at full width, over
  ragged chunks and row ranges: relative L2 1e-5.
- The new entry points' declarations and the forward's shared memory, read
  from the source.
- The float32 ``elastic_se3`` and ``elastic_quaternion`` steps at narrow
  widths with the Jacobian at every sample (the stochastic path, K = 0) and
  subsampled (K = 4) against the JAX float32 model with its kernels in
  interpret mode (``test_torch_elastic_train_step.py``'s check: loss 1e-5,
  every gradient 1e-4 of its largest entry); the translation warp's two
  paths are that file's own cases, which run in float32.
- The CLI: ``train.main --precision 32 --elastic_loss_weight 0.01
  --elastic_jacobian_samples 4 --warp_field se3 --use_nerfies_embed`` takes
  two steps on the CPU.

One torch thread. About 60 s alone on one worker.
"""

import contextlib
import importlib
import os
import re
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hypernerf_tpu_torch.flagship import (F32_JACOBIAN_CASES,
                                          F32_JACOBIAN_REFERENCE,
                                          f32_jacobian_model, flagship_model,
                                          jacobian_probe_inputs,
                                          read_jacobian_reference)
from hypernerf_tpu_torch import train as port_train
from hypernerf_tpu_torch.kernels import build, common, f32
from hypernerf_tpu_torch.kernels import fused_mlp as K_mlp
from hypernerf_tpu_torch.kernels.fused_field import field_layers
from hypernerf_tpu_torch.ops import quaternion, rigid_body
from tests import test_torch_elastic_train_step as elastic_step
from tests.conftest import make_smooth_llff_scene
from tests.test_torch_precision32 import (_RecordingLibrary, _source,
                                          as_on_the_card)
from tests.test_torch_precision32_modular import _check_signatures
from tests.test_torch_precision32_screw import TorchScrewOps

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'tools'))
import make_level_reference  # noqa: E402

# The kernels' package re-exports functions under some of its submodules'
# names: the modules themselves.
K_jac = importlib.import_module('hypernerf_tpu_torch.kernels.fused_jacobian')
K_se3 = importlib.import_module('hypernerf_tpu_torch.kernels.fused_se3')
K_se3_jac = importlib.import_module(
    'hypernerf_tpu_torch.kernels.fused_se3_jacobian')
F32 = dict(compute_dtype='float32')
REF_L2 = 1e-4
TOL = 1e-5
WINDOW = 3.5  # warp_alpha of the trunk's 8 bands
RETRACTIONS = {'se3': rigid_body.se3_warp_vec_bwd,
               'quaternion': quaternion.quat_warp_vec_bwd}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a, b = torch.as_tensor(np.array(a)), torch.as_tensor(np.array(b))
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _x_raw(rows, seed):
    rs = np.random.RandomState(seed)
    return torch.from_numpy(np.concatenate(
        [rs.randn(rows, 3) * 0.5, rs.randn(rows, 8) * 0.1], 1).astype(
            np.float32))


def _scales(field, alpha):
    """(the window row as the plain versions take it, as the kernels do)."""
    if alpha is None:
        return None, None
    row = K_se3.se3_encoding_scales(field, alpha)
    return row, common.padded_scales(row, row.shape[0], f32.SE3_ENC,
                                     row.device)


# ---------------------------------------------------------------------------
# The stored JAX numbers.


def _plain_case(case, arrays):
    """{name: numpy} of the plain float32 versions on a stored case, named
    as the file names them."""
    config, _, alpha, _ = F32_JACOBIAN_CASES[case]
    model = f32_jacobian_model(case)
    x = torch.from_numpy(arrays['x_raw'].copy())
    g = torch.from_numpy(arrays['cotangent'].copy())
    with torch.no_grad():
        if config == 'flagship':
            mlp = model.warp_field.mlp
            out = K_jac.fused_jacobian_plain(mlp, 10, x)
            dx, grads = K_jac.fused_jacobian_bwd_plain(mlp, 10, x, g)
            jacs = {}
        else:
            field = model.warp_field
            row = _scales(field, alpha)[0]
            out = K_se3_jac.fused_se3_jacobian_plain(field, x, row)
            dx, grads = K_se3_jac.fused_se3_jacobian_bwd_plain(field, x, g,
                                                               row)
            p = out.shape[0]
            w, v, dw, dv = (out[:, :3], out[:, 3:6],
                            out[:, 6:15].reshape(p, 3, 3),
                            out[:, 15:].reshape(p, 3, 3))
            jacs = {f'jac_{kind}': rigid_body.retraction_jacobian(
                bwd, w, v, x[:, :3], dw, dv).reshape(p, 9)
                for kind, bwd in RETRACTIONS.items()}
    names = ['dx'] + [f'd{"wb"[i % 2]}{i // 2}' for i in range(len(grads))]
    got = dict(zip(names, (dx, *grads)), out=out, **jacs)
    return {k: v.double().numpy() for k, v in got.items()}


@pytest.mark.parametrize('case', list(F32_JACOBIAN_CASES))
def test_stored_float32_jacobian_reference(case):
    """tests/data/fused_f32_jacobian_jax_ref.npz, what ``chip_smoke.py``
    phase 38 holds rows 14 to 17 to: the case's inputs redrawn from their
    seed, its JAX numbers recomputed (the JAX Jacobian kernels at float32,
    interpret mode), and the plain float32 versions held to every array:
    relative L2 REF_L2."""
    stored = read_jacobian_reference(F32_JACOBIAN_REFERENCE,
                                     F32_JACOBIAN_CASES)[case]
    inputs = jacobian_probe_inputs(case, F32_JACOBIAN_CASES)
    for k, v in inputs.items():
        np.testing.assert_array_equal(stored[k], v)
    again = make_level_reference.jax_jacobian(
        f32_jacobian_model(case), case, inputs, F32_JACOBIAN_CASES)
    assert sorted(again) == sorted(k for k in stored if k not in inputs)
    for k, v in again.items():
        assert _rel(v, stored[k]) <= 1e-6, k
    port = _plain_case(case, stored)
    assert sorted(port) == sorted(again)
    for k, v in port.items():
        assert v.shape == stored[k].shape, k
        assert _rel(v, stored[k].astype(np.float64)) <= REF_L2, k
    # The probe weights move J well away from the identity, and the trunk's
    # rotations are of ordinary size.
    if F32_JACOBIAN_CASES[case][0] == 'flagship':
        assert np.abs(port['out'].reshape(-1, 3, 3) - np.eye(3)).mean() > 0.1
    else:
        assert 0.1 < np.linalg.norm(port['out'][:, :3], axis=-1).mean() < 1.0


# ---------------------------------------------------------------------------
# The gates and the launches.


@pytest.fixture
def recording(monkeypatch):
    """The kernel library as a ``_RecordingLibrary`` on a card of 132 SMs:
    the wrappers' launches are recorded, nothing runs."""
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


# name -> (configuration, warp_alpha of the trunk's window row or None).
ADMITTED = {'elastic': ('elastic', None),
            'elastic_se3': ('elastic_se3', None),
            'elastic_se3 windowed': ('elastic_se3', WINDOW),
            'elastic_quaternion': ('elastic_quaternion', WINDOW)}


@torch.no_grad()
@pytest.mark.parametrize('name', list(ADMITTED))
def test_gate_admits_the_float32_jacobians(name, recording):
    """The float32 Jacobians, refused before: the warp field (rows 14, 15)
    or the trunk (rows 16, 17, its window row's pointer where it has one)
    at the flagship widths runs forward and backward as on the card. The
    forward is one launch of its entry; the backward the streams' steps:
    the cotangent as the streams' rows, their encoding, a primal and a
    tangent product a layer for the recompute (the tangent rows' mask the
    primal rows, repeating every P rows), dW over the walk's rows with db
    over none (J) or the P primal rows (the trunk), a reduce of dW and of db
    a layer, the encoding's pullback last. Every C call has its signature's
    arguments; each wrapper counts one launch a call; no plain version
    runs."""
    config, alpha = ADMITTED[name]
    field = flagship_model('cpu', config=config, **F32).warp_field
    p = 37
    x = _x_raw(p, 5)
    trunk = config != 'elastic'
    wrappers = ((f32.fused_se3_jacobian_f32, f32.fused_se3_jacobian_bwd_f32)
                if trunk else (f32.fused_jacobian_f32,
                               f32.fused_jacobian_bwd_f32))
    counts = [fn.launches for fn in wrappers]
    plains = (K_jac.fused_jacobian_plain, K_jac.fused_jacobian_bwd_plain,
              K_se3_jac.fused_se3_jacobian_plain,
              K_se3_jac.fused_se3_jacobian_bwd_plain)
    plain_calls = [fn.calls for fn in plains]
    with as_on_the_card():
        if trunk:
            row = _scales(field, alpha)[0]
            outs = K_se3_jac.fused_se3_wv_tangents(field, x, row)
            assert [t.shape for t in outs] == [(p, 3), (p, 3), (p, 3, 3),
                                               (p, 3, 3)]
            fwd = recording.calls[-1]
            assert fwd[0] == 'hn_f32_se3_jacobian_fwd'
            assert (fwd[1][1] is None) == (alpha is None)
            del recording.calls[:]
            dx, grads = K_se3_jac.fused_se3_jacobian_bwd(field, x,
                                                         torch.zeros(p, 24),
                                                         row)
            n_layers = 9
        else:
            jac = K_jac.fused_warp_jacobian(field.mlp, 10, x[:, :3], x[:, 3:])
            assert jac.shape == (p, 3, 3)
            assert recording.calls[-1][0] == 'hn_f32_jacobian_fwd'
            del recording.calls[:]
            dx, grads = K_jac.fused_jacobian_bwd(field.mlp, 10, x,
                                                 torch.zeros(p, 9))
            n_layers = 7
    assert dx.shape == (p, 11) and len(grads) == 2 * n_layers
    _check_signatures(recording.calls)
    names = [n for n, _ in recording.calls]
    assert all(n.startswith('hn_f32_') for n in names)
    assert names[:2] == ['hn_f32_stream_cot', 'hn_f32_stream_encode']
    assert names[-1] == 'hn_f32_stream_enc_bwd'
    assert names.count('hn_f32_reduce') == 2 * n_layers
    assert names.count('hn_f32_dw') == n_layers
    assert {a[0] for n, a in recording.calls
            if n.startswith('hn_f32_stream')} == {int(trunk)}
    walk_rows = (4 if trunk else 3) * p
    masked = [a for n, a in recording.calls
              if n == 'hn_f32_rowprod' and a[11] is not None]
    assert masked and all(a[13] == p for a in masked)
    # The recompute's tangent products: 6 hidden layers, masked, 3 P rows.
    assert sum(a[17] == 3 * p for a in masked) >= 6
    for n, a in recording.calls:
        if n == 'hn_f32_dw':
            assert a[15] == walk_rows and a[14] == (p if trunk else 0)
    assert [fn.launches - c for fn, c in zip(wrappers, counts)] == [1, 1]
    assert [fn.calls for fn in plains] == plain_calls


@pytest.mark.parametrize('config', ['elastic', 'elastic_se3'])
def test_gate_still_refuses_other_bands(config):
    """A warp field of other bands (A.13.3's shapes are refused the same
    way) raises naming A.13 at either precision, before any library is
    needed; nothing falls back to a plain version."""
    over = (dict(warp_freq=8) if config == 'elastic'
            else dict(warp_max_deg=6))
    field = flagship_model('cpu', config=config, **over, **F32).warp_field
    x = torch.zeros(4, 11)
    with as_on_the_card(), pytest.raises(NotImplementedError,
                                         match='ROADMAP item A.13'):
        if config == 'elastic':
            K_jac.fused_warp_jacobian(field.mlp, field.n_freq, x[:, :3],
                                      x[:, 3:])
        else:
            K_se3_jac.fused_se3_wv_tangents(field, x)


def test_new_entries_in_the_sources():
    """The new entry points take what ``build._SIGNATURES`` declares
    (argument counts read from the C declarations, the stream last); the
    forwards run f32_chain.cuh's products with a stream-aware epilogue and
    level_common.cuh's tables, not copies; their shared memory, from the
    source's constants, lets two blocks share an SM; rowprod's mask rows
    and dw's db rows are arguments of the entries."""
    tangents, steps = _source('f32_tangents.cu'), _source('f32_steps.cu')
    for src, names in ((tangents, ('hn_f32_jacobian_fwd',
                                   'hn_f32_se3_jacobian_fwd',
                                   'hn_f32_stream_encode',
                                   'hn_f32_stream_cot',
                                   'hn_f32_stream_enc_bwd')),
                       (steps, ('hn_f32_rowprod', 'hn_f32_dw'))):
        for name in names:
            decl = re.search(r'extern "C" int ' + name + r'\(([^)]*)\)', src)
            params = decl.group(1).split(',')
            assert len(params) == len(build._SIGNATURES[name][0]), name
            assert 'cudaStream_t' in params[-1], name
    assert '#include "f32_chain.cuh"' in tangents
    assert 'pass_product<T>(acc, segs, w, N, K, n0, N, ws);' in tangents
    assert 'weight_offset<Table>(L)' in tangents
    assert 'long long mrows' in steps and 'long long db_rows' in steps
    assert ('kSmemBytes = 4 * (kEncMax * kRows + 2 * kW * kRows + 2 * '
            'Narrow::kWTile + 8 * kRows + 3 * kPoints);') in tangents
    smem = 4 * (80 * 64 + 2 * 128 * 64 + 2 * f32.DEPTH * 128 + 8 * 64
                + 3 * 16)
    assert smem == 104640 and 2 * (smem + 1024) <= 233472
    assert f32.STREAMS * 16 == f32.TILE_ROWS


# ---------------------------------------------------------------------------
# The steps through the PyTorch model of each C entry point.


class TorchJacobianOps(TorchScrewOps):
    """``TorchScrewOps`` with the stream steps, each the contract of its C
    entry point (csrc/f32_tangents.cu): stream s of point q at row s n + q
    (the translation warp's cotangent and pullback on its three tangent
    streams alone)."""

    def stream_encode(self, trunk, x, scales, out):
        n = x.shape[0]
        pts, emb = x[:, :3], x[:, 3:11]
        n_freq = 8 if trunk else 10
        sin, cos = common.posenc_trig(pts, n_freq)
        t_sin, t_cos = K_jac.tangent_trig(sin, cos, n_freq)
        ident = [] if trunk else [pts]
        primal = torch.cat(ident + [sin, cos, emb], 1)
        t_ident = [] if trunk else [torch.eye(3)[:, None, :].expand(3, n, 3)]
        tangent = torch.cat(t_ident + [t_sin, t_cos, torch.zeros(3, n, 8)],
                            -1).reshape(3 * n, -1)
        enc = F.pad(torch.cat([primal, tangent]),
                    (0, out.shape[1] - primal.shape[1]))
        out[:] = enc if scales is None else enc * scales

    def stream_cot(self, trunk, g, out):
        n = g.shape[0]

        def tangents(cols):  # (n, 9) [i * 3 + k] -> row k n + q, column i
            return cols.reshape(n, 3, 3).permute(2, 0, 1).reshape(3 * n, 3)

        rows = tangents(g) if not trunk else torch.cat([
            g[:, :6], torch.cat([tangents(g[:, 6:15]),
                                 tangents(g[:, 15:24])], 1)])
        out[:] = F.pad(rows, (0, out.shape[1] - rows.shape[1]))

    def stream_enc_bwd(self, trunk, x, scales, g, dx):
        n = x.shape[0]
        gs = g if scales is None else g * scales
        n_freq, at = (8, 0) if trunk else (10, 3)
        nb = 3 * n_freq
        trig = common.posenc_trig(x[:, :3], n_freq)
        tan = (gs[n:] if trunk else gs).reshape(3, n, -1)
        dp = K_jac.tangent_encode_dp(tan[..., at:at + nb],
                                     tan[..., at + nb:at + 2 * nb], *trig,
                                     n_freq)
        dx[:] = 0
        if trunk:
            dp = common.posenc_bwd(gs[:n, :2 * nb], trig, 3, n_freq,
                                   identity=False) + dp
            dx[:, 3:11] = gs[:n, 2 * nb:2 * nb + 8]
        dx[:, :3] = dp


@pytest.fixture(scope='module')
def probes():
    """The probe-weight float32 warp fields of the stored cases."""
    return {config: f32_jacobian_model(case).warp_field
            for case, (config, *_) in F32_JACOBIAN_CASES.items()}


@torch.no_grad()
@pytest.mark.parametrize('config,alpha,rows,max_points,sms', [
    ('flagship', None, 301, 70, 2), ('flagship', None, 97, 1000, 400),
    ('se3', None, 211, 50, 2), ('se3', WINDOW, 130, 1000, 400),
    ('se3', 1.0, 77, 20, 2)])
def test_jacobian_steps_match_the_plain_backward(probes, config, alpha, rows,
                                                 max_points, sms):
    """Rows 15 and 17's float32 steps (``f32.jacobian_bwd_steps``, the
    trunk's with ``trunk=True``) through ``TorchJacobianOps`` at full width
    (ragged chunks of points and row ranges; the trunk's window row off,
    on, and at a whole band) give the plain backward's dx_raw and every dW
    / db: relative L2 1e-5; J's db exactly zero."""
    field = probes[config]
    trunk = config != 'flagship'
    owner = field if trunk else field.mlp
    layers = K_se3.se3_layers(field) if trunk else field_layers(field.mlp)
    w_blob, b_blob, shapes = common.pack_layers(owner, layers,
                                                dtype=torch.float32)
    wt_blob = common.pack_layers(owner, layers, transposed=True,
                                 dtype=torch.float32)[0]
    w, wt, b, w_off, b_off, n = K_mlp.layer_views(w_blob, wt_blob, b_blob,
                                                  shapes)
    x = _x_raw(rows, rows)
    g = torch.from_numpy(np.random.RandomState(rows + 1).randn(
        rows, 24 if trunk else 9).astype(np.float32))
    ops = TorchJacobianOps(sms)
    if trunk:
        row, krow = _scales(field, alpha)
        dx, grads = f32.jacobian_bwd_steps(ops, w, wt, b, w_off, b_off, n,
                                           x, g, trunk=True, scales=krow,
                                           max_points=max_points)
        want = K_se3_jac.fused_se3_jacobian_bwd_plain(field, x, g, row)
    else:
        dx, grads = f32.jacobian_bwd_steps(ops, w, wt, b, w_off, b_off, n, x,
                                           g, max_points=max_points)
        want = K_jac.fused_jacobian_bwd_plain(field.mlp, 10, x, g)
    n_w = sum(a * c for a, c in shapes)
    got = [dx] + common.unpack_grads(grads[:n_w], grads[n_w:], layers,
                                     shapes)
    errs = [_rel(a, c) for a, c in zip(got, [want[0], *want[1]])]
    assert len(errs) == 1 + 2 * len(layers) and max(errs) <= TOL, errs
    if not trunk:
        assert not grads[n_w:].any()


# ---------------------------------------------------------------------------
# The models against the JAX model at float32, and the CLI.


# name -> (warp field, K): the level path (one GLO table), the Jacobian at
# every sample (the stochastic path) or at K samples a ray.
STEPS = {'elastic_se3_k0': ('se3', 0), 'elastic_quaternion_k4':
         ('quaternion', elastic_step.K)}


@pytest.mark.parametrize('case', list(STEPS))
def test_float32_elastic_step_matches_jax(case, monkeypatch):
    """The float32 elastic step of a screw warp at narrow widths
    (``test_torch_elastic_train_step.py``'s ``check_loss_and_gradients``,
    the JAX model at ``compute_dtype='float32'`` with its kernels in
    interpret mode, the same converted weights and the JAX step's draws):
    the loss within 1e-5, every gradient within 1e-4 of its largest
    entry."""
    kind, k = STEPS[case]
    monkeypatch.setitem(elastic_step.CASES, case, (kind, True, k, False))
    assert elastic_step._arch(case)['compute_dtype'] == 'float32'
    elastic_step.check_loss_and_gradients(case, monkeypatch)


def test_cli_precision_32_elastic_runs_on_the_cpu(tmp_path, monkeypatch):
    """``train.main --precision 32 --elastic_loss_weight 0.01
    --elastic_jacobian_samples 4 --warp_field se3 --use_nerfies_embed``
    (the Nerfies paper's setting: the elastic loss on the SE(3) warp with
    the annealed encoding) builds a float32 model the kernels' gates admit
    and takes two steps on the CPU at the flagship widths, its losses
    finite."""
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    monkeypatch.setenv('HYPERNERF_PLATFORM', 'cpu')
    monkeypatch.chdir(tmp_path)
    scene = make_smooth_llff_scene(tmp_path / 'scene')
    trainer = port_train.main([
        '--root_dir', scene, '--img_wh', '16', '12', '--precision', '32',
        '--elastic_loss_weight', '0.01', '--elastic_jacobian_samples', '4',
        '--warp_field', 'se3', '--use_nerfies_embed', '--N_samples', '8',
        '--N_importance', '8', '--batch_size', '32', '--chunk', '64',
        '--max_steps', '2', '--exp_name', 'elastic32'])
    cfg = trainer.nerf_cfg
    assert (cfg.compute_dtype, cfg.warp_field_type,
            cfg.elastic_jacobian_samples) == ('float32', 'se3', 4)
    assert not cfg.use_original_embed and trainer.state.step == 2
    assert trainer.train_cfg.elastic_loss_weight == 0.01
    field = trainer.model.warp_field
    layers = K_se3.se3_layers(field)
    shapes = common.pack_layers(field, layers, dtype=torch.float32)[2]
    with monkeypatch.context() as m:
        m.setattr(build, 'library', _RecordingLibrary)
        f32.check_layout(shapes, common.SE3_LAYERS, 'se3')
    assert all(np.isfinite(v) for v in trainer.last_metrics.values())
