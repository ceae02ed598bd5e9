"""``--precision 32`` on the sheet tables' other layouts and conditions
(ROADMAP A.13.1 sub-item 3, first half): the float32 level forward (row 1)
and kernel A (row 9) with the template's Nerfies layout and its window row
(``anneal``, the paper's ``anneal_se3``, ``anneal_quaternion``), with the
``use_nerf_embed`` conditions (47 rgb columns and the alpha condition, the
embedding alone, none), the template alone (row 8) in the same layouts and
conditions, and a field alone with a window row (rows 10 and 11), checked
on the CPU.

- The gate: each of those configurations is admitted at both levels, and
  since sub-item 3's second half so are the plane tables (table codes 3 to
  8; their numbers are ``tests/test_torch_precision32_plane.py``'s), and
  since sub-item 4 the elastic loss's Jacobian of ``anneal_se3`` (rows 16
  and 17 with the trunk's window row; their numbers are
  ``tests/test_torch_precision32_jacobian.py``'s); a Jacobian of other
  degrees and the band flags (A.13.2) still raise naming A.13, before any
  library is needed.
- The launches: each wrapper, run as on the card against a recording
  library, passes its C entry point as many arguments of the kinds
  ``build``'s ctypes signature declares, the window row's pointer where
  the layout has one and the alpha condition's two where the template has
  one; kernel A's Nerfies encoding and its VJP without the hyper
  coordinates' identity, over 4 bands, into a 96-column stash; its alpha
  step once a chunk. The new arguments
  are run-time arguments of the existing kernels (read from the sources).
- The steps of kernel A (``f32.template_bwd_steps`` with the window row and
  the alpha condition) and of a field alone backward with a window row
  (``f32.field_bwd_steps``) through ``TorchF32Ops``, the PyTorch model of
  each C entry point, over ragged chunks and row ranges, against the plain
  backward: relative L2 1e-5 (float32 both ways, other summation orders).
- The port's float32 ``anneal``, ``anneal_se3``, ``nerf_embed`` and
  ``use_viewdirs=False`` models at narrow widths, on the level kernel's
  branch and on the per-module branch (``return_points``), against the
  JAX model at ``compute_dtype='float32'`` on the same weights with the
  alphas mid-ramp: outputs and the loss's gradients relative L2 1e-5, each
  parameter's max|d| 1e-4 of its largest entry (the JAX render and
  gradient jitted once per configuration).
- ``tests/data/fused_f32_nerfies_jax_ref.npz``
  (``tools/make_level_reference.py --only f32_nerfies``): its inputs
  redrawn, one template case recomputed (relative 1e-6), and the plain
  float32 versions held to every case. Outputs 1e-4 of the largest entry.
  Gradients of the template alone and of a field alone relative L2 1e-4
  (measured 9.1e-7 at worst). A level's gradients flow back through its
  float32 raw_t, whose rounding the template's 2^9 band amplifies: the
  plain backward fed the plain float32 forward's raw_t, against the same
  fed the raw_t of the forward with float64 arithmetic outside the MLPs
  (``_plain_level``), moves them by up to 4.8e-3 (``level_anneal``'s db14:
  a near-zero ReLU of the template's first layer flips); each level
  gradient is held to 1e-2 plus twice that floor as this file measures
  it, never past 5e-2, and 5e-2 of the largest entry.

One torch thread. About 50 s alone on one worker.
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

from hypernerf_tpu.configs import NerfConfig as JaxNerfConfig
from hypernerf_tpu.models.nerf import NerfModel as JaxNerfModel
from hypernerf_tpu.ops.ray_dict import prepare_ray_dict as jax_ray_dict
from hypernerf_tpu.training.losses import mse_loss as jax_mse_loss
from hypernerf_tpu_torch import configs as port_configs
from hypernerf_tpu_torch.convert import params_from_jax
from hypernerf_tpu_torch.flagship import (F32_NERFIES_FIELD_CASES,
                                          F32_NERFIES_LEVEL_CASES,
                                          F32_NERFIES_TEMPLATE_CASES,
                                          LEVEL_INPUTS, f32_nerfies_extra,
                                          f32_nerfies_grad_layers,
                                          f32_nerfies_model,
                                          f32_nerfies_probe_inputs,
                                          flagship_model, load_probe_weights,
                                          read_f32_nerfies_reference)
from hypernerf_tpu_torch.kernels import build, common, f32
from hypernerf_tpu_torch.kernels import fused_mlp as K_mlp
from hypernerf_tpu_torch.kernels.fused_level import (_check_covered,
                                                     fused_fields_bwd_plain,
                                                     fused_level_plain,
                                                     pack_level_f32)
from hypernerf_tpu_torch.models.nerf import NerfModel
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
K_field = importlib.import_module('hypernerf_tpu_torch.kernels.fused_field')
K_level = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
K_se3 = importlib.import_module('hypernerf_tpu_torch.kernels.fused_se3')
K_se3_jac = importlib.import_module(
    'hypernerf_tpu_torch.kernels.fused_se3_jacobian')
F32 = dict(compute_dtype='float32')
TOL = 1e-5
EMBED = dict(use_nerf_embed=True, use_alpha_condition=True,
             use_rgb_condition=True)
# The configurations sub-item 3's first half admits: name -> (configuration,
# NerfConfig overrides); the rgb and alpha conditions' widths in comments.
ADMITTED = {
    'anneal': ('anneal', {}),                          # Nerfies, 27 + 0
    'anneal_se3': ('anneal_se3', {}),                  # code 1, 27 + 0
    'anneal_quaternion': ('anneal_quaternion', {}),    # code 2, 27 + 0
    'anneal_embed': ('anneal', EMBED),                 # Nerfies, 35 + 8
    'nerf_embed': ('nerf_embed', {}),                  # 47 + 8
    'embed_only': ('nerf_embed', dict(use_viewdirs=False)),  # 8 + 8
    'no_viewdirs': ('flagship', dict(use_viewdirs=False)),   # 0 + 0
}
# Alphas mid-ramp for the steps: the xyz window partly on too.
ALPHAS = (4.5, 1.5)


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
    """Each ADMITTED configuration at float32, full width, probe weights."""
    return {name: load_probe_weights(flagship_model(
        'cpu', config=config, **over, **F32))
        for name, (config, over) in ADMITTED.items()}


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


def _alpha(level, rays, seed=0):
    """An alpha condition of ``rays`` rows where the template takes one."""
    if not K_mlp.alpha_cond_width(level):
        return None
    return torch.from_numpy(np.random.RandomState(seed).randn(
        rays, 8).astype(np.float32) * 0.3)


# ---------------------------------------------------------------------------
# The gate.


@pytest.mark.parametrize('name', list(ADMITTED))
def test_gate_admits_the_sheet_tables_layouts(probes, name, monkeypatch):
    """Both levels of each configuration pass the float32 level gate and
    the template's; their fp32 blobs are the compiled float32 table of
    their warp (csrc/f32_level.cu: the Nerfies encoding and every
    condition width fill the flagship table's 128 and 48 columns), and
    the template's layout and widths are ``fused_mlp.F32_LAYOUTS``'."""
    monkeypatch.setattr(build, 'library', _RecordingLibrary)
    model = probes[name]
    for level_name in ('coarse', 'fine'):
        level = model.level(level_name)
        _check_covered(level)
        K_mlp.check_f32_covered(level)
        shapes = pack_level_f32(level)[2]
        f32.check_layout(shapes, warp=level.warp.kind)
        widths = K_mlp.F32_LAYOUTS[K_mlp.layout(level)]
        assert K_mlp.cond_width(level) in widths['rgb_cond']
        assert K_mlp.alpha_cond_width(level) in common.ALPHA_COND
    assert K_mlp.layout(model.level('fine')) == (
        'nerfies' if name.startswith('anneal') else 'orig')


def _refusals():
    """(label, call that must raise)."""
    x11 = torch.zeros(4, 11)

    def tangents_of_other_degrees():
        field = flagship_model('cpu', config='anneal_se3', warp_max_deg=6,
                               **F32).warp_field
        with as_on_the_card():
            K_se3_jac.fused_se3_wv_tangents(field, x11)

    return [
        ('rows 16, 17 of other degrees (A.13)', tangents_of_other_degrees),
        ('the xyz bands (A.13.2)', lambda: _check_covered(flagship_model(
            'cpu', config='nerf_embed', xyz_freq=8, **F32).level('fine'))),
    ]


@pytest.mark.parametrize('label,call', _refusals(),
                         ids=[r[0].split(' (')[0] for r in _refusals()])
def test_gate_still_refuses_the_jacobians(label, call):
    """Since sub-item 4 the float32 kernels take the flagship's Jacobians
    (``test_gate_admits_the_nerfies_jacobian``); a Jacobian of other degrees
    and an A.13.2 band flag still raise, naming ROADMAP A.13 and no
    sub-item of A.13.1, with what the float32 kernels cover (the Nerfies
    template, the warps' Jacobians); nothing falls back to plain."""
    with pytest.raises(NotImplementedError, match='ROADMAP item A.13') as e:
        call()
    assert 'sub-item' not in str(e.value)
    assert 'posenc_orig and Nerfies templates' in str(e.value)
    assert 'the warps\' Jacobians' in str(e.value)


@torch.no_grad()
def test_gate_admits_the_nerfies_jacobian(recording):
    """The elastic loss on the Nerfies paper's model (``anneal_se3``: the
    SE(3) trunk with its window row) at float32, refused before sub-item
    4: the trunk's tangents forward (row 16) and backward (row 17) run as
    on the card through their float32 entry points with the window row's
    pointer, each with its signature's arguments."""
    field = flagship_model('cpu', config='anneal_se3', **F32).warp_field
    row = K_se3.se3_encoding_scales(field, 3.5)
    x = torch.zeros(6, 11)
    with as_on_the_card():
        K_se3_jac.fused_se3_wv_tangents(field, x, row)
        K_se3_jac.fused_se3_jacobian_bwd(field, x, torch.zeros(6, 24), row)
    _check_signatures(recording.calls)
    calls = dict(recording.calls)
    assert calls['hn_f32_se3_jacobian_fwd'][1] is not None
    assert calls['hn_f32_stream_encode'][3] is not None
    assert calls['hn_f32_stream_enc_bwd'][3] is not None


@torch.no_grad()
@pytest.mark.parametrize('config', ['plane', 'plane_anneal',
                                    'plane_anneal_se3',
                                    'the Nerfies plane template alone'])
def test_gate_admits_the_plane_tables(config, recording):
    """The plane cases this file refused before sub-item 3's second half:
    both levels of ``plane`` (code 3), ``plane_anneal`` (6) and
    ``plane_anneal_se3`` (7) pass the float32 gates, their fp32 blobs the
    compiled plane table of their code; the Nerfies plane template alone
    runs as on the card with its 8 hyper coordinates and its window row."""
    if config.startswith('the '):
        tmpl = flagship_model('cpu', config='plane_anneal',
                              **F32).template_of('fine')
        with as_on_the_card():
            K_mlp.fused_template(tmpl, torch.zeros(16, 16),
                                 torch.zeros(2, K_mlp.cond_width(tmpl)),
                                 K_mlp.template_scales(tmpl, *ALPHAS))
        _check_signatures(recording.calls)
        name, a = recording.calls[-1]
        assert name == 'hn_f32_template_fwd' and a[1:3] == (16, 8)
        assert a[5] is not None
        return
    model = flagship_model('cpu', config=config, **F32)
    for level_name in ('coarse', 'fine'):
        level = model.level(level_name)
        _check_covered(level)
        K_mlp.check_f32_covered(level)
        f32.check_layout(pack_level_f32(level)[2],
                         warp=K_level.level_table(level))
        assert common.TABLE_CODES[K_level.level_table(level)] == {
            'plane': 3, 'plane_anneal': 6, 'plane_anneal_se3': 7}[config]


# ---------------------------------------------------------------------------
# The launches and the sources.


@torch.no_grad()
@pytest.mark.parametrize('name', ['anneal', 'anneal_se3', 'nerf_embed',
                                  'no_viewdirs'])
def test_level_launches_match_the_c_signatures(probes, recording, name):
    """Row 1 and its backward (A, B) as on the card: ``hn_f32_level_fwd``
    takes the rgb condition's width, the template's window row where the
    layout is Nerfies (the trunk's too with a screw warp) and the alpha
    condition's two pointers where there is one; kernel A encodes the
    Nerfies layout without the hyper coordinates' identity, over 4 bands,
    times the window row, into a 96-column stash, and runs its alpha step
    (then a reduce into the condition columns' dW) once a chunk; every
    call has its signature's arguments, the stream last; each wrapper
    counts one launch a call."""
    level = probes[name].level('fine')
    nerfies = K_mlp.layout(level) == 'nerfies'
    rays, samples = 3, 8
    args = _rays(rays, samples, cond=K_mlp.cond_width(level))
    alpha = _alpha(level, rays)
    row = K_mlp.template_scales(level, *ALPHAS)
    wrow = (None if level.warp.kind == 'translation'
            else K_se3.se3_encoding_scales(level.warp, 3.5))
    wrappers = (f32.fused_level_f32, f32.fused_template_bwd_f32,
                f32.fused_fields_bwd_f32)
    counts = [fn.launches for fn in wrappers]
    with as_on_the_card():
        _, raw_t = K_level._launch_forward(
            level, *args, want_raw_t=True, warp_scales=wrow,
            tmpl_scales=row, alpha_cond=alpha)
        fwd = recording.calls[-1]
        dx_t, d_cond, grads, d_alpha = K_mlp.fused_template_bwd(
            level, raw_t, args[4], torch.zeros(rays * samples, 4), row,
            alpha)
        K_level.fused_fields_bwd(level, *args[:4], dx_t, wrow)
    assert [fn.launches - c for fn, c in zip(wrappers, counts)] == [1, 1, 1]
    _check_signatures(recording.calls)
    name_, a = fwd
    assert name_ == 'hn_f32_level_fwd' and a[5] == K_mlp.cond_width(level)
    assert a[8] == common.WARP_CODES[level.warp.kind]
    assert (a[9] is None) == (wrow is None)
    assert (a[10] is None) != nerfies
    assert (a[11] is None) == (a[12] is None) == (alpha is None)
    assert (d_alpha is None) == (alpha is None)
    assert d_cond.shape == (rays, K_mlp.cond_width(level))
    assert len(grads) == 32 and grads[20].shape == (
        1, 128 + (0 if alpha is None else 8))
    names = [n for n, _ in recording.calls]
    enc = [a for n, a in recording.calls if n == 'hn_f32_tmpl_encode'][0]
    vjp = [a for n, a in recording.calls if n == 'hn_f32_tmpl_posenc_bwd']
    assert enc[2:5] == ((10, 4, 4) if nerfies else (10, 4, 6))
    assert enc[7] == (96 if nerfies else 128)
    assert enc[9] == int(not nerfies) == vjp[0][10]
    assert (enc[10] is None) != nerfies and (vjp[0][11] is None) != nerfies
    # Kernel A's one chunk: a reduce of dW and one of db after each layer's
    # dW pass and, with the alpha condition, its step and a reduce.
    steps = names[names.index('hn_f32_tmpl_encode'):
                  names.index('hn_f32_tmpl_posenc_bwd') + 1]
    n_alpha = steps.count('hn_f32_alpha_cond_bwd')
    assert n_alpha == (0 if alpha is None else 1)
    assert steps.count('hn_f32_reduce') == 2 * 16 + n_alpha
    if alpha is not None:
        at = steps.index('hn_f32_alpha_cond_bwd')
        assert steps[at + 1] == 'hn_f32_reduce'


@torch.no_grad()
def test_module_launches_match_the_c_signatures(probes, recording):
    """Row 8 (Nerfies with its window row; 47 + 8 conditions; S = 1), and
    rows 10 and 11 with a window row, as on the card: the window row's and
    the alpha condition's pointers where they belong."""
    wrappers = (f32.fused_template_f32, f32.fused_field_f32,
                f32.fused_field_bwd_f32)
    counts = [fn.launches for fn in wrappers]
    with as_on_the_card():
        for name, rows, per in (('anneal', 24, 8), ('nerf_embed', 5, 1)):
            tmpl = probes[name].template_of('coarse')
            row = K_mlp.template_scales(tmpl, *ALPHAS)
            alpha = _alpha(tmpl, rows // per)
            out = K_mlp.fused_template(
                tmpl, torch.zeros(rows, 8),
                torch.zeros(rows // per, K_mlp.cond_width(tmpl)), row, alpha)
            assert out.shape == (rows, 4)
            n, a = recording.calls[-1]
            assert n == 'hn_f32_template_fwd'
            assert (a[2], a[4]) == (4, K_mlp.cond_width(tmpl))
            assert (a[5] is None) == (row is None)
            assert (a[6] is None) == (a[7] is None) == (alpha is None)
            assert a[-3:-1] == (rows, per)
        model = probes['nerf_embed']
        for field, freq, alpha in (('warp_field', 10, 4.5),
                                   ('hyper_sheet_mlp', 7, 3.5)):
            mlp = getattr(model, field).mlp
            row = K_field.encoding_scales(freq, 8, alpha)
            x = torch.zeros(9, 11)
            K_field.fused_field(mlp, freq, x, row)
            n, a = recording.calls[-1]
            assert n == 'hn_f32_field_fwd' and a[2] is not None
            del recording.calls[:]
            K_field.fused_field_bwd(mlp, freq, x, torch.zeros(9, 8), row)
            enc = [a for n, a in recording.calls
                   if n in ('hn_f32_tmpl_encode', 'hn_f32_tmpl_posenc_bwd')]
            assert len(enc) == 2 and all(a[-2] is not None for a in enc)
            assert enc[0][7] == (80 if freq == 10 else 64)
    _check_signatures(recording.calls)
    assert [fn.launches - c for fn, c in zip(wrappers, counts)] == [2, 2, 2]


def test_new_arguments_in_the_sources():
    """The changed entry points take what ``build._SIGNATURES`` declares
    (argument counts read from the C declarations, the stream last); the
    layout, the window row and the conditions are run-time arguments of
    the existing kernels (no new kernel, instantiation or source: the
    level forward's four kernels, the level's shared memory unchanged);
    the alpha step's static shared memory within 48 KB; kernel A's Nerfies
    stash of 96 encoding columns."""
    level, steps = _source('f32_level.cu'), _source('f32_steps.cu')
    for src, names in ((level, ('hn_f32_level_fwd', 'hn_f32_template_fwd',
                                'hn_f32_field_fwd')),
                       (steps, ('hn_f32_tmpl_encode',
                                'hn_f32_tmpl_posenc_bwd',
                                'hn_f32_alpha_cond_bwd'))):
        for name in names:
            decl = re.search(r'extern "C" int ' + name + r'\(([^)]*)\)', src)
            params = decl.group(1).split(',')
            assert len(params) == len(build._SIGNATURES[name][0]), name
            assert 'cudaStream_t' in params[-1]
    assert len(re.findall(r'__global__ void', level)) == 4
    assert 'encode_template(s, hyper, a.tmpl_scales, c.xf);' in level
    assert 'encode_template(s, a.hyper, a.scales, c.xf);' in level
    assert level.count('template_stage(a.net, s, a.cond, a.cond_w, a.alpha, '
                       'a.alpha_w);') == 2
    assert f32.LEVEL_SMEM_BYTES == 201984
    assert 'constexpr int kMaxAlpha = 8;' in steps
    assert '__shared__ float part[kMaxAlpha][kThreads];' in steps
    assert 4 * 8 * f32.THREADS <= 48 * 1024
    sp = f32.template_stash(4, nerfies=True)
    assert sp.widths['enc'] == 96 and sp.width == 3088
    assert all(c % 4 == 0 for c in sp.col.values())
    assert f32.template_stash(4).width == 3120
    assert 4 * sp.width * f32.chunk_rows(sp) <= f32.STASH_BYTES


# ---------------------------------------------------------------------------
# The steps through the PyTorch model of each C entry point.


@torch.no_grad()
@pytest.mark.parametrize('name,rays,samples,max_rows,sms', [
    ('anneal', 7, 13, 40, 2), ('anneal_embed', 3, 29, 1000, 400),
    ('nerf_embed', 12, 24, 120, 2), ('embed_only', 2, 64, 64, 2),
    ('no_viewdirs', 5, 16, 48, 2)])
def test_kernel_a_steps_match_the_plain_backward(probes, name, rays, samples,
                                                 max_rows, sms):
    """Kernel A's float32 steps (``f32.template_bwd_steps``) with the
    Nerfies layout's window row (xyz and hyper windows both partly on) and
    the conditions' widths, the alpha condition's step included, through
    ``TorchF32Ops`` at full width (several chunks of whole rays, ragged row
    ranges) give the plain backward's dx_t, d rgb_cond, d alpha_cond and
    every dW / db: relative L2 1e-5."""
    level = probes[name].level('fine')
    args = _rays(rays, samples, cond=K_mlp.cond_width(level), seed=rays)
    alpha = _alpha(level, rays, seed=samples)
    row = K_mlp.template_scales(level, *ALPHAS)
    _, raw_t = fused_level_plain(level, *args, return_raw_t=True,
                                 tmpl_scales=row, alpha_cond=alpha)
    g = torch.from_numpy(np.random.RandomState(samples).randn(
        rays * samples, 4).astype(np.float32))
    layers = K_mlp.kernel_template_layers(level.template)
    w_blob, b_blob, shapes = common.pack_layers(level.template, layers,
                                                dtype=torch.float32)
    wt_blob = common.pack_layers(level.template, layers, transposed=True,
                                 dtype=torch.float32)[0]
    w, wt, b, w_off, b_off, n = K_mlp.layer_views(w_blob, wt_blob, b_blob,
                                                  shapes)
    kernel_alpha = None
    if alpha is not None:
        n += K_mlp.ALPHA_TAIL
        kernel_alpha = (alpha, K_mlp.alpha_cond_weight(level.template,
                                                       torch.float32))
    dx_t, d_cond, grads, d_alpha = f32.template_bwd_steps(
        TorchF32Ops(sms), w, wt, b, w_off, b_off, n, raw_t, args[4], samples,
        g, max_rows, scales=K_mlp.kernel_scales(level, row, g.device),
        alpha=kernel_alpha)
    n_w = sum(a * c for a, c in shapes)
    got = [dx_t, d_cond] + K_mlp.unpack_template_grads(
        grads, layers, shapes, n_w, alpha is not None)
    want = K_mlp.fused_template_bwd_plain(level, raw_t, args[4], g, row,
                                          alpha)
    want_all = [want[0], want[1], *want[2]]
    if alpha is not None:
        got.append(d_alpha)
        want_all.append(want[3])
    errs = [_rel(a, c) for a, c in zip(got, want_all)]
    assert len(errs) == 34 + (alpha is not None) and max(errs) <= TOL, errs


@torch.no_grad()
@pytest.mark.parametrize('field,alpha,rows,max_rows,sms', [
    ('warp_field', 4.5, 300, 64, 2), ('warp_field', 0.5, 97, 1000, 400),
    ('hyper_sheet_mlp', 3.5, 130, 50, 2)])
def test_windowed_field_steps_match_the_plain_backward(probes, field, alpha,
                                                       rows, max_rows, sms):
    """A field alone backward's float32 steps (``f32.field_bwd_steps``)
    with a window row through ``TorchF32Ops`` at full width (ragged chunks
    and row ranges) give the plain windowed backward's dx_raw and every dW
    / db: relative L2 1e-5."""
    f = getattr(probes['nerf_embed'], field)  # the flagship's fields
    row = K_field.encoding_scales(f.n_freq, 8, alpha)
    layers = K_field.field_layers(f.mlp)
    w_blob, b_blob, shapes = common.pack_layers(f.mlp, layers,
                                                dtype=torch.float32)
    wt_blob = common.pack_layers(f.mlp, layers, transposed=True,
                                 dtype=torch.float32)[0]
    rs = np.random.RandomState(rows)
    x = torch.from_numpy(np.concatenate(
        [rs.randn(rows, 3) * 0.5, rs.randn(rows, 8) * 0.1], 1).astype(
            np.float32))
    g = torch.from_numpy(rs.randn(rows, f.mlp.logit.out_features).astype(
        np.float32))
    w, wt, b, w_off, b_off, n = K_mlp.layer_views(w_blob, wt_blob, b_blob,
                                                  shapes)
    dx, grads = f32.field_bwd_steps(
        TorchF32Ops(sms), w, wt, b, w_off, b_off, n, f.n_freq, x, g,
        max_rows, scales=common.padded_scales(row, row.shape[0],
                                              shapes[0][1], row.device))
    n_w = sum(a * c for a, c in shapes)
    got = [dx] + common.unpack_grads(grads[:n_w], grads[n_w:], layers,
                                     shapes)
    want_dx, want_grads = K_field.fused_field_bwd_plain(f.mlp, f.n_freq, x,
                                                        g, row)
    errs = [_rel(a, c) for a, c in zip(got, [want_dx, *want_grads])]
    assert len(errs) == 15 and max(errs) <= TOL, errs


# ---------------------------------------------------------------------------
# The models against the JAX model at float32.


# The small flagship of the model tests with the Nerfies encoding
# (``tests/test_torch_anneal.py``'s): xyz over degrees 0..4 with identity,
# hyper over 0..2, viewdirs over 0..2.
NARROW_NERFIES = dict(use_original_embed=False, spatial_point_max_deg=4,
                      hyper_point_max_deg=2, viewdir_max_deg=2)
MODELS = {'anneal': NARROW_NERFIES,
          'anneal_se3': dict(warp_field_type='se3', **NARROW_NERFIES),
          'nerf_embed': EMBED,
          'no_viewdirs': dict(use_viewdirs=False)}
EXTRA = {'nerf_alpha': 3.5, 'warp_alpha': 3.5, 'hyper_alpha': 1.4,
         'hyper_sheet_alpha': 1.4}


@pytest.fixture(scope='module')
def models():
    """{name: (port model, JAX model, flax params, JAX outputs, JAX
    gradients)} at narrow widths in float32, the warp and sheet heads
    scaled up so that both fields move the output; the JAX render and the
    loss's gradient jitted, once per configuration."""
    out = {}
    rays, rgbs = _batch()
    for name, over in MODELS.items():
        cfg = {**ARCH, **over}
        jmodel = JaxNerfModel(JaxNerfConfig(use_pallas=False, **cfg))
        params = jax.device_get(jax.jit(jmodel.init)(
            {'params': jax.random.PRNGKey(5)},
            jax_ray_dict(jnp.asarray(rays)))['params'])
        params = jax.tree.map(np.array, params)
        if 'w_net' in params['warp_field']:
            for head in ('w_net', 'v_net'):
                params['warp_field'][head]['logit']['kernel'] *= 1e3
        else:
            params['warp_field']['mlp']['logit']['kernel'] *= 300.0
        params['hyper_sheet_mlp']['mlp']['logit']['kernel'] *= 1e4
        jextra = {k: jnp.float32(v) for k, v in EXTRA.items()}

        def loss(p, jmodel=jmodel, jextra=jextra):
            res = jmodel.apply({'params': p}, jax_ray_dict(jnp.asarray(rays)),
                               jextra, deterministic=True)
            return jax_mse_loss(res, jnp.asarray(rgbs)), res

        (_, want), grads = jax.device_get(jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params))
        model = NerfModel(port_configs.NerfConfig(**cfg))
        model.load_state_dict(params_from_jax(params))
        assert model.config.compute_dtype == 'float32'
        out[name] = (model, want, params_from_jax(grads))
    return out


@pytest.mark.parametrize('branch', ['level_kernel', 'per_module'])
@pytest.mark.parametrize('name', list(MODELS))
def test_float32_models_match_jax(models, name, branch):
    """A deterministic render's per-ray outputs of both levels at the
    alphas mid-ramp, relative L2 1e-5, and the loss's gradient against the
    JAX model at float32: relative L2 1e-5 over all parameters, each
    parameter's max|d| 1e-4 of its largest entry; on the level kernel's
    branch (one plain level call per level) and on the per-module branch
    (``return_points``: the fields, then the template alone)."""
    model, want, jgrads = models[name]
    rays, rgbs = _batch()
    calls = fused_level_plain.calls
    model.zero_grad(set_to_none=True)
    got = model(prepare_ray_dict(torch.from_numpy(rays)), deterministic=True,
                extra_params=EXTRA, return_points=branch == 'per_module')
    assert fused_level_plain.calls - calls == (2 if branch == 'level_kernel'
                                               else 0)
    for level in want:
        for k in ('rgb', 'depth', 'acc'):
            assert _rel(got[level][k].detach(), want[level][k]) <= TOL, \
                (level, k)
    mse_loss(got, torch.from_numpy(rgbs)).backward()
    mine, theirs = [], []
    for pname, p in model.named_parameters():
        want_g = torch.as_tensor(np.asarray(jgrads[pname]))
        g = torch.zeros_like(want_g) if p.grad is None else p.grad
        assert (g - want_g).abs().max() <= \
            10 * TOL * want_g.abs().max().clamp_min(1e-30), pname
        mine.append(g.reshape(-1))
        theirs.append(want_g.reshape(-1))
    assert _rel(torch.cat(mine), torch.cat(theirs)) <= TOL


# ---------------------------------------------------------------------------
# The stored JAX numbers.


def _window_rows(level, case, dtype):
    """(the trunk's window row or None, the template's) of a level case at
    its alphas, in ``dtype``."""
    ep = f32_nerfies_extra(case)
    tmpl = K_mlp.template_scales(level, ep.get('nerf_alpha'),
                                 ep.get('hyper_alpha'))
    warp = (None if level.warp.kind == 'translation'
            else K_se3.se3_encoding_scales(level.warp, ep['warp_alpha']))
    return tuple(None if t is None else t.to(dtype) for t in (warp, tmpl))


def _plain_level(case, arrays, dtype, raw_t=None):
    """(out, raw_t, {'d_<input>', 'dw<l>', 'db<l>'}) of the plain level at
    ``dtype`` for a stored level case; the backward from ``raw_t`` where
    given (else the forward's)."""
    level = f32_nerfies_model(case).to(dtype).level(
        F32_NERFIES_LEVEL_CASES[case][2])
    ws, ts = _window_rows(level, case, dtype)
    args = [torch.from_numpy(arrays[k]).to(dtype) for k in LEVEL_INPUTS]
    alpha = (torch.from_numpy(arrays['alpha_cond']).to(dtype)
             if 'alpha_cond' in arrays else None)
    with torch.no_grad():
        out, fwd_raw = fused_level_plain(level, *args, return_raw_t=True,
                                         warp_scales=ws, tmpl_scales=ts,
                                         alpha_cond=alpha)
        raw_t = fwd_raw if raw_t is None else raw_t.to(dtype)
        dx_t, d_cond, t_grads, d_alpha = K_mlp.fused_template_bwd_plain(
            level, raw_t, args[4], torch.from_numpy(
                arrays['cotangent']).to(dtype), ts, alpha)
        *rays, f_grads = fused_fields_bwd_plain(level, *args[:4], dx_t, ws)
    got = dict(zip(('d_z_vals', 'd_origins', 'd_directions', 'd_embed'),
                   rays))
    got['d_rgb_cond'] = d_cond
    if d_alpha is not None:
        got['d_alpha_cond'] = d_alpha
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
def test_stored_float32_nerfies_reference():
    """tests/data/fused_f32_nerfies_jax_ref.npz, what ``chip_smoke.py``
    phase 36 holds rows 1, 5, 8, 9, 10 and 11 to: its inputs redrawn from
    their seeds, its ``template_anneal_embed`` case (the Nerfies layout,
    35 + 8 conditions) recomputed from the JAX template kernel at float32
    in interpret mode, and the plain float32 versions held to every case
    (the module docstring's rule; the level's floor measured here in
    float64)."""
    ref = read_f32_nerfies_reference()
    cases = (*F32_NERFIES_LEVEL_CASES, *F32_NERFIES_TEMPLATE_CASES,
             *F32_NERFIES_FIELD_CASES)
    assert sorted(ref) == sorted(cases)
    for case in cases:
        for k, v in f32_nerfies_probe_inputs(case).items():
            np.testing.assert_array_equal(ref[case][k], v, err_msg=case)
        keep = {int(k[2:]) for k in ref[case] if k.startswith('dw')}
        assert keep == set(f32_nerfies_grad_layers(case)), case
    case = 'template_anneal_embed'
    again = make_level_reference.f32_nerfies_case(case)
    for k, v in ref[case].items():
        if k in again:
            assert _rel(again[k], v) <= 1e-6, k
    for case, (_, _, level, *_) in F32_NERFIES_TEMPLATE_CASES.items():
        arrays = ref[case]
        tmpl = f32_nerfies_model(case).template_of(level)
        ep = f32_nerfies_extra(case)
        row = K_mlp.template_scales(tmpl, ep.get('nerf_alpha'),
                                    ep.get('hyper_alpha'))
        x, cond = (torch.from_numpy(arrays[k]) for k in ('x_raw', 'rgb_cond'))
        alpha = (torch.from_numpy(arrays['alpha_cond'])
                 if 'alpha_cond' in arrays else None)
        out = K_mlp.fused_template_plain(tmpl, x, cond, row, alpha)
        assert np.abs(out.numpy() - arrays['out']).max() <= \
            1e-4 * np.abs(arrays['out']).max(), case
        dx, d_cond, grads, d_alpha = K_mlp.fused_template_bwd_plain(
            tmpl, x, cond, torch.from_numpy(arrays['cotangent']), row, alpha)
        got = {'dx': dx, 'd_rgb_cond': d_cond, 'd_alpha_cond': d_alpha}
        for l, (dw, db) in enumerate(zip(*[iter(grads)] * 2)):
            got.update({f'dw{l}': dw, f'db{l}': db})
        assert _hold_grads(got, arrays, lambda k: 1e-4) == 2 + (
            alpha is not None) + len(f32_nerfies_grad_layers(case)) + 16, \
            case
    for case, (_, _, module, _, alpha, _) in F32_NERFIES_FIELD_CASES.items():
        arrays = ref[case]
        f = getattr(f32_nerfies_model(case), module)
        row = K_field.encoding_scales(f.n_freq, 8, alpha)
        x = torch.from_numpy(arrays['x_raw'])
        out = K_field.fused_field_plain(f.mlp, f.n_freq, x, row)
        assert np.abs(out.numpy() - arrays['out']).max() <= \
            1e-4 * np.abs(arrays['out']).max(), case
        dx, grads = K_field.fused_field_bwd_plain(
            f.mlp, f.n_freq, x, torch.from_numpy(arrays['cotangent']), row)
        got = {'dx': dx}
        for l, (dw, db) in enumerate(zip(*[iter(grads)] * 2)):
            got.update({f'dw{l}': dw, f'db{l}': db})
        assert _hold_grads(got, arrays, lambda k: 1e-4) == 15, case
    for case in F32_NERFIES_LEVEL_CASES:
        arrays = ref[case]
        out, raw_t, got = _plain_level(case, arrays, torch.float32)
        assert np.abs(out.numpy() - arrays['out']).max() <= \
            1e-4 * np.abs(arrays['out']).max(), case
        exact = _plain_level(case, arrays, torch.float64)[2]
        rounded = _plain_level(case, arrays, torch.float64, raw_t)[2]
        floor = {k: np.linalg.norm(rounded[k] - v) / max(np.linalg.norm(v),
                                                          1e-30)
                 for k, v in exact.items()}
        n = _hold_grads(got, arrays,
                        lambda k: min(1e-2 + 2 * floor[k], 5e-2))
        assert n == 5 + ('alpha_cond' in arrays) + len(
            f32_nerfies_grad_layers(case)) + (32 if 'se3' in case else 30)
