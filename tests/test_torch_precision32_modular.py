"""``--precision 32`` on the per-module path (ROADMAP A.13.1 sub-item 1): the
float32 template alone (row 8), a field alone (row 10), a field alone
backward (row 11) and kernel A at the static template's width, checked on
the CPU.

- The gate: a float32 template with 4 hyper coordinates or none and either
  float32 field are admitted; so are, since sub-item 3's first half, the
  template alone in the Nerfies layout or with the conditions' widths and
  a field alone backward with a window row, which run as on the card
  through their float32 entry points (refused before; their steps and
  numbers are ``tests/test_torch_precision32_nerfies.py``'s), and since
  sub-item 3's second half the template alone in the plane layouts (raw
  rows of 16 columns; its numbers are
  ``tests/test_torch_precision32_plane.py``'s), and since sub-item 4 the
  per-module path's elastic loss (the translation Jacobian, rows 14 and
  15, on ``split_glo``; its numbers are
  ``tests/test_torch_precision32_jacobian.py``'s); a Jacobian of other bands
  raises NotImplementedError naming A.13 before any library is needed (the
  screw warps' trunk, ``split_glo`` with them included, is admitted:
  ``tests/test_torch_precision32_screw.py``).
- The launches: each wrapper, run as on the card against a recording
  library, passes its C entry point (``hn_f32_template_fwd``,
  ``hn_f32_field_fwd``, the steps of ``f32_steps.cu``) as many arguments of
  the kinds ``build``'s ctypes signature declares, and counts one launch a
  call; the entries and the new kernels' shared memory read from the
  sources.
- The steps of a field alone backward and of kernel A at the static width
  (``f32.field_bwd_steps``, ``f32.template_bwd_steps(hyper=0)``) through
  ``tests/test_torch_precision32.py``'s PyTorch model of each C entry point,
  at full width, several chunks of ragged rows, against the plain backward:
  relative L2 1e-5 (float32 both ways, other summation orders).
- The port's float32 ``static`` and ``split_glo`` models, and ``query_sigma``
  and ``return_points`` with a ``hyper_point`` override on the flagship, at
  narrow widths, against the JAX model at ``compute_dtype='float32'`` on the
  same weights (``convert.params_from_jax``) and rays: outputs and the
  loss's gradients relative L2 1e-5.
- ``tests/data/fused_f32_modular_jax_ref.npz``
  (``tools/make_level_reference.py --only f32_modular``): its sheet case
  recomputed, and the plain float32 versions held to every case at full
  width: outputs 1e-4 of the largest entry, gradients relative L2 1e-2 and
  5e-2 of the largest entry (the float32 rule of
  ``tests/test_torch_precision32.py``: the static template's inputs hold
  ReLU pre-activations of 1e-8, one of which falls on the other side in one
  of the two sums; measured here 5.0e-3 and 2.6e-2 at worst).

One torch thread. About 25 s alone on one worker.
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
from hypernerf_tpu.training.losses import mse_loss as jax_mse_loss
from hypernerf_tpu_torch import configs as port_configs
from hypernerf_tpu_torch.convert import params_from_jax
from hypernerf_tpu_torch.flagship import (F32_MODULAR_CASES, flagship_model,
                                          load_probe_weights,
                                          modular_probe_inputs,
                                          read_f32_modular_reference)
from hypernerf_tpu_torch.kernels import build, common, f32
from hypernerf_tpu_torch.kernels import fused_mlp as K_mlp
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.training.losses import mse_loss
from tests.test_torch_modular_model import _flax_params, _ray_dicts
from tests.test_torch_precision32 import (TorchF32Ops, _RecordingLibrary,
                                          _source, as_on_the_card)
from tests.test_torch_train_step import ARCH, _batch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'tools'))
import make_level_reference  # noqa: E402

K_field = importlib.import_module('hypernerf_tpu_torch.kernels.fused_field')
K_jac = importlib.import_module('hypernerf_tpu_torch.kernels.fused_jacobian')
F32 = dict(compute_dtype='float32')
TOL = 1e-5
CONFIGS = {'flagship': {},
           'static': dict(use_warp=False, hyper_slice_method='none'),
           'split_glo': dict(share_glo=False)}


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
    """The probe-weight models at float32, full width: the flagship and
    static."""
    return {c: load_probe_weights(flagship_model('cpu', config=c, **F32))
            for c in ('flagship', 'static')}


def _x_field(rows, seed):
    rs = np.random.RandomState(seed)
    return torch.from_numpy(np.concatenate(
        [rs.randn(rows, 3) * 0.5, rs.randn(rows, 8) * 0.1], 1).astype(
            np.float32))


def _x_template(rows, hyper, seed):
    rs = np.random.RandomState(seed)
    x = np.zeros((rows, common.RAW_PAD), np.float32)
    x[:, :3] = rs.randn(rows, 3) * 0.5
    x[:, 3:3 + hyper] = rs.randn(rows, hyper) * 0.3
    return torch.from_numpy(x)


# ---------------------------------------------------------------------------
# The gate.


def test_gate_admits_the_per_module_path(probes):
    """The static template (no hyper coordinates) and the flagship's
    (4) pass the float32 template gate; both pack to the compiled table's
    template rows, the static one with zero weight columns where the hyper
    bands would be; the split_glo model's fields are float32 at the two
    compiled bands."""
    for config, hyper in (('flagship', 4), ('static', 0)):
        tmpl = probes[config].template_of('coarse')
        K_mlp.check_f32_covered(tmpl)
        K_mlp.check_covered(tmpl)  # float32 goes to check_f32_covered
        assert K_mlp.n_hyper(tmpl) == hyper
        w, _, shapes = common.pack_layers(
            tmpl.template, K_mlp.kernel_template_layers(tmpl.template),
            dtype=torch.float32)
        assert shapes[0] == (256, 128) and shapes[5] == (256, 384)
        if not hyper:
            assert not w[:256 * 128].view(256, 128)[:, 63:].any()
    split = flagship_model('cpu', config='split_glo', **F32)
    for field in (split.warp_field, split.hyper_sheet_mlp):
        assert field.mlp.dtype == torch.float32 and field.n_freq in f32.FIELDS


def _refusals():
    """(label, call that must raise)."""
    x11 = torch.zeros(4, 11)
    return [
        ('rows 14, 15 of other bands (A.13)',
         lambda: K_jac._launch_args(flagship_model(
             'cpu', warp_freq=8, **F32).warp_field.mlp, 8, x11)),
    ]


@pytest.mark.parametrize('label,call', _refusals(),
                         ids=[r[0].split(' (')[0] for r in _refusals()])
def test_gate_refuses_what_is_left(label, call):
    """What float32 still lacks on the per-module path (A.13.1 is done:
    bands and widths other than the flagship's, A.13) raises naming ROADMAP
    A.13 and no sub-item of A.13.1, and nothing falls back to a plain
    version."""
    with pytest.raises(NotImplementedError, match='ROADMAP item A.13') as e:
        call()
    assert 'sub-item' not in str(e.value)


@torch.no_grad()
def test_gate_admits_the_per_module_jacobian(recording):
    """The per-module path's elastic loss, refused before sub-item 4:
    ``split_glo`` with the elastic loss takes the translation warp's
    Jacobian at every sample (rows 14 and 15, float32), which runs as on
    the card through its float32 entry points, each with its signature's
    arguments, one launch of each wrapper a call."""
    mlp = flagship_model('cpu', config='split_glo', **F32).warp_field.mlp
    x = torch.zeros(5, 11)
    counts = [f32.fused_jacobian_f32.launches,
              f32.fused_jacobian_bwd_f32.launches]
    with as_on_the_card():
        jac = K_jac.fused_warp_jacobian(mlp, 10, x[:, :3], x[:, 3:])
        K_jac.fused_jacobian_bwd(mlp, 10, x, torch.zeros(5, 9))
    assert jac.shape == (5, 3, 3)
    _check_signatures(recording.calls)
    names = [n for n, _ in recording.calls]
    assert names[0] == 'hn_f32_jacobian_fwd'
    assert names[-1] == 'hn_f32_stream_enc_bwd'
    assert [f32.fused_jacobian_f32.launches,
            f32.fused_jacobian_bwd_f32.launches] == [c + 1 for c in counts]


def _admissions():
    """(label, call run as on the card, the float32 entry point it must
    reach): the per-module rows sub-item 3 ported (its first half's, then
    the template alone in the plane layouts), each refused before."""
    x11 = torch.zeros(4, 11)

    def template_alone(config, **over):
        def call():
            tmpl = flagship_model('cpu', config=config, **over,
                                  **F32).template_of('fine')
            x = torch.zeros(16, K_mlp.raw_pad(tmpl))
            cond = torch.zeros(2, K_mlp.cond_width(tmpl))
            alpha = (torch.zeros(2, 8) if K_mlp.alpha_cond_width(tmpl)
                     else None)
            K_mlp.fused_template(tmpl, x, cond, alpha_cond=alpha)
            K_mlp.fused_template_bwd(tmpl, x, cond, torch.zeros(16, 4),
                                     alpha_cond=alpha)
        return call

    def windowed_field():
        mlp = flagship_model('cpu', config='split_glo', **F32).warp_field.mlp
        K_field.fused_field_bwd(mlp, 10, x11, torch.zeros(4, 8),
                                torch.ones(71))

    return [
        ('anneal template alone', template_alone('anneal'),
         'hn_f32_template_fwd'),
        ('nerf_embed template alone (47 + 8 conditions)',
         template_alone('nerf_embed'), 'hn_f32_alpha_cond_bwd'),
        ('a 0-column condition', template_alone('flagship',
                                                use_viewdirs=False),
         'hn_f32_template_fwd'),
        ('a field alone backward with a window row', windowed_field,
         'hn_f32_tmpl_posenc_bwd'),
        ('plane return_points (its template)', template_alone('plane'),
         'hn_f32_template_fwd'),
        ('plane_anneal template alone (the Nerfies plane layout)',
         template_alone('plane_anneal'), 'hn_f32_template_fwd'),
    ]


@torch.no_grad()
@pytest.mark.parametrize('label,call,entry', _admissions(),
                         ids=[r[0].split(' (')[0] for r in _admissions()])
def test_gate_admits_what_sub_item_3_ported(label, call, entry, recording):
    """The per-module rows sub-item 3 ported (the template alone in the
    Nerfies layout or with the conditions' widths, a field alone backward
    with a window row, the template alone in the plane layouts) run as on
    the card: their float32
    entry points, each with its signature's arguments, the entry named
    reached, the window row's pointer given where there is one."""
    with as_on_the_card():
        call()
    _check_signatures(recording.calls)
    names = [n for n, _ in recording.calls]
    assert entry in names and all(n.startswith('hn_f32_') for n in names)
    windows = [a[-2] for n, a in recording.calls
               if n in ('hn_f32_tmpl_encode', 'hn_f32_tmpl_posenc_bwd')]
    want = 'anneal' in label or 'window' in label
    assert windows and all((w is not None) == want for w in windows)


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


def _check_signatures(calls):
    ints = (build._I, build._L)
    for name, call_args in calls:
        argtypes = build._SIGNATURES[name][0]
        assert len(call_args) == len(argtypes), name
        for i, (a, kind) in enumerate(zip(call_args, argtypes)):
            if kind in ints:
                assert isinstance(a, int) and not isinstance(a, bool), \
                    (name, i)
            else:
                assert a is None or isinstance(a, int), (name, i)
        assert call_args[-1] == 7, name  # the stream


@torch.no_grad()
def test_launches_match_the_c_signatures(probes, recording):
    """Rows 8 (flagship and static, S = 8 and S = 1), 10 and 11 (warp and
    sheet) and kernel A at the static width, as on the card: every C call
    has its signature's arguments, the stream last; the template alone
    takes the hyper count (4 or 0) and the rows per condition row, a field
    its index (0 warp, 1 sheet); each wrapper counts one launch a call."""
    lib = recording
    wrappers = (f32.fused_template_f32, f32.fused_field_f32,
                f32.fused_field_bwd_f32, f32.fused_template_bwd_f32)
    counts = [fn.launches for fn in wrappers]
    with as_on_the_card():
        for config, hyper in (('flagship', 4), ('static', 0)):
            tmpl = probes[config].template_of('coarse')
            for rows, per in ((24, 8), (5, 1)):
                out = K_mlp.fused_template(
                    tmpl, _x_template(rows, hyper, 0),
                    torch.zeros(rows // per, 39))
                assert out.shape == (rows, 4)
                name, args = lib.calls[-1]
                assert name == 'hn_f32_template_fwd'
                assert (args[1], args[2], args[4]) == (8, hyper, 39)
                assert args[-3:-1] == (rows, per)
        K_mlp.fused_template_bwd(probes['static'].template_of('coarse'),
                                 _x_template(16, 0, 1), torch.zeros(2, 39),
                                 torch.zeros(16, 4))
        for which, field in enumerate(('warp_field', 'hyper_sheet_mlp')):
            f = getattr(probes['flagship'], field)
            out = K_field.fused_field(f.mlp, f.n_freq, _x_field(9, 2))
            assert out.shape == (9, f.mlp.logit.out_features)
            name, args = lib.calls[-1]
            assert name == 'hn_f32_field_fwd' and args[0] == which
            assert args[-2] == 9
            K_field.fused_field_bwd(f.mlp, f.n_freq, _x_field(9, 2),
                                    torch.zeros(9, 8))
    assert [fn.launches - c for fn, c in zip(wrappers, counts)] == [4, 2, 2,
                                                                   1]
    _check_signatures(lib.calls)
    names = [n for n, _ in lib.calls]
    # Kernel A: a reduce of dW and one of db after each layer's dW; each
    # field alone backward the same over its 7 layers.
    assert names.count('hn_f32_reduce') == 2 * 16 + 2 * 2 * 7
    # The static template's encoding: no hyper columns, 64 stash columns.
    enc = [a for n, a in lib.calls if n == 'hn_f32_tmpl_encode']
    assert (enc[0][3], enc[0][7]) == (0, 64)
    # A field alone: the template's encoding step with 0 bands on the
    # embedding, its VJP the same way.
    assert [(a[2], a[3], a[4]) for a in enc[1:]] == [(10, 8, 0), (7, 8, 0)]


def test_new_kernels_in_the_sources():
    """The two new entry points of csrc/f32_level.cu take what
    ``build._SIGNATURES`` declares (argument counts read from the C
    declarations, the stream last); the template alone launches with the
    level forward's dynamic shared memory and a field alone with its
    narrower one, both under ``f32.SMEM_LIMIT``; the hyper count is a
    run-time argument, not an instantiation; dw's grid covers the packed
    columns (``ldc``), so an input narrower than them gets zero dW there."""
    level, steps = _source('f32_level.cu'), _source('f32_steps.cu')
    for name in ('hn_f32_template_fwd', 'hn_f32_field_fwd',
                 'hn_f32_level_fwd'):
        decl = re.search(r'extern "C" int ' + name + r'\(([^)]*)\)', level)
        params = decl.group(1).split(',')
        assert len(params) == len(build._SIGNATURES[name][0]), name
        assert 'cudaStream_t' in params[-1]
    assert ('template_fwd_f32<<<tiles_of(rows), kThreads, carve_bytes(c), '
            'stream>>>') in level
    assert 'allow_smem(template_fwd_f32, kPlaneSmemBytes, ready)' in level
    assert ('field_fwd_f32<<<tiles_of(rows), kThreads, kFieldSmemBytes, '
            'stream>>>') in level
    assert max(f32.LEVEL_SMEM_BYTES, f32.FIELD_SMEM_BYTES) <= f32.SMEM_LIMIT
    assert ('__global__ void __launch_bounds__(kThreads) '
            'template_fwd_f32(const TemplateArgs a)') in level
    assert 'int hyper; // hyper coordinates: 4, or 0 (static)' in level
    assert '(unsigned)((ldc + T::kCols - 1) / T::kCols)' in steps
    assert 'if (k < p.ldc) slab[' in steps


# ---------------------------------------------------------------------------
# The steps through the PyTorch model of each C entry point.


def test_static_stash_plan():
    """Kernel A's stash at the static width: 64 encoding columns (63
    encoded), the flagship's other columns, every column float4-aligned,
    chunks of whole rays within 3 GiB at S = 64 and 128."""
    sp = f32.template_stash(0)
    assert f32.template_enc(0) == 64 and f32.template_enc(4) == 128
    assert sp.widths['enc'] == 64 and sp.width == 3056
    assert sp.width == f32.TEMPLATE_STASH.width - 64
    assert all(c % 4 == 0 for c in sp.col.values())
    for samples in (64, 128):
        p = 16384 * samples
        plan = K_mlp.chunk_plan(p, samples, f32.chunk_rows(sp))
        assert plan[0][0] == 0 and plan[-1][1] == p
        assert all((r1 - r0) % samples == 0 for r0, r1 in plan)
        assert 4 * sp.width * max(r1 - r0 for r0, r1 in plan) <= 3 << 30


@torch.no_grad()
@pytest.mark.parametrize('rows,max_rows,sms', [(300, 64, 2), (97, 1000, 400)])
def test_field_bwd_steps_match_the_plain_backward(probes, rows, max_rows,
                                                  sms):
    """A field alone backward's float32 steps (``f32.field_bwd_steps``)
    through ``TorchF32Ops`` on the warp field and the sheet at full width
    (several chunks, ragged row ranges) give the plain backward's dx_raw
    and every dW / db: relative L2 1e-5."""
    for field in ('warp_field', 'hyper_sheet_mlp'):
        f = getattr(probes['flagship'], field)
        layers = K_field.field_layers(f.mlp)
        w_blob, b_blob, shapes = common.pack_layers(f.mlp, layers,
                                                    dtype=torch.float32)
        wt_blob = common.pack_layers(f.mlp, layers, transposed=True,
                                     dtype=torch.float32)[0]
        x = _x_field(rows, rows)
        g = torch.from_numpy(np.random.RandomState(rows + 1).randn(
            rows, 8).astype(np.float32))
        n_out = f.mlp.logit.out_features
        w, wt, b, w_off, b_off, n = K_mlp.layer_views(w_blob, wt_blob,
                                                      b_blob, shapes)
        dx, grads = f32.field_bwd_steps(TorchF32Ops(sms), w, wt, b, w_off,
                                        b_off, n, f.n_freq, x, g[:, :n_out],
                                        max_rows)
        n_w = sum(a * c for a, c in shapes)
        got = [dx] + common.unpack_grads(grads[:n_w], grads[n_w:], layers,
                                         shapes)
        want_dx, want_grads = K_field.fused_field_bwd_plain(f.mlp, f.n_freq,
                                                            x, g)
        errs = [_rel(a, c) for a, c in zip(got, [want_dx, *want_grads])]
        assert max(errs) <= TOL, (field, errs)


@torch.no_grad()
@pytest.mark.parametrize('rays,samples,max_rows', [(5, 13, 40), (2, 64, 64)])
def test_static_template_bwd_steps_match_the_plain_backward(
        probes, rays, samples, max_rows):
    """Kernel A's float32 steps at the static width
    (``f32.template_bwd_steps(..., hyper=0)``, a 64-column stash) through
    ``TorchF32Ops`` at full width give the plain backward's dx_t (zero past
    the xyz), d rgb_cond and every dW / db (zero on the hyper bands'
    columns, which unpacking drops): relative L2 1e-5."""
    tmpl = probes['static'].template_of('coarse')
    layers = K_mlp.kernel_template_layers(tmpl.template)
    w_blob, b_blob, shapes = common.pack_layers(tmpl.template, layers,
                                                dtype=torch.float32)
    wt_blob = common.pack_layers(tmpl.template, layers, transposed=True,
                                 dtype=torch.float32)[0]
    p = rays * samples
    x = _x_template(p, 0, p)
    cond = torch.from_numpy(np.random.RandomState(3).randn(
        rays, 39).astype(np.float32))
    g = torch.from_numpy(np.random.RandomState(4).randn(p, 4).astype(
        np.float32))
    w, wt, b, w_off, b_off, n = K_mlp.layer_views(w_blob, wt_blob, b_blob,
                                                  shapes)
    dx_t, d_cond, grads, _ = f32.template_bwd_steps(
        TorchF32Ops(2), w, wt, b, w_off, b_off, n, x, cond, samples, g,
        max_rows, hyper=0)
    n_w = sum(a * c for a, c in shapes)
    dw0 = grads[:256 * 128].view(256, 128)
    assert not dw0[:, 64:].any()  # the columns past the stash's 64
    got = [dx_t, d_cond] + common.unpack_grads(grads[:n_w], grads[n_w:],
                                               layers, shapes)
    want = K_mlp.fused_template_bwd_plain(tmpl, x, cond, g)
    assert not dx_t[:, 3:].any()
    errs = [_rel(a, c) for a, c in zip(got, [want[0], want[1], *want[2]])]
    assert max(errs) <= TOL, errs


# ---------------------------------------------------------------------------
# The models against the JAX model at float32.


@pytest.fixture(scope='module')
def models():
    """{config: (port model, JAX model, flax params)} at narrow widths in
    float32, the port's weights converted from the flax ones."""
    out = {}
    for config, over in CONFIGS.items():
        params = _flax_params(config)
        jmodel = JaxNerfModel(JaxNerfConfig(use_pallas=False,
                                            **{**ARCH, **over}))
        model = NerfModel(port_configs.NerfConfig(**{**ARCH, **over}))
        model.load_state_dict(params_from_jax(params))
        assert model.config.compute_dtype == 'float32'
        out[config] = (model, jmodel, params)
    return out


@pytest.mark.parametrize('config', ['static', 'split_glo'])
def test_float32_models_match_jax(models, config):
    """A deterministic render's per-ray outputs of both levels, relative
    L2 1e-5, and the loss's gradient against the JAX model at float32
    (the JAX render and gradient jitted, one compile): relative L2 1e-5
    over all parameters, and each parameter's max|d| 1e-4 of its largest
    entry (the coarse alpha head's bias, one small sum of cancelling
    terms, reads 2e-5 of itself)."""
    model, jmodel, params = models[config]
    rays, rgbs = _batch()
    jd, td = _ray_dicts(rays)

    def loss(p):
        out = jmodel.apply({'params': p}, jd, deterministic=True)
        return jax_mse_loss(out, jnp.asarray(rgbs)), out

    (_, want), jgrads = jax.device_get(jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params))
    model.zero_grad(set_to_none=True)
    got = model(td, deterministic=True)
    for level in want:
        for k in ('rgb', 'depth', 'acc'):
            assert _rel(got[level][k].detach(), want[level][k]) <= TOL, \
                (level, k)
    mse_loss(got, torch.from_numpy(rgbs)).backward()
    jgrads = params_from_jax(jgrads)
    mine, theirs = [], []
    for name, p in model.named_parameters():
        want_g = torch.as_tensor(np.asarray(jgrads[name]))
        g = torch.zeros_like(want_g) if p.grad is None else p.grad
        assert (g - want_g).abs().max() <= \
            10 * TOL * want_g.abs().max().clamp_min(1e-30), name
        mine.append(g.reshape(-1))
        theirs.append(want_g.reshape(-1))
    assert _rel(torch.cat(mine), torch.cat(theirs)) <= TOL


def test_float32_query_sigma_matches_jax(models):
    """The flagship's query_sigma (warp field, sheet, template; one sample
    a row) at float32 against JAX's: relative L2 1e-5."""
    model, jmodel, params = models['flagship']
    rs = np.random.RandomState(6)
    pts = (rs.randn(29, 3) * 0.5).astype(np.float32)
    ids = rs.randint(0, 4, (29, 1)).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, x, i: jmodel.apply(
        {'params': p}, x, i, method=JaxNerfModel.query_sigma))(
            params, jnp.asarray(pts), jnp.asarray(ids)))
    with torch.no_grad():
        got = model.query_sigma(torch.from_numpy(pts),
                                torch.from_numpy(ids).long())
    assert got.shape == (29,) and (got >= 0).all()
    assert _rel(got, want) <= TOL


def test_float32_return_points_and_hyper_point_match_jax(models):
    """The flagship with ``return_points`` and with a ``hyper_point``
    override (the per-module path's warp field and template, no sheet) at
    float32: per-ray outputs, the warped points and med_points against
    JAX's, relative L2 1e-5."""
    model, jmodel, params = models['flagship']
    rays, _ = _batch()
    hyper = (np.random.RandomState(5).randn(rays.shape[0], 4) * 0.3).astype(
        np.float32)
    render = jax.jit(lambda p, jd: jmodel.apply(
        {'params': p}, jd, deterministic=True, return_points=True))
    for hyper_point in (None, hyper):
        jd, td = _ray_dicts(rays, hyper_point)
        want = jax.device_get(render(params, jd))
        with torch.no_grad():
            got = model(td, deterministic=True, return_points=True)
        for level in want:
            for k in ('rgb', 'depth', 'warped_points', 'med_points'):
                assert _rel(got[level][k], want[level][k]) <= TOL, \
                    (hyper_point is None, level, k)


# ---------------------------------------------------------------------------
# The stored JAX numbers.


def _plain_case(probe_models, case, ref):
    """The plain float32 version's out and gradients of a stored case."""
    kind, config, module, *_ = F32_MODULAR_CASES[case]
    model = probe_models[config]
    x, cot = torch.from_numpy(ref['x_raw']), torch.from_numpy(
        ref['cotangent'])
    if kind == 'field':
        f = getattr(model, module)
        out = K_field.fused_field_plain(f.mlp, f.n_freq, x)
        dx, grads = K_field.fused_field_bwd_plain(f.mlp, f.n_freq, x, cot)
        got = {'dx': dx}
    else:
        tmpl = model.template_of(module)
        cond = torch.from_numpy(ref['rgb_cond'])
        out = K_mlp.fused_template_plain(tmpl, x, cond)
        dx, d_cond, grads, _ = K_mlp.fused_template_bwd_plain(tmpl, x, cond,
                                                              cot)
        got = {'dx': dx[:, :ref['dx'].shape[1]], 'd_rgb_cond': d_cond}
    for i in range(0, len(grads), 2):
        got.update({f'dw{i // 2}': grads[i], f'db{i // 2}': grads[i + 1]})
    return out, {k: v for k, v in got.items() if k in ref}


@torch.no_grad()
def test_stored_float32_modular_reference(probes):
    """tests/data/fused_f32_modular_jax_ref.npz, what ``chip_smoke.py``
    phase 34 holds rows 8, 10, 11 and kernel A at the static width to: its
    inputs redrawn from their seeds, its sheet case recomputed (the JAX
    field kernel at float32, interpret mode), and the plain float32
    versions held to every case."""
    ref = read_f32_modular_reference()
    assert sorted(ref) == sorted(F32_MODULAR_CASES)
    for case, arrays in ref.items():
        for k, v in modular_probe_inputs(case, F32_MODULAR_CASES).items():
            np.testing.assert_array_equal(arrays[k], v, err_msg=case)
    again = make_level_reference.jax_modular(
        probes['flagship'], 'sheet', ref['sheet'], F32_MODULAR_CASES)
    for k, v in again.items():
        assert _rel(v, ref['sheet'][k]) <= 1e-6, k
    for case, arrays in ref.items():
        out, got = _plain_case(probes, case, arrays)
        scale = np.abs(arrays['out']).max()
        assert np.abs(out.numpy() - arrays['out']).max() <= 1e-4 * scale, \
            case
        assert len(got) == sum(k.startswith(('d_', 'dx', 'dw', 'db'))
                               for k in arrays)
        for k, g in got.items():
            want = arrays[k]
            assert np.linalg.norm(g.numpy() - want) <= \
                1e-2 * np.linalg.norm(want), (case, k)
            assert np.abs(g.numpy() - want).max() <= \
                5e-2 * np.abs(want).max(), (case, k)
