"""``--precision 32`` on the card (ROADMAP A.13.1, the flagship table): the
float32 kernels of rows 1, 9 and 5 (``kernels/f32.py``, ``csrc/f32_*``),
what runs them and what is still refused, checked on the CPU.

- The gate: the float32 flagship level (translation warp, bendy sheet,
  posenc_orig template, a 39-column rgb condition) is admitted; so are,
  since sub-item 3, the sheet tables' Nerfies layout with its window row,
  the conditions' widths, a field alone's window row and the plane tables,
  each run as on the card through its float32 entry points against a
  recording library (refused before), and since sub-item 4 the Jacobians,
  rows 14 to 17 (their numbers are
  ``tests/test_torch_precision32_jacobian.py``'s); other bands and widths
  (A.13.2, A.13.3) raise NotImplementedError naming A.13, before any
  library is needed (``common.runs_plain`` rebound as the card would take
  it). The per-module rows at float32 (8, 10, 11) are
  ``tests/test_torch_precision32_modular.py``'s, the screw warps' (rows 1
  and 5 at table codes 1 and 2, rows 12 and 13)
  ``tests/test_torch_precision32_screw.py``'s, the Nerfies layout's and
  the conditions' ``tests/test_torch_precision32_nerfies.py``'s.
- The CLI: ``--precision 32`` builds a float32 model the gate admits;
  ``train.main`` takes two steps at narrow widths equal to the JAX
  trainer's at float32 (the JAX trainer's batches and draws fed to the
  port's step, from its initial weights; ``tests/test_torch_trainer.py``'s
  rule: logged metrics relative 1e-4, final weights 1e-1 of their
  movement).
- A float32 JAX checkpoint converts bit for bit (parameters are stored in
  float32 whatever the compute dtype; nothing rounds through bf16).
- Kernel A's and B's chunk plans: stashes of at most 3 GiB at S = 64, 128
  and 192, whole rays, every ray once.
- Shared memory of the float32 kernels, read from the sources, within an
  sm_90 block's 232,448 bytes (static: 48 KB).
- The steps of kernels A and B (``f32.template_bwd_steps`` /
  ``fields_bwd_steps``) through a PyTorch model of each C entry point
  against the plain backward at the flagship widths, several chunks of
  ragged rows: relative L2 1e-5 (float32 both ways, other summation
  orders); the launches against the C signatures.
- ``tests/data/fused_f32_jax_ref.npz`` (``tools/make_level_reference.py
  --only f32``: the JAX level kernel at float32, interpret mode, full width,
  64 rays x 128 samples at the probe weights) recomputed for two of its
  rays, and the plain float32 level held to the whole file: outputs 1e-4 of
  the largest entry, gradients relative L2 1e-2 and 5e-2 of the largest
  entry (``tests/test_torch_plane.py``'s float32 rule: at full width one
  near-zero ReLU pre-activation falls on the other side in one of the two
  sums; measured here 8.8e-5 and 7.8e-3 at worst).

One torch thread for the full-width cases. About 40 s on one worker.
"""

import contextlib
import ctypes
import dataclasses
import importlib
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from hypernerf_tpu.configs import NerfConfig as JaxNerfConfig
from hypernerf_tpu.configs import TrainConfig as JaxTrainConfig
from hypernerf_tpu.ops.ray_dict import prepare_ray_dict as jax_ray_dict
from hypernerf_tpu.training import checkpoints as jax_ckpt
from hypernerf_tpu.training import trainer as jax_trainer_mod
from hypernerf_tpu.training.optimizers import get_optimizer as jax_optimizer
from hypernerf_tpu.training.train_state import TrainState as JaxTrainState
from hypernerf_tpu.training.train_state import forward_params
from hypernerf_tpu_torch import configs as port_configs
from hypernerf_tpu_torch import opt as port_opt
from hypernerf_tpu_torch import train as port_train
from hypernerf_tpu_torch.convert import params_from_jax
from hypernerf_tpu_torch.flagship import (F32_GRAD_LAYERS, LEVEL_INPUTS,
                                          flagship_model, load_probe_weights,
                                          read_f32_reference)
from hypernerf_tpu_torch.kernels import (build, common, f32,
                                         fused_fields_bwd_plain, fused_level,
                                         fused_level_plain,
                                         fused_template_bwd_plain)
from hypernerf_tpu_torch.kernels import fused_jacobian as K_jac
from hypernerf_tpu_torch.kernels import fused_mlp as K_mlp
from hypernerf_tpu_torch.kernels.fused_level import (_check_covered,
                                                     _n_field_layers,
                                                     level_layers,
                                                     pack_level,
                                                     pack_level_f32)
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.ops.posenc import posenc_orig
from hypernerf_tpu_torch.training import checkpoints
from hypernerf_tpu_torch.training import trainer as port_trainer
from tests.conftest import make_smooth_llff_scene, tiny_nerf_config
from tests.test_torch_train_step import (ARCH, STEPS_PER_EPOCH, TRAIN,
                                         _flax_params)
from tests.test_torch_trainer import (_assert_close, _assert_weights,
                                      _jax_batch, _logged, _run_jax,
                                      _train_kw)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'tools'))
import jax_ckpt_to_torch  # noqa: E402
import make_level_reference  # noqa: E402

# The kernels' package re-exports functions under some of its submodules'
# names: the modules themselves.
K_field = importlib.import_module('hypernerf_tpu_torch.kernels.fused_field')
K_level = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
K_se3_jac = importlib.import_module(
    'hypernerf_tpu_torch.kernels.fused_se3_jacobian')
F32 = dict(compute_dtype='float32')


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def as_on_the_card():
    """The wrappers take their kernel path on CPU tensors, as they would on
    CUDA ones: the gates run before any library is needed."""
    saved = common.runs_plain
    common.runs_plain = lambda t, name: False
    try:
        yield
    finally:
        common.runs_plain = saved


def _model(config='flagship', **over):
    return flagship_model('cpu', config=config, **{**F32, **over})


def _rays(n_rays=2, samples=8, cond=39, seed=0):
    rs = np.random.RandomState(seed)
    z = np.sort(rs.rand(n_rays, samples), -1)
    out = [z, rs.randn(n_rays, 3) * 0.1, rs.randn(n_rays, 3),
           rs.randn(n_rays, 8) * 0.1, rs.randn(n_rays, cond)]
    return [torch.from_numpy(a.astype(np.float32)) for a in out]


def test_gate_admits_the_float32_flagship_table():
    """Both levels of the flagship at float32 (64 + 128, the CLI's) pass
    the level gate and kernel A's; the fp32 blobs hold the 30 layers of the
    compiled table at the bf16 table's shapes, in float32, cached apart from
    the bf16 blobs."""
    model = _model(num_fine_samples=128)
    for name in ('coarse', 'fine'):
        level = model.level(name)
        _check_covered(level)
        K_mlp.check_f32_covered(level)
        w, b, shapes = pack_level_f32(level)
        assert w.dtype == b.dtype == torch.float32
        assert len(shapes) == 30 and w.numel() == 828928
        assert shapes[:7] == [(128, 80)] + [(128, 128)] * 4 + [
            (128, 208), (8, 128)]
        assert shapes[19] == (256, 384) and shapes[25] == (128, 176)
        assert hasattr(level.template, '_packed_f32')
        assert not hasattr(level.template, '_packed')
    bf16 = flagship_model('cpu').level('fine')
    assert pack_level(bf16)[0].dtype == torch.bfloat16


def _refusals():
    """(label, call that must raise)."""
    def level_of(config, **over):
        return lambda: _check_covered(_model(config, **over).level('fine'))

    return [
        ('the xyz bands (A.13.2)', level_of('flagship', xyz_freq=8)),
        ('the GLO width (A.13.3)', level_of('flagship', glo_dim=16)),
        ('other bands', level_of('flagship', warp_freq=8)),
    ]


@pytest.mark.parametrize('label,call', _refusals(),
                         ids=[r[0].split(' (')[0] for r in _refusals()])
def test_gate_refuses_what_float32_does_not_cover(label, call):
    """Every other float32 band and width (A.13.1 is done: the posenc band
    flags of A.13.2 and the widths of A.13.3 are what is left) raises
    naming ROADMAP A.13; nothing falls back to a plain version."""
    with pytest.raises(NotImplementedError, match='ROADMAP item A.13') as e:
        call()
    assert 'sub-item' not in str(e.value)


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


def _admissions():
    """(label, call run as on the card, the float32 entry point it must
    reach): what A.13.1 sub-item 3 ported (the sheet tables' Nerfies
    layout and window row, the conditions' widths, a field alone's window
    row; then the plane tables, codes 3 to 8, and their template alone)
    and sub-item 4 (the Jacobians, rows 14 to 17), each refused before
    it."""
    x11 = torch.from_numpy(np.random.RandomState(11).randn(4, 11).astype(
        np.float32))

    def level_call(config, **over):
        def call():
            level = _model(config, **over).level('fine')
            _check_covered(level)
            row = K_mlp.template_scales(level, 10.0, 1.5)
            alpha = (torch.zeros(2, 8) if K_mlp.alpha_cond_width(level)
                     else None)
            args = _rays(cond=K_mlp.cond_width(level))
            _, raw_t = K_level._launch_forward(
                level, *args, want_raw_t=True, tmpl_scales=row,
                alpha_cond=alpha)
            K_mlp.fused_template_bwd(level, raw_t, args[4],
                                     torch.zeros(16, 4), row, alpha)
            K_level.fused_fields_bwd(level, *args[:4], torch.zeros(
                16, K_mlp.raw_pad(level)))
        return call

    def template_alone(config):
        def call():
            tmpl = _model(config).template_of('fine')
            x = torch.zeros(16, K_mlp.raw_pad(tmpl))
            cond = torch.zeros(2, K_mlp.cond_width(tmpl))
            row = K_mlp.template_scales(tmpl, 10.0, 1.5)
            K_mlp.fused_template(tmpl, x, cond, row)
            K_mlp.fused_template_bwd(tmpl, x, cond, torch.zeros(16, 4), row)
        return call

    def field_alone_windowed():
        mlp = _model('split_glo').warp_field.mlp
        row = K_field.encoding_scales(10, 8, 4.5)
        K_field.fused_field(mlp, 10, x11, row)
        K_field.fused_field_bwd(mlp, 10, x11, torch.zeros(4, 8), row)

    def translation_jacobian():
        mlp = _model('elastic').warp_field.mlp
        K_jac.fused_warp_jacobian(mlp, 10, x11[:, :3], x11[:, 3:])
        K_jac.fused_jacobian_bwd(mlp, 10, x11, torch.zeros(4, 9))

    def se3_tangents():
        from hypernerf_tpu_torch.kernels.fused_se3 import \
            se3_encoding_scales
        field = _model('elastic_se3').warp_field
        row = se3_encoding_scales(field, 3.5)
        K_se3_jac.fused_se3_wv_tangents(field, x11, row)
        K_se3_jac.fused_se3_jacobian_bwd(field, x11, torch.zeros(4, 24), row)

    return [
        ('anneal level (the Nerfies layout)', level_call('anneal'),
         'hn_f32_level_fwd'),
        ('nerf_embed level (47 + 8 conditions)', level_call('nerf_embed'),
         'hn_f32_alpha_cond_bwd'),
        ('use_viewdirs=False (a 0-column condition)',
         level_call('flagship', use_viewdirs=False), 'hn_f32_level_fwd'),
        ('B.4 anneal_se3', level_call('anneal_se3'), 'hn_f32_retract_bwd'),
        ('anneal template alone (row 8, the Nerfies layout)',
         template_alone('anneal'), 'hn_f32_template_fwd'),
        ('a field alone with a window row (rows 10, 11)',
         field_alone_windowed, 'hn_f32_field_fwd'),
        ('plane level (code 3)', level_call('plane'), 'hn_f32_plane_rows'),
        ('plane_se3 level (code 4)', level_call('plane_se3'),
         'hn_f32_plane_rows'),
        ('B.4 plane_anneal', level_call('plane_anneal'), 'hn_f32_level_fwd'),
        ('plane template alone (row 8, return_points)',
         template_alone('plane'), 'hn_f32_template_fwd'),
        ('rows 14, 15, the translation Jacobian', translation_jacobian,
         'hn_f32_jacobian_fwd'),
        ('rows 16, 17, the trunk\'s tangents (window row on)', se3_tangents,
         'hn_f32_se3_jacobian_fwd'),
    ]


@torch.no_grad()
@pytest.mark.parametrize('label,call,entry', _admissions(),
                         ids=[r[0].split(' (')[0] for r in _admissions()])
def test_gate_admits_what_sub_item_3_ported(label, call, entry, recording):
    """Each configuration sub-items 3 and 4 ported, refused before, runs
    its float32 forward and backward as on the card: every launch one
    of the float32 entry points with its signature's arguments (the window
    row's pointer given where the layout has one), the entry named reached,
    no plain version called."""
    plain = [fn.calls for fn in (fused_level_plain,
                                 fused_template_bwd_plain)]
    with as_on_the_card():
        call()
    names = [n for n, _ in recording.calls]
    assert entry in names and all(n.startswith('hn_f32_') for n in names)
    for name, call_args in recording.calls:
        assert len(call_args) == len(build._SIGNATURES[name][0]), name
    for name, a in recording.calls:
        if name in ('hn_f32_level_fwd', 'hn_f32_template_fwd'):
            window = a[10] if name == 'hn_f32_level_fwd' else a[5]
            assert (window is not None) == ('anneal' in label), label
    assert [fn.calls for fn in (fused_level_plain,
                                fused_template_bwd_plain)] == plain


def test_cli_precision_32_builds_an_admitted_model():
    """``--precision 32`` with the CLI's other defaults: the flagship's
    widths, 64 + 128 samples, the translation warp and the bendy sheet in
    float32, which the float32 kernels take."""
    nerf_cfg, _ = port_opt.configs_from_args(port_opt.get_opts(
        ['--precision', '32']))
    assert nerf_cfg.compute_dtype == 'float32'
    assert (nerf_cfg.num_coarse_samples, nerf_cfg.num_fine_samples) == (64,
                                                                        128)
    assert (nerf_cfg.warp_field_type, nerf_cfg.hyper_slice_method) == (
        'translation', 'bendy_sheet')
    model = NerfModel(nerf_cfg)
    for name in ('coarse', 'fine'):
        _check_covered(model.level(name))
    assert port_opt.configs_from_args(port_opt.get_opts(
        []))[0].compute_dtype == 'bfloat16'


def _jitted_train_state(model, tx, train_cfg, rng, sample_rays):
    """``create_train_state`` with ``model.init`` jitted: the same initial
    weights as its eager init (one compile where the eager one compiles
    some 300 ops, 18 s on the CPU)."""
    rays_dict = jax_ray_dict(jax.numpy.asarray(sample_rays))
    params = jax.jit(model.init)({'params': rng, 'sampling': rng,
                                  'sigma_noise': rng}, rays_dict)['params']
    return JaxTrainState(step=jax.numpy.zeros((), jax.numpy.int32),
                         params=params, opt_state=tx.init(params))


def test_train_main_at_float32_equals_the_jax_trainer(tmp_path, monkeypatch):
    """``train.main([... '--precision', '32'])`` at ``tiny_nerf_config``'s
    widths (the CLI's configuration with its widths narrowed) for two steps,
    warm-started from the JAX trainer's initial weights and fed its batches
    and draws: the logged losses and PSNRs equal the JAX trainer's at
    float32 (relative 1e-4) and so do the final weights (1e-1 of their
    movement)."""
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    monkeypatch.setenv('HYPERNERF_PLATFORM', 'cpu')
    monkeypatch.chdir(tmp_path)
    scene = make_smooth_llff_scene(tmp_path / 'scene')
    root = str(tmp_path)
    # No val: the JAX val's compile would take 20 s of the test's 25.
    kw = _train_kw(scene, root, 'jax', max_steps=2, val_check_interval=100.0,
                   num_sanity_val_steps=0, ckpt_every_steps=100,
                   lr_scheduler='steplr', decay_step=(20,), optimizer='adam',
                   lr=5e-4)
    monkeypatch.setattr(jax_trainer_mod, 'create_train_state',
                        _jitted_train_state)
    init, jt = _run_jax(kw)
    tiny = port_configs.NerfConfig.from_json(tiny_nerf_config().to_json())
    weights = os.path.join(root, 'init', 'model.pt')
    checkpoints.save_weights(weights, params_from_jax(init), tiny)
    cli = port_opt.configs_from_args

    def narrowed(args):
        nerf_cfg, train_cfg = cli(args)
        assert nerf_cfg.compute_dtype == 'float32'
        keep = {f.name for f in dataclasses.fields(tiny)} - {'compute_dtype'}
        return (dataclasses.replace(nerf_cfg, **{
            k: getattr(tiny, k) for k in keep}),
            dataclasses.replace(train_cfg, **{
                k: v for k, v in kw.items() if k != 'exp_name'}))

    make_step = port_trainer.make_train_step

    def jax_fed(model, optimizer, nerf_cfg, train_cfg, device, **kwargs):
        kwargs.pop('background_points', None)
        explicit = make_step(model, optimizer, nerf_cfg, train_cfg, device,
                             explicit_batch=True, **kwargs)

        def step(state, all_rays, all_rgbs):
            idx, draws = _jax_batch(jt, state.step)
            return explicit(state, all_rays[idx], all_rgbs[idx], draws=draws)
        return step

    monkeypatch.setattr(port_opt, 'configs_from_args', narrowed)
    monkeypatch.setattr(port_trainer, 'make_train_step', jax_fed)
    pt = port_train.main(['--root_dir', scene, '--img_wh', '16', '12',
                          '--precision', '32', '--max_steps', '2',
                          '--batch_size', '64', '--chunk', '64',
                          '--weight_path', weights, '--exp_name', 'port'])
    assert pt.nerf_cfg.compute_dtype == 'float32' and pt.state.step == 2
    assert all(p.dtype == torch.float32 for p in pt.model.parameters())
    want = _logged(kw['log_dir'], 'jax')
    got = _logged(kw['log_dir'], 'port')
    assert {k for k, _ in want} >= {'train/loss', 'train/psnr'}
    _assert_close(got, want)
    final = params_from_jax(jax.tree.map(np.array, jax.device_get(
        forward_params(jt.state.params))))
    _assert_weights(pt.model.state_dict(), final, params_from_jax(init))


def test_float32_jax_checkpoint_converts_bit_for_bit(tmp_path):
    """A float32 JAX model's full checkpoint (``save_checkpoint``, Adam's
    state) converted by ``tools/jax_ckpt_to_torch.py``: the configuration's
    compute dtype float32, and every parameter of the port's float32 model
    that restores it equal to JAX's bit for bit (no bf16 round trip)."""
    cfg = JaxNerfConfig(use_pallas=False, **ARCH)
    assert cfg.compute_dtype == 'float32'
    train_cfg = JaxTrainConfig(**TRAIN)
    tx = jax_optimizer(train_cfg, steps_per_epoch=STEPS_PER_EPOCH)
    params = jax.tree.map(jax.numpy.asarray, _flax_params())
    state = JaxTrainState(step=jax.numpy.zeros((), jax.numpy.int32),
                          params=params, opt_state=tx.init(params))
    path = jax_ckpt.save_checkpoint(str(tmp_path / 'jax'), 0, state,
                                    nerf_config=cfg, train_config=train_cfg)
    out = jax_ckpt_to_torch.convert_checkpoint(path, str(tmp_path / 'port'))
    port_cfg = checkpoints.load_config(out)
    assert port_cfg.compute_dtype == 'float32'
    model = NerfModel(port_cfg)
    checkpoints.load_weights(model, out)
    want = params_from_jax(jax.device_get(params))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.dtype == torch.float32, k
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    # The weights carry bits below bf16's: a bf16 round trip would show.
    w = got['nerf_fine.trunk.hidden_0.weight']
    assert not torch.equal(w, w.to(torch.bfloat16).float())


@pytest.mark.parametrize('samples', [64, 128, 192])
def test_float32_chunk_plans(samples):
    """Kernel A's and B's float32 chunk plans at the train step's 16384
    rays: whole rays, every ray once, each chunk's stash at most 3 GiB (the
    bf16 kernel A's), so the step's peak stays near the bf16 step's."""
    p = 16384 * samples
    for stash in (f32.TEMPLATE_STASH, f32.WARP_STASH):
        plan = K_mlp.chunk_plan(p, samples, f32.chunk_rows(stash))
        assert plan[0][0] == 0 and plan[-1][1] == p
        assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
        assert all((r1 - r0) % samples == 0 for r0, r1 in plan)
        rows = max(r1 - r0 for r0, r1 in plan)
        assert 4 * stash.width * rows <= 3 << 30
        assert 4 * stash.width * (rows + samples) > 3 << 30 or len(plan) == 1
    assert f32.TEMPLATE_STASH.width == 3120 and f32.WARP_STASH.width == 848
    assert f32.SHEET_STASH.width <= f32.WARP_STASH.width


def _source(name):
    return ' '.join((build.CSRC / name).read_text().split())


def test_float32_kernels_shared_memory_fits():
    """The level forward's dynamic shared memory as csrc/f32_level.cu
    computes it (X, H0, H1, the Wide tile's weight chunks, per-row scratch;
    the template alone's the same, a field alone's narrower) and the steps'
    static shared memory as f32_steps.cu declares it (the Step tile's), from
    the sources' constants and tiles: within an sm_90 block's 232,448
    bytes, and the static ones within 48 KB. The screw level runs its trunk
    in the level forward's carve-out (X of 128 features holds the trunk's
    64, H of 256 its 128); the SE(3) trunk alone carves X of 64 features,
    H of 128 and the Narrow tile's weight chunks, two blocks an SM."""
    chain, level, steps = (_source(n) for n in (
        'f32_chain.cuh', 'f32_level.cu', 'f32_steps.cu'))
    const = {k: int(v) for decl in re.findall(
        r'constexpr int ([^;]+);', chain + ' ' + level)
        for k, v in re.findall(r'(k\w+) = (\d+)(?:,|$)', decl)}
    tiles = {name: tuple(int(v) for v in args.split(','))
             for name, args in re.findall(
                 r'using (\w+) = Tile<([\d, ]+)>;', chain)}
    assert (const['kThreads'], const['kDepth']) == (f32.THREADS, f32.DEPTH)

    def rows_cols(name):
        tr, tc, cg = tiles[name]
        return const['kThreads'] // cg * tr, cg * tc

    assert rows_cols('Wide') == (f32.TILE_ROWS, f32.WIDE_COLS)
    assert rows_cols('Narrow') == (f32.TILE_ROWS, f32.WIDE_COLS // 2)
    assert rows_cols('Step') == (f32.STEP_ROWS, f32.STEP_COLS)
    assert ('return xf * kRows + 2 * hf * kRows + 2 * wtile + (3 + raw + 8 + '
            '1) * kRows + kRows;') in level
    assert 'int smem_floats(int xf, int hf, int wtile, int raw = kRaw)' in level
    assert ('kSmemBytes = 4 * smem_floats(kTmplEnc, 256, Wide::kWTile);'
            in level)
    assert ('kFieldSmemBytes = 4 * smem_floats(kWarpEnc, 128, '
            'Narrow::kWTile);' in level)
    rows, depth = f32.TILE_ROWS, f32.DEPTH

    def smem(xf, hf, wtile, raw=8):
        return 4 * (xf * rows + 2 * hf * rows + 2 * wtile
                    + (3 + raw + 8 + 1) * rows + rows)

    assert smem(const['kTmplEnc'], 256, depth * f32.WIDE_COLS) == \
        f32.LEVEL_SMEM_BYTES == 201984
    # A plane table's carve: X of the posenc_orig plane layout's 192
    # features and 16 raw rows, one block an SM.
    assert smem(const['kPlaneEnc'], 256, depth * f32.WIDE_COLS,
                const['kPlaneRaw']) == f32.PLANE_SMEM_BYTES == 220416
    assert ('kPlaneSmemBytes = 4 * smem_floats(kPlaneEnc, 256, '
            'Wide::kWTile, kPlaneRaw);') in level
    assert 'static_assert(kPlaneSmemBytes <= 232448' in level
    assert smem(const['kWarpEnc'], 128, depth * f32.WIDE_COLS // 2) == \
        f32.FIELD_SMEM_BYTES == 107776
    assert ('kTrunkSmemBytes = 4 * smem_floats(kSe3EncP, kSe3W, '
            'Narrow::kWTile);' in level)
    assert smem(f32.SE3_ENC, 128, depth * f32.WIDE_COLS // 2) == \
        f32.TRUNK_SMEM_BYTES == 103680
    assert f32.SE3_ENC <= const['kTmplEnc'] and 2 * (
        f32.TRUNK_SMEM_BYTES + 1024) <= 233472
    assert 'static_assert(kTrunkSmemBytes <= 232448' in level
    assert f32.LEVEL_SMEM_BYTES <= f32.SMEM_LIMIT
    assert 2 * (f32.FIELD_SMEM_BYTES + 1024) <= 233472  # two blocks an SM
    assert 'static_assert(kSmemBytes <= 232448' in level
    assert 'static_assert(kFieldSmemBytes <= 232448' in level
    assert 'using T = Step;' in steps
    assert 'constexpr int kALd = T::kRows + 4;' in steps
    decl = re.findall(
        r'__shared__ __align__\(16\) float \w+\[2\]\[([\w:* ]+)\]', steps)
    names = {'kDepth': depth, 'kALd': f32.STEP_ROWS + 4,
             'T_kRows': f32.STEP_ROWS, 'T_kWTile': depth * f32.STEP_COLS}
    sizes = [eval(d.replace('T::', 'T_'), {}, names) for d in decl]
    assert len(sizes) == 4
    assert 4 * 2 * (sizes[0] + sizes[1]) == f32.STEP_SMEM_BYTES <= 48 * 1024
    assert 4 * 2 * (sizes[2] + sizes[3]) <= 48 * 1024


class TorchF32Ops:
    """The steps of ``f32.template_bwd_steps`` / ``fields_bwd_steps`` in
    PyTorch, each the contract of its C entry point (csrc/f32_steps.cu):
    fp32 operands and sums, dW / db slabs per row range."""

    def __init__(self, sms=2):
        self.sms = sms  # a small card: several row ranges at these sizes

    def split_count(self, n_out, k, rows):
        return f32.split_count(n_out, k, rows, self.sms)

    def rowprod(self, a, w, out, bias=None, relu=False, mask=None,
                accumulate=False, a1=None):
        x = a if a1 is None else torch.cat([a, a1], 1)
        k, n = x.shape[1], out.shape[1]
        assert n % 4 == 0 and w.stride(0) % 4 == 0  # the kernel's float4
        y = x @ w[:k, :n]
        if accumulate:
            out += y
            return
        if bias is not None:
            y = y + bias[:n]
        if relu:
            y = y.clamp_min(0)
        if mask is not None:  # row r reads mask row r % its rows
            mask = mask[torch.arange(y.shape[0]) % mask.shape[0]]
            y = torch.where(mask > 0, y, torch.zeros_like(y))
        out[:] = y

    def dw(self, g, h, h1, slab, w_off, ldc, b_off, db_rows=None):
        x = h if h1 is None else torch.cat([h, h1], 1)
        n, k, m = g.shape[1], x.shape[1], g.shape[0]
        assert k <= ldc
        splits = slab.shape[0]
        db_rows = m if db_rows is None else db_rows
        for z in range(splits):
            r0, r1 = m * z // splits, m * (z + 1) // splits
            dw = slab[z, w_off:w_off + n * ldc].view(n, ldc)
            dw[:, :k] = g[r0:r1].t() @ x[r0:r1]
            dw[:, k:] = 0  # an input narrower than the packed columns
            if b_off >= 0:  # db over the rows r < db_rows
                slab[z, b_off:b_off + n] = g[r0:min(r1, max(r0, db_rows))
                                             ].sum(0)

    def reduce(self, slabs, grads):
        grads += slabs.sum(0)

    def field_encode(self, z, o, d, emb, samples, freq, out):
        q = torch.arange(z.shape[0]) // samples
        pts = o[q] + z[:, None] * d[q]
        enc = torch.cat([posenc_orig(pts, freq), emb[q]], 1)
        out[:] = torch.nn.functional.pad(enc, (0, out.shape[1]
                                               - enc.shape[1]))

    def tmpl_encode(self, raw, f0, ch1, f1, out, ident1=True, scales=None):
        # ch1 = 0: no second segment; f1 = 0: its identity alone; without
        # ident1 the Nerfies posenc [sin | cos]; times the window row.
        x1 = raw[:, 3:3 + ch1]
        seg1 = posenc_orig(x1, f1) if ident1 else torch.cat(
            common.posenc_trig(x1, f1), 1)
        enc = torch.cat([posenc_orig(raw[:, :3], f0), seg1], 1)
        enc = torch.nn.functional.pad(enc, (0, out.shape[1] - enc.shape[1]))
        out[:] = enc if scales is None else enc * scales[:out.shape[1]]

    def cond_rows(self, cond, samples, out):
        out[:] = torch.nn.functional.pad(cond.repeat_interleave(
            samples, 0), (0, out.shape[1] - cond.shape[1]))

    def tmpl_posenc_bwd(self, raw, f0, ch1, f1, g, dx, ident1=True,
                        scales=None):
        n0 = 3 * (1 + 2 * f0)
        g = g if scales is None else g * scales[:g.shape[1]]
        dx[:] = 0
        dx[:, :3] = common.posenc_bwd(g[:, :n0], common.posenc_trig(
            raw[:, :3], f0), 3, f0)
        g1 = g[:, n0:n0 + ch1 * (int(ident1) + 2 * f1)]
        if ch1:  # f1 = 0: the identity's cotangent alone
            dx[:, 3:3 + ch1] = g1 if f1 == 0 else common.posenc_bwd(
                g1, common.posenc_trig(raw[:, 3:3 + ch1], f1), ch1, f1,
                identity=ident1)

    def alpha_cond_bwd(self, g, alpha, aw, samples, d_alpha, slabs):
        gs = g[:, 0].reshape(-1, samples).sum(1)
        d_alpha[:] = gs[:, None] * aw
        rays, splits = alpha.shape[0], slabs.shape[0]
        for z in range(splits):
            q0, q1 = rays * z // splits, rays * (z + 1) // splits
            slabs[z] = (gs[q0:q1, None] * alpha[q0:q1]).sum(0)

    def fields_rows(self, z, o, d, emb, samples, dxt, gw, f0, gs, f1, dz,
                    rows):
        q = torch.arange(z.shape[0]) // samples
        pts = o[q] + z[:, None] * d[q]
        n0, n1 = 3 * (1 + 2 * f0), 3 * (1 + 2 * f1)
        dp = (dxt[:, :3] + common.posenc_bwd(
            gw[:, :n0], common.posenc_trig(pts, f0), 3, f0)) \
            + common.posenc_bwd(gs[:, :n1], common.posenc_trig(pts, f1), 3,
                                f1)
        e = emb.shape[1]
        dz[:] = (dp * d[q]).sum(1)
        rows[:] = torch.cat([dp, dp * z[:, None],
                             gw[:, n0:n0 + e] + gs[:, n1:n1 + e]], 1)

    def ray_sum(self, x, samples, out):
        out[:] = x.reshape(out.shape[0], samples, x.shape[1]).sum(1)



def _rel(a, b):
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


@pytest.fixture(scope='module')
def probe_level():
    """The flagship at float32 with the probe weights: its fine level."""
    return load_probe_weights(_model()).level('fine')


@torch.no_grad()
@pytest.mark.parametrize('rays,samples,max_rows,sms', [
    (7, 13, 40, 2), (3, 29, 1000, 2), (2, 192, 192, 2), (12, 192, 2304, 400)])
def test_float32_steps_match_the_plain_backward(probe_level, rays, samples,
                                                max_rows, sms):
    """Kernel A's and kernel B's float32 steps through ``TorchF32Ops``
    (several chunks of whole rays, ragged slabs; a card of ``sms`` SMs,
    whose row ranges also size the dW scratch: 400 asks for more than an
    H100's 132 would) give the plain backward's numbers: dx_t, d rgb_cond
    and every dW / db of the template; d z, d o, d d, d embed and every dW
    / db of the fields; relative L2 1e-5."""
    level = probe_level
    args = _rays(rays, samples, seed=rays)
    _, raw_t = fused_level_plain(level, *args, return_raw_t=True)
    g = torch.from_numpy(np.random.RandomState(samples).randn(
        rays * samples, 4).astype(np.float32))
    ops = TorchF32Ops(sms)
    layers_t = K_mlp.kernel_template_layers(level.template)
    tw, tb, tshapes = common.pack_layers(level.template, layers_t,
                                         dtype=torch.float32)
    twt = common.pack_layers(level.template, layers_t, transposed=True,
                             dtype=torch.float32)[0]
    w, wt, b, w_off, b_off, n = K_mlp.layer_views(tw, twt, tb, tshapes)
    w_blob, b_blob, shapes = pack_level_f32(level)
    wt_blob = pack_level_f32(level, transposed=True)[0]
    assert tshapes == shapes[14:]
    dx_t, d_cond, grads, _ = f32.template_bwd_steps(
        ops, w, wt, b, w_off, b_off, n, raw_t, args[4], samples, g, max_rows)
    layers = level_layers(level)
    n_w = sum(a * c for a, c in shapes[14:])
    got = [dx_t, d_cond] + common.unpack_grads(grads[:n_w], grads[n_w:],
                                               layers[14:], shapes[14:])
    want = fused_template_bwd_plain(level, raw_t, args[4], g)
    want = [want[0], want[1], *want[2]]
    errs = [_rel(a, c) for a, c in zip(got, want)]
    assert max(errs) <= 1e-5, errs
    nf = _n_field_layers(level)
    w, wt, b, w_off, b_off, n = K_mlp.layer_views(w_blob, wt_blob, b_blob,
                                                  shapes[:nf])
    d_z, d_ray, grads = f32.fields_bwd_steps(
        ops, w, wt, b, w_off, b_off, n, *args[:4], want[0], max_rows)
    n_w = sum(a * c for a, c in shapes[:nf])
    got = [d_z, d_ray[:, :3], d_ray[:, 3:6], d_ray[:, 6:]] + \
        common.unpack_grads(grads[:n_w], grads[n_w:], layers[:nf],
                            shapes[:nf])
    want = fused_fields_bwd_plain(level, *args[:4], want[0])
    want = [*want[:4], *want[4]]
    errs = [_rel(a, c) for a, c in zip(got, want)]
    assert max(errs) <= 1e-5, errs


class _RecordingLibrary:
    """Stands in for the kernel library: records each entry point's
    arguments and returns success; the float32 table as the C source
    declares it."""

    def __init__(self):
        self.calls = []

    def hn_f32_table_layout(self, code, n, k, count):
        """Table code ``code``'s layers as the C source lays them out: the
        warp's (the flagship table's rows 0..6, or the trunk's), the
        sheet's 7..13 on the sheet tables (codes 0 to 2), the template's
        14..29, its first layer and skip on kPlaneEnc encoding columns in
        the posenc_orig plane layout (codes 3 to 5)."""
        flag = self._rows('kShapeN', 'kShapeK', 'kLayers')
        enc = (int(re.search(r'kPlaneEnc = (\d+)', _source(
            'f32_level.cu')).group(1)) if 3 <= code < 6 else 128)
        rows = ((self._rows('kTrunkN', 'kTrunkK', 'kTrunkLayers')
                 if code % 3 else flag[:7]) + (flag[7:14] if code < 3 else [])
                + [(a, c - 128 + enc if l in (14, 19) else c)
                   for l, (a, c) in enumerate(flag) if l >= 14])
        return self._write(rows, n, k)

    @staticmethod
    def _rows(n_name, k_name, size):
        src = _source('f32_level.cu')
        table = [[int(v) for v in re.search(
            name + r'\[' + size + r'\] = \{([\d, ]+)\}', src).group(
                1).split(',')] for name in (n_name, k_name)]
        return list(zip(*table))

    @staticmethod
    def _write(rows, n, k):
        for i, (a, c) in enumerate(rows):
            ctypes.c_int.from_address(n + 4 * i).value = a
            ctypes.c_int.from_address(k + 4 * i).value = c
        return len(rows)

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@torch.no_grad()
def test_float32_launches_match_the_c_signatures(monkeypatch, probe_level):
    """The float32 wrappers (rows 1, 9, 5 through ``fused_level``,
    ``fused_template_bwd``, ``fused_fields_bwd`` as on the card) pass each
    C entry point as many arguments as ``build``'s ctypes signature
    declares, of the declared kinds, the stream last; the packed shapes
    pass the compiled float32 table read from csrc/f32_level.cu; each
    wrapper counts one launch a call, whatever its steps."""
    lib = _RecordingLibrary()
    monkeypatch.setattr(build, 'library', lambda: lib)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: type('S', (), {'cuda_stream': 7}))
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'get_device_properties',
                        lambda device=None: type(
                            'P', (), {'multi_processor_count': 132}))
    level = probe_level
    rays, samples = 3, 8
    args = _rays(rays, samples)
    counts = [f.launches for f in (f32.fused_level_f32,
                                   f32.fused_template_bwd_f32,
                                   f32.fused_fields_bwd_f32)]
    with as_on_the_card():
        out, raw_t = K_level._launch_forward(
            level, *args, want_raw_t=True)
        assert out.shape == (rays * samples, 4) and raw_t.shape == (
            rays * samples, 8)
        K_mlp.fused_template_bwd(level, raw_t, args[4], torch.zeros(
            rays * samples, 4))
        K_level.fused_fields_bwd(
            level, *args[:4], torch.zeros(rays * samples, 8))
    assert [f.launches - c for f, c in zip(
        (f32.fused_level_f32, f32.fused_template_bwd_f32,
         f32.fused_fields_bwd_f32), counts)] == [1, 1, 1]
    names = [n for n, _ in lib.calls]
    assert names[0] == 'hn_f32_level_fwd'
    # A reduce of dW and one of db after each of the 16 + 14 layers' dW.
    assert names.count('hn_f32_reduce') == 2 * (16 + 14)
    ints = (ctypes.c_int, ctypes.c_longlong)
    for name, call_args in lib.calls:
        argtypes = build._SIGNATURES[name][0]
        assert len(call_args) == len(argtypes), name
        for i, (a, kind) in enumerate(zip(call_args, argtypes)):
            if kind in ints:
                assert isinstance(a, int) and not isinstance(a, bool), \
                    (name, i)
            else:
                assert a is None or isinstance(a, int), (name, i)
        assert call_args[-1] == 7, name  # the stream
    fwd = dict(lib.calls)['hn_f32_level_fwd']
    assert fwd[5] == 39 and fwd[-3:-1] == (rays, samples)


def test_stored_float32_jax_reference(probe_level):
    """tests/data/fused_f32_jax_ref.npz, what chip_smoke.py phase 33 holds
    the float32 kernels to on the card: the JAX level kernel's numbers at
    float32 for the stored cotangent. Two of its rays recomputed here
    (outputs and every per-ray gradient: the level is ray-native), and the
    plain float32 level's outputs and gradients held to the whole file."""
    ref = read_f32_reference()['level']
    model = load_probe_weights(flagship_model('cpu', **F32))
    keep = slice(0, 2)
    samples = ref['z_vals'].shape[1]
    rows = slice(0, 2 * samples)
    rays = {k: ref[k][keep] for k in LEVEL_INPUTS}
    again = make_level_reference.jax_level_vjp(
        model, 'fine', rays, ref['cotangent'][rows])
    # Two rays are another shape of the same jitted kernel: the CPU's
    # products sum in another order (measured: outputs 4.2e-6 apart).
    np.testing.assert_allclose(again['out'], ref['out'][rows], rtol=0,
                               atol=2e-5)
    for k in LEVEL_INPUTS:
        assert _rel(torch.tensor(again[f'd_{k}']),
                    torch.tensor(ref[f'd_{k}'][keep])) <= 1e-3, k
    level = probe_level
    args = [torch.from_numpy(ref[k]).requires_grad_(True)
            for k in LEVEL_INPUTS]
    out = fused_level(level, *args)
    scale = np.abs(ref['out']).max()
    assert np.abs(out.detach().numpy() - ref['out']).max() <= 1e-4 * scale
    out.backward(torch.from_numpy(ref['cotangent']))
    got = {f'd_{k}': a.grad.numpy() for k, a in zip(LEVEL_INPUTS, args)}
    for l, (lin, _) in enumerate(level_layers(level)):
        got[f'db{l}'] = lin.bias.grad.numpy()
        if l in F32_GRAD_LAYERS:
            got[f'dw{l}'] = lin.weight.grad.numpy()
    assert sorted(got) == sorted(k for k in ref
                                 if k.startswith(('d_', 'dw', 'db')))
    for k, g in got.items():
        want = ref[k]
        assert np.linalg.norm(g - want) <= 1e-2 * np.linalg.norm(want), k
        assert np.abs(g - want).max() <= 5e-2 * np.abs(want).max(), k
