"""The template MLP alone: the port's plain forward and plain backward
(``kernels/fused_mlp.py``, what its wrappers run on CPU tensors) against the
JAX Pallas kernel ``fused_nerf_mlp`` with its in-kernel encoding (interpret
mode) and its VJP, on the same numpy inputs and weights.

Cases: [xyz | hyper] inputs (``enc_segments`` ((3, 10), (4, 6))) and xyz
alone (((3, 10),), the static template); one condition row per ray of 8
samples and one per sample (``cond_samples`` 8 and 1); row counts (48, 50)
that are multiples of neither the JAX forward tile (16) nor its backward tile
(32), which differ.

Tolerances as in ``test_torch_fused_field.py``: float32 rtol 2e-4 / atol
2e-5; bfloat16 outputs 1e-2 + 1e-2 |x|, gradients relative L2 5e-2 and 0.25
of the largest entry.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.ops.pallas.fused_mlp import FusedMLPSpec, fused_nerf_mlp
from hypernerf_tpu_torch.kernels import (Template, fused_template,
                                         fused_template_bwd_plain,
                                         fused_template_plain)
from hypernerf_tpu_torch.kernels import common
from hypernerf_tpu_torch.kernels.fused_mlp import template_layers
from hypernerf_tpu_torch.models.modules import NerfMLP, torch_dtype
from tests.test_torch_fused_field import _assert_close

C = 11  # condition features
SEGMENTS = {'hyper': ((3, 10), (4, 6)), 'static': ((3, 10),)}
# rows per condition row -> (condition rows, rows)
ROWS = {8: (6, 48), 1: (50, 50)}


def _enc(segments):
    return sum(ch * (1 + 2 * f) for ch, f in segments)


def _setup(kind, per, seed=0):
    """Numpy raw rows (P, 8), condition rows, cotangent and the (W (in,
    out), b) pairs of a 3 x 32 trunk (skip after 1) with a 2 x 16 rgb
    branch, in the kernel's layer order."""
    segments = SEGMENTS[kind]
    r, p = ROWS[per]
    rs = np.random.RandomState(seed)
    raw = sum(ch for ch, _ in segments)
    x = np.zeros((p, 8), np.float32)
    x[:, :raw] = rs.randn(p, raw) * 0.5
    cond = rs.randn(r, C).astype(np.float32)
    enc = _enc(segments)
    shapes = [(enc, 32), (32, 32), (32 + enc, 32), (32, 32), (32, 16),
              (16, 1), (16 + C, 16), (16, 16), (16 + 16 + C, 3)]
    pairs = [((rs.randn(i, o) * np.sqrt(2.0 / i)).astype(np.float32),
              (rs.randn(o) * 0.1).astype(np.float32)) for i, o in shapes]
    return x, cond, rs.randn(p, 4).astype(np.float32), pairs


def _port_template(kind, pairs, dtype):
    mlp = NerfMLP(_enc(SEGMENTS[kind]), C, 3, 32, 2, 16, skips=(1,),
                  dtype=torch_dtype(dtype))
    with torch.no_grad():
        for (lin, _), (w, b) in zip(template_layers(mlp), pairs):
            lin.weight.copy_(torch.from_numpy(w.T))
            lin.bias.copy_(torch.from_numpy(b))
    return Template(mlp, 10, 6)


def _jax(kind, per, dtype, x, cond, cot, pairs):
    segments = SEGMENTS[kind]
    raw = sum(ch for ch, _ in segments)
    spec = FusedMLPSpec(in_ch=_enc(segments), trunk_depth=3, trunk_width=32,
                        rgb_depth=2, rgb_width=16, skips=(1,), rgb_cond_ch=C,
                        tile=16, bwd_tile=32, compute_dtype=dtype,
                        enc_segments=segments, cond_samples=per,
                        interpret=True)

    def fn(x_raw, rgb_cond, wbs):
        out = fused_nerf_mlp(spec, x_raw[:, :raw], rgb_cond, None, wbs)
        return jnp.concatenate([out['rgb'], out['alpha']], -1)

    args = (jnp.asarray(x), jnp.asarray(cond),
            [(jnp.asarray(w), jnp.asarray(b)) for w, b in pairs])
    dx, d_cond, dwb = jax.grad(
        lambda *a: jnp.sum(fn(*a) * jnp.asarray(cot)),
        argnums=(0, 1, 2))(*args)
    grads = [np.asarray(dx), np.asarray(d_cond)]
    for dw, db in dwb:
        grads += [np.asarray(dw).T, np.asarray(db)]
    return np.asarray(fn(*args)), grads


@pytest.mark.parametrize('per', [8, 1], ids=['per_ray', 'per_sample'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('kind', sorted(SEGMENTS))
def test_plain_template_matches_jax_kernel(kind, dtype, per):
    """Forward and backward, through the wrapper and its autograd Function
    on CPU tensors (which take the plain versions)."""
    x, cond, cot, pairs = _setup(kind, per)
    want_out, want_grads = _jax(kind, per, dtype, x, cond, cot, pairs)
    tmpl = _port_template(kind, pairs, dtype)
    calls = (fused_template_plain.calls, fused_template_bwd_plain.calls)
    xt = torch.from_numpy(x).requires_grad_()
    ct = torch.from_numpy(cond).requires_grad_()
    out = fused_template(tmpl, xt, ct)
    params = common.layer_params(template_layers(tmpl.template))
    grads = torch.autograd.grad(out, [xt, ct] + params, torch.from_numpy(cot))
    assert (fused_template_plain.calls, fused_template_bwd_plain.calls) == (
        calls[0] + 1, calls[1] + 1)
    _assert_close(out.detach().numpy(), want_out, dtype, 'out')
    assert len(grads) == len(want_grads) == 2 + 2 * len(pairs)
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        _assert_close(g.numpy(), w, dtype, f'grad {i}')
    if kind == 'static':  # nothing flows to the unused raw columns
        assert (grads[0][:, 3:] == 0).all()


@pytest.mark.parametrize('kind', sorted(SEGMENTS))
def test_plain_template_backward_matches_autograd(kind):
    """At float32 the explicit backward is the autograd of the plain
    forward."""
    x, cond, cot, pairs = _setup(kind, 8, seed=1)
    tmpl = _port_template(kind, pairs, 'float32')
    xt = torch.from_numpy(x).requires_grad_()
    ct = torch.from_numpy(cond).requires_grad_()
    params = common.layer_params(template_layers(tmpl.template))
    want = torch.autograd.grad(fused_template_plain(tmpl, xt, ct),
                               [xt, ct] + params, torch.from_numpy(cot))
    with torch.no_grad():
        dx, d_cond, grads = fused_template_bwd_plain(
            tmpl, xt.detach(), ct.detach(), torch.from_numpy(cot))
    for a, b in zip([dx, d_cond, *grads], want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))


def test_static_template_packs_zero_columns_for_the_hyper_bands():
    """A template without hyper coordinates is packed into the layout the
    kernels are compiled for (a 128-column encoding): its 63 encoded inputs
    first, zero weight columns where the hyper bands and the padding would
    be, in layer 0 and after the skip; unpacking a gradient drops those
    columns again."""
    from hypernerf_tpu_torch.flagship import flagship_model
    static = flagship_model('cpu', config='static').nerf_coarse
    full = flagship_model('cpu').nerf_coarse
    want_shapes = common.pack_layers(full, template_layers(full))[2]
    layers = template_layers(static, enc_pad=128)
    w_blob, b_blob, shapes = common.pack_layers(static, layers)
    assert shapes == want_shapes and shapes[0] == (256, 128)
    assert shapes[5] == (256, 256 + 128)
    w0 = w_blob[:256 * 128].view(256, 128).float()
    assert torch.equal(w0[:, :63],
                       static.trunk.hidden_0.weight.bfloat16().float())
    assert (w0[:, 63:] == 0).all()
    at = sum(n * k for n, k in shapes[:5])
    w5 = w_blob[at:at + 256 * 384].view(256, 384).float()
    assert torch.equal(w5[:, 256:256 + 63],
                       static.trunk.hidden_5.weight[:, 256:].bfloat16().float())
    assert (w5[:, 256 + 63:] == 0).all()
    n_w = sum(n * k for n, k in shapes)
    grads = common.unpack_grads(torch.randn(n_w), torch.randn(b_blob.numel()),
                                layers, shapes)
    for g, p in zip(grads, common.layer_params(layers)):
        assert g.shape == p.shape


def test_shared_fields_are_packed_once_for_both_levels():
    """The warp field and the sheet are shared by the coarse and the fine
    level: each module owns its packed blobs, both levels' joined blobs are
    built from the same ones, and all follow the parameters' version
    counters."""
    from hypernerf_tpu_torch.flagship import flagship_model
    from hypernerf_tpu_torch.kernels.fused_level import pack_level
    model = flagship_model('cpu', seed=0)
    coarse, fine = model.level('coarse'), model.level('fine')
    w_c, _, shapes = pack_level(coarse)
    warp_blob = model.warp_field.mlp._packed['w']
    w_f, _, _ = pack_level(fine)
    assert model.warp_field.mlp._packed['w'] is warp_blob  # not repacked
    n_fields = sum(n * k for n, k in shapes[:14])
    assert torch.equal(w_c[:n_fields], w_f[:n_fields])
    assert torch.equal(w_c[:warp_blob.numel()], warp_blob)
    assert not torch.equal(w_c[n_fields:], w_f[n_fields:])
    with torch.no_grad():
        model.warp_field.mlp.logit.weight.add_(0.5)
    w_c2, _, _ = pack_level(coarse)
    w_f2, _, _ = pack_level(fine)
    fresh = pack_level(copy.deepcopy(model).level('fine'))[0]
    assert not torch.equal(w_c2, w_c) and torch.equal(w_f2, fresh)
    assert torch.equal(w_c2[n_fields:], w_c[n_fields:])


@pytest.mark.parametrize('case', ['template', 'template_static',
                                  'template_s1'])
def test_stored_jax_template_reference(case):
    """tests/data/fused_modular_jax_ref.npz, what chip_smoke.py holds the
    CUDA template kernels to on the card: the case's numbers are the JAX
    kernel's (interpret mode, flagship widths, bf16) at the numpy probe
    weights and the stored inputs, recomputed here, and the port's plain
    versions match them within the bf16 tolerances above."""
    from hypernerf_tpu_torch.flagship import (MODULAR_REFERENCE_CASES,
                                              flagship_model,
                                              load_probe_weights,
                                              modular_probe_inputs,
                                              read_modular_reference)
    from tools.make_level_reference import jax_modular
    _, config, level, rows, per, _ = MODULAR_REFERENCE_CASES[case]
    stored = read_modular_reference()[case]
    inputs = modular_probe_inputs(case)
    for k, v in inputs.items():
        np.testing.assert_array_equal(stored[k], v)
    assert stored['rgb_cond'].shape == (rows // per, 39)
    model = load_probe_weights(flagship_model('cpu', config=config))
    again = jax_modular(model, case, inputs)
    assert sorted(again) == sorted(k for k in stored if k not in inputs)
    cfg = model.config
    tmpl = Template(getattr(model, f'nerf_{level}'), cfg.xyz_freq,
                    cfg.hyper_freq)
    x = torch.from_numpy(stored['x_raw']).requires_grad_()
    cond = torch.from_numpy(stored['rgb_cond']).requires_grad_()
    out = fused_template(tmpl, x, cond)
    params = common.layer_params(template_layers(tmpl.template))
    grads = torch.autograd.grad(out, [x, cond] + params,
                                torch.from_numpy(stored['cotangent']))
    names = ['dx', 'd_rgb_cond'] + [f'd{"wb"[i % 2]}{i // 2}'
                                    for i in range(len(params))]
    port = dict(zip(names, (g.numpy() for g in grads)),
                out=out.detach().numpy())
    for got in (again, port):
        for k, v in got.items():
            _assert_close(v, stored[k], 'bfloat16',
                          'out' if k == 'out' else k)
