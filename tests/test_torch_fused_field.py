"""A field MLP alone: the port's plain forward and plain backward
(``kernels/fused_field.py``, what its wrapper runs on CPU tensors) against
the JAX Pallas kernel ``fused_field_mlp`` (interpret mode) and its VJP, on
the same numpy inputs and weights.

Cases: a warp-like field (3 outputs) and a sheet-like one (4 outputs, fewer
bands), a skip after the last hidden layer (the head then reads [h | enc]),
the window row on and off, and a row count (50) that is a multiple of neither
the JAX forward tile (16) nor its backward tile (32), which differ.

Tolerances. float32: rtol 2e-4, atol 2e-5 on outputs and gradients (same fp32
math, other summation order; gradients against each one's largest entry).
bfloat16: both round at the same points, so they differ only where a last-bit
fp32 difference moves a value across a bf16 rounding boundary: outputs
1e-2 + 1e-2 |x|; gradients relative L2 5e-2 and 0.25 of the largest entry
(the JAX kernel also rounds its finished dW / db to bf16, where the port
keeps fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.ops.pallas.fused_field import (FusedFieldSpec,
                                                  fused_field_mlp)
from hypernerf_tpu.ops.pallas.fused_field import \
    encoding_scales as jax_encoding_scales
from hypernerf_tpu_torch.kernels import (fused_field, fused_field_bwd_plain,
                                         fused_field_plain)
from hypernerf_tpu_torch.kernels.common import layer_params
from hypernerf_tpu_torch.kernels.fused_field import (encoding_scales,
                                                     field_layers)
from hypernerf_tpu_torch.models.modules import MLP, torch_dtype

P, E = 50, 8
# name -> (bands, depth, width, outputs, skips)
FIELDS = {'warp': (4, 3, 16, 3, (1,)),
          'sheet': (3, 3, 16, 4, (1,)),
          'skip_last': (4, 3, 16, 3, (2,))}
ALPHA = 2.4  # the window: bands 0 and 1 on, band 2 partly, band 3 off


def _setup(name, seed=0):
    """Numpy raw rows, cotangent and (W (in, out), b) pairs of a field."""
    n_freq, depth, width, out_ch, skips = FIELDS[name]
    rs = np.random.RandomState(seed)
    x = np.concatenate([rs.randn(P, 3) * 0.7, rs.randn(P, E) * 0.3],
                       1).astype(np.float32)
    enc = 3 * (1 + 2 * n_freq) + E
    pairs, ch = [], enc
    for i in range(depth):
        pairs.append(((rs.randn(ch, width) * np.sqrt(2.0 / ch)),
                      rs.randn(width) * 0.1))
        ch = width + (enc if i in skips else 0)
    pairs.append((rs.randn(ch, out_ch) * 0.3, rs.randn(out_ch) * 0.1))
    pairs = [(w.astype(np.float32), b.astype(np.float32)) for w, b in pairs]
    return x, rs.randn(P, out_ch).astype(np.float32), pairs


def _spec(name, dtype, windowed):
    n_freq, depth, width, out_ch, skips = FIELDS[name]
    return FusedFieldSpec(segments=((3, n_freq), (E, 0)), depth=depth,
                          width=width, out_ch=out_ch, skips=skips, tile=16,
                          bwd_tile=32, compute_dtype=dtype, windowed=windowed,
                          interpret=True)


def _port_mlp(name, pairs, dtype):
    n_freq, depth, width, out_ch, skips = FIELDS[name]
    mlp = MLP(3 * (1 + 2 * n_freq) + E, out_ch, depth, width, skips,
              dtype=torch_dtype(dtype))
    with torch.no_grad():
        for (lin, _), (w, b) in zip(field_layers(mlp), pairs):
            lin.weight.copy_(torch.from_numpy(w.T))
            lin.bias.copy_(torch.from_numpy(b))
    return mlp, n_freq


def _jax(name, dtype, windowed, x, cot, pairs):
    spec = _spec(name, dtype, windowed)
    scales = jax_encoding_scales(spec.segments, [jnp.float32(ALPHA), None]) \
        if windowed else None

    def fn(x_raw, wbs):
        return fused_field_mlp(spec, x_raw, wbs, enc_scales=scales)

    args = (jnp.asarray(x), [(jnp.asarray(w), jnp.asarray(b))
                             for w, b in pairs])
    out = fn(*args)
    dx, dwb = jax.grad(lambda *a: jnp.sum(fn(*a) * jnp.asarray(cot)),
                       argnums=(0, 1))(*args)
    grads = [np.asarray(dx)]
    for dw, db in dwb:
        grads += [np.asarray(dw).T, np.asarray(db)]
    return np.asarray(out), grads


def _assert_close(got, want, dtype, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dtype == 'float32':
        scale = max(np.abs(want).max(), 1.0) if what == 'out' else max(
            np.abs(want).max(), 1e-12)
        err = np.abs(got - want) / scale
        assert (err <= 2e-5 + 2e-4 * np.abs(want) / scale).all(), \
            (what, err.max())
    elif what == 'out':
        assert (np.abs(got - want) <= 1e-2 + 1e-2 * np.abs(want)).all(), \
            (what, np.abs(got - want).max())
    else:
        l2 = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)
        top = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
        assert l2 <= 5e-2 and top <= 0.25, (what, l2, top)


@pytest.mark.parametrize('windowed', [False, True], ids=['plain', 'window'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('name', sorted(FIELDS))
def test_plain_field_matches_jax_kernel(name, dtype, windowed):
    """Forward and backward, through the wrapper and its autograd Function
    on CPU tensors (which take the plain versions)."""
    x, cot, pairs = _setup(name)
    want_out, want_grads = _jax(name, dtype, windowed, x, cot, pairs)
    mlp, n_freq = _port_mlp(name, pairs, dtype)
    scales = encoding_scales(n_freq, E, ALPHA) if windowed else None
    calls = (fused_field_plain.calls, fused_field_bwd_plain.calls)
    xt = torch.from_numpy(x).requires_grad_()
    out = fused_field(mlp, n_freq, xt, scales)
    params = layer_params(field_layers(mlp))
    grads = torch.autograd.grad(out, [xt] + params, torch.from_numpy(cot))
    assert (fused_field_plain.calls,
            fused_field_bwd_plain.calls) == (calls[0] + 1, calls[1] + 1)
    _assert_close(out.detach().numpy(), want_out, dtype, 'out')
    assert len(grads) == len(want_grads) == 1 + 2 * len(pairs)
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        _assert_close(g.numpy(), w, dtype, f'grad {i}')


def test_window_row_matches_jax():
    for n_freq, alpha in ((4, 0.0), (4, 2.4), (7, 3.25), (10, 10.0)):
        want = np.asarray(jax_encoding_scales(((3, n_freq), (E, 0)),
                                              [jnp.float32(alpha), None]))
        got = encoding_scales(n_freq, E, alpha).numpy()
        assert got.shape == (3 * (1 + 2 * n_freq) + E,)
        np.testing.assert_allclose(got, want[0, :got.shape[0]], rtol=0,
                                   atol=1e-6)
        assert (want[0, got.shape[0]:] == 0).all()


@pytest.mark.parametrize('windowed', [False, True], ids=['plain', 'window'])
def test_plain_field_backward_matches_autograd(windowed):
    """At float32 the explicit backward is the autograd of the plain
    forward."""
    x, cot, pairs = _setup('skip_last', seed=1)
    mlp, n_freq = _port_mlp('skip_last', pairs, 'float32')
    scales = encoding_scales(n_freq, E, ALPHA) if windowed else None
    xt = torch.from_numpy(x).requires_grad_()
    params = layer_params(field_layers(mlp))
    want = torch.autograd.grad(fused_field_plain(mlp, n_freq, xt, scales),
                               [xt] + params, torch.from_numpy(cot))
    with torch.no_grad():
        g = torch.nn.functional.pad(torch.from_numpy(cot), (0, 5))
        dx, grads = fused_field_bwd_plain(mlp, n_freq, xt.detach(), g, scales)
    for a, b in zip([dx, *grads], want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))


def test_modules_take_the_dense_code_on_cpu_tensors():
    """``TranslationField`` and ``HyperSheetMLP`` (with its residual) on CPU
    tensors equal the plain field forward, and the embedding's gradient
    through a broadcast view is summed per ray."""
    from hypernerf_tpu_torch.models.modules import HyperSheetMLP
    from hypernerf_tpu_torch.models.warping import TranslationField
    torch.manual_seed(0)
    rays, samples = 5, 6
    warp = TranslationField(E, 3, 16, 4, (1,))
    sheet = HyperSheetMLP(E, E, 3, 16, 3, (1,), use_residual=True)
    pts = torch.randn(rays, samples, 3)
    emb = (torch.randn(rays, E) * 0.3).requires_grad_()
    emb_b = emb[:, None, :].expand(rays, samples, E)
    raw = torch.cat([pts, emb_b], -1).reshape(-1, 3 + E)
    with torch.no_grad():
        want_w = pts + fused_field_plain(warp.mlp, 4, raw).reshape(
            rays, samples, 3)
        want_h = fused_field_plain(sheet.mlp, 3, raw).reshape(
            rays, samples, E) + emb_b
    np.testing.assert_allclose(warp(pts, emb_b).detach().numpy(),
                               want_w.numpy(), rtol=1e-5, atol=1e-6)
    hyper = sheet(pts, emb_b)
    np.testing.assert_allclose(hyper.detach().numpy(), want_h.numpy(),
                               rtol=1e-5, atol=1e-6)
    d_emb, = torch.autograd.grad(hyper.sum(), emb)
    assert d_emb.shape == (rays, E) and d_emb.abs().min() > 0


@pytest.mark.parametrize('case', ['warp', 'warp_window', 'sheet',
                                  'sheet_window'])
def test_stored_jax_field_reference(case):
    """tests/data/fused_modular_jax_ref.npz, what chip_smoke.py holds the
    CUDA field kernels to on the card: the case's numbers are the JAX kernel's
    (interpret mode, flagship widths, bf16) at the numpy probe weights and
    the stored inputs, recomputed here, and the port's plain versions match
    them within the bf16 tolerances above."""
    from hypernerf_tpu_torch.flagship import (MODULAR_REFERENCE_CASES,
                                              flagship_model,
                                              load_probe_weights,
                                              modular_probe_inputs,
                                              read_modular_reference)
    from tools.make_level_reference import jax_modular
    _, config, module, rows, alpha, _ = MODULAR_REFERENCE_CASES[case]
    stored = read_modular_reference()[case]
    inputs = modular_probe_inputs(case)
    for k, v in inputs.items():
        np.testing.assert_array_equal(stored[k], v)
    model = load_probe_weights(flagship_model('cpu', config=config))
    again = jax_modular(model, case, inputs)
    assert sorted(again) == sorted(k for k in stored if k not in inputs)
    field = getattr(model, module)
    scales = None if alpha is None else encoding_scales(field.n_freq, E,
                                                        alpha)
    x = torch.from_numpy(stored['x_raw']).requires_grad_()
    out = fused_field(field.mlp, field.n_freq, x, scales)
    assert out.shape == (rows, field.mlp.logit.out_features)
    params = layer_params(field_layers(field.mlp))
    grads = torch.autograd.grad(
        out, [x] + params,
        torch.from_numpy(stored['cotangent'][:, :out.shape[1]]))
    names = ['dx'] + [f'd{"wb"[i % 2]}{i // 2}' for i in range(len(params))]
    port = dict(zip(names, (g.numpy() for g in grads)),
                out=out.detach().numpy())
    for got in (again, port):
        for k, v in got.items():
            _assert_close(v, stored[k], 'bfloat16',
                          'out' if k == 'out' else k)
