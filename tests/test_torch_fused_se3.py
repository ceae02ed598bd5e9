"""The SE(3) / quaternion field's trunk alone: the port's plain forward and
plain backward (``kernels/fused_se3.py``, what its wrapper runs on CPU
tensors) against the JAX Pallas kernel ``fused_se3_wv`` (interpret mode) and
its VJP, on the same numpy inputs and weights.

Cases: a small trunk (depth 2, width 16, 4 bands), one whose last hidden layer
has the skip (the trunk logit then reads [h | enc]), a non-zero ``min_deg``,
and the flagship's widths (6 x 128, 8 bands) on a few hundred rows; the window
row on and off; a JAX backward tile that differs from the forward tile and a
row count that is a multiple of neither.

Tolerances. float32: rtol 2e-4, atol 2e-5 on outputs and gradients (same fp32
math, other summation order; gradients against each one's largest entry).
bfloat16: both round at the same points, so they differ only where a last-bit
fp32 difference moves a value across a bf16 rounding boundary: outputs
2e-2; gradients relative L2 5e-2 and 0.25 of the largest entry (the JAX kernel
also rounds its finished dW / db to bf16, where the port keeps fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.ops.pallas.fused_field import \
    encoding_scales as jax_encoding_scales
from hypernerf_tpu.ops.pallas.fused_se3 import FusedSE3Spec
from hypernerf_tpu.ops.pallas.fused_se3 import fused_se3_wv as jax_se3_wv
from hypernerf_tpu_torch.kernels import (fused_se3_bwd_plain, fused_se3_plain,
                                         fused_se3_wv)
from hypernerf_tpu_torch.kernels.common import layer_params
from hypernerf_tpu_torch.kernels.fused_se3 import (se3_encoding_scales,
                                                   se3_layers)
from hypernerf_tpu_torch.models.modules import torch_dtype
from hypernerf_tpu_torch.models.warping import SE3Field

E = 8
# name -> (rows, min_deg, max_deg, depth, width, skips, JAX tile, bwd tile)
TRUNKS = {'small': (50, 0, 4, 2, 16, (0,), 16, 32),
          'skip_last': (50, 0, 4, 3, 16, (2,), 16, 32),
          'min_deg': (44, 1, 4, 2, 16, (0,), 8, 16),
          'flagship': (300, 0, 8, 6, 128, (4,), 128, 64)}
ALPHA = 2.4  # the window: bands 0 and 1 on, band 2 partly, band 3 off


def _setup(name, seed=0):
    """Numpy raw rows, cotangent (P, 6) and (W (in, out), b) pairs of a
    trunk in kernel order: hidden layers, trunk logit, w head, v head."""
    rows, min_deg, max_deg, depth, width, skips, _, _ = TRUNKS[name]
    rs = np.random.RandomState(seed)
    x = np.concatenate([rs.randn(rows, 3) * 0.5, rs.randn(rows, E) * 0.3],
                       1).astype(np.float32)
    enc = 6 * (max_deg - min_deg) + E
    pairs, ch = [], enc
    for i in range(depth):
        pairs.append(((rs.randn(ch, width) * np.sqrt(2.0 / ch)),
                      rs.randn(width) * 0.1))
        ch = width + (enc if i in skips else 0)
    pairs.append((rs.randn(ch, width) * np.sqrt(1.0 / ch),
                  rs.randn(width) * 0.1))
    for _ in range(2):
        pairs.append((rs.randn(width, 3) * 0.3, rs.randn(3) * 0.1))
    pairs = [(w.astype(np.float32), b.astype(np.float32)) for w, b in pairs]
    return x, rs.randn(rows, 6).astype(np.float32), pairs


def _spec(name, dtype, windowed, **kw):
    _, min_deg, max_deg, depth, width, skips, tile, bwd_tile = TRUNKS[name]
    return FusedSE3Spec(embed_ch=E, min_deg=min_deg, max_deg=max_deg,
                        depth=depth, width=width, skips=skips, tile=tile,
                        bwd_tile=bwd_tile, compute_dtype=dtype,
                        windowed=windowed, interpret=True)._replace(**kw)


def _port_field(name, pairs, dtype):
    _, min_deg, max_deg, depth, width, skips, _, _ = TRUNKS[name]
    field = SE3Field(E, depth, width, min_deg, max_deg, skips,
                     dtype=torch_dtype(dtype))
    with torch.no_grad():
        for (lin, _), (w, b) in zip(se3_layers(field), pairs):
            lin.weight.copy_(torch.from_numpy(w.T))
            lin.bias.copy_(torch.from_numpy(b))
    return field


def _jax(spec, x, cot, pairs):
    scales = jax_encoding_scales(spec.enc_segments,
                                 [jnp.float32(ALPHA), None]) \
        if spec.windowed else None

    def fn(x_raw, wbs):
        w, v = jax_se3_wv(spec, x_raw[:, :3], x_raw[:, 3:], wbs,
                          enc_scales=scales)
        return jnp.concatenate([w, v], -1)

    args = (jnp.asarray(x), [(jnp.asarray(w), jnp.asarray(b))
                             for w, b in pairs])
    out = jax.jit(fn)(*args)
    dx, dwb = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) * jnp.asarray(cot)),
                               argnums=(0, 1)))(*args)
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
        assert np.abs(got - want).max() <= 2e-2, (what,
                                                  np.abs(got - want).max())
    else:
        l2 = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)
        top = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
        assert l2 <= 5e-2 and top <= 0.25, (what, l2, top)


def _port(field, x, cot, scales):
    """([w | v], [dx, dW0, db0, ...]) through the wrapper and its autograd
    Function on CPU tensors (which take the plain versions)."""
    calls = (fused_se3_plain.calls, fused_se3_bwd_plain.calls)
    xt = torch.from_numpy(x).requires_grad_()
    out = torch.cat(fused_se3_wv(field, xt, scales), dim=-1)
    params = layer_params(se3_layers(field))
    grads = torch.autograd.grad(out, [xt] + params, torch.from_numpy(cot))
    assert (fused_se3_plain.calls,
            fused_se3_bwd_plain.calls) == (calls[0] + 1, calls[1] + 1)
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize('windowed', [False, True], ids=['plain', 'window'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('name', sorted(TRUNKS))
def test_plain_trunk_matches_jax_kernel(name, dtype, windowed):
    x, cot, pairs = _setup(name)
    want_out, want_grads = _jax(_spec(name, dtype, windowed), x, cot, pairs)
    field = _port_field(name, pairs, dtype)
    scales = se3_encoding_scales(field, ALPHA) if windowed else None
    out, grads = _port(field, x, cot, scales)
    _assert_close(out, want_out, dtype, 'out')
    assert len(grads) == len(want_grads) == 1 + 2 * len(pairs)
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        _assert_close(g, w, dtype, f'grad {i}')


@pytest.mark.parametrize('tile,bwd_tile', [(16, 16), (32, 16), (8, 24)])
def test_jax_tiles_do_not_move_the_reference(tile, bwd_tile):
    """The JAX kernel's numbers at other forward / backward tile heights (the
    row count, 50, is a multiple of none; a JAX gradient fault once showed
    only where they differ) are the ones the port matches."""
    x, cot, pairs = _setup('small', seed=2)
    spec = _spec('small', 'float32', True, tile=tile, bwd_tile=bwd_tile)
    want_out, want_grads = _jax(spec, x, cot, pairs)
    field = _port_field('small', pairs, 'float32')
    out, grads = _port(field, x, cot, se3_encoding_scales(field, ALPHA))
    _assert_close(out, want_out, 'float32', 'out')
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        _assert_close(g, w, 'float32', f'grad {i}')


def test_window_row_of_ones_is_no_window():
    x, _, pairs = _setup('small')
    field = _port_field('small', pairs, 'bfloat16')
    ones = se3_encoding_scales(field, None)
    assert ones.shape == (6 * 4 + E,) and (ones == 1).all()
    with torch.no_grad():
        a = fused_se3_plain(field, torch.from_numpy(x), ones)
        b = fused_se3_plain(field, torch.from_numpy(x))
    assert torch.equal(a, b)
    want = np.asarray(jax_encoding_scales(((3, 4, 0, False), (E, 0)),
                                          [jnp.float32(ALPHA), None]))[0]
    got = se3_encoding_scales(field, ALPHA).numpy()
    np.testing.assert_allclose(got, want[:got.shape[0]], rtol=0, atol=1e-6)


@pytest.mark.parametrize('windowed', [False, True], ids=['plain', 'window'])
@pytest.mark.parametrize('name', ['small', 'skip_last', 'min_deg'])
def test_plain_trunk_backward_matches_autograd(name, windowed):
    """At float32 the explicit backward is the autograd of the plain
    forward."""
    x, cot, pairs = _setup(name, seed=1)
    field = _port_field(name, pairs, 'float32')
    scales = se3_encoding_scales(field, ALPHA) if windowed else None
    xt = torch.from_numpy(x).requires_grad_()
    params = layer_params(se3_layers(field))
    want = torch.autograd.grad(fused_se3_plain(field, xt, scales),
                               [xt] + params, torch.from_numpy(cot))
    with torch.no_grad():
        g = torch.nn.functional.pad(torch.from_numpy(cot), (0, 2))
        dx, grads = fused_se3_bwd_plain(field, xt.detach(), g, scales)
    for a, b in zip([dx, *grads], want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize('kind', ['se3', 'quaternion'])
def test_fields_take_the_dense_code_on_cpu_tensors(kind):
    """The field module on CPU tensors equals the plain trunk followed by the
    retraction, and the embedding's gradient through a broadcast view is
    summed per ray."""
    from hypernerf_tpu_torch.models.warping import WARP_FIELDS
    torch.manual_seed(0)
    rays, samples = 5, 6
    field = WARP_FIELDS[kind](E, 2, 16, 0, 4, (0,))
    with torch.no_grad():
        for head in (field.w_net, field.v_net):
            head.logit.weight.mul_(3e3)
    pts = torch.randn(rays, samples, 3)
    emb = (torch.randn(rays, E) * 0.3).requires_grad_()
    emb_b = emb[:, None, :].expand(rays, samples, E)
    raw = torch.cat([pts, emb_b], -1).reshape(-1, 3 + E)
    scales = se3_encoding_scales(field, ALPHA)
    with torch.no_grad():
        wv = fused_se3_plain(field, raw, scales)
        want = field.retract(wv[:, :3], wv[:, 3:], raw[:, :3]).reshape(
            rays, samples, 3)
    got = field(pts, emb_b, {'warp_alpha': ALPHA})
    assert (want - pts).abs().max() > 1e-2
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    d_emb, = torch.autograd.grad(got.sum(), emb)
    assert d_emb.shape == (rays, E) and d_emb.abs().min() > 0


def test_cuda_kernels_cover_the_flagship_trunk_only():
    """What the wrappers would refuse on a CUDA tensor is decided by a check
    that runs on the CPU too."""
    from hypernerf_tpu_torch.kernels.fused_se3 import check_covered
    check_covered(SE3Field(E, dtype=torch.bfloat16))
    check_covered(SE3Field(E, dtype=torch.float32))  # the float32 trunk
    for bad in (SE3Field(E, max_deg=6, dtype=torch.float32),
                SE3Field(E, max_deg=6, dtype=torch.bfloat16),
                SE3Field(E, min_deg=1, max_deg=9, dtype=torch.bfloat16),
                SE3Field(4, dtype=torch.bfloat16),
                SE3Field(E, skips=(3,), dtype=torch.bfloat16)):
        with pytest.raises(NotImplementedError, match='A.13'):
            check_covered(bad)


@pytest.mark.parametrize('case', ['trunk', 'trunk_window'])
def test_stored_jax_trunk_reference(case):
    """tests/data/fused_se3_jax_ref.npz, what chip_smoke.py holds the CUDA
    trunk kernels to on the card: the case's numbers are the JAX kernel's
    (interpret mode, flagship widths, bf16) at the numpy probe weights and
    the stored inputs, recomputed here, and the port's plain versions match
    them within the bf16 tolerances above."""
    from hypernerf_tpu_torch.flagship import (SE3_TRUNK_CASES, flagship_model,
                                              load_probe_weights,
                                              read_se3_reference,
                                              se3_probe_inputs)
    from tools.make_level_reference import jax_se3_trunk
    rows, alpha, _ = SE3_TRUNK_CASES[case]
    stored = read_se3_reference()[case]
    inputs = se3_probe_inputs(case)
    for k, v in inputs.items():
        np.testing.assert_array_equal(stored[k], v)
    model = load_probe_weights(flagship_model('cpu', config='se3'))
    again = jax_se3_trunk(model, inputs, alpha)
    assert sorted(again) == sorted(k for k in stored if k not in inputs)
    field = model.warp_field
    scales = None if alpha is None else se3_encoding_scales(field, alpha)
    out, grads = _port(field, stored['x_raw'].copy(),
                       stored['cotangent'][:, :6].copy(), scales)
    assert out.shape == (rows, 6)
    # Rotations of the order the probe weights promise.
    assert 0.1 < np.linalg.norm(out[:, :3], axis=-1).mean() < 1.0
    names = ['dx'] + [f'd{"wb"[i % 2]}{i // 2}' for i in range(18)]
    port = dict(zip(names, grads), out=out)
    for got in (again, port):
        for k, v in got.items():
            _assert_close(v, stored[k], 'bfloat16',
                          'out' if k == 'out' else k)
