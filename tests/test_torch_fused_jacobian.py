"""The warp-Jacobian kernels' plain versions against the JAX Pallas kernels
(interpret mode) on the same numpy inputs and weights: the translation warp's
Jacobian (``kernels/fused_jacobian.py`` against ``fused_warp_jacobian``), the
SE(3) trunk's (w, v) and point-tangents (``kernels/fused_se3_jacobian.py``
against ``fused_se3_wv_tangents``), forward and backward, and the
retraction's point-Jacobian (``ops.rigid_body.retraction_jacobian``, the
hand-derived VJP's rows) against the JAX side channel's ``jax.jvp`` of the
vector-form retraction, for the SE(3) and the quaternion warp.

Cases: a small field (depth 3, width 16, 4 bands, skip after layer 1); the
skip after the last hidden layer; point counts that are a multiple of neither
the JAX tile (8) nor the port's; the window row on and off; rows with w = 0
exactly; the init regime (|w| of 1e-3 to 1e-2) against a float64 evaluation.

Tolerances (those of ``tests/test_fused_jacobian.py`` and
``test_fused_se3_jacobian.py``; fp32 both ways, other summation orders):
outputs rtol 1e-5, atol 1e-6; gradients 2e-4 of each one's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.ops import quaternion as jax_quaternion
from hypernerf_tpu.ops import rigid_body as jax_rigid_body
from hypernerf_tpu.ops.pallas.fused_field import FusedFieldSpec
from hypernerf_tpu.ops.pallas.fused_field import \
    encoding_scales as jax_encoding_scales
from hypernerf_tpu.ops.pallas.fused_jacobian import \
    fused_warp_jacobian as jax_warp_jacobian
from hypernerf_tpu.ops.pallas.fused_se3 import FusedSE3Spec
from hypernerf_tpu.ops.pallas.fused_se3_jacobian import \
    fused_se3_wv_tangents as jax_wv_tangents
from hypernerf_tpu_torch import kernels as K
from hypernerf_tpu_torch.kernels.common import layer_params
from hypernerf_tpu_torch.kernels.fused_field import field_layers
from hypernerf_tpu_torch.kernels.fused_se3 import (se3_encoding_scales,
                                                   se3_layers)
from hypernerf_tpu_torch.models.warping import (QuaternionField, SE3Field,
                                                TranslationField)
from hypernerf_tpu_torch.ops import quaternion, rigid_body

E = 8
N_FREQ, DEPTH, WIDTH = 4, 3, 16
ALPHA = 2.3  # the SE(3) window: bands 0, 1 on, band 2 partly, band 3 off
RTOL, ATOL, GRAD_TOL = 1e-5, 1e-6, 2e-4


def _inputs(rows, seed, scale=0.4):
    rs = np.random.RandomState(seed)
    return np.concatenate([rs.randn(rows, 3) * scale,
                           rs.randn(rows, E) * 0.2], 1).astype(np.float32)


def _pairs(rs, enc, out_ch, skips, extra_logit=None):
    """(W (in, out), b) numpy pairs of a skip MLP on ``enc`` features."""
    pairs, ch = [], enc
    for i in range(DEPTH):
        pairs.append((rs.randn(ch, WIDTH) * np.sqrt(2.0 / ch),
                      rs.randn(WIDTH) * 0.1))
        ch = WIDTH + (enc if i in skips else 0)
    pairs.append((rs.randn(ch, out_ch) * (extra_logit or 0.3),
                  rs.randn(out_ch) * 0.1))
    return pairs


def _load(layers, pairs):
    with torch.no_grad():
        for (lin, _), (w, b) in zip(layers, pairs):
            lin.weight.copy_(torch.from_numpy(np.asarray(w, np.float32).T))
            lin.bias.copy_(torch.from_numpy(np.asarray(b, np.float32)))


def _jax_grads(fn, args, cot):
    """fn's output and the gradients of sum(fn * cot) for every argument,
    weights as (out, in) like ``nn.Linear``."""
    out = fn(*args)
    dx, dwb = jax.grad(lambda *a: jnp.sum(fn(*a) * jnp.asarray(cot)),
                       argnums=(0, 1))(*args)
    grads = [np.asarray(dx)]
    for dw, db in dwb:
        grads += [np.asarray(dw).T, np.asarray(db)]
    return np.asarray(out), grads


def _assert_close(got, want, what):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _assert_grads(got, want, names):
    assert len(got) == len(want)
    for name, a, b in zip(names, got, want):
        a = a.detach().numpy()
        assert a.shape == b.shape, (name, a.shape, b.shape)
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)
        assert err <= GRAD_TOL, (name, err)


# -- rows 14 and 15: the translation warp's Jacobian ------------------------


def _translation(skips, seed):
    rs = np.random.RandomState(seed)
    pairs = _pairs(rs, 3 * (1 + 2 * N_FREQ) + E, 3, skips)
    field = TranslationField(E, DEPTH, WIDTH, N_FREQ, skips)
    _load(field_layers(field.mlp), pairs)
    spec = FusedFieldSpec(segments=((3, N_FREQ), (E, 0)), depth=DEPTH,
                          width=WIDTH, out_ch=3, skips=skips, tile=8,
                          interpret=True, compute_dtype='float32')
    jpairs = [(jnp.asarray(w, jnp.float32), jnp.asarray(b, jnp.float32))
              for w, b in pairs]
    return field, spec, jpairs


@pytest.mark.parametrize('skips,rows', [((1,), 24), ((1,), 13),
                                        ((2,), 21)])
def test_translation_jacobian_matches_jax(skips, rows):
    field, spec, jpairs = _translation(skips, seed=rows)
    x = _inputs(rows, seed=rows + 1)
    cot = np.random.RandomState(rows + 2).randn(rows, 9).astype(np.float32)

    def fn(x_raw, wbs):
        return jax_warp_jacobian(spec, x_raw[:, :3], x_raw[:, 3:],
                                 wbs).reshape(-1, 9)

    want, want_grads = _jax_grads(fn, (jnp.asarray(x), jpairs), cot)
    x_t = torch.from_numpy(x)
    got = K.fused_jacobian_plain(field.mlp, N_FREQ, x_t)
    _assert_close(got, want, 'J')
    dx, grads = K.fused_jacobian_bwd_plain(field.mlp, N_FREQ, x_t,
                                           torch.from_numpy(cot))
    names = ['dx'] + [f'd{"Wb"[i % 2]}{i // 2}' for i in range(len(grads))]
    _assert_grads([dx, *grads], want_grads, names)
    # d embed and every db are exactly zero, on both sides.
    assert not dx[:, 3:].any() and not np.asarray(want_grads[0])[:, 3:].any()
    for db in grads[1::2]:
        assert not db.any()
    assert np.abs(want_grads[0][:, :3]).max() > 0


def test_translation_jacobian_wrapper_and_autograd():
    """The wrapper on CPU tensors: the plain versions through the autograd
    Function, J of the field's own forward (finite differences), and the
    identity at a zero head."""
    field, _, _ = _translation((1,), seed=5)
    x = torch.from_numpy(_inputs(7, seed=6)).double()
    field = field.double()
    field.mlp.dtype = torch.float64
    pts = x[:, :3].clone().requires_grad_()
    jac = field.jacobian(pts, x[:, 3:])
    assert jac.shape == (7, 3, 3)
    eps = 1e-6
    for k in range(3):
        step = torch.zeros(3, dtype=x.dtype)
        step[k] = eps
        with torch.no_grad():
            fd = (field(pts + step, x[:, 3:]) - field(pts - step, x[:, 3:]))
        np.testing.assert_allclose(jac[:, :, k].detach(), fd / (2 * eps),
                                   rtol=1e-6, atol=1e-8)
    params = layer_params(field_layers(field.mlp))
    grads = torch.autograd.grad(jac.square().sum(), [pts, *params])
    assert all(torch.isfinite(g).all() for g in grads)
    with torch.no_grad():
        field.mlp.logit.weight.zero_()
    eye = field.jacobian(pts.detach(), x[:, 3:])
    assert torch.equal(eye, torch.eye(3, dtype=x.dtype).expand(7, 3, 3))


# -- rows 16 and 17: the SE(3) trunk's primal outputs and tangents ---------


def _se3(skips, seed, cls=SE3Field):
    rs = np.random.RandomState(seed)
    enc = 6 * N_FREQ + E
    pairs = _pairs(rs, enc, WIDTH, skips, extra_logit=np.sqrt(1.0 / WIDTH))
    for _ in range(2):
        pairs.append((rs.randn(WIDTH, 3) * 0.3, rs.randn(3) * 0.1))
    field = cls(E, DEPTH, WIDTH, 0, N_FREQ, skips)
    _load(se3_layers(field), pairs)
    jpairs = [(jnp.asarray(w, jnp.float32), jnp.asarray(b, jnp.float32))
              for w, b in pairs]
    return field, jpairs


def _se3_spec(skips, windowed):
    return FusedSE3Spec(embed_ch=E, min_deg=0, max_deg=N_FREQ, depth=DEPTH,
                        width=WIDTH, skips=skips, tile=8, bwd_tile=8,
                        compute_dtype='float32', windowed=windowed,
                        interpret=True)


@pytest.mark.parametrize('skips,rows,windowed', [
    ((1,), 24, False), ((1,), 13, True), ((2,), 19, False)])
def test_se3_tangents_match_jax(skips, rows, windowed):
    field, jpairs = _se3(skips, seed=rows)
    spec = _se3_spec(skips, windowed)
    scales = (jax_encoding_scales(spec.enc_segments, [jnp.float32(ALPHA),
                                                      None])
              if windowed else None)
    x = _inputs(rows, seed=rows + 3)
    cot = np.random.RandomState(rows + 4).randn(rows, 24).astype(np.float32)

    def fn(x_raw, wbs):
        w, v, dw, dv = jax_wv_tangents(spec, x_raw[:, :3], x_raw[:, 3:], wbs,
                                       enc_scales=scales)
        n = x_raw.shape[0]
        return jnp.concatenate([w, v, dw.reshape(n, 9), dv.reshape(n, 9)],
                               -1)

    want, want_grads = _jax_grads(fn, (jnp.asarray(x), jpairs), cot)
    x_t = torch.from_numpy(x)
    t_scales = se3_encoding_scales(field, ALPHA) if windowed else None
    got = K.fused_se3_jacobian_plain(field, x_t, t_scales)
    _assert_close(got, want, 'w | v | dw | dv')
    dx, grads = K.fused_se3_jacobian_bwd_plain(field, x_t,
                                               torch.from_numpy(cot),
                                               t_scales)
    names = ['dx'] + [f'd{"Wb"[i % 2]}{i // 2}' for i in range(len(grads))]
    _assert_grads([dx, *grads], want_grads, names)
    # d embed flows through the primal stream: non-zero.
    assert dx[:, 3:].abs().max() > 0
    # The wrapper's autograd Function gives the same gradients.
    x_g = x_t.clone().requires_grad_()
    params = layer_params(se3_layers(field))
    out = torch.cat([t.reshape(rows, -1) for t in K.fused_se3_wv_tangents(
        field, x_g, t_scales)], -1)
    again = torch.autograd.grad(out, [x_g, *params], torch.from_numpy(cot))
    for a, b in zip(again, [dx, *grads]):
        assert torch.equal(a, b)


# -- the retraction's point-Jacobian ----------------------------------------

RETRACTIONS = {'se3': (rigid_body.se3_warp_vec_bwd,
                       jax_rigid_body.se3_warp_vec),
               'quaternion': (quaternion.quat_warp_vec_bwd,
                              jax_quaternion.quat_warp_vec)}


def _jax_retraction_jacobian(retract, w, v, p, dw, dv):
    """The JAX side channel's form (fused_se3_jacobian.py:418-431): one
    vmapped jax.jvp of the component-major retraction per tangent k."""
    twc = jnp.transpose(dw, (2, 1, 0))
    tvc = jnp.transpose(dv, (2, 1, 0))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=p.dtype)[:, :, None],
                           (3, 3, p.shape[0]))
    cols = jax.vmap(lambda a, b, c: jax.jvp(
        lambda w_, v_, p_: retract(w_, v_, p_, axis=0), (w.T, v.T, p.T),
        (a, b, c))[1])(twc, tvc, eye)
    return jnp.transpose(cols, (2, 1, 0))


def _retraction_inputs(n, seed, w_scale=0.5):
    rs = np.random.RandomState(seed)
    w = rs.randn(n, 3) * w_scale
    v = rs.randn(n, 3) * 0.3
    p = rs.randn(n, 3) * 0.5
    dw = rs.randn(n, 3, 3) * 0.4
    dv = rs.randn(n, 3, 3) * 0.4
    return [a.astype(np.float32) for a in (w, v, p, dw, dv)]


@pytest.mark.parametrize('kind', ['se3', 'quaternion'])
def test_retraction_jacobian_matches_jax_jvp(kind):
    """theta of order 0.1 to 1 (the probe weights' regime): values and
    gradients of a loss on J against autodiff of the JAX form."""
    bwd, retract = RETRACTIONS[kind]
    args = _retraction_inputs(40, seed=3)
    cot = np.random.RandomState(4).randn(40, 3, 3).astype(np.float32)
    theta = np.linalg.norm(args[0], axis=-1)
    assert 0.05 < theta.min() and theta.max() < 3.0
    jargs = [jnp.asarray(a) for a in args]
    want = _jax_retraction_jacobian(retract, *jargs)
    want_grads = jax.grad(lambda *a: jnp.sum(
        _jax_retraction_jacobian(retract, *a) * cot),
        argnums=tuple(range(5)))(*jargs)
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    got = rigid_body.retraction_jacobian(bwd, *targs)
    _assert_close(got.detach(), np.asarray(want), 'J')
    grads = torch.autograd.grad(got, targs, torch.from_numpy(cot),
                                allow_unused=True)
    # The quaternion warp's J does not depend on v.
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, targs)]
    _assert_grads(grads, [np.asarray(g) for g in want_grads],
                  ['dw', 'dv', 'dp', 'd dw', 'd dv'])


@pytest.mark.parametrize('kind', ['se3', 'quaternion'])
def test_retraction_jacobian_at_w_zero(kind):
    """Rows with w = 0 exactly: J = I + DV (the retraction is p + v there),
    as the JAX form gives, and every gradient is finite; w's own gradient
    from those rows is zero."""
    bwd, retract = RETRACTIONS[kind]
    args = _retraction_inputs(12, seed=5)
    args[0][::2] = 0.0
    want = np.asarray(_jax_retraction_jacobian(
        retract, *[jnp.asarray(a) for a in args]))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    got = rigid_body.retraction_jacobian(bwd, *targs)
    _assert_close(got.detach(), want, 'J')
    np.testing.assert_allclose(got.detach()[::2],
                               np.eye(3) + args[4][::2], rtol=0, atol=1e-7)
    grads = torch.autograd.grad(got.square().sum(), targs, allow_unused=True)
    assert all(g is None or torch.isfinite(g).all() for g in grads)
    assert not grads[0][::2].any()


@pytest.mark.parametrize('kind', ['se3', 'quaternion'])
def test_retraction_jacobian_init_regime_against_float64(kind):
    """|w| of 1e-3 to 1e-2, where the heads start (U(0, 1e-4) weights, zero
    bias): J and its gradients from fp32 inputs against the same function on
    float64 inputs. The port evaluates it in float64 inside, so the two
    differ by the rounding of the inputs and outputs alone: J within 1e-6,
    gradients within 1e-5 of the largest entry. In fp32 the same function
    missed J by 6.8e-3 and d w by several times its size (SE(3))."""
    bwd = RETRACTIONS[kind][0]
    args = _retraction_inputs(64, seed=6, w_scale=1.0)
    theta = np.linalg.norm(args[0], axis=-1, keepdims=True)
    args[0] = args[0] / theta * np.geomspace(1e-3, 1e-2, 64)[:, None]
    args[0] = args[0].astype(np.float32)
    cot = torch.from_numpy(np.random.RandomState(7).randn(64, 3, 3))

    def run(dtype):
        targs = [torch.from_numpy(a).to(dtype).requires_grad_()
                 for a in args]
        jac = rigid_body.retraction_jacobian(bwd, *targs)
        grads = torch.autograd.grad(jac, targs, cot.to(dtype),
                                    allow_unused=True)
        return jac, [g for g in grads if g is not None]

    j32, g32 = run(torch.float32)
    j64, g64 = run(torch.float64)
    assert j32.dtype == torch.float32 and torch.isfinite(j32).all()
    assert all(torch.isfinite(g).all() for g in g32)
    assert (j32.double() - j64).abs().max() <= 1e-6 * j64.abs().max()
    for a, b in zip(g32, g64):
        assert (a.double() - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.parametrize('cls', [SE3Field, QuaternionField])
def test_field_jacobian_matches_finite_differences(cls):
    """``SE3Field.jacobian`` (tangents, then the retraction's Jacobian) on
    CPU tensors in float64 against central differences of the field's own
    forward, with and without a window."""
    field, _ = _se3((1,), seed=9, cls=cls)
    field = field.double()
    for m in (field.trunk, field.w_net, field.v_net):
        m.dtype = torch.float64
    x = torch.from_numpy(_inputs(9, seed=10)).double()
    for extra in (None, {'warp_alpha': ALPHA}):
        jac = field.jacobian(x[:, :3], x[:, 3:], extra)
        eps = 1e-6
        for k in range(3):
            step = torch.zeros(3, dtype=x.dtype)
            step[k] = eps
            with torch.no_grad():
                fd = (field(x[:, :3] + step, x[:, 3:], extra)
                      - field(x[:, :3] - step, x[:, 3:], extra))
            np.testing.assert_allclose(jac[:, :, k].detach(), fd / (2 * eps),
                                       rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize('case', ['translation', 'se3', 'se3_window'])
def test_stored_jax_jacobian_reference(case):
    """tests/data/fused_jacobian_jax_ref.npz, what chip_smoke.py holds the
    CUDA Jacobian kernels to on the card: the case's numbers are the JAX
    kernel's (interpret mode, flagship widths, bf16) at the numpy probe
    weights and the stored inputs, recomputed here, and the port's plain
    versions match them where both round at the same points: relative L2
    1e-2 on every output and gradient (a last-bit fp32 difference moves a
    bf16 rounding, and the 2^9 band amplifies it)."""
    from hypernerf_tpu_torch.flagship import (JACOBIAN_CASES, flagship_model,
                                              jacobian_probe_inputs,
                                              load_probe_weights,
                                              read_jacobian_reference)
    from tools.make_level_reference import jax_jacobian
    config, rows, alpha, _ = JACOBIAN_CASES[case]
    stored = read_jacobian_reference()[case]
    inputs = jacobian_probe_inputs(case)
    for k, v in inputs.items():
        np.testing.assert_array_equal(stored[k], v)
    model = load_probe_weights(flagship_model('cpu', config=config))
    again = jax_jacobian(model, case, inputs)
    assert sorted(again) == sorted(k for k in stored if k not in inputs)
    x = torch.from_numpy(stored['x_raw'].copy())
    g = torch.from_numpy(stored['cotangent'].copy())
    with torch.no_grad():
        if config == 'flagship':
            mlp = model.warp_field.mlp
            out = K.fused_jacobian_plain(mlp, 10, x)
            dx, grads = K.fused_jacobian_bwd_plain(mlp, 10, x, g)
            # The probe's head moves J well away from the identity.
            assert (out.reshape(-1, 3, 3) - torch.eye(3)).abs().mean() > 0.1
        else:
            field = model.warp_field
            scales = None if alpha is None else se3_encoding_scales(field,
                                                                    alpha)
            out = K.fused_se3_jacobian_plain(field, x, scales)
            dx, grads = K.fused_se3_jacobian_bwd_plain(field, x, g, scales)
            assert 0.1 < out[:, :3].norm(dim=-1).mean() < 1.0
            w, v, dw, dv = (out[:, :3], out[:, 3:6],
                            out[:, 6:15].reshape(-1, 3, 3),
                            out[:, 15:].reshape(-1, 3, 3))
            jacs = {f'jac_{kind}': rigid_body.retraction_jacobian(
                bwd, w, v, x[:, :3], dw, dv).reshape(-1, 9).numpy()
                for kind, (bwd, _) in RETRACTIONS.items()}
    names = ['dx'] + [f'd{"wb"[i % 2]}{i // 2}' for i in range(len(grads))]
    port = dict(zip(names, [t.numpy() for t in (dx, *grads)]),
                out=out.numpy())
    if config != 'flagship':
        port.update(jacs)
    for got in (again, port):
        for k, v in got.items():
            want = stored[k]
            assert v.shape == want.shape, (k, v.shape, want.shape)
            err = np.linalg.norm(v - want) / max(np.linalg.norm(want), 1e-30)
            assert err <= 1e-2, (k, err)


def test_cuda_kernels_cover_the_flagship_fields_only():
    """What the Jacobian wrappers would refuse on a CUDA tensor is decided
    by checks that run on the CPU too (before the library is needed)."""
    from hypernerf_tpu_torch.kernels import fused_jacobian, fused_se3_jacobian
    x = torch.zeros(4, 11)
    for bad in (TranslationField(E, dtype=torch.float32),
                TranslationField(E, n_freq=8, dtype=torch.bfloat16)):
        with pytest.raises(NotImplementedError, match='A.13'):
            fused_jacobian._launch_args(bad.mlp, bad.n_freq, x, False)
    for bad in (SE3Field(E, dtype=torch.float32),
                SE3Field(E, max_deg=6, dtype=torch.bfloat16)):
        with pytest.raises(NotImplementedError, match='A.13'):
            fused_se3_jacobian._launch_args(bad, x, None, False)
