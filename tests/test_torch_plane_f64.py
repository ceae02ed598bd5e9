"""The ``plane`` level in float64 against the JAX package: does the float32
check's wide gradient bound (``tests/test_torch_plane.py``: relative L2
1e-2) come from rounding alone?

The port's plain level (``kernels.fused_level`` on CPU tensors: the plain
warp field, the GLO coordinates as the hyper coordinates, the plain
template, and their plain backwards) runs on a ``compute_dtype='float64'``
model at the probe weights of ``flagship.load_probe_weights``, on the first
stored probe case's inputs (``flagship.plane_probe_inputs('level')``, the
case the float32 check reads) and its cotangent, all in float64. The JAX
side composes the same level from the JAX model's own modules (its warp
field, ``posenc_orig`` of the warped points and of the 8 GLO coordinates,
its ``nerf_coarse`` template) at ``compute_dtype='float64'`` inside
``jax.enable_x64(True)``, a context manager, so that no other test in this
worker process sees 64-bit JAX. (The JAX level kernel writes float32
outputs whatever its compute dtype, so it cannot take this leg.) The
weights and inputs are float32 numbers on both sides, exactly.

Measured on the CPU: outputs agree to 7.2e-15 of their largest entry, and
every gradient to a relative L2 of at most 2.9e-14 (the inputs' and every
layer's). At float32 the same level's gradients lie up to 5e-3 apart
(relative L2 on template layers 0..4): one ReLU at the probe whose
pre-activation lies within 2e-6 of zero falls on the other side in one of
the two sums. In float64 the two implementations agree to rounding, so
that bound is the flip and not a fault. Bounds here: outputs 1e-12 of the
largest entry, gradients relative L2 1e-10 each.

The same leg for the screw levels (ROADMAP D.3): the ``se3`` level (the
SE(3) trunk with its window row, the bendy sheet, the posenc_orig
template) and the paper's axis-aligned-plane level ``plane_anneal_se3``
(the windowed trunk, the GLO coordinates, the Nerfies template with its
window row), the JAX side from the JAX model's ``map_points`` and the
template encoding of its ``query_template``, every window partly on, at
the same bounds. At float32 these levels' gradients lie up to 1.8e-2 and
5.2e-2 apart (the heads' db; ``chip_smoke.py`` phases 35 and 36): the
warped point rounds apart in the last bit and the template's 2^9 band
amplifies it. In float64 the two agree to rounding, so the float32 bound
(1e-2 plus twice the raw_t floor) is that amplification, not a fault.

About 25 s on one worker.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.configs import NerfConfig as JaxNerfConfig
from hypernerf_tpu.models.nerf import NerfModel as JaxNerfModel
from hypernerf_tpu.ops.posenc import posenc as jax_posenc
from hypernerf_tpu.ops.posenc import posenc_orig as jax_posenc_orig
from hypernerf_tpu_torch import kernels as K
from hypernerf_tpu_torch.convert import params_to_jax
from hypernerf_tpu_torch.flagship import (LEVEL_INPUTS, f32_nerfies_conditions,
                                          flagship_model, load_probe_weights,
                                          plane_probe_inputs, probe_cotangents,
                                          probe_inputs)
from hypernerf_tpu_torch.kernels.fused_level import (_level_params,
                                                     level_layers)
from hypernerf_tpu_torch.kernels.fused_mlp import encoding_segments, n_hyper
from hypernerf_tpu_torch.kernels.fused_se3 import enc_segments

OUT_TOL, GRAD_L2 = 1e-12, 1e-10


def _port_model(config='plane'):
    return load_probe_weights(flagship_model(
        'cpu', config=config, compute_dtype='float64')).double()


def _port_level(model, inputs, extra=None):
    """The port's plain level in float64 at the alphas ``extra`` (the
    trunk's and the template's window rows): (out, [d inputs..., dW, db,
    ...] in kernel order)."""
    lv = model.level('coarse')
    extra = extra or {}
    ws = (None if lv.warp.kind == 'translation' else _scales64(
        enc_segments(lv.warp), [extra['warp_alpha']]))
    ts = (None if not lv.nerfies else _scales64(
        encoding_segments(lv, n_hyper(lv)),
        [extra.get('nerf_alpha'), extra.get('hyper_alpha')]))
    args = [torch.from_numpy(inputs[k]).double().requires_grad_()
            for k in LEVEL_INPUTS]
    out = K.fused_level(lv, *args, warp_scales=ws, tmpl_scales=ts)
    grads = torch.autograd.grad(
        out, args + _level_params(lv),
        torch.from_numpy(inputs['cotangent']).double())
    return out.detach().numpy(), [g.numpy() for g in grads]


def _scales64(segments, alphas):
    """``kernels.common.encoding_scales`` in float64 (the kernels' row is
    fp32, whose window weights round in the 8th digit): each segment's
    identity columns 1, band k's sin and cos columns the Hann window's
    weight of band k at its alpha (None: 1), a 0-band segment 1."""
    parts = []
    for seg, alpha in zip(segments, list(alphas) + [None] * len(segments)):
        ch, n_freq, min_deg, ident = (*seg, 0, True) if len(seg) == 2 else seg
        if n_freq == 0 or ident:
            parts.append(np.ones(ch))
        if n_freq == 0:
            continue
        band = (np.ones(n_freq) if alpha is None else 0.5 * (1.0 - np.cos(
            np.pi * np.clip(alpha - np.arange(min_deg, min_deg + n_freq),
                            0.0, 1.0))))
        parts += [np.repeat(band, ch)] * 2
    return torch.from_numpy(np.concatenate(parts))


def _jax_level(model, inputs, extra=None):
    """The same level from the JAX model's modules, float64 under
    ``jax.enable_x64``: (out, [d inputs..., dW (out, in), db, ...] in the
    port's kernel order). Without ``extra`` the plane level as composed
    first (its warp field, ``posenc_orig`` of the warped points and of the
    GLO coordinates); with it (the alphas) any level through the JAX
    model's ``map_points`` and ``query_template``'s encoding."""
    cfg = model.config
    fields = {f.name for f in dataclasses.fields(JaxNerfConfig)}
    jcfg = JaxNerfConfig(**{
        **{k: v for k, v in dataclasses.asdict(cfg).items() if k in fields},
        'compute_dtype': 'float64', 'use_pallas': False})
    jmodel = JaxNerfModel(jcfg)
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              params_to_jax(model.state_dict()))

        def level(m, z, origins, directions, embed, rgb_cond):
            pts = origins[:, None] + z[..., None] * directions[:, None]
            emb = jnp.broadcast_to(embed[:, None],
                                   pts.shape[:-1] + embed.shape[-1:])
            if extra is None:
                warped = m.warp_field(pts, emb, {})['warped_points']
                feat = jnp.concatenate(
                    [jax_posenc_orig(warped, jcfg.xyz_freq),
                     jax_posenc_orig(emb, jcfg.hyper_freq)], -1)
            else:
                feat = _template_features(jcfg, m.map_points(
                    pts, emb, emb, jextra)[0], jextra)
            raw = m.nerf_mlp_coarse(feat, None, rgb_cond)
            return jnp.concatenate([raw['rgb'], raw['alpha']],
                                   -1).reshape(-1, 4)

        def fn(p, *a):
            return jmodel.apply({'params': p}, *a, method=level)

        jextra = {k: jnp.asarray(v, jnp.float64)
                  for k, v in (extra or {}).items()}

        args = [jnp.asarray(inputs[k], jnp.float64) for k in LEVEL_INPUTS]
        out, vjp = jax.vjp(fn, params, *args)
        g = vjp(jnp.asarray(inputs['cotangent'], jnp.float64))
        out, g = np.asarray(out), jax.device_get(g)
    assert out.dtype == np.float64
    d_params, d_inputs = g[0], [np.asarray(x) for x in g[1:]]
    grads = list(d_inputs)
    for key in _param_keys(model):
        node = d_params
        *path, leaf = key.split('.')
        for name in path:
            node = node[name]
        arr = np.asarray(node['kernel' if leaf == 'weight' else 'bias'])
        grads.append(arr.T if leaf == 'weight' else arr)
    return out, grads


def _template_features(cfg, points, extra):
    """``query_template``'s encoding of [warped | hyper] points."""
    if cfg.use_original_embed:
        return jnp.concatenate([jax_posenc_orig(points[..., :3], cfg.xyz_freq),
                                jax_posenc_orig(points[..., 3:],
                                                cfg.hyper_freq)], -1)
    return jnp.concatenate([
        jax_posenc(points[..., :3], min_deg=cfg.spatial_point_min_deg,
                   max_deg=cfg.spatial_point_max_deg, use_identity=True,
                   alpha=extra.get('nerf_alpha')),
        jax_posenc(points[..., 3:], min_deg=cfg.hyper_point_min_deg,
                   max_deg=cfg.hyper_point_max_deg, use_identity=False,
                   alpha=extra.get('hyper_alpha'))], -1)


def _param_keys(model):
    """State-dict keys of the level's parameters in kernel order."""
    names = {id(p): k for k, p in model.named_parameters()}
    return [names[id(p)] for p in _level_params(model.level('coarse'))]


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def test_plane_level_agrees_with_jax_in_float64():
    model = _port_model()
    assert len(level_layers(model.level('coarse'))) == 23
    inputs = plane_probe_inputs('level')
    got_out, got = _port_level(model, inputs)
    want_out, want = _jax_level(model, inputs)
    assert got_out.dtype == np.float64 and got_out.shape == (8 * 64, 4)
    assert np.abs(got_out - want_out).max() <= \
        OUT_TOL * np.abs(want_out).max()
    assert len(got) == len(want) == len(LEVEL_INPUTS) + 2 * 23
    worst = max(_rel_l2(a, b) for a, b in zip(got, want))
    assert worst <= GRAD_L2, worst
    for a in got:
        assert a.dtype == np.float64


# The screw levels of ROADMAP D.3: (configuration, the alphas, the layers of
# the coarse level), every window partly on.
SCREW_LEVELS = {
    'se3': ({'warp_alpha': 3.5}, 32),
    'plane_anneal_se3': ({'warp_alpha': 3.5, 'nerf_alpha': 7.5,
                          'hyper_alpha': 1.5}, 25)}


@pytest.mark.parametrize('config', list(SCREW_LEVELS))
def test_screw_level_agrees_with_jax_in_float64(config):
    """The ``se3`` and ``plane_anneal_se3`` coarse levels in float64 at the
    probe weights, on probe rays (8 x 64, seed 61) with the model's rgb
    condition, against the JAX model's modules at float64: outputs 1e-12 of
    the largest entry, every gradient relative L2 1e-10."""
    extra, n_layers = SCREW_LEVELS[config]
    model = _port_model(config)
    assert len(level_layers(model.level('coarse'))) == n_layers
    inputs = probe_inputs(8, 64, 61)
    inputs['rgb_cond'] = f32_nerfies_conditions(
        model, inputs['directions'], inputs['embed'],
        extra.get('nerf_alpha'))[1]
    inputs['cotangent'] = probe_cotangents(8, 64, 61)['level']
    got_out, got = _port_level(model, inputs, extra)
    want_out, want = _jax_level(model, inputs, extra)
    assert got_out.dtype == np.float64 and got_out.shape == (8 * 64, 4)
    assert np.abs(got_out - want_out).max() <= \
        OUT_TOL * np.abs(want_out).max()
    assert len(got) == len(want) == len(LEVEL_INPUTS) + 2 * n_layers
    worst = max(_rel_l2(a, b) for a, b in zip(got, want))
    assert worst <= GRAD_L2, worst


def test_plain_versions_follow_a_float64_compute_dtype():
    """The plain level, template and field versions return float64 at a
    float64 compute dtype (fp32 at bf16 and float32, as the kernels)."""
    inputs = plane_probe_inputs('level')
    for dtype, want in (('float64', torch.float64),
                        ('float32', torch.float32),
                        ('bfloat16', torch.float32)):
        model = load_probe_weights(flagship_model('cpu', config='plane',
                                                  compute_dtype=dtype))
        if dtype == 'float64':
            model = model.double()
        args = [torch.from_numpy(inputs[k]).to(
            torch.float64 if dtype == 'float64' else torch.float32)
            for k in LEVEL_INPUTS]
        out, raw_t = K.fused_level_plain(model.level('coarse'), *args,
                                         return_raw_t=True)
        assert out.dtype == raw_t.dtype == want, dtype

