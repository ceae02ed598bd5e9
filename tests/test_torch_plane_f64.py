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

About 15 s on one worker.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hypernerf_tpu.configs import NerfConfig as JaxNerfConfig
from hypernerf_tpu.models.nerf import NerfModel as JaxNerfModel
from hypernerf_tpu.ops.posenc import posenc_orig as jax_posenc_orig
from hypernerf_tpu_torch import kernels as K
from hypernerf_tpu_torch.convert import params_to_jax
from hypernerf_tpu_torch.flagship import (LEVEL_INPUTS, flagship_model,
                                          load_probe_weights,
                                          plane_probe_inputs)
from hypernerf_tpu_torch.kernels.fused_level import (_level_params,
                                                     level_layers)

OUT_TOL, GRAD_L2 = 1e-12, 1e-10


def _port_model():
    return load_probe_weights(flagship_model(
        'cpu', config='plane', compute_dtype='float64')).double()


def _port_level(model, inputs):
    """The port's plain plane level in float64: (out, [d inputs..., dW, db,
    ...] in kernel order)."""
    lv = model.level('coarse')
    args = [torch.from_numpy(inputs[k]).double().requires_grad_()
            for k in LEVEL_INPUTS]
    out = K.fused_level(lv, *args)
    grads = torch.autograd.grad(
        out, args + _level_params(lv),
        torch.from_numpy(inputs['cotangent']).double())
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_level(model, inputs):
    """The same level from the JAX model's modules, float64 under
    ``jax.enable_x64``: (out, [d inputs..., dW (out, in), db, ...] in the
    port's kernel order)."""
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
            warped = m.warp_field(pts, emb, {})['warped_points']
            feat = jnp.concatenate([jax_posenc_orig(warped, jcfg.xyz_freq),
                                    jax_posenc_orig(emb, jcfg.hyper_freq)],
                                   -1)
            raw = m.nerf_mlp_coarse(feat, None, rgb_cond)
            return jnp.concatenate([raw['rgb'], raw['alpha']],
                                   -1).reshape(-1, 4)

        def fn(p, *a):
            return jmodel.apply({'params': p}, *a, method=level)

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

