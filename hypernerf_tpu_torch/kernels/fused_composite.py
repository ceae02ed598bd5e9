"""Compositing forward, with the in-kernel hierarchical draw, and its
backward.

``fused_composite`` is the wrapper: on CUDA tensors it launches the
hand-written kernel ``csrc/fused_composite.cu`` (which replaces the TPU
kernel ``hypernerf_tpu/ops/pallas/fused_composite.py`` ``_fused``); on CPU
tensors it runs ``fused_composite_plain`` — sigmoid / softplus, then
``volumetric_rendering``, then ``piecewise_constant_pdf`` and a sort. On a
CUDA tensor it launches the kernel or raises.

When a gradient is wanted the call goes through ``FusedCompositeFn``, whose
backward is ``fused_composite_bwd``: the kernel
``csrc/fused_composite_bwd.cu`` (replacing the TPU kernel's ``_fused_bwd``)
on CUDA tensors, ``fused_composite_bwd_plain`` — the analytic VJP written
out, with the reverse cumulative sum — on CPU tensors. ``z_union`` and ``u``
carry no gradient, as in the JAX package.

Bound and design: see the note at the top of ``csrc/fused_composite.cu``.
"""

from __future__ import annotations

from typing import Optional

import torch

from hypernerf_tpu_torch.kernels import build, common
from hypernerf_tpu_torch.ops.rendering import (compute_opaqueness_mask,
                                               volumetric_rendering)
from hypernerf_tpu_torch.ops.sampling import piecewise_constant_pdf

# Shared memory holds one CDF column of `samples` floats per thread.
MAX_SAMPLES_WITH_FINE = 192


def _softplus(x):
    # jax.nn.softplus's form (torch's F.softplus switches to x above 20).
    return torch.log1p(torch.exp(-torch.abs(x))) + torch.clamp(x, min=0.0)


def fused_composite_plain(packed, z_vals, directions,
                          u: Optional[torch.Tensor] = None,
                          use_white_background: bool = False,
                          sample_at_infinity: bool = True,
                          noise: Optional[torch.Tensor] = None) -> dict:
    """Plain PyTorch compositing.

    Args:
      packed: (R * S, 4) [rgb logits | raw sigma] from the level.
      z_vals: (R, S) ascending depths; directions: (R, 3).
      u: (R, N) ascending draws in [0, 1] for the fine level, or None.
      noise: (R, S) added to raw sigma before the softplus, or None.

    Returns:
      {'rgb' (R, 3), 'depth', 'med_depth', 'acc' (R,), 'weights' (R, S)},
      plus 'z_union' (R, S + N) sorted when ``u`` is given.
    """
    fused_composite_plain.calls += 1
    r, s = z_vals.shape
    packed = packed.reshape(r, s, -1)
    rgb = torch.sigmoid(packed[..., :3])
    raw = packed[..., 3] if noise is None else packed[..., 3] + noise
    out = volumetric_rendering(rgb, _softplus(raw), z_vals, directions,
                               use_white_background=use_white_background,
                               sample_at_infinity=sample_at_infinity)
    if u is not None:
        bins = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
        fine = piecewise_constant_pdf(bins, out['weights'][:, 1:-1],
                                      u.shape[-1], False, u=u)
        out['z_union'] = torch.sort(torch.cat([z_vals, fine], dim=-1),
                                    dim=-1)[0].detach()
    return out


fused_composite_plain.calls = 0


def fused_composite_bwd_plain(packed, z_vals, dnorm, noise, d_outs,
                              d_weights, use_white_background: bool = False,
                              sample_at_infinity: bool = True,
                              eps: float = 1e-5):
    """Plain compositing backward: the analytic VJP of sigmoid / softplus
    and ``volumetric_rendering``, after a recompute of the forward.

    Args:
      packed: (R * S, 4); z_vals: (R, S); dnorm: (R, 1) direction norms;
      noise: (R, S) or None; d_outs: (R, 6) cotangent of [rgb (3) | depth |
      med_depth | acc]; d_weights: (R, S).

    Returns:
      d packed (R * S, 4), d z_vals (R, S), d dnorm (R, 1) and d noise
      ((R, S), or None without noise).
    """
    fused_composite_bwd_plain.calls += 1
    r, s = z_vals.shape
    pk = packed.reshape(r, s, 4)
    a_raw = pk[..., 3] if noise is None else pk[..., 3] + noise
    sigma = _softplus(a_raw)
    rgb = torch.sigmoid(pk[..., :3])
    last = 1e7 if sample_at_infinity else 1e-7
    dists_raw = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                           torch.full_like(z_vals[:, :1], last)], dim=-1)
    dists = dists_raw * dnorm
    alpha = 1.0 - torch.exp(-sigma * dists)
    u = 1.0 - alpha + eps
    trans = torch.cat([torch.ones_like(u[:, :1]),
                       torch.cumprod(u[:, :-1], dim=-1)], dim=-1)
    weights = alpha * trans
    mask = compute_opaqueness_mask(weights)

    d_rgb, d_depth = d_outs[:, None, :3], d_outs[:, 3:4]
    d_med, d_acc = d_outs[:, 4:5], d_outs[:, 5:6]
    inner = torch.ones_like(z_vals)
    if sample_at_infinity:
        inner[:, -1] = 0.0
    g_w = d_weights + z_vals * d_depth + (rgb * d_rgb).sum(-1) + inner * d_acc
    if use_white_background:
        g_w = g_w - d_rgb.sum(-1)
    d_logits = weights[..., None] * d_rgb * rgb * (1.0 - rgb)

    gw_w = g_w * weights
    rc = torch.flip(torch.cumsum(torch.flip(gw_w, [-1]), dim=-1), [-1])
    d_u = (rc - gw_w) / u
    d_alpha = g_w * trans - d_u
    exp_term = 1.0 - alpha
    d_sigma = d_alpha * dists * exp_term
    d_dists = d_alpha * sigma * exp_term
    d_araw = d_sigma * torch.sigmoid(a_raw)

    d_dnorm = (d_dists * dists_raw).sum(-1, keepdim=True)
    d_draw = d_dists * dnorm
    d_draw[:, -1] = 0.0
    d_z = weights * d_depth + mask * d_med - d_draw
    d_z[:, 1:] += d_draw[:, :-1]
    d_packed = torch.cat([d_logits, d_araw[..., None]], dim=-1)
    return (d_packed.reshape(r * s, 4), d_z, d_dnorm,
            None if noise is None else d_araw)


fused_composite_bwd_plain.calls = 0


def _launch_forward(packed, z_vals, directions, u, noise, white, infinity):
    """Launch the forward kernel: (outs (R, 6), weights, z_union or None)."""
    dev = z_vals.device
    r, s = z_vals.shape
    n = 0 if u is None else u.shape[-1]
    if n and (s < 3 or s > MAX_SAMPLES_WITH_FINE):
        raise ValueError(f'fused_composite: the fine draw takes 3..'
                         f'{MAX_SAMPLES_WITH_FINE} samples, got {s}')
    f32 = torch.float32
    build.check_tensor('packed', packed, (r * s, 4), f32, dev)
    build.check_tensor('z_vals', z_vals, (r, s), f32, dev)
    build.check_tensor('directions', directions, (r, 3), f32, dev)
    if n:
        build.check_tensor('u', u, (r, n), f32, dev)
    if noise is not None:
        build.check_tensor('noise', noise, (r, s), f32, dev)
    out = torch.empty((r, 6), dtype=f32, device=dev)
    weights = torch.empty((r, s), dtype=f32, device=dev)
    z_union = torch.empty((r, s + n), dtype=f32, device=dev) if n else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(build.library().hn_fused_composite_fwd(
            packed.data_ptr(), z_vals.data_ptr(), directions.data_ptr(),
            None if noise is None else noise.data_ptr(),
            u.data_ptr() if n else None, out.data_ptr(), weights.data_ptr(),
            z_union.data_ptr() if n else None, r, s, n, int(white),
            int(infinity), stream), 'hn_fused_composite_fwd')
    fused_composite.launches += 1
    return out, weights, z_union


def _forward(packed, z_vals, directions, u, noise, white, infinity):
    """(outs (R, 6), weights, z_union or None): the plain version on CPU
    tensors, the kernel on CUDA tensors."""
    if not common.runs_plain(z_vals, 'fused_composite'):
        return _launch_forward(packed, z_vals, directions, u, noise, white,
                               infinity)
    res = fused_composite_plain(packed, z_vals, directions, u, white,
                                infinity, noise)
    outs = torch.cat([res['rgb'], res['depth'][:, None],
                      res['med_depth'][:, None], res['acc'][:, None]], dim=-1)
    return outs, res['weights'], res.get('z_union')


def fused_composite_bwd(packed, z_vals, directions, noise, d_outs, d_weights,
                        use_white_background: bool = False,
                        sample_at_infinity: bool = True):
    """Compositing backward (see ``fused_composite_bwd_plain``, which takes
    the directions' norms where this takes the directions): CPU tensors
    take the plain version, CUDA tensors launch the kernel or raise."""
    if common.runs_plain(z_vals, 'fused_composite_bwd'):
        dnorm = torch.linalg.norm(directions, dim=-1, keepdim=True)
        return fused_composite_bwd_plain(
            packed, z_vals, dnorm, noise, d_outs, d_weights,
            use_white_background, sample_at_infinity)
    dev, f32 = z_vals.device, torch.float32
    r, s = z_vals.shape
    for name, t, shape in (('packed', packed, (r * s, 4)),
                           ('z_vals', z_vals, (r, s)),
                           ('directions', directions, (r, 3)),
                           ('d_outs', d_outs, (r, 6)),
                           ('d_weights', d_weights, (r, s))):
        build.check_tensor(name, t, shape, f32, dev)
    if noise is not None:
        build.check_tensor('noise', noise, (r, s), f32, dev)
    d_packed = torch.empty((r * s, 4), dtype=f32, device=dev)
    d_z = torch.empty((r, s), dtype=f32, device=dev)
    d_dnorm = torch.empty((r, 1), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(build.library().hn_fused_composite_bwd(
            packed.data_ptr(), z_vals.data_ptr(), directions.data_ptr(),
            None if noise is None else noise.data_ptr(), d_outs.data_ptr(),
            d_weights.data_ptr(), d_packed.data_ptr(), d_z.data_ptr(),
            d_dnorm.data_ptr(), r, s, int(use_white_background),
            int(sample_at_infinity), stream), 'hn_fused_composite_bwd')
    fused_composite_bwd.launches += 1
    # d noise is d raw sigma, the fourth column of d packed.
    d_noise = None if noise is None else d_packed[:, 3].reshape(r, s)
    return d_packed, d_z, d_dnorm, d_noise


fused_composite_bwd.launches = 0


class FusedCompositeFn(torch.autograd.Function):
    """Compositing with its hand-written backward. ``dnorm`` is the
    directions' norm, taken outside so that autograd carries its cotangent
    back to the directions; ``u`` and ``z_union`` carry no gradient."""

    @staticmethod
    def forward(ctx, packed, z_vals, directions, dnorm, noise, u, white,
                infinity):
        args = [None if t is None else t.detach()
                for t in (packed, z_vals, directions, noise, u)]
        with torch.no_grad():
            outs, weights, z_union = _forward(*args[:3], args[4], args[3],
                                              white, infinity)
        ctx.flags = (white, infinity)
        ctx.has_noise = noise is not None
        ctx.save_for_backward(*[t for t in args[:4] if t is not None])
        if z_union is None:
            return outs, weights
        ctx.mark_non_differentiable(z_union)
        return outs, weights, z_union

    @staticmethod
    def backward(ctx, d_outs, d_weights, *_):
        packed, z_vals, directions, *noise = ctx.saved_tensors
        noise = noise[0] if ctx.has_noise else None
        with torch.no_grad():
            d_packed, d_z, d_dnorm, d_noise = fused_composite_bwd(
                packed, z_vals, directions, noise, d_outs.contiguous(),
                d_weights.contiguous(), *ctx.flags)
        return d_packed, d_z, None, d_dnorm, d_noise, None, None, None


def fused_composite(packed, z_vals, directions,
                    u: Optional[torch.Tensor] = None,
                    use_white_background: bool = False,
                    sample_at_infinity: bool = True,
                    noise: Optional[torch.Tensor] = None) -> dict:
    """Compositing forward (see ``fused_composite_plain``); on CUDA ``u``
    must be ascending per ray, as linspace and ``sorted_uniform`` are.
    Differentiable in ``packed``, ``z_vals``, ``directions`` and ``noise``
    (``FusedCompositeFn``)."""
    diff = [t for t in (packed, z_vals, directions, noise) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in diff):
        dnorm = torch.linalg.norm(directions, dim=-1, keepdim=True)
        outs, weights, *z_union = FusedCompositeFn.apply(
            packed, z_vals, directions, dnorm, noise, u,
            use_white_background, sample_at_infinity)
        z_union = z_union[0] if z_union else None
    else:
        outs, weights, z_union = _forward(
            packed, z_vals, directions, u, noise, use_white_background,
            sample_at_infinity)
    result = {'rgb': outs[:, :3], 'depth': outs[:, 3],
              'med_depth': outs[:, 4], 'acc': outs[:, 5], 'weights': weights}
    if z_union is not None:
        result['z_union'] = z_union
    return result


fused_composite.launches = 0
