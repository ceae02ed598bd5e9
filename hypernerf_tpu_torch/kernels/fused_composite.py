"""Compositing forward, with the in-kernel hierarchical draw.

``fused_composite`` is the wrapper: on CUDA tensors it launches the
hand-written kernel ``csrc/fused_composite.cu`` (which replaces the TPU
kernel ``hypernerf_tpu/ops/pallas/fused_composite.py`` ``_fused``); on CPU
tensors it runs ``fused_composite_plain`` — sigmoid / softplus, then
``volumetric_rendering``, then ``piecewise_constant_pdf`` and a sort. On a
CUDA tensor it launches the kernel or raises.

Bound and design: see the note at the top of ``csrc/fused_composite.cu``.
"""

from __future__ import annotations

from typing import Optional

import torch

from hypernerf_tpu_torch.kernels import build
from hypernerf_tpu_torch.ops.rendering import volumetric_rendering
from hypernerf_tpu_torch.ops.sampling import piecewise_constant_pdf

# Shared memory holds one CDF column of `samples` floats per thread.
MAX_SAMPLES_WITH_FINE = 192


def _softplus(x):
    # jax.nn.softplus's form (torch's F.softplus switches to x above 20).
    return torch.log1p(torch.exp(-torch.abs(x))) + torch.clamp(x, min=0.0)


def fused_composite_plain(packed, z_vals, directions,
                          u: Optional[torch.Tensor] = None,
                          use_white_background: bool = False,
                          sample_at_infinity: bool = True) -> dict:
    """Plain PyTorch compositing.

    Args:
      packed: (R * S, 4) [rgb logits | raw sigma] from the level.
      z_vals: (R, S) ascending depths; directions: (R, 3).
      u: (R, N) ascending draws in [0, 1] for the fine level, or None.

    Returns:
      {'rgb' (R, 3), 'depth', 'med_depth', 'acc' (R,), 'weights' (R, S)},
      plus 'z_union' (R, S + N) sorted when ``u`` is given.
    """
    fused_composite_plain.calls += 1
    r, s = z_vals.shape
    packed = packed.reshape(r, s, -1)
    rgb = torch.sigmoid(packed[..., :3])
    sigma = _softplus(packed[..., 3])
    out = volumetric_rendering(rgb, sigma, z_vals, directions,
                               use_white_background=use_white_background,
                               sample_at_infinity=sample_at_infinity)
    if u is not None:
        bins = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
        fine = piecewise_constant_pdf(bins, out['weights'][:, 1:-1],
                                      u.shape[-1], False, u=u)
        out['z_union'] = torch.sort(torch.cat([z_vals, fine], dim=-1),
                                    dim=-1)[0]
    return out


fused_composite_plain.calls = 0


def fused_composite(packed, z_vals, directions,
                    u: Optional[torch.Tensor] = None,
                    use_white_background: bool = False,
                    sample_at_infinity: bool = True) -> dict:
    """Compositing forward (see ``fused_composite_plain``); on CUDA ``u``
    must be ascending per ray, as linspace and ``sorted_uniform`` are."""
    if z_vals.device.type == 'cpu':
        return fused_composite_plain(packed, z_vals, directions, u,
                                     use_white_background,
                                     sample_at_infinity)
    if z_vals.device.type != 'cuda':
        raise ValueError(f'fused_composite: no kernel for {z_vals.device}')
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
    out = torch.empty((r, 6), dtype=torch.float32, device=dev)
    weights = torch.empty((r, s), dtype=torch.float32, device=dev)
    z_union = torch.empty((r, s + n), dtype=torch.float32, device=dev) \
        if n else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(build.library().hn_fused_composite_fwd(
            packed.data_ptr(), z_vals.data_ptr(), directions.data_ptr(),
            u.data_ptr() if n else None, out.data_ptr(), weights.data_ptr(),
            z_union.data_ptr() if n else None, r, s, n,
            int(use_white_background), int(sample_at_infinity), stream),
            'hn_fused_composite_fwd')
    fused_composite.launches += 1
    result = {'rgb': out[:, :3], 'depth': out[:, 3], 'med_depth': out[:, 4],
              'acc': out[:, 5], 'weights': weights}
    if n:
        result['z_union'] = z_union
    return result


fused_composite.launches = 0
