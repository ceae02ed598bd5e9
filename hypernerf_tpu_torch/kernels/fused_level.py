"""Level forward: warp field + hyper sheet + template for every sample.

``fused_level`` is the wrapper: on CUDA tensors it launches the hand-written
Hopper kernel ``csrc/fused_level.cu`` (which replaces the TPU kernel
``hypernerf_tpu/ops/pallas/fused_level.py`` ``_fused``); on CPU tensors it
runs ``fused_level_plain``, the same function composed from this package's
modules, whose rounding points are the kernel's (models/modules.py). On a
CUDA tensor it launches the kernel or raises.

Bound and design: see the note at the top of ``csrc/fused_level.cu``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from hypernerf_tpu_torch.kernels import build
from hypernerf_tpu_torch.models.modules import MLP, HyperSheetMLP, NerfMLP
from hypernerf_tpu_torch.models.warping import TranslationField
from hypernerf_tpu_torch.ops.posenc import posenc_orig

# The widths the CUDA kernel is compiled for (NerfConfig's flagship).
FLAGSHIP = dict(embed=8, warp_freq=10, hyper_sheet_freq=7, hyper_out=4,
                xyz_freq=10, hyper_freq=6, rgb_cond=39)
_NOT_COVERED = ('the CUDA level kernel covers the flagship widths in bf16 '
                'only; other widths are ROADMAP item A.13 (level kernel '
                'generality)')


class Level(NamedTuple):
    """The modules of one level and the template's encoding bands."""
    warp: TranslationField
    hyper: HyperSheetMLP
    template: NerfMLP
    xyz_freq: int
    hyper_freq: int


def fused_level_plain(level: Level, z_vals, origins, directions, embed,
                      rgb_cond) -> torch.Tensor:
    """Plain PyTorch level forward.

    Args:
      z_vals: (R, S) depths; origins / directions: (R, 3); embed: (R, E)
        per-ray warp/hyper embedding; rgb_cond: (R, C) per-ray condition.

    Returns:
      (R * S, 4) fp32 [rgb logits (3) | raw sigma].
    """
    fused_level_plain.calls += 1
    r, s = z_vals.shape
    pts = origins[:, None, :] + z_vals[..., None] * directions[:, None, :]
    emb = embed[:, None, :].expand(r, s, embed.shape[-1])
    warped = level.warp(pts, emb)
    hyper = level.hyper(pts, emb)
    feat = torch.cat([posenc_orig(warped, level.xyz_freq),
                      posenc_orig(hyper, level.hyper_freq)], dim=-1)
    raw = level.template(feat, rgb_cond)
    return torch.cat([raw['rgb'], raw['alpha']], dim=-1).reshape(r * s, -1)


fused_level_plain.calls = 0


def _pad16(x: int) -> int:
    return (x + 15) // 16 * 16


def _mlp_layers(mlp: MLP, in_segs):
    """(Linear, input segments) of an MLP in order; a segment is (width,
    padded width) of one contiguous block of the layer's input."""
    width = mlp.hidden(0).out_features
    out = []
    for i in range(mlp.depth):
        segs = list(in_segs) if i == 0 else [(width, width)]
        if i > 0 and (i - 1) in mlp.skips:
            segs += in_segs
        out.append((mlp.hidden(i), segs))
    segs = [(width, width)]
    if (mlp.depth - 1) in mlp.skips:
        segs += in_segs
    out.append((mlp.logit, segs))
    return out


def level_layers(level: Level):
    """Every Linear of the level in kernel order with its input segments."""
    def enc(mlp):
        return [(mlp.hidden(0).in_features, _pad16(mlp.hidden(0).in_features))]

    t = level.template
    tw = t.bottleneck.in_features
    bw = t.bottleneck.out_features
    cond = t.rgb_branch.hidden(0).in_features - bw
    return (_mlp_layers(level.warp.mlp, enc(level.warp.mlp))
            + _mlp_layers(level.hyper.mlp, enc(level.hyper.mlp))
            + _mlp_layers(t.trunk, enc(t.trunk))
            + [(t.bottleneck, [(tw, tw)]), (t.alpha_head, [(bw, bw)])]
            + _mlp_layers(t.rgb_branch, [(bw, bw), (cond, _pad16(cond))]))


def _pack_layer(layer: torch.nn.Linear, segs, dtype):
    """(n_pad, k_pad) weight with each input segment zero-padded, out rows
    padded to 8, and the (n_pad,) bias — both in ``dtype``."""
    w = layer.weight.detach()
    cols, start = [], 0
    for orig, padded in segs:
        cols.append(F.pad(w[:, start:start + orig], (0, padded - orig)))
        start += orig
    w = torch.cat(cols, dim=1)
    n_pad = (w.shape[0] + 7) // 8 * 8
    w = F.pad(w, (0, 0, 0, n_pad - w.shape[0]))
    b = F.pad(layer.bias.detach(), (0, n_pad - layer.bias.shape[0]))
    return w.to(dtype), b.to(dtype)


@functools.cache
def kernel_layout():
    """[(n_pad, k_pad)] of the compiled kernel, in layer order."""
    lib = build.library()
    n = (ctypes.c_int * 64)()
    k = (ctypes.c_int * 64)()
    count = lib.hn_fused_level_layout(ctypes.addressof(n),
                                      ctypes.addressof(k), 64)
    return [(n[i], k[i]) for i in range(count)]


def _check_covered(level: Level) -> None:
    t = level.template
    have = dict(embed=level.warp.mlp.hidden(0).in_features
                - 3 * (1 + 2 * level.warp.n_freq),
                warp_freq=level.warp.n_freq,
                hyper_sheet_freq=level.hyper.n_freq,
                hyper_out=level.hyper.mlp.logit.out_features,
                xyz_freq=level.xyz_freq, hyper_freq=level.hyper_freq,
                rgb_cond=t.rgb_branch.hidden(0).in_features
                - t.bottleneck.out_features)
    dtypes = {m.dtype for m in (level.warp.mlp, level.hyper.mlp, t.trunk,
                                t.rgb_branch)} | {t.dtype}
    if (have != FLAGSHIP or dtypes != {torch.bfloat16}
            or level.hyper.use_residual):
        raise NotImplementedError(f'{_NOT_COVERED}; got {have}, {dtypes}')


def pack_level(level: Level):
    """The kernel's bf16 weight and bias blobs for ``level`` and the
    (n_pad, k_pad) of each layer, cached on the template module.

    The cache is keyed on each parameter's storage and version counter, so
    it is repacked after ``load_state_dict``, ``.to()``, an optimizer step or
    any in-place op on the parameter itself (``with torch.no_grad():
    p.add_(...)``). A write through ``p.data`` bumps no version counter and
    leaves the cache stale: change parameters only through the parameter.
    """
    params = [p for m in (level.warp, level.hyper, level.template)
              for p in m.parameters()]
    key = tuple((p.data_ptr(), p._version) for p in params)
    cached = getattr(level.template, '_packed_level', None)
    if cached is not None and cached[0] == key:
        return cached[1:]
    _check_covered(level)
    layers = level_layers(level)
    packed = [_pack_layer(lin, segs, torch.bfloat16) for lin, segs in layers]
    shapes = [tuple(w.shape) for w, _ in packed]
    w_blob = torch.cat([w.reshape(-1) for w, _ in packed]).contiguous()
    b_blob = torch.cat([b for _, b in packed]).contiguous()
    object.__setattr__(level.template, '_packed_level',
                       (key, w_blob, b_blob, shapes))
    return w_blob, b_blob, shapes


def fused_level(level: Level, z_vals, origins, directions, embed,
                rgb_cond) -> torch.Tensor:
    """Level forward; (R * S, 4) fp32 [rgb logits | raw sigma].

    CPU tensors take ``fused_level_plain``; CUDA tensors launch the kernel
    (flagship widths, bf16) or raise.
    """
    if z_vals.device.type == 'cpu':
        return fused_level_plain(level, z_vals, origins, directions, embed,
                                 rgb_cond)
    if z_vals.device.type != 'cuda':
        raise ValueError(f'fused_level: no kernel for {z_vals.device}')
    w_blob, b_blob, shapes = pack_level(level)
    if shapes != kernel_layout():
        raise NotImplementedError(f'{_NOT_COVERED}; layer shapes {shapes}')
    dev = z_vals.device
    r, s = z_vals.shape
    rgbc = rgb_cond.to(torch.bfloat16).contiguous()
    for name, t, shape, dtype in (
            ('z_vals', z_vals, (r, s), torch.float32),
            ('origins', origins, (r, 3), torch.float32),
            ('directions', directions, (r, 3), torch.float32),
            ('embed', embed, (r, FLAGSHIP['embed']), torch.float32),
            ('rgb_cond', rgbc, (r, FLAGSHIP['rgb_cond']), torch.bfloat16),
            ('weights', w_blob, tuple(w_blob.shape), torch.bfloat16),
            ('biases', b_blob, tuple(b_blob.shape), torch.bfloat16)):
        build.check_tensor(name, t, shape, dtype, dev)
    out = torch.empty((r * s, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(build.library().hn_fused_level_fwd(
            z_vals.data_ptr(), origins.data_ptr(), directions.data_ptr(),
            embed.data_ptr(), rgbc.data_ptr(), w_blob.data_ptr(),
            b_blob.data_ptr(), out.data_ptr(), r, s, stream),
            'hn_fused_level_fwd')
    fused_level.launches += 1
    return out


fused_level.launches = 0
