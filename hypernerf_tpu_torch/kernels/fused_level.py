"""One level: warp field + hyper sheet + template for every sample, forward
and backward.

``fused_level`` is the wrapper. On CUDA tensors it launches the hand-written
Hopper kernel ``csrc/fused_level.cu`` (which replaces the TPU kernel
``hypernerf_tpu/ops/pallas/fused_level.py`` ``_fused``); on CPU tensors it
runs ``fused_level_plain``, the same function composed from this package's
modules, whose rounding points are the kernel's (models/modules.py). On a
CUDA tensor it launches the kernel or raises.

When a gradient is wanted the call goes through ``FusedLevelFn``: its
forward also keeps ``raw_t``, the template's raw input [warped | hyper], and
its backward runs the template backward (``fused_template_bwd``, kernel
``csrc/fused_template_bwd.cu``) and then the fields backward
(``fused_fields_bwd``, ``csrc/fused_fields_bwd.cu``), stitched through
``dx_t`` = d[warped | hyper] as the JAX package's split backward is. Each has
a plain version written out explicitly, with the kernels' rounding points
(the cotangent is rounded to the compute dtype before every product, a
hidden layer's db sums the rounded cotangent, heads' db the fp32 one).

Bound and design: see the notes at the top of the ``csrc/*.cu`` sources.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from hypernerf_tpu_torch.kernels import build
from hypernerf_tpu_torch.models.modules import (MLP, HyperSheetMLP, NerfMLP,
                                                dense)
from hypernerf_tpu_torch.models.warping import TranslationField
from hypernerf_tpu_torch.ops.posenc import posenc_orig

# The widths the CUDA kernel is compiled for (NerfConfig's flagship).
FLAGSHIP = dict(embed=8, warp_freq=10, hyper_sheet_freq=7, hyper_out=4,
                xyz_freq=10, hyper_freq=6, rgb_cond=39)
RAW_T_PAD = 8  # columns of raw_t and dx_t: [warped (3) | hyper (4) | 0]
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
                      rgb_cond, return_raw_t: bool = False):
    """Plain PyTorch level forward.

    Args:
      z_vals: (R, S) depths; origins / directions: (R, 3); embed: (R, E)
        per-ray warp/hyper embedding; rgb_cond: (R, C) per-ray condition.

    Returns:
      (R * S, 4) fp32 [rgb logits (3) | raw sigma]; with ``return_raw_t``
      also the template's raw input (R * S, 8) fp32 [warped | hyper | 0].
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
    out = torch.cat([raw['rgb'], raw['alpha']], dim=-1).reshape(r * s, -1)
    if not return_raw_t:
        return out
    raw_t = torch.cat([warped, hyper], dim=-1).reshape(r * s, -1)
    return out, F.pad(raw_t.float(), (0, RAW_T_PAD - raw_t.shape[-1]))


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


def pack_level(level: Level, transposed: bool = False):
    """The kernel's bf16 weight and bias blobs for ``level`` and the
    (n_pad, k_pad) of each layer, cached on the template module.

    With ``transposed`` the first blob holds every layer as (k_pad, n_pad),
    which is how the backward kernels read a weight for ``g @ W``.

    The cache is keyed on each parameter's storage and version counter, so
    it is repacked after ``load_state_dict``, ``.to()``, an optimizer step or
    any in-place op on the parameter itself (``with torch.no_grad():
    p.add_(...)``). A write through ``p.data`` bumps no version counter and
    leaves the cache stale: change parameters only through the parameter.
    Neither does ``torch.optim.Adam(fused=True)``, which
    ``training.train_state.make_train_step`` therefore refuses.
    """
    params = [p for m in (level.warp, level.hyper, level.template)
              for p in m.parameters()]
    key = tuple((p.data_ptr(), p._version) for p in params)
    cached = getattr(level.template, '_packed_level', None)
    if cached is None or cached['key'] != key:
        _check_covered(level)
        packed = [_pack_layer(lin, segs, torch.bfloat16)
                  for lin, segs in level_layers(level)]
        cached = dict(
            key=key, packed=packed,
            shapes=[tuple(w.shape) for w, _ in packed],
            w=torch.cat([w.reshape(-1) for w, _ in packed]).contiguous(),
            b=torch.cat([b for _, b in packed]).contiguous())
        object.__setattr__(level.template, '_packed_level', cached)
    if transposed and 'wt' not in cached:
        cached['wt'] = torch.cat([w.t().reshape(-1)
                                  for w, _ in cached['packed']]).contiguous()
    return cached['wt' if transposed else 'w'], cached['b'], cached['shapes']


def _level_params(level: Level):
    """[weight, bias] of every Linear of the level, in kernel order."""
    return [p for lin, _ in level_layers(level)
            for p in (lin.weight, lin.bias)]


def _n_field_layers(level: Level) -> int:
    return level.warp.mlp.depth + 1 + level.hyper.mlp.depth + 1


def _unpack_grads(dw_blob, db_blob, layers, shapes):
    """The inverse of ``_pack_layer`` for gradients: the packed fp32
    (n_pad, k_pad) dW and (n_pad,) db of ``layers`` -> [dW, db, ...] in each
    ``nn.Linear``'s own shapes, pad rows and columns dropped."""
    out, w_at, b_at = [], 0, 0
    for (lin, segs), (n_pad, k_pad) in zip(layers, shapes):
        dw = dw_blob[w_at:w_at + n_pad * k_pad].view(n_pad, k_pad)
        cols, start = [], 0
        for orig, padded in segs:
            cols.append(dw[:lin.out_features, start:start + orig])
            start += padded
        out.append(torch.cat(cols, dim=1) if len(cols) > 1
                   else cols[0].contiguous())
        out.append(db_blob[b_at:b_at + lin.out_features].clone())
        w_at += n_pad * k_pad
        b_at += n_pad
    return out


def _launch_forward(level: Level, z_vals, origins, directions, embed,
                    rgb_cond, want_raw_t: bool):
    """Launch the forward kernel; (out, raw_t or None)."""
    w_blob, b_blob, shapes = pack_level(level)
    if shapes != kernel_layout():
        raise NotImplementedError(f'{_NOT_COVERED}; layer shapes {shapes}')
    dev = z_vals.device
    r, s = z_vals.shape
    rgbc = rgb_cond.detach().to(torch.bfloat16).contiguous()
    _check_ray_inputs(z_vals, origins, directions, embed)
    build.check_tensor('rgb_cond', rgbc, (r, FLAGSHIP['rgb_cond']),
                       torch.bfloat16, dev)
    out = torch.empty((r * s, 4), dtype=torch.float32, device=dev)
    raw_t = torch.empty((r * s, RAW_T_PAD), dtype=torch.float32,
                        device=dev) if want_raw_t else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(build.library().hn_fused_level_fwd(
            z_vals.data_ptr(), origins.data_ptr(), directions.data_ptr(),
            embed.data_ptr(), rgbc.data_ptr(), w_blob.data_ptr(),
            b_blob.data_ptr(), out.data_ptr(),
            raw_t.data_ptr() if want_raw_t else None, r, s, stream),
            'hn_fused_level_fwd')
    fused_level.launches += 1
    return out, raw_t


def _check_ray_inputs(z_vals, origins, directions, embed) -> None:
    r, s = z_vals.shape
    for name, t, shape in (('z_vals', z_vals, (r, s)),
                           ('origins', origins, (r, 3)),
                           ('directions', directions, (r, 3)),
                           ('embed', embed, (r, FLAGSHIP['embed']))):
        build.check_tensor(name, t, shape, torch.float32, z_vals.device)


def _forward(level: Level, z_vals, origins, directions, embed, rgb_cond,
             want_raw_t: bool):
    """(out, raw_t or None): the plain version on CPU tensors, the kernel on
    CUDA tensors."""
    if z_vals.device.type == 'cpu':
        res = fused_level_plain(level, z_vals, origins, directions, embed,
                                rgb_cond, return_raw_t=want_raw_t)
        return res if want_raw_t else (res, None)
    if z_vals.device.type != 'cuda':
        raise ValueError(f'fused_level: no kernel for {z_vals.device}')
    return _launch_forward(level, z_vals, origins, directions, embed,
                           rgb_cond, want_raw_t)


def fused_level(level: Level, z_vals, origins, directions, embed,
                rgb_cond) -> torch.Tensor:
    """Level forward; (R * S, 4) fp32 [rgb logits | raw sigma].

    CPU tensors take ``fused_level_plain``; CUDA tensors launch the kernel
    (flagship widths, bf16) or raise. Differentiable in every argument and
    in the level's parameters (``FusedLevelFn``).
    """
    params = _level_params(level)
    inputs = (z_vals, origins, directions, embed, rgb_cond)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (*inputs, *params)):
        return FusedLevelFn.apply(level, *inputs, *params)
    return _forward(level, *inputs, want_raw_t=False)[0]


fused_level.launches = 0


class FusedLevelFn(torch.autograd.Function):
    """The level with its hand-written backward: the forward keeps the
    inputs and ``raw_t``; the backward runs the template backward, then the
    fields backward on its ``dx_t``. Gradients of ``warp`` and ``hyper``
    parameters shared by two levels add up in autograd."""

    @staticmethod
    def forward(ctx, level, z_vals, origins, directions, embed, rgb_cond,
                *params):
        inputs = [t.detach() for t in (z_vals, origins, directions, embed,
                                       rgb_cond)]
        with torch.no_grad():
            out, raw_t = _forward(level, *inputs, want_raw_t=True)
        ctx.level = level
        ctx.save_for_backward(*inputs, raw_t)
        return out

    @staticmethod
    def backward(ctx, g):
        z_vals, origins, directions, embed, rgb_cond, raw_t = \
            ctx.saved_tensors
        level = ctx.level
        g = g.contiguous()
        with torch.no_grad():
            dx_t, d_rgb_cond, t_grads = fused_template_bwd(level, raw_t,
                                                           rgb_cond, g)
            d_z, d_o, d_d, d_embed, f_grads = fused_fields_bwd(
                level, z_vals, origins, directions, embed, dx_t)
        return (None, d_z, d_o, d_d, d_embed,
                d_rgb_cond.to(rgb_cond.dtype), *f_grads, *t_grads)


# ---------------------------------------------------------------------------
# Plain backward, written out (no autograd), with the kernels' rounding.


def _acc_dtype(dt):
    return torch.promote_types(dt, torch.float32)


def _prod(a, b, dt):
    """a @ b with compute-dtype operands summed in at least fp32."""
    acc = _acc_dtype(dt)
    return a.to(dt).to(acc) @ b.to(dt).to(acc)


def _posenc_trig(x, n_freqs: int):
    """fp32 (sin, cos) of the band products of (P, C) ``x``, each
    (P, n_freqs * C) with band k of channel c at k * C + c."""
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    xb = (x[:, None, :] * freqs[:, None]).reshape(x.shape[0], -1)
    return torch.sin(xb), torch.cos(xb)


def _posenc_bwd(g_enc, trig, ch: int, n_freqs: int):
    """VJP of ``posenc_orig`` from the recompute's (sin, cos): cotangent
    (P, ch * (1 + 2 F)) of [x | sin | cos] -> (P, ch)."""
    sin, cos = trig
    nb = ch * n_freqs
    flat = cos * g_enc[:, ch:ch + nb] - sin * g_enc[:, ch + nb:ch + 2 * nb]
    freqs = 2.0 ** torch.arange(n_freqs, dtype=flat.dtype, device=flat.device)
    dx = (flat.reshape(-1, n_freqs, ch) * freqs[:, None]).sum(1)
    return g_enc[:, :ch] + dx


def _mlp_recompute(mlp: MLP, x):
    """Hidden chain of ``mlp`` on compute-dtype ``x``: each layer's input
    and rounded output, and the logit's input."""
    ins, outs, h = [], [], x
    for i in range(mlp.depth):
        ins.append(h)
        h = dense(h, mlp.hidden(i), mlp.dtype, relu=True)
        outs.append(h)
        if i in mlp.skips:
            h = torch.cat([h, x], dim=-1)
    return ins, outs, h


def _head_bwd(layer, x_in, g, dt):
    """A linear fp32 head: (dW, db, fp32 g @ W). The cotangent is rounded
    for the products; db sums the fp32 one."""
    g_c = g.to(dt)
    return (_prod(g_c.t(), x_in, dt), g.sum(0).to(_acc_dtype(dt)),
            _prod(g_c, layer.weight, dt))


def _hidden_bwd(mlp: MLP, ins, outs, gh, in_w: int):
    """Back through the hidden chain. ``gh``: compute-dtype cotangent of the
    logit's input. Returns the fp32 cotangent of the MLP's input and
    [dW, db, ...] of the hidden layers in order."""
    dt, acc = mlp.dtype, _acc_dtype(mlp.dtype)
    width = mlp.hidden(0).out_features
    g_in = torch.zeros((gh.shape[0], in_w), dtype=acc, device=gh.device)
    if (mlp.depth - 1) in mlp.skips:
        g_in = g_in + gh[:, width:].to(acc)
        gh = gh[:, :width]
    grads = [None] * mlp.depth
    for i in range(mlp.depth - 1, -1, -1):
        gh = torch.where(outs[i].to(acc) > 0, gh, torch.zeros_like(gh))
        grads[i] = (_prod(gh.t(), ins[i], dt), gh.to(acc).sum(0))
        gh = _prod(gh, mlp.hidden(i).weight, dt).to(dt)
        if i > 0 and (i - 1) in mlp.skips:
            g_in = g_in + gh[:, width:].to(acc)
            gh = gh[:, :width]
    return g_in + gh.to(acc), [t for pair in grads for t in pair]


def fused_template_bwd_plain(level: Level, raw_t, rgb_cond, g):
    """Plain template backward: recompute from ``raw_t``, then walk back.

    Args:
      raw_t: (P, 8) fp32 [warped | hyper | 0]; rgb_cond: (R, C);
      g: (P, 4) fp32 cotangent of [rgb logits | raw sigma].

    Returns:
      dx_t (P, 8) fp32, d rgb_cond (R, C) fp32 summed per ray, and
      [dW, db, ...] of the template's layers in kernel order, fp32, in each
      ``nn.Linear``'s shapes.
    """
    fused_template_bwd_plain.calls += 1
    t = level.template
    dt, acc = t.dtype, _acc_dtype(t.dtype)
    p, r = raw_t.shape[0], rgb_cond.shape[0]
    n_rgb = t.rgb_branch.logit.out_features
    n_hyper = (t.trunk.hidden(0).in_features
               - 3 * (1 + 2 * level.xyz_freq)) // (1 + 2 * level.hyper_freq)
    segs = ((raw_t[:, :3], 3, level.xyz_freq),
            (raw_t[:, 3:3 + n_hyper], n_hyper, level.hyper_freq))
    trigs = [_posenc_trig(x, f) for x, _, f in segs]
    feat = torch.cat([torch.cat([x, sin, cos], dim=-1)
                      for (x, _, _), (sin, cos) in zip(segs, trigs)], dim=-1)
    x = feat.to(dt)
    ins, outs, tl_in = _mlp_recompute(t.trunk, x)
    hl = dense(tl_in, t.trunk.logit, dt, relu=True)
    bneck = dense(hl, t.bottleneck, dt).to(dt)
    cond = rgb_cond.to(dt)
    r_in = torch.cat([bneck, cond.repeat_interleave(p // r, dim=0)], dim=-1)
    r_ins, r_outs, rl_in = _mlp_recompute(t.rgb_branch, r_in)

    g = g.to(acc)
    dw_rl, db_rl, gg = _head_bwd(t.rgb_branch.logit, rl_in, g[:, :n_rgb], dt)
    g_rin, rgb_grads = _hidden_bwd(t.rgb_branch, r_ins, r_outs, gg.to(dt),
                                   r_in.shape[1])
    bw = bneck.shape[1]
    dw_a, db_a, ga = _head_bwd(t.alpha_head, bneck, g[:, n_rgb:], dt)
    g_b = g_rin[:, :bw] + ga
    dw_bn, db_bn, g_hl = _head_bwd(t.bottleneck, hl, g_b, dt)
    g_hl = torch.where(hl.to(acc) > 0, g_hl, torch.zeros_like(g_hl)).to(dt)
    dw_tl, db_tl = _prod(g_hl.t(), tl_in, dt), g_hl.to(acc).sum(0)
    gh = _prod(g_hl, t.trunk.logit.weight, dt).to(dt)
    g_x, trunk_grads = _hidden_bwd(t.trunk, ins, outs, gh, x.shape[1])

    dx, at = [], 0
    for (_, ch, f), trig in zip(segs, trigs):
        width = ch * (1 + 2 * f)
        dx.append(_posenc_bwd(g_x[:, at:at + width], trig, ch, f))
        at += width
    dx_t = torch.cat(dx, dim=-1).float()
    dx_t = F.pad(dx_t, (0, RAW_T_PAD - dx_t.shape[1]))
    d_cond = g_rin[:, bw:].reshape(r, p // r, -1).sum(1).float()
    grads = (trunk_grads + [dw_tl, db_tl, dw_bn, db_bn, dw_a, db_a]
             + rgb_grads + [dw_rl, db_rl])
    return dx_t, d_cond, [t_.float() for t_ in grads]


fused_template_bwd_plain.calls = 0


def fused_fields_bwd_plain(level: Level, z_vals, origins, directions, embed,
                           dx_t):
    """Plain fields backward: warp field and hyper sheet from ``dx_t``.

    Args:
      dx_t: (P, 8) fp32 cotangent of [warped | hyper | 0].

    Returns:
      d z_vals (R, S), d origins, d directions (R, 3), d embed (R, E), and
      [dW, db, ...] of the warp then the hyper layers in kernel order.
    """
    fused_fields_bwd_plain.calls += 1
    if level.hyper.use_residual:
        raise NotImplementedError('hyper sheet residual (ROADMAP A.13)')
    r, s = z_vals.shape
    pts = (origins[:, None, :]
           + z_vals[..., None] * directions[:, None, :]).reshape(r * s, 3)
    emb = embed.repeat_interleave(s, dim=0)
    n_hyper = level.hyper.mlp.logit.out_features
    d_raw, grads = [], []
    for field, g_out in ((level.warp, dx_t[:, :3]),
                         (level.hyper, dx_t[:, 3:3 + n_hyper])):
        mlp, dt = field.mlp, field.mlp.dtype
        trig = _posenc_trig(pts, field.n_freq)
        enc = torch.cat([pts, *trig, emb.to(pts.dtype)], dim=-1)
        ins, outs, logit_in = _mlp_recompute(mlp, enc.to(dt))
        dw, db, gh = _head_bwd(mlp.logit, logit_in, g_out.to(_acc_dtype(dt)),
                               dt)
        g_enc, hidden = _hidden_bwd(mlp, ins, outs, gh.to(dt), enc.shape[1])
        n_pts = 3 * (1 + 2 * field.n_freq)
        d_raw.append((_posenc_bwd(g_enc[:, :n_pts], trig, 3, field.n_freq),
                      g_enc[:, n_pts:]))
        grads += hidden + [dw, db]
    (d_pts_w, d_emb_w), (d_pts_h, d_emb_h) = d_raw
    d_pts = ((dx_t[:, :3] + d_pts_w) + d_pts_h).float().reshape(r, s, 3)
    d_emb = (d_emb_w + d_emb_h).float().reshape(r, s, -1)
    d_z = (d_pts * directions[:, None, :]).sum(-1)
    d_o = d_pts.sum(1)
    d_d = (d_pts * z_vals[..., None]).sum(1)
    return d_z, d_o, d_d, d_emb.sum(1), [t.float() for t in grads]


fused_fields_bwd_plain.calls = 0


# ---------------------------------------------------------------------------
# The backward kernels' wrappers.


def fused_template_bwd(level: Level, raw_t, rgb_cond, g):
    """Template backward (see ``fused_template_bwd_plain``): CPU tensors
    take the plain version, CUDA tensors launch the kernel or raise."""
    if raw_t.device.type == 'cpu':
        return fused_template_bwd_plain(level, raw_t, rgb_cond, g)
    if raw_t.device.type != 'cuda':
        raise ValueError(f'fused_template_bwd: no kernel for {raw_t.device}')
    w_blob, b_blob, shapes = pack_level(level)
    wt_blob, _, _ = pack_level(level, transposed=True)
    if shapes != kernel_layout():
        raise NotImplementedError(f'{_NOT_COVERED}; layer shapes {shapes}')
    dev, f32 = raw_t.device, torch.float32
    p, r = raw_t.shape[0], rgb_cond.shape[0]
    rgbc = rgb_cond.to(torch.bfloat16).contiguous()
    build.check_tensor('raw_t', raw_t, (p, RAW_T_PAD), f32, dev)
    build.check_tensor('g', g, (p, 4), f32, dev)
    build.check_tensor('rgb_cond', rgbc, (r, FLAGSHIP['rgb_cond']),
                       torch.bfloat16, dev)
    if p % r:
        raise ValueError(f'{p} samples do not divide into {r} rays')
    lib = build.library()
    nf = _n_field_layers(level)
    n_w = sum(n * k for n, k in shapes[nf:])
    n_b = sum(n for n, _ in shapes[nf:])
    blocks = lib.hn_fused_template_bwd_blocks(p)
    dx_t = torch.empty((p, RAW_T_PAD), dtype=f32, device=dev)
    d_cond = torch.zeros((r, FLAGSHIP['rgb_cond']), dtype=f32, device=dev)
    # [dW | db] in the packed layout; every block adds its tiles' into it.
    grads = torch.zeros((n_w + n_b,), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(lib.hn_fused_template_bwd(
            raw_t.data_ptr(), rgbc.data_ptr(), g.data_ptr(),
            w_blob.data_ptr(), wt_blob.data_ptr(), b_blob.data_ptr(),
            dx_t.data_ptr(), d_cond.data_ptr(), grads.data_ptr(), p, p // r,
            blocks, stream), 'hn_fused_template_bwd')
    fused_template_bwd.launches += 1
    layers = level_layers(level)[nf:]
    return dx_t, d_cond, _unpack_grads(grads[:n_w], grads[n_w:], layers,
                                       shapes[nf:])


fused_template_bwd.launches = 0


def fused_fields_bwd(level: Level, z_vals, origins, directions, embed, dx_t):
    """Fields backward (see ``fused_fields_bwd_plain``): CPU tensors take
    the plain version, CUDA tensors launch the kernel or raise."""
    if z_vals.device.type == 'cpu':
        return fused_fields_bwd_plain(level, z_vals, origins, directions,
                                      embed, dx_t)
    if z_vals.device.type != 'cuda':
        raise ValueError(f'fused_fields_bwd: no kernel for {z_vals.device}')
    w_blob, b_blob, shapes = pack_level(level)
    wt_blob, _, _ = pack_level(level, transposed=True)
    if shapes != kernel_layout():
        raise NotImplementedError(f'{_NOT_COVERED}; layer shapes {shapes}')
    dev, f32 = z_vals.device, torch.float32
    r, s = z_vals.shape
    _check_ray_inputs(z_vals, origins, directions, embed)
    build.check_tensor('dx_t', dx_t, (r * s, RAW_T_PAD), f32, dev)
    lib = build.library()
    nf = _n_field_layers(level)
    n_w = sum(n * k for n, k in shapes[:nf])
    n_b = sum(n for n, _ in shapes[:nf])
    blocks = lib.hn_fused_fields_bwd_blocks(r * s)
    d_z = torch.empty((r, s), dtype=f32, device=dev)
    # [d origins (3) | d directions (3) | d embed (8)] per ray, added to by
    # every tile that holds samples of the ray.
    d_ray = torch.zeros((r, 6 + FLAGSHIP['embed']), dtype=f32, device=dev)
    grads = torch.zeros((n_w + n_b,), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(lib.hn_fused_fields_bwd(
            z_vals.data_ptr(), origins.data_ptr(), directions.data_ptr(),
            embed.data_ptr(), dx_t.data_ptr(), w_blob.data_ptr(),
            wt_blob.data_ptr(), b_blob.data_ptr(), d_z.data_ptr(),
            d_ray.data_ptr(), grads.data_ptr(), r, s, blocks, stream),
            'hn_fused_fields_bwd')
    fused_fields_bwd.launches += 1
    layers = level_layers(level)[:nf]
    return (d_z, d_ray[:, :3].contiguous(), d_ray[:, 3:6].contiguous(),
            d_ray[:, 6:].contiguous(),
            _unpack_grads(grads[:n_w], grads[n_w:], layers, shapes[:nf]))


fused_fields_bwd.launches = 0
