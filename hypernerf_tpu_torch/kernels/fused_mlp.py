"""The template MLP alone, forward and backward: the positional encoding of
raw [xyz | hyper] rows, the trunk, the bottleneck, the alpha head and the rgb
branch on the per-ray condition.

``fused_template`` is the wrapper. On CUDA tensors it launches the
hand-written Hopper kernel ``csrc/fused_template.cu`` (which replaces the TPU
kernel ``hypernerf_tpu/ops/pallas/fused_mlp.py`` ``_fwd_call``); on CPU
tensors it runs ``fused_template_plain``, the same function composed from
this package's modules. When a gradient is wanted the call goes through
``FusedTemplateFn``, whose backward is ``fused_template_bwd``: the kernel
``csrc/fused_template_bwd.cu`` (for the TPU kernel's ``_bwd_call``; it is also
the template half of the level backward) on CUDA tensors, and
``fused_template_bwd_plain``, written out without autograd and with the
kernel's rounding points, on CPU tensors. On a CUDA tensor a wrapper launches
its kernel or raises.

The CUDA kernels are compiled for the flagship template (8 x 256 with a skip
after layer 4, bottleneck 128, rgb branch 4 x 128 on 39 condition features,
xyz at 10 bands, 4 hyper coordinates at 6 bands, bf16). A template without
hyper coordinates (static NeRF) runs through the same kernels: its encoding
is packed with zero weight columns where the hyper bands would be, which is
exact, and those columns' dW is dropped on unpack.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from hypernerf_tpu_torch.kernels import build, common
from hypernerf_tpu_torch.models.modules import NerfMLP, dense
from hypernerf_tpu_torch.ops.posenc import posenc_orig

RAW_PAD = 8  # columns of the raw input and its cotangent: [xyz | hyper | 0]


class Template(NamedTuple):
    """A template module and its encoding bands. (A ``fused_level.Level``
    carries the same three fields and serves as one.)"""
    template: NerfMLP
    xyz_freq: int
    hyper_freq: int


def n_hyper(tmpl) -> int:
    """Hyper coordinates the template's encoding holds (0: static)."""
    enc = tmpl.template.trunk.hidden(0).in_features
    return (enc - 3 * (1 + 2 * tmpl.xyz_freq)) // (1 + 2 * tmpl.hyper_freq)


def template_layers(t: NerfMLP, enc_pad: int = 0):
    """Every Linear of the template in kernel order with its input segments;
    the encoding is padded to ``enc_pad`` columns (default: to 16)."""
    enc = t.trunk.hidden(0).in_features
    tw = t.bottleneck.in_features
    bw = t.bottleneck.out_features
    cond = t.rgb_branch.hidden(0).in_features - bw
    return (common.mlp_layers(t.trunk, [(enc, enc_pad or common.pad16(enc))])
            + [(t.bottleneck, [(tw, tw)]), (t.alpha_head, [(bw, bw)])]
            + common.mlp_layers(t.rgb_branch,
                                [(bw, bw), (cond, common.pad16(cond))]))


def _segments(tmpl, x_raw):
    """((raw columns, channels, bands), ...) of the encoding's segments."""
    segs = [(x_raw[:, :3], 3, tmpl.xyz_freq)]
    nh = n_hyper(tmpl)
    if nh:
        segs.append((x_raw[:, 3:3 + nh], nh, tmpl.hyper_freq))
    return segs


def _recompute(tmpl, x_raw, rgb_cond):
    """The forward with everything the backward needs kept."""
    t = tmpl.template
    dt = t.dtype
    p, r = x_raw.shape[0], rgb_cond.shape[0]
    segs = _segments(tmpl, x_raw)
    trigs = [common.posenc_trig(x, f) for x, _, f in segs]
    feat = torch.cat([torch.cat([x, sin, cos], dim=-1)
                      for (x, _, _), (sin, cos) in zip(segs, trigs)], dim=-1)
    x = feat.to(dt)
    ins, outs, tl_in = common.mlp_recompute(t.trunk, x)
    hl = dense(tl_in, t.trunk.logit, dt, relu=True)
    bneck = dense(hl, t.bottleneck, dt).to(dt)
    cond = rgb_cond.to(dt)
    r_in = torch.cat([bneck, cond.repeat_interleave(p // r, dim=0)], dim=-1)
    r_ins, r_outs, rl_in = common.mlp_recompute(t.rgb_branch, r_in)
    return dict(segs=segs, trigs=trigs, x=x, ins=ins, outs=outs, tl_in=tl_in,
                hl=hl, bneck=bneck, r_in=r_in, r_ins=r_ins, r_outs=r_outs,
                rl_in=rl_in)


def fused_template_plain(tmpl, x_raw, rgb_cond):
    """Plain PyTorch template forward.

    Args:
      x_raw: (P, 8) fp32 raw rows [xyz | hyper | 0].
      rgb_cond: (R, C) per-ray condition; each row serves P / R consecutive
        rows of ``x_raw``.

    Returns:
      (P, 4) fp32 [rgb logits (3) | raw sigma].
    """
    fused_template_plain.calls += 1
    p, r = x_raw.shape[0], rgb_cond.shape[0]
    feat = torch.cat([posenc_orig(x, f) for x, _, f in _segments(tmpl, x_raw)],
                     dim=-1)
    raw = tmpl.template(feat.reshape(r, p // r, -1), rgb_cond)
    return torch.cat([raw['rgb'], raw['alpha']],
                     dim=-1).reshape(p, -1).float()


fused_template_plain.calls = 0


def fused_template_bwd_plain(tmpl, raw_t, rgb_cond, g):
    """Plain template backward: recompute from ``raw_t``, then walk back.

    Args:
      raw_t: (P, 8) fp32 [xyz | hyper | 0]; rgb_cond: (R, C);
      g: (P, 4) fp32 cotangent of [rgb logits | raw sigma].

    Returns:
      dx_t (P, 8) fp32, d rgb_cond (R, C) fp32 summed per ray, and
      [dW, db, ...] of the template's layers in kernel order, fp32, in each
      ``nn.Linear``'s shapes.
    """
    fused_template_bwd_plain.calls += 1
    t = tmpl.template
    dt, acc = t.dtype, common.acc_dtype(t.dtype)
    p, r = raw_t.shape[0], rgb_cond.shape[0]
    n_rgb = t.rgb_branch.logit.out_features
    v = _recompute(tmpl, raw_t, rgb_cond)

    g = g.to(acc)
    dw_rl, db_rl, gg = common.head_bwd(t.rgb_branch.logit, v['rl_in'],
                                       g[:, :n_rgb], dt)
    g_rin, rgb_grads = common.hidden_bwd(t.rgb_branch, v['r_ins'],
                                         v['r_outs'], gg.to(dt),
                                         v['r_in'].shape[1])
    bw = v['bneck'].shape[1]
    dw_a, db_a, ga = common.head_bwd(t.alpha_head, v['bneck'], g[:, n_rgb:],
                                     dt)
    g_b = g_rin[:, :bw] + ga
    dw_bn, db_bn, g_hl = common.head_bwd(t.bottleneck, v['hl'], g_b, dt)
    g_hl = torch.where(v['hl'].to(acc) > 0, g_hl,
                       torch.zeros_like(g_hl)).to(dt)
    dw_tl = common.prod(g_hl.t(), v['tl_in'], dt)
    db_tl = g_hl.to(acc).sum(0)
    gh = common.prod(g_hl, t.trunk.logit.weight, dt).to(dt)
    g_x, trunk_grads = common.hidden_bwd(t.trunk, v['ins'], v['outs'], gh,
                                         v['x'].shape[1])

    dx, at = [], 0
    for (_, ch, f), trig in zip(v['segs'], v['trigs']):
        width = ch * (1 + 2 * f)
        dx.append(common.posenc_bwd(g_x[:, at:at + width], trig, ch, f))
        at += width
    dx_t = torch.cat(dx, dim=-1).float()
    dx_t = F.pad(dx_t, (0, RAW_PAD - dx_t.shape[1]))
    d_cond = g_rin[:, bw:].reshape(r, p // r, -1).sum(1).float()
    grads = (trunk_grads + [dw_tl, db_tl, dw_bn, db_bn, dw_a, db_a]
             + rgb_grads + [dw_rl, db_rl])
    return dx_t, d_cond, [t_.float() for t_ in grads]


fused_template_bwd_plain.calls = 0


def _check_covered(tmpl) -> None:
    t = tmpl.template
    nh = n_hyper(tmpl)
    flag = common.FLAGSHIP
    have = dict(xyz_freq=tmpl.xyz_freq,
                rgb_cond=t.rgb_branch.hidden(0).in_features
                - t.bottleneck.out_features)
    if nh:
        have.update(hyper_out=nh, hyper_freq=tmpl.hyper_freq)
    dtypes = {t.trunk.dtype, t.rgb_branch.dtype, t.dtype}
    if any(flag[k] != v for k, v in have.items()) \
            or dtypes != {torch.bfloat16}:
        raise NotImplementedError(f'{common.NOT_COVERED}; got {have}, '
                                  f'{dtypes}')


def _launch_args(tmpl, x_raw, rgb_cond, transposed: bool):
    """Checked inputs of a kernel launch: the bf16 condition, the rows per
    condition row and the packed blobs."""
    table = common.kernel_layout()[common.TEMPLATE_LAYERS]
    layers = template_layers(tmpl.template, enc_pad=table[0][1])
    check = lambda: _check_covered(tmpl)
    packs = [common.pack_layers(tmpl.template, layers, check)]
    if transposed:
        packs.append(common.pack_layers(tmpl.template, layers, check,
                                        transposed=True))
    common.check_layout(packs[0][2], common.TEMPLATE_LAYERS)
    dev = x_raw.device
    p, r = x_raw.shape[0], rgb_cond.shape[0]
    rgbc = rgb_cond.detach().to(torch.bfloat16).contiguous()
    build.check_tensor('x_raw', x_raw, (p, RAW_PAD), torch.float32, dev)
    build.check_tensor('rgb_cond', rgbc, (r, common.FLAGSHIP['rgb_cond']),
                       torch.bfloat16, dev)
    if r == 0 or p % r:
        raise ValueError(f'{p} samples do not divide into {r} rays')
    return rgbc, p // r, layers, packs


def _forward(tmpl, x_raw, rgb_cond):
    if common.runs_plain(x_raw, 'fused_template'):
        return fused_template_plain(tmpl, x_raw, rgb_cond)
    rgbc, s, _, ((w_blob, b_blob, _),) = _launch_args(tmpl, x_raw, rgb_cond,
                                                     False)
    p = x_raw.shape[0]
    out = torch.empty((p, 4), dtype=torch.float32, device=x_raw.device)
    common.launch('hn_fused_template_fwd', x_raw.device, x_raw.data_ptr(),
                  rgbc.data_ptr(), w_blob.data_ptr(), b_blob.data_ptr(),
                  out.data_ptr(), p, s)
    fused_template.launches += 1
    return out


def fused_template(tmpl, x_raw, rgb_cond) -> torch.Tensor:
    """Template forward; (P, 4) fp32 [rgb logits | raw sigma].

    CPU tensors take ``fused_template_plain``; CUDA tensors launch the kernel
    (flagship widths, bf16) or raise. Differentiable in ``x_raw``,
    ``rgb_cond`` and the template's parameters (``FusedTemplateFn``).
    """
    params = common.layer_params(template_layers(tmpl.template))
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x_raw, rgb_cond, *params)):
        return FusedTemplateFn.apply(tmpl, x_raw, rgb_cond, *params)
    return _forward(tmpl, x_raw, rgb_cond)


fused_template.launches = 0


class FusedTemplateFn(torch.autograd.Function):
    """The template with its hand-written backward: the forward keeps the
    raw input and the condition, the backward recomputes."""

    @staticmethod
    def forward(ctx, tmpl, x_raw, rgb_cond, *params):
        x_raw, rgb_cond = x_raw.detach(), rgb_cond.detach()
        with torch.no_grad():
            out = _forward(tmpl, x_raw, rgb_cond)
        ctx.tmpl = tmpl
        ctx.save_for_backward(x_raw, rgb_cond)
        return out

    @staticmethod
    def backward(ctx, g):
        x_raw, rgb_cond = ctx.saved_tensors
        with torch.no_grad():
            dx, d_cond, grads = fused_template_bwd(ctx.tmpl, x_raw, rgb_cond,
                                                   g.contiguous())
        return (None, dx, d_cond.to(rgb_cond.dtype), *grads)


def fused_template_bwd(tmpl, raw_t, rgb_cond, g):
    """Template backward (see ``fused_template_bwd_plain``): CPU tensors
    take the plain version, CUDA tensors launch the kernel or raise."""
    if common.runs_plain(raw_t, 'fused_template_bwd'):
        return fused_template_bwd_plain(tmpl, raw_t, rgb_cond, g)
    rgbc, s, layers, ((w_blob, b_blob, shapes), (wt_blob, _, _)) = \
        _launch_args(tmpl, raw_t, rgb_cond, True)
    dev, f32 = raw_t.device, torch.float32
    p, r = raw_t.shape[0], rgb_cond.shape[0]
    build.check_tensor('g', g, (p, 4), f32, dev)
    blocks = build.library().hn_fused_template_bwd_blocks(p)
    dx_t = torch.empty((p, RAW_PAD), dtype=f32, device=dev)
    d_cond = torch.zeros((r, common.FLAGSHIP['rgb_cond']), dtype=f32,
                         device=dev)
    grads, n_w = common.grad_buffer(shapes, dev)
    common.launch('hn_fused_template_bwd', dev, raw_t.data_ptr(),
                  rgbc.data_ptr(), g.data_ptr(), w_blob.data_ptr(),
                  wt_blob.data_ptr(), b_blob.data_ptr(), dx_t.data_ptr(),
                  d_cond.data_ptr(), grads.data_ptr(), p, s, blocks)
    fused_template_bwd.launches += 1
    return dx_t, d_cond, common.unpack_grads(grads[:n_w], grads[n_w:], layers,
                                             shapes)


fused_template_bwd.launches = 0
