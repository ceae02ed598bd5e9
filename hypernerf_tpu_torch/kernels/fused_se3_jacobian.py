"""The SE(3) / quaternion trunk's primal outputs (w, v) and their
point-tangents d{w, v}_i / d p_k, forward and backward: the trunk of
``kernels.fused_se3`` with the three coordinate tangents stacked as three
more row blocks beside the primal rows.

``fused_se3_wv_tangents`` is the wrapper. On CUDA tensors it launches the
hand-written Hopper kernel ``csrc/fused_se3_jacobian.cu`` (which replaces the
TPU kernel ``hypernerf_tpu/ops/pallas/fused_se3_jacobian.py`` ``_fused_fwd``);
on CPU tensors it runs ``fused_se3_jacobian_plain``. When a gradient is
wanted the call goes through ``FusedSE3JacobianFn``, whose backward is
``fused_se3_jacobian_bwd``: the kernel ``csrc/fused_se3_jacobian_bwd.cu``
(for the TPU kernel's ``_fused_bwd``) on CUDA tensors,
``fused_se3_jacobian_bwd_plain`` on CPU tensors. On a CUDA tensor a wrapper
launches its kernel or raises. The retraction's point-Jacobian from these
outputs is the caller's (``ops.rigid_body.retraction_jacobian``).

Math (the TPU kernel's): the tangent encoding of point tangent k is
[cos(p_k 2^m) 2^m | -sin(p_k 2^m) 2^m on channel k's band columns | 0] times
the window row, rounded once; hidden layers map tangent rows t to
round((t W) * [primal pre-activation > 0]); the trunk logit is linear, so its
tangent passes unmasked and is rounded like its primal output; the heads are
linear, fp32, the bias on the primal rows alone. Backward: both streams carry
cotangents and couple only through the masks, so dW sums the primal and the
tangent rows, db the primal rows alone, tangent rows are masked by their
primal row, d(embed) comes from the primal encoding's pullback and d(points)
adds the tangent encoding's. Rounding points are ``fused_se3_bwd``'s: the
heads' cotangents rounded for the products (their db sums the fp32 values),
g_w W_w + g_v W_v summed in fp32 and rounded once, hidden cotangents rounded
after every product.

The CUDA kernels are compiled for the flagship's trunk (``fused_se3``'s).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hypernerf_tpu_torch.kernels import build, common
from hypernerf_tpu_torch.kernels.fused_jacobian import (stream_rows,
                                                        streams_forward,
                                                        tangent_encode_dp,
                                                        tangent_trig)
from hypernerf_tpu_torch.kernels.fused_se3 import (_encode, check_covered,
                                                   se3_layers)

OUT = 24  # columns per point: [w (3) | v (3) | dw (9) | dv (9)]


def _encode_streams(field, x_raw, scales):
    """(trig, primal encoding (P, enc), tangent encodings (3, P, enc)), both
    in the compute dtype, the window row applied."""
    dt = field.trunk.dtype
    n_freq = field.max_deg - field.min_deg
    (sin, cos), enc = _encode(field, x_raw, scales)
    t_sin, t_cos = tangent_trig(sin, cos, n_freq, field.min_deg)
    p = x_raw.shape[0]
    parts = [t_sin, t_cos]
    if field.use_metadata:
        parts.append(torch.zeros((3, p, x_raw.shape[1] - 3), dtype=sin.dtype,
                                 device=sin.device))
    tan = torch.cat(parts, dim=-1)
    if scales is not None:
        tan = tan * scales.reshape(1, 1, -1)
    return (sin, cos), enc, tan.to(dt)


def _trunk_streams(field, enc, tan):
    """The trunk on the primal and tangent rows: (trunk output of all 4P rows
    rounded, logit input of all rows, [input of each hidden layer, all rows],
    [primal mask of each hidden layer])."""
    mlp = field.trunk
    dt, acc = mlp.dtype, common.acc_dtype(mlp.dtype)
    p = enc.shape[0]
    h, t, ins, masks = streams_forward(mlp, enc, stream_rows(tan))
    logit_in = torch.cat([h, t])
    pre = F.linear(logit_in.to(dt).to(acc), mlp.logit.weight.to(dt).to(acc))
    trunk = (pre[:p] + mlp.logit.bias.to(dt).to(acc)).to(dt)
    return torch.cat([trunk, pre[p:].to(dt)]), logit_in, ins, masks


def _heads(field, trunk4, p):
    """The w and v heads on all 4P rows, fp32, the bias on the primal rows."""
    dt = field.trunk.dtype
    acc = common.acc_dtype(dt)
    outs = []
    for head in (field.w_net.logit, field.v_net.logit):
        pre = F.linear(trunk4.to(acc), head.weight.to(dt).to(acc))
        outs.append(torch.cat([pre[:p] + head.bias.to(dt).to(acc), pre[p:]]))
    return outs


def fused_se3_jacobian_plain(field, x_raw, scales=None):
    """Plain PyTorch forward.

    Args:
      x_raw: (P, 3 + E) fp32 raw rows [points | embedding].
      scales: optional (enc,) fp32 window row over the encoded features.

    Returns:
      (P, 24) fp32 [w | v | dw | dv], dw[p, i * 3 + k] = d w_i / d p_k.
    """
    fused_se3_jacobian_plain.calls += 1
    p = x_raw.shape[0]
    _, enc, tan = _encode_streams(field, x_raw, scales)
    trunk4, _, _, _ = _trunk_streams(field, enc, tan)
    w4, v4 = _heads(field, trunk4, p)
    tang = [x[p:].reshape(3, p, 3).permute(1, 2, 0).reshape(p, 9)
            for x in (w4, v4)]
    return torch.cat([w4[:p], v4[:p], *tang], dim=-1)


fused_se3_jacobian_plain.calls = 0


def fused_se3_jacobian_bwd_plain(field, x_raw, g, scales=None):
    """Plain backward: recompute, then walk both streams back together.

    Args:
      g: (P, 24) fp32 cotangent of [w | v | dw | dv].

    Returns:
      dx_raw (P, 3 + E) fp32 and [dW, db, ...] of the field's layers in
      kernel order, fp32, in each ``nn.Linear``'s shapes.
    """
    fused_se3_jacobian_bwd_plain.calls += 1
    mlp = field.trunk
    dt, acc = mlp.dtype, common.acc_dtype(mlp.dtype)
    width = mlp.hidden(0).out_features
    n_freq = field.max_deg - field.min_deg
    p = x_raw.shape[0]
    (sin, cos), enc, tan = _encode_streams(field, x_raw, scales)
    trunk4, logit_in4, ins4, masks = _trunk_streams(field, enc, tan)
    g = g.to(acc)

    def stacked(primal, tangent):  # (P, 3), (P, 9) -> (4P, 3) rows
        return torch.cat([primal, stream_rows(
            tangent.reshape(p, 3, 3).permute(2, 0, 1))])

    # The heads: dW over all rows from the rounded cotangent, db over the
    # primal rows from the fp32 one; g_w W_w + g_v W_v in fp32, rounded once.
    heads, g4 = [], 0.0
    for head, gh in ((field.w_net.logit, stacked(g[:, 0:3], g[:, 6:15])),
                     (field.v_net.logit, stacked(g[:, 3:6], g[:, 15:24]))):
        gh_c = gh.to(dt)
        heads += [common.prod(gh_c.t(), trunk4, dt), gh[:p].sum(0)]
        g4 = g4 + common.prod(gh_c, head.weight, dt)
    # The trunk logit: linear, its db over the primal rows.
    g4 = g4.to(dt)
    logit = [common.prod(g4.t(), logit_in4, dt), g4[:p].to(acc).sum(0)]
    g4 = common.prod(g4, mlp.logit.weight, dt).to(dt)
    g_enc = torch.zeros((4 * p, enc.shape[1]), dtype=acc, device=g.device)
    if (mlp.depth - 1) in mlp.skips:
        g_enc = g_enc + g4[:, width:].to(acc)
        g4 = g4[:, :width]
    hidden = [None] * mlp.depth
    for i in range(mlp.depth - 1, -1, -1):
        # Every row is masked by its point's primal ReLU.
        gp = torch.where(masks[i].repeat(4, 1), g4, torch.zeros_like(g4))
        hidden[i] = [common.prod(gp.t(), ins4[i], dt), gp[:p].to(acc).sum(0)]
        g4 = common.prod(gp, mlp.hidden(i).weight, dt).to(dt)
        if i > 0 and (i - 1) in mlp.skips:
            g_enc = g_enc + g4[:, width:].to(acc)
            g4 = g4[:, :width]
    g_enc = g_enc + g4.to(acc)
    if scales is not None:
        g_enc = g_enc * scales.reshape(1, -1)
    # d pts: the primal encoding's pullback plus the tangent encoding's.
    nb = 3 * n_freq
    freqs = 2.0 ** torch.arange(field.min_deg, field.max_deg, dtype=acc,
                                device=g.device)
    flat = cos * g_enc[:p, :nb] - sin * g_enc[:p, nb:2 * nb]
    d_pts = (flat.reshape(-1, n_freq, 3) * freqs[:, None]).sum(1)
    g_tan = g_enc[p:].reshape(3, p, -1)
    d_pts = d_pts + tangent_encode_dp(g_tan[..., :nb], g_tan[..., nb:2 * nb],
                                      sin, cos, n_freq, field.min_deg)
    dx = torch.cat([d_pts, g_enc[:p, 2 * nb:2 * nb + x_raw.shape[1] - 3]],
                   dim=-1)
    grads = [t for pair in hidden for t in pair] + logit + heads
    return dx, grads


fused_se3_jacobian_bwd_plain.calls = 0


def _launch_args(field, x_raw, scales, transposed):
    """Checked inputs of a kernel launch: the padded window row or None and
    the packed blobs."""
    check = lambda: check_covered(field)
    layers = se3_layers(field)
    packs = [common.pack_layers(field, layers, check)]
    if transposed:
        packs.append(common.pack_layers(field, layers, check,
                                        transposed=True))
    check()
    common.check_layout(packs[0][2], common.SE3_LAYERS, 'se3')
    dev = x_raw.device
    build.check_tensor('x_raw', x_raw,
                       (x_raw.shape[0], 3 + common.SE3_FLAGSHIP['embed']),
                       torch.float32, dev)
    scales = common.padded_scales(scales, field.trunk.hidden(0).in_features,
                                  packs[0][2][0][1], dev)
    return scales, packs


def _forward(field, x_raw, scales):
    """(P, 24) fp32 [w | v | dw | dv]: the plain version on CPU tensors, the
    kernel on CUDA tensors."""
    if common.runs_plain(x_raw, 'fused_se3_wv_tangents'):
        return fused_se3_jacobian_plain(field, x_raw, scales)
    scales, ((w_blob, b_blob, _),) = _launch_args(field, x_raw, scales, False)
    p = x_raw.shape[0]
    out = torch.empty((p, OUT), dtype=torch.float32, device=x_raw.device)
    if p:
        common.launch('hn_fused_se3_jacobian_fwd', x_raw.device,
                      x_raw.data_ptr(),
                      None if scales is None else scales.data_ptr(),
                      w_blob.data_ptr(), b_blob.data_ptr(), out.data_ptr(), p)
        fused_se3_wv_tangents.launches += 1
    return out


def fused_se3_wv_tangents(field, x_raw, scales=None):
    """The trunk's (w, v) and their point-tangents.

    Args:
      x_raw: (P, 3 + E) fp32 raw rows [points | embedding].
      scales: optional (enc,) fp32 window row (``se3_encoding_scales``).

    Returns:
      w, v (P, 3) and dw, dv (P, 3, 3) fp32 with dw[p, i, k] = d w_i / d p_k.

    CPU tensors take ``fused_se3_jacobian_plain``; CUDA tensors launch the
    kernel (the flagship's trunk, bf16) or raise. Differentiable in
    ``x_raw`` and in the field's parameters (``FusedSE3JacobianFn``).
    """
    params = common.layer_params(se3_layers(field))
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x_raw, *params)):
        out = FusedSE3JacobianFn.apply(field, x_raw, scales, *params)
    else:
        out = _forward(field, x_raw, scales)
    p = out.shape[0]
    return (out[:, 0:3], out[:, 3:6], out[:, 6:15].reshape(p, 3, 3),
            out[:, 15:24].reshape(p, 3, 3))


fused_se3_wv_tangents.launches = 0


class FusedSE3JacobianFn(torch.autograd.Function):
    """The trunk's tangents with their hand-written backward: the forward
    keeps the raw input alone, the backward recomputes."""

    @staticmethod
    def forward(ctx, field, x_raw, scales, *params):
        x_raw = x_raw.detach()
        with torch.no_grad():
            out = _forward(field, x_raw, scales)
        ctx.field, ctx.scales = field, scales
        ctx.save_for_backward(x_raw)
        return out

    @staticmethod
    def backward(ctx, g):
        x_raw, = ctx.saved_tensors
        with torch.no_grad():
            dx_raw, grads = fused_se3_jacobian_bwd(ctx.field, x_raw,
                                                   g.contiguous(), ctx.scales)
        return (None, dx_raw, None, *grads)


def fused_se3_jacobian_bwd(field, x_raw, g, scales=None):
    """Backward (see ``fused_se3_jacobian_bwd_plain``): CPU tensors take the
    plain version, CUDA tensors launch the kernel or raise."""
    if common.runs_plain(x_raw, 'fused_se3_jacobian_bwd'):
        return fused_se3_jacobian_bwd_plain(field, x_raw, g, scales)
    scales, ((w_blob, b_blob, shapes), (wt_blob, _, _)) = _launch_args(
        field, x_raw, scales, True)
    dev, p = x_raw.device, x_raw.shape[0]
    build.check_tensor('g', g, (p, OUT), torch.float32, dev)
    dx_raw = torch.empty_like(x_raw)
    grads, n_w = common.grad_buffer(shapes, dev)
    if p:
        blocks = build.library().hn_fused_se3_jacobian_bwd_blocks(p)
        common.launch('hn_fused_se3_jacobian_bwd', dev, x_raw.data_ptr(),
                      None if scales is None else scales.data_ptr(),
                      g.data_ptr(), w_blob.data_ptr(), wt_blob.data_ptr(),
                      b_blob.data_ptr(), dx_raw.data_ptr(), grads.data_ptr(),
                      p, blocks)
        fused_se3_jacobian_bwd.launches += 1
    return dx_raw, common.unpack_grads(grads[:n_w], grads[n_w:],
                                       se3_layers(field), shapes)


fused_se3_jacobian_bwd.launches = 0
