"""The translation warp's Jacobian J = d warped / d points, forward and
backward: forward-mode tangents through the warp field's MLP, the three
coordinate tangents stacked as three more row blocks beside the primal rows.

``fused_warp_jacobian`` is the wrapper. On CUDA tensors it launches the
hand-written Hopper kernel of ``csrc/tangents_fwd.cu`` (which replaces the TPU
kernel ``hypernerf_tpu/ops/pallas/fused_jacobian.py`` ``_fused_fwd``): the
level forward's block run on the warp field with its tangent streams, a tile
of 16 points x 4 streams (``fused_level.tangent_row``; its plan is
``fused_level.stage_plan('warp_tangents', ...)``'s); on CPU tensors it runs
``fused_jacobian_plain``. When a gradient is wanted the call
goes through ``FusedJacobianFn``, whose backward is ``fused_jacobian_bwd``:
on CUDA tensors the kernel of ``csrc/warp_tangents_bwd.cu`` (for the TPU
kernel's ``_fused_bwd``), kernel B's block run on the warp field with its
tangents as a block tile of 32 points x 4 streams
(``csrc/fields_bwd_alone.cuh``; its plan is
``fused_level.field_bwd_plan('warp_tangents', ...)``'s, its rows
``fused_level.tangent_row``), and ``fused_jacobian_bwd_plain`` on CPU
tensors. On a CUDA tensor a wrapper launches its kernel or raises.

Math (the TPU kernel's): the tangent encoding of point tangent k is
[e_k | cos(p_k 2^j) 2^j | -sin(p_k 2^j) 2^j on channel k's band columns | 0],
rounded to the compute dtype; a hidden layer maps tangent rows t to
round((t W) * [primal pre-activation > 0]); the skip concatenates the tangent
encoding; the head is linear without bias. J[i, k] = delta_ik + head row of
tangent k, column i. Backward: only J carries a cotangent, so it flows down
the tangent rows alone; db and d(embed) are exactly zero (both reach J only
through the ReLU masks); d(points) is the tangent encoding's pullback.

Rounding points of the backward: the cotangent stays fp32, as the TPU kernel
keeps it. The CUDA kernel holds every stored cotangent as two bf16 halves
(hi + lo, 16 mantissa bits), and the plain version rounds it to the same
hi + lo value at the same points (at float32 compute there is nothing to
round). The head's dW and g W_head take the unrounded fp32 cotangent.

The CUDA kernels are compiled for the flagship's warp field: 3 + 8 raw inputs,
10 bands, 6 x 128 with a skip after layer 4, 3 outputs, in bf16 or in
float32. A float32 field takes the float32 kernels (``f32.fused_jacobian_f32``,
csrc/f32_tangents.cu: a field alone's stages on a tile of 16 points x 4
streams, and ``f32.fused_jacobian_bwd_f32``, the float32 steps on a chunk's
streams), whose arithmetic is the plain versions' at float32.
"""

from __future__ import annotations

import importlib

import torch
import torch.nn.functional as F

from hypernerf_tpu_torch.kernels import build, common, f32
from hypernerf_tpu_torch.kernels.fused_field import field_layers
from hypernerf_tpu_torch.models.modules import MLP

JAC = 9  # columns of J per point: [i * 3 + k]


def band_columns(n_freq: int, min_deg: int, device):
    """(channel, 2^(min_deg + band)) of each of the 3 * n_freq band columns,
    band j of channel c at j * 3 + c."""
    cols = torch.arange(3 * n_freq, device=device)
    return cols % 3, 2.0 ** (min_deg + cols // 3).float()


def tangent_trig(sin, cos, n_freq: int, min_deg: int = 0):
    """(3(k), P, 3 F) fp32 tangents of the [sin | cos] band features along
    point channel k: cos * 2^m and -sin * 2^m on channel k's columns, 0
    elsewhere."""
    chan, freq = band_columns(n_freq, min_deg, sin.device)
    on = torch.stack([chan == k for k in range(3)])[:, None, :]
    zero = torch.zeros((), dtype=sin.dtype, device=sin.device)
    return (torch.where(on, cos * freq, zero),
            torch.where(on, -sin * freq, zero))


def tangent_encode_dp(g_sin, g_cos, sin, cos, n_freq: int, min_deg: int = 0):
    """Pullback of ``tangent_trig`` to the points: cotangents (3(k), P, 3 F)
    of the sin and cos tangent columns -> (P, 3). Only channel k's columns of
    tangent k depend on p_k: d [cos(p 2^m) 2^m] = -sin(p 2^m) 4^m,
    d [-sin(p 2^m) 2^m] = -cos(p 2^m) 4^m, summed over the bands in fp32."""
    chan, freq = band_columns(n_freq, min_deg, sin.device)
    pick = F.one_hot(chan, 3).t().to(g_sin.dtype)[:, None, :]  # (3, 1, 3F)
    a_sin = (g_sin * pick).sum(0) * freq
    a_cos = (g_cos * pick).sum(0) * freq
    val = (-sin * a_sin - cos * a_cos) * freq
    return val.reshape(-1, n_freq, 3).sum(1)


def stream_rows(x):
    """(3, P, C) tangent blocks -> (3P, C) rows, block k at rows k P.."""
    return x.reshape(-1, x.shape[-1])


def split_cotangent(g, dt):
    """The backward kernel's stored cotangent: fp32 ``g`` as the sum of two
    bf16 halves hi = bf16(g), lo = bf16(g - hi); ``g`` itself at any other
    compute dtype."""
    if dt != torch.bfloat16:
        return g
    hi = g.to(torch.bfloat16).float()
    return hi + (g - hi).to(torch.bfloat16).float()


def _encode_streams(mlp: MLP, n_freq: int, x_raw):
    """(trig, primal encoding (P, enc), tangent encodings (3, P, enc)), both
    rounded to the compute dtype."""
    dt = mlp.dtype
    pts = x_raw[:, :3]
    sin, cos = common.posenc_trig(pts, n_freq)
    enc = torch.cat([pts, sin, cos, x_raw[:, 3:]], dim=-1).to(dt)
    t_sin, t_cos = tangent_trig(sin, cos, n_freq)
    p = pts.shape[0]
    ident = torch.eye(3, dtype=sin.dtype, device=sin.device)[:, None, :]
    tan = torch.cat([ident.expand(3, p, 3), t_sin, t_cos,
                     torch.zeros((3, p, x_raw.shape[1] - 3), dtype=sin.dtype,
                                 device=sin.device)], dim=-1).to(dt)
    return (sin, cos), enc, tan


def streams_forward(mlp: MLP, enc, tan):
    """The hidden chain on the primal rows ``enc`` (P, C) and the tangent
    rows ``tan`` (3P, C): (logit input of the primal rows, of the tangent
    rows, [input of each layer, all 4P rows: primal, then tangent],
    [primal mask of each layer])."""
    dt, acc = mlp.dtype, common.acc_dtype(mlp.dtype)
    p = enc.shape[0]
    h, t, ins, masks = enc, tan, [], []
    for i in range(mlp.depth):
        lin = mlp.hidden(i)
        ins.append(torch.cat([h, t]))
        pre = F.linear(ins[-1].to(dt).to(acc), lin.weight.to(dt).to(acc))
        hp = pre[:p] + lin.bias.to(dt).to(acc)
        mask = hp > 0
        masks.append(mask)
        h = torch.relu(hp).to(dt)
        t = (pre[p:] * mask.repeat(3, 1)).to(dt)
        if i in mlp.skips:
            h = torch.cat([h, enc], dim=-1)
            t = torch.cat([t, tan], dim=-1)
    return h, t, ins, masks


def fused_jacobian_plain(mlp: MLP, n_freq: int, x_raw):
    """Plain PyTorch Jacobian forward.

    Args:
      x_raw: (P, 3 + E) fp32 raw rows [points | embedding].

    Returns:
      (P, 9) J with J[p, i * 3 + k] = d warped_i / d p_k, fp32 (float64 at
      that compute dtype).
    """
    fused_jacobian_plain.calls += 1
    dt = mlp.dtype
    _, enc, tan = _encode_streams(mlp, n_freq, x_raw)
    _, t, _, _ = streams_forward(mlp, enc, stream_rows(tan))
    t_out = common.prod(t, mlp.logit.weight.t(), dt)       # (3P, 3)
    p = x_raw.shape[0]
    cols = t_out.reshape(3, p, -1)[..., :3].permute(1, 2, 0)  # (P, i, k)
    eye = torch.eye(3, dtype=cols.dtype, device=cols.device)
    return (cols + eye).reshape(p, JAC)


fused_jacobian_plain.calls = 0


def fused_jacobian_bwd_plain(mlp: MLP, n_freq: int, x_raw, g):
    """Plain Jacobian backward: recompute, then walk the tangent rows back.

    Args:
      g: (P, 9) fp32 cotangent of J in its layout.

    Returns:
      dx_raw (P, 3 + E) fp32 ([d points | 0]) and [dW, db, ...] of the
      field's layers in order, fp32, in each ``nn.Linear``'s shapes (every
      db zero).
    """
    fused_jacobian_bwd_plain.calls += 1
    dt, acc = mlp.dtype, common.acc_dtype(mlp.dtype)
    width = mlp.hidden(0).out_features
    p = x_raw.shape[0]
    (sin, cos), enc, tan = _encode_streams(mlp, n_freq, x_raw)
    _, t_last, ins, masks = streams_forward(mlp, enc, stream_rows(tan))
    # Tangent row k takes column k of dJ.
    g_out = stream_rows(g.to(acc).reshape(p, 3, 3).permute(2, 0, 1))
    head = mlp.logit
    grads = [None] * (mlp.depth + 1)
    grads[mlp.depth] = (g_out.t() @ t_last.to(acc),
                        torch.zeros_like(head.bias, dtype=acc))
    gh = g_out @ head.weight.to(dt).to(acc)
    gh = split_cotangent(torch.cat([gh[:, :width] * masks[-1].repeat(3, 1),
                                    gh[:, width:]], dim=-1), dt)
    g_skip = 0.0
    if (mlp.depth - 1) in mlp.skips:
        g_skip, gh = gh[:, width:], gh[:, :width]
    for i in range(mlp.depth - 1, -1, -1):
        lin = mlp.hidden(i)
        grads[i] = (gh.t() @ ins[i][p:].to(acc),
                    torch.zeros_like(lin.bias, dtype=acc))
        gn = gh @ lin.weight.to(dt).to(acc)
        if i > 0:
            gn = torch.cat([gn[:, :width] * masks[i - 1].repeat(3, 1),
                            gn[:, width:]], dim=-1)
        gn = split_cotangent(gn, dt)
        if i > 0 and (i - 1) in mlp.skips:
            g_skip = g_skip + gn[:, width:]
            gn = gn[:, :width]
        gh = gn
    g_enc = (gh + g_skip).reshape(3, p, -1)
    nb = 3 * n_freq
    dp = tangent_encode_dp(g_enc[..., 3:3 + nb], g_enc[..., 3 + nb:3 + 2 * nb],
                           sin, cos, n_freq)
    dx = torch.cat([dp, torch.zeros_like(x_raw[:, 3:], dtype=dp.dtype)], -1)
    return dx, [t for pair in grads for t in pair]


fused_jacobian_bwd_plain.calls = 0


def _launch_args(mlp: MLP, n_freq: int, x_raw):
    """Checked inputs of a kernel launch: the packed blobs (weights, biases,
    shapes; in float32 also the weights transposed layer by layer, last),
    one set for both kernels."""
    def check():
        if mlp.dtype not in (torch.bfloat16, torch.float32) or n_freq != \
                common.FLAGSHIP['warp_freq'] or mlp.logit.out_features != 3:
            raise NotImplementedError(
                f'{common.NOT_COVERED}; got a warp field with {n_freq} bands, '
                f'{mlp.logit.out_features} outputs in {mlp.dtype}')

    layers = field_layers(mlp)
    pack = common.pack_layers(mlp, layers, check, dtype=mlp.dtype)
    check()
    if mlp.dtype == torch.float32:
        f32.check_layout(pack[2], common.WARP_LAYERS)
        pack = (*pack, common.pack_layers(mlp, layers, check,
                                          transposed=True,
                                          dtype=mlp.dtype)[0])
    else:
        common.check_layout(pack[2], common.WARP_LAYERS)
    build.check_tensor('x_raw', x_raw,
                       (x_raw.shape[0], 3 + common.FLAGSHIP['embed']),
                       torch.float32, x_raw.device)
    return pack


def _forward(mlp: MLP, n_freq: int, x_raw):
    """(P, 9) fp32 J: the plain version on CPU tensors, the kernel on CUDA
    tensors."""
    if common.runs_plain(x_raw, 'fused_warp_jacobian'):
        return fused_jacobian_plain(mlp, n_freq, x_raw)
    w_blob, b_blob, _, *f32_blobs = _launch_args(mlp, n_freq, x_raw)
    if f32_blobs:
        return f32.fused_jacobian_f32(f32_blobs[0], b_blob, x_raw)
    p = x_raw.shape[0]
    jac = torch.empty((p, JAC), dtype=torch.float32, device=x_raw.device)
    if p:
        common.launch('hn_fused_jacobian_fwd', x_raw.device, x_raw.data_ptr(),
                      w_blob.data_ptr(), b_blob.data_ptr(), jac.data_ptr(), p)
        fused_warp_jacobian.launches += 1
    return jac


def fused_warp_jacobian(mlp: MLP, n_freq: int, pts, embed) -> torch.Tensor:
    """J = d warped / d points of the translation warp ``points + mlp(
    posenc_orig(points, n_freq) ++ embed)``.

    Args:
      pts: (..., 3) points; embed: (..., E) per-point embeddings.

    Returns:
      (..., 3, 3) fp32 with [..., i, k] = d warped_i / d points_k.

    CPU tensors take ``fused_jacobian_plain``; CUDA tensors launch the kernel
    (the flagship's warp field, bf16 or float32) or raise. Differentiable in
    the points and in the field's parameters (``FusedJacobianFn``); the
    embedding's gradient is exactly zero.
    """
    batch = pts.shape[:-1]
    x_raw = torch.cat([pts.reshape(-1, 3), embed.reshape(
        -1, embed.shape[-1]).to(pts.dtype)], dim=-1)
    x_raw = x_raw.to(torch.promote_types(x_raw.dtype,
                                         torch.float32)).contiguous()
    params = common.layer_params(field_layers(mlp))
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x_raw, *params)):
        jac = FusedJacobianFn.apply(mlp, n_freq, x_raw, *params)
    else:
        jac = _forward(mlp, n_freq, x_raw)
    return jac.reshape(*batch, 3, 3)


fused_warp_jacobian.launches = 0


class FusedJacobianFn(torch.autograd.Function):
    """The Jacobian with its hand-written backward: the forward keeps the raw
    input alone, the backward recomputes."""

    @staticmethod
    def forward(ctx, mlp, n_freq, x_raw, *params):
        x_raw = x_raw.detach()
        with torch.no_grad():
            jac = _forward(mlp, n_freq, x_raw)
        ctx.mlp, ctx.n_freq = mlp, n_freq
        ctx.save_for_backward(x_raw)
        return jac

    @staticmethod
    def backward(ctx, g):
        x_raw, = ctx.saved_tensors
        with torch.no_grad():
            dx_raw, grads = fused_jacobian_bwd(ctx.mlp, ctx.n_freq, x_raw,
                                               g.contiguous())
        return (None, None, dx_raw, *grads)


def fused_jacobian_bwd(mlp: MLP, n_freq: int, x_raw, g):
    """Jacobian backward (see ``fused_jacobian_bwd_plain``): CPU tensors take
    the plain version, CUDA tensors launch the kernel or raise. The bf16
    kernel reads the field's one weight blob (no transposed form), adds dW
    into ``fused_level.FB_GRAD_COPIES`` buffers that are summed here (db
    stays zero), and gets a per-block spill scratch (its plan spills); in
    float32 the steps (``f32.fused_jacobian_bwd_f32``) read both forms."""
    if common.runs_plain(x_raw, 'fused_jacobian_bwd'):
        return fused_jacobian_bwd_plain(mlp, n_freq, x_raw, g)
    w_blob, b_blob, shapes, *f32_blobs = _launch_args(mlp, n_freq, x_raw)
    p = x_raw.shape[0]
    build.check_tensor('g', g, (p, JAC), torch.float32, x_raw.device)
    if f32_blobs:
        dx_raw, grads = f32.fused_jacobian_bwd_f32(w_blob, f32_blobs[0],
                                                   b_blob, shapes, x_raw, g)
        n_w = sum(n * k for n, k in shapes)
        return dx_raw, common.unpack_grads(grads[:n_w], grads[n_w:],
                                           field_layers(mlp), shapes)
    # fused_level models kernel B's block, which this kernel runs; imported
    # by its module path (the package re-exports a function of that name).
    fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
    dx_raw, dw, db = fl.launch_field_bwd('warp_tangents',
                                         'hn_fused_jacobian_bwd',
                                         fused_jacobian_bwd, [], x_raw, None,
                                         g, w_blob, b_blob, shapes)
    return dx_raw, common.unpack_grads(dw, db, field_layers(mlp), shapes)


fused_jacobian_bwd.launches = 0
