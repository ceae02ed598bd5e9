"""One field MLP alone, forward and backward: the positional encoding of raw
[points | embedding] rows, a skip MLP and one linear head — the warp field's
translation or the hyper sheet's coordinates.

``fused_field`` is the wrapper. On CUDA tensors it launches the hand-written
Hopper kernel ``csrc/fused_field.cu`` (which replaces the TPU kernel
``hypernerf_tpu/ops/pallas/fused_field.py`` ``_fused``); on CPU tensors it
runs ``fused_field_plain``, the same function composed from this package's
modules. When a gradient is wanted the call goes through ``FusedFieldFn``,
whose backward is ``fused_field_bwd``: the kernel ``csrc/fused_field_bwd.cu``
(for the TPU kernel's ``_fused_bwd``) on CUDA tensors, and
``fused_field_bwd_plain``, written out without autograd and with the
kernel's rounding points, on CPU tensors. On a CUDA tensor a wrapper launches
its kernel or raises.

The optional ``scales`` row is the annealing window of the windowed
encoding: one fp32 weight per encoded feature, multiplied into the rounded
encoding (identity and embedding features weigh 1); the backward scales the
encoding's cotangent by the same row. It is a schedule constant and gets no
gradient.

The CUDA kernels are compiled for two fields: the flagship warp (6 x 128,
10 bands, 3 outputs) and sheet (6 x 64, 7 bands, 4 outputs), both on
3 + 8 raw inputs, skip after layer 4, bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hypernerf_tpu_torch.kernels import build, common
from hypernerf_tpu_torch.models.modules import MLP
from hypernerf_tpu_torch.ops.posenc import posenc_orig_channels

OUT_PAD = 8  # columns of the kernels' output and cotangent: [out | 0]
# The compiled fields: n_freq -> (rows of the layer table, index in csrc).
_COMPILED = {common.FLAGSHIP['warp_freq']: (common.WARP_LAYERS, 0),
             common.FLAGSHIP['hyper_sheet_freq']: (common.SHEET_LAYERS, 1)}


def field_layers(mlp: MLP):
    """Every Linear of the field in kernel order with its input segments."""
    enc = mlp.hidden(0).in_features
    return common.mlp_layers(mlp, [(enc, common.pad16(enc))])


def encoding_scales(n_freq: int, embed_ch: int, alpha: float,
                    device=None) -> torch.Tensor:
    """The (enc,) fp32 window row of a field's encoding at annealing
    ``alpha``: band k of the points' sin and cos features weighs
    0.5 (1 - cos(pi clip(alpha - k, 0, 1))), fully on once alpha >= k + 1;
    the identity and embedding features weigh 1."""
    return common.encoding_scales(((3, n_freq), (embed_ch, 0)), (alpha, None),
                                  device)


def _encode(mlp: MLP, n_freq: int, x_raw, scales):
    """(trig, encoding in the compute dtype) of raw rows [points | embed]."""
    pts = x_raw[:, :3]
    trig = common.posenc_trig(pts, n_freq)
    enc = torch.cat([pts, *trig, x_raw[:, 3:]], dim=-1).to(mlp.dtype)
    return trig, common.scaled(enc, scales, mlp.dtype)


def fused_field_plain(mlp: MLP, n_freq: int, x_raw, scales=None):
    """Plain PyTorch field forward.

    Args:
      x_raw: (P, 3 + E) fp32 raw rows [points | embedding].
      scales: optional (enc,) fp32 window row over the encoded features.

    Returns:
      (P, out_ch) fp32.
    """
    fused_field_plain.calls += 1
    return mlp(_encode(mlp, n_freq, x_raw, scales)[1])


fused_field_plain.calls = 0


def fused_field_bwd_plain(mlp: MLP, n_freq: int, x_raw, g, scales=None):
    """Plain field backward: recompute, then walk back.

    Args:
      g: (P, 8) fp32 cotangent of [out | 0] (columns past out_ch unused).

    Returns:
      dx_raw (P, 3 + E) fp32 and [dW, db, ...] of the field's layers in
      order, fp32, in each ``nn.Linear``'s shapes.
    """
    fused_field_bwd_plain.calls += 1
    dt, acc = mlp.dtype, common.acc_dtype(mlp.dtype)
    trig, enc = _encode(mlp, n_freq, x_raw, scales)
    ins, outs, logit_in = common.mlp_recompute(mlp, enc)
    g_out = g[:, :mlp.logit.out_features].to(acc)
    dw, db, gh = common.head_bwd(mlp.logit, logit_in, g_out, dt)
    g_enc, hidden = common.hidden_bwd(mlp, ins, outs, gh.to(dt),
                                      enc.shape[1])
    if scales is not None:
        g_enc = g_enc * scales.reshape(1, -1)
    n_pts = posenc_orig_channels(3, n_freq)
    dx = torch.cat([common.posenc_bwd(g_enc[:, :n_pts], trig, 3, n_freq),
                    g_enc[:, n_pts:]], dim=-1)
    return dx.float(), [t.float() for t in hidden + [dw, db]]


fused_field_bwd_plain.calls = 0


def _launch_args(mlp: MLP, n_freq: int, x_raw, scales, transposed):
    """Checked inputs of a kernel launch: (index of the compiled field, the
    padded window row or None, the packed blobs)."""
    def check():
        if mlp.dtype != torch.bfloat16 or n_freq not in _COMPILED:
            raise NotImplementedError(
                f'{common.NOT_COVERED}; got a field with {n_freq} bands in '
                f'{mlp.dtype}')

    layers = field_layers(mlp)
    packs = [common.pack_layers(mlp, layers, check)]
    if transposed:
        packs.append(common.pack_layers(mlp, layers, check,
                                        transposed=True))
    shapes = packs[0][2]
    check()
    table, which = _COMPILED[n_freq]
    common.check_layout(shapes, table)
    dev = x_raw.device
    build.check_tensor('x_raw', x_raw,
                       (x_raw.shape[0], 3 + common.FLAGSHIP['embed']),
                       torch.float32, dev)
    scales = common.padded_scales(scales, mlp.hidden(0).in_features,
                                  shapes[0][1], dev)
    return which, scales, packs


def _forward(mlp: MLP, n_freq: int, x_raw, scales):
    """(P, 8) fp32 [out | 0]: the plain version on CPU tensors, the kernel on
    CUDA tensors."""
    if common.runs_plain(x_raw, 'fused_field'):
        out = fused_field_plain(mlp, n_freq, x_raw, scales)
        return F.pad(out.float(), (0, OUT_PAD - out.shape[1]))
    which, scales, ((w_blob, b_blob, _),) = _launch_args(mlp, n_freq, x_raw,
                                                         scales, False)
    p = x_raw.shape[0]
    out = torch.empty((p, OUT_PAD), dtype=torch.float32, device=x_raw.device)
    if p:
        common.launch('hn_fused_field_fwd', x_raw.device, which,
                      x_raw.data_ptr(),
                      None if scales is None else scales.data_ptr(),
                      w_blob.data_ptr(), b_blob.data_ptr(), out.data_ptr(), p)
        fused_field.launches += 1
    return out


def fused_field(mlp: MLP, n_freq: int, x_raw, scales=None) -> torch.Tensor:
    """Field forward; (P, out_ch) fp32.

    CPU tensors take ``fused_field_plain``; CUDA tensors launch the kernel
    (the two compiled fields, bf16) or raise. Differentiable in ``x_raw``
    and in the field's parameters (``FusedFieldFn``).
    """
    params = common.layer_params(field_layers(mlp))
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x_raw, *params)):
        out = FusedFieldFn.apply(mlp, n_freq, x_raw, scales, *params)
    else:
        out = _forward(mlp, n_freq, x_raw, scales)
    return out[:, :mlp.logit.out_features]


fused_field.launches = 0


class FusedFieldFn(torch.autograd.Function):
    """The field with its hand-written backward: the forward keeps the raw
    input alone, the backward recomputes. Gradients of a field shared by two
    levels add up in autograd."""

    @staticmethod
    def forward(ctx, mlp, n_freq, x_raw, scales, *params):
        x_raw = x_raw.detach()
        with torch.no_grad():
            out = _forward(mlp, n_freq, x_raw, scales)
        ctx.mlp, ctx.n_freq, ctx.scales = mlp, n_freq, scales
        ctx.save_for_backward(x_raw)
        return out

    @staticmethod
    def backward(ctx, g):
        x_raw, = ctx.saved_tensors
        with torch.no_grad():
            dx_raw, grads = fused_field_bwd(ctx.mlp, ctx.n_freq, x_raw,
                                            g.contiguous(), ctx.scales)
        return (None, None, dx_raw, None, *grads)


def fused_field_bwd(mlp: MLP, n_freq: int, x_raw, g, scales=None):
    """Field backward (see ``fused_field_bwd_plain``): CPU tensors take the
    plain version, CUDA tensors launch the kernel or raise."""
    if common.runs_plain(x_raw, 'fused_field_bwd'):
        return fused_field_bwd_plain(mlp, n_freq, x_raw, g, scales)
    which, scales, ((w_blob, b_blob, shapes), (wt_blob, _, _)) = \
        _launch_args(mlp, n_freq, x_raw, scales, True)
    dev, p = x_raw.device, x_raw.shape[0]
    build.check_tensor('g', g, (p, OUT_PAD), torch.float32, dev)
    dx_raw = torch.empty_like(x_raw)
    grads, n_w = common.grad_buffer(shapes, dev)
    if p:
        blocks = build.library().hn_fused_field_bwd_blocks(p)
        common.launch('hn_fused_field_bwd', dev, which, x_raw.data_ptr(),
                      None if scales is None else scales.data_ptr(),
                      g.data_ptr(), w_blob.data_ptr(), wt_blob.data_ptr(),
                      b_blob.data_ptr(), dx_raw.data_ptr(), grads.data_ptr(),
                      p, blocks)
        fused_field_bwd.launches += 1
    return dx_raw, common.unpack_grads(grads[:n_w], grads[n_w:],
                                       field_layers(mlp), shapes)


fused_field_bwd.launches = 0
