"""One field MLP alone, forward and backward: the positional encoding of raw
[points | embedding] rows, a skip MLP and one linear head — the warp field's
translation or the hyper sheet's coordinates.

``fused_field`` is the wrapper. On CUDA tensors it launches the hand-written
Hopper kernel of ``csrc/modular_fwd.cu``, the field's stage of the level
forward (``csrc/level_fwd.cuh``) run alone on that kernel's block, which
replaces the TPU kernel ``hypernerf_tpu/ops/pallas/fused_field.py``
``_fused``; its plan is ``fused_level.stage_plan``'s. On CPU tensors it
runs ``fused_field_plain``, the same function composed from this package's
modules. When a gradient is wanted the call goes through ``FusedFieldFn``,
whose backward is ``fused_field_bwd``: on CUDA tensors the kernel
``csrc/fields_bwd_alone.cu`` (for the TPU kernel's ``_fused_bwd``), the
fields backward's block (kernel B, ``csrc/fields_bwd.cuh``) run on the
field alone, whose plan is ``fused_level.field_bwd_plan``'s; on CPU tensors
``fused_field_bwd_plain``, written out without autograd and with the
kernel's rounding points. On a CUDA tensor a wrapper launches its kernel or
raises.

The optional ``scales`` row is the annealing window of the windowed
encoding: one fp32 weight per encoded feature, multiplied into the rounded
encoding (identity and embedding features weigh 1); the backward scales the
encoding's cotangent by the same row. It is a schedule constant and gets no
gradient.

The CUDA kernels are compiled for two fields: the flagship warp (6 x 128,
10 bands, 3 outputs) and sheet (6 x 64, 7 bands, 4 outputs), both on
3 + 8 raw inputs, skip after layer 4, bf16. A field whose MLP computes in
float32 takes the float32 kernels (``f32.fused_field_f32``, the float32
level forward's field stage, and ``f32.fused_field_bwd_f32``, kernel B's
float32 steps on the one field) for the same two fields, with or without a
window row.
"""

from __future__ import annotations

import importlib

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
    return dx.to(acc), [t.to(acc) for t in hidden + [dw, db]]


fused_field_bwd_plain.calls = 0


def _launch_args(mlp: MLP, n_freq: int, x_raw, scales):
    """Checked inputs of a kernel launch: (index of the compiled field, the
    padded window row or None, the packed blobs and shapes)."""
    def check():
        if mlp.dtype != torch.bfloat16 or n_freq not in _COMPILED:
            raise NotImplementedError(
                f'{common.NOT_COVERED}; got a field with {n_freq} bands in '
                f'{mlp.dtype}')

    packed = common.pack_layers(mlp, field_layers(mlp), check)
    shapes = packed[2]
    check()
    table, which = _COMPILED[n_freq]
    common.check_layout(shapes, table)
    dev = x_raw.device
    build.check_tensor('x_raw', x_raw,
                       (x_raw.shape[0], 3 + common.FLAGSHIP['embed']),
                       torch.float32, dev)
    scales = common.padded_scales(scales, mlp.hidden(0).in_features,
                                  shapes[0][1], dev)
    return which, scales, packed


def _f32_launch_args(mlp: MLP, n_freq: int, x_raw, scales):
    """Checked inputs of a float32 kernel launch: the field's packed fp32
    blobs (w, w transposed, b) and shapes, the float32 table's rows of the
    field's bands, and the window row padded to the packed encoding's
    columns or None."""
    from hypernerf_tpu_torch.kernels import f32  # f32 imports fused_mlp

    def check():
        if mlp.dtype != torch.float32 or n_freq not in f32.FIELDS:
            raise NotImplementedError(
                f'{common.NOT_COVERED}; got a field with {n_freq} bands in '
                f'{mlp.dtype}')

    layers = field_layers(mlp)
    w_blob, b_blob, shapes = common.pack_layers(mlp, layers, check,
                                                dtype=torch.float32)
    wt_blob = common.pack_layers(mlp, layers, check, transposed=True,
                                 dtype=torch.float32)[0]
    check()
    f32.check_layout(shapes, f32.FIELDS[n_freq][1])
    dev = x_raw.device
    build.check_tensor('x_raw', x_raw,
                       (x_raw.shape[0], 3 + common.FLAGSHIP['embed']),
                       torch.float32, dev)
    scales = common.padded_scales(scales, mlp.hidden(0).in_features,
                                  shapes[0][1], dev)
    return w_blob, wt_blob, b_blob, shapes, scales


def _forward(mlp: MLP, n_freq: int, x_raw, scales):
    """(P, 8) fp32 [out | 0]: the plain version on CPU tensors, the kernel on
    CUDA tensors."""
    if common.runs_plain(x_raw, 'fused_field'):
        out = fused_field_plain(mlp, n_freq, x_raw, scales)
        return F.pad(out.to(common.acc_dtype(mlp.dtype)),
                     (0, OUT_PAD - out.shape[1]))
    if mlp.dtype == torch.float32:
        from hypernerf_tpu_torch.kernels import f32
        _, wt_blob, b_blob, _, scales = _f32_launch_args(mlp, n_freq, x_raw,
                                                          scales)
        return f32.fused_field_f32(n_freq, wt_blob, b_blob, x_raw, scales)
    which, scales, (w_blob, b_blob, _) = _launch_args(mlp, n_freq, x_raw,
                                                       scales)
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
    (the two compiled fields, bf16 or float32) or raise. Differentiable in ``x_raw``
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
    plain version, CUDA tensors launch the kernel or raise. The kernel reads
    the field's one weight blob (no transposed form), adds dW / db into
    ``fused_level.FB_GRAD_COPIES`` buffers that are summed here, and, where
    its plan spills (the warp field), gets a per-block scratch."""
    if common.runs_plain(x_raw, 'fused_field_bwd'):
        return fused_field_bwd_plain(mlp, n_freq, x_raw, g, scales)
    if mlp.dtype == torch.float32:
        return _field_bwd_f32(mlp, n_freq, x_raw, g, scales)
    # fused_level models kernel B's block, which this kernel runs; it
    # imports this module, so it is imported here (by its module path: the
    # package re-exports a function of the same name).
    fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
    which, scales, (w_blob, b_blob, shapes) = _launch_args(mlp, n_freq, x_raw,
                                                           scales)
    p = x_raw.shape[0]
    build.check_tensor('g', g, (p, OUT_PAD), torch.float32, x_raw.device)
    dx_raw, dw, db = fl.launch_field_bwd(
        ('warp', 'sheet')[which], 'hn_fused_field_bwd', fused_field_bwd,
        [which], x_raw, scales, g, w_blob, b_blob, shapes)
    return dx_raw, common.unpack_grads(dw, db, field_layers(mlp), shapes)


fused_field_bwd.launches = 0


def _field_bwd_f32(mlp: MLP, n_freq: int, x_raw, g, scales):
    """A field alone backward at float32 (``f32.fused_field_bwd_f32``);
    returns as ``fused_field_bwd``. Only the head's outputs' columns of
    ``g`` are read."""
    from hypernerf_tpu_torch.kernels import f32
    w_blob, wt_blob, b_blob, shapes, scales = _f32_launch_args(
        mlp, n_freq, x_raw, scales)
    build.check_tensor('g', g, (x_raw.shape[0], OUT_PAD), torch.float32,
                       x_raw.device)
    dx_raw, grads = f32.fused_field_bwd_f32(
        w_blob, wt_blob, b_blob, shapes, n_freq, x_raw,
        g[:, :mlp.logit.out_features], scales)
    n_w = sum(n * k for n, k in shapes)
    return dx_raw, common.unpack_grads(grads[:n_w], grads[n_w:],
                                       field_layers(mlp), shapes)
