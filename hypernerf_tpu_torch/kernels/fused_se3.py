"""The SE(3) / quaternion warp field's trunk alone, forward and backward: the
Nerfies encoding of raw [points | embedding] rows (sin and cos of the degrees
[min_deg, max_deg), no identity block), a skip MLP whose linear logit is the
trunk's output, and the two linear heads w and v that read it.

``fused_se3_wv`` is the wrapper. On CUDA tensors it launches the hand-written
Hopper kernel of ``csrc/modular_fwd.cu``, the level forward's trunk stage
(``csrc/level_fwd.cuh``, the screw warp without its retraction) run alone on
that kernel's block, which replaces the TPU kernel
``hypernerf_tpu/ops/pallas/fused_se3.py`` ``_fused``; its plan is
``fused_level.stage_plan('se3', ...)``'s. On CPU tensors it runs
``fused_se3_plain``, the same function composed from this package's modules.
When a gradient is wanted the call goes through ``FusedSE3Fn``, whose backward
is ``fused_se3_bwd``: on CUDA tensors the kernel of ``csrc/se3_bwd_alone.cu``
(for the TPU kernel's ``_fused_bwd``), kernel B's block run on the trunk alone
(``csrc/fields_bwd_alone.cuh``; its plan is
``fused_level.field_bwd_plan('se3', ...)``'s), and ``fused_se3_bwd_plain``,
written out without autograd and with the kernel's rounding points, on CPU
tensors. On a CUDA tensor a wrapper launches its kernel or raises. The
retraction (w, v, points) -> warped points is the caller's
(``ops.rigid_body``, ``ops.quaternion``).

The optional ``scales`` row is the ``warp_alpha`` window: one fp32 weight per
encoded feature, multiplied into the rounded encoding (embedding features
weigh 1); the backward scales the encoding's cotangent by the same row. It is
a schedule constant and gets no gradient. A row of ones and no row give the
same numbers.

The CUDA kernels are compiled for the flagship's trunk: 3 + 8 raw inputs,
degrees 0..8, 6 x 128 with a skip after layer 4, trunk logit 128 -> 128, heads
128 -> 3, bf16. A trunk that computes in float32 takes the float32 kernels
(``f32.fused_se3_f32``, the float32 level forward's trunk stage run alone,
and ``f32.fused_se3_bwd_f32``, the float32 trunk steps of kernel B) at the
same widths, with or without the window row.
"""

from __future__ import annotations

import importlib

import torch
import torch.nn.functional as F

from hypernerf_tpu_torch.kernels import build, common, f32
from hypernerf_tpu_torch.models.modules import dense

OUT_PAD = 8  # columns of the kernels' output and cotangent: [w | v | 0 0]


def se3_layers(field):
    """Every Linear of the field in kernel order with its input segments:
    the trunk's hidden layers, its logit, the w head, the v head. A field
    with the identity in its encoding has no kernel, here as in the JAX
    package: ``SE3Field`` runs it in tensor code, and every kernel path
    (this trunk's, its tangents', the level's) refuses it here."""
    if field.use_posenc_identity:
        raise ValueError('an SE(3) field with the identity in its encoding '
                         'runs in tensor code (SE3Field), not on the trunk '
                         'kernels, as in the JAX package')
    enc = field.trunk.hidden(0).in_features
    width = field.trunk.logit.out_features
    return (common.mlp_layers(field.trunk, [(enc, common.pad16(enc))])
            + [(field.w_net.logit, [(width, width)]),
               (field.v_net.logit, [(width, width)])])


def enc_segments(field):
    """The encoding's segments as ``common.encoding_scales`` takes them."""
    segs = ((3, field.max_deg - field.min_deg, field.min_deg, False),)
    return segs + (((field.embed_ch, 0),) if field.use_metadata else ())


def se3_encoding_scales(field, alpha, device=None):
    """The (enc,) fp32 window row of the trunk's encoding at ``warp_alpha``
    = ``alpha`` (None: a row of ones)."""
    segs = enc_segments(field)
    return common.encoding_scales(segs, (alpha,) + (None,) * (len(segs) - 1),
                                  device)


def _encode(field, x_raw, scales):
    """(trig, encoding in the compute dtype) of raw rows [points | embed]."""
    dt = field.trunk.dtype
    n_freq = field.max_deg - field.min_deg
    trig = common.posenc_trig(x_raw[:, :3] * 2.0 ** field.min_deg, n_freq)
    enc = torch.cat([*trig, x_raw[:, 3:]], dim=-1).to(dt)
    return trig, common.scaled(enc, scales, dt)


def fused_se3_plain(field, x_raw, scales=None):
    """Plain PyTorch trunk forward.

    Args:
      x_raw: (P, 3 + E) fp32 raw rows [points | embedding] ((P, 3) for a
        field without metadata).
      scales: optional (enc,) fp32 window row over the encoded features.

    Returns:
      (P, 6) fp32 [w | v] (float64 at a float64 compute dtype).
    """
    fused_se3_plain.calls += 1
    trunk = field.trunk(_encode(field, x_raw, scales)[1])
    return torch.cat([field.w_net(trunk), field.v_net(trunk)], dim=-1).to(
        common.acc_dtype(field.trunk.dtype))


fused_se3_plain.calls = 0


def fused_se3_bwd_plain(field, x_raw, g, scales=None):
    """Plain trunk backward: recompute, then walk back.

    Args:
      g: (P, 8) fp32 cotangent of [w | v | 0 0].

    Returns:
      dx_raw (P, 3 + E) fp32 and [dW, db, ...] of the field's layers in
      kernel order, fp32, in each ``nn.Linear``'s shapes (float64 at a
      float64 compute dtype).
    """
    fused_se3_bwd_plain.calls += 1
    mlp = field.trunk
    dt, acc = mlp.dtype, common.acc_dtype(mlp.dtype)
    n_freq = field.max_deg - field.min_deg
    (sin, cos), enc = _encode(field, x_raw, scales)
    ins, outs, logit_in = common.mlp_recompute(mlp, enc)
    # The trunk logit is linear and its output is rounded: what the heads
    # read.
    trunk = dense(logit_in, mlp.logit, dt).to(dt)
    g = g.to(acc)
    dw_w, db_w, gt_w = common.head_bwd(field.w_net.logit, trunk, g[:, :3], dt)
    dw_v, db_v, gt_v = common.head_bwd(field.v_net.logit, trunk, g[:, 3:6],
                                       dt)
    # The two heads' parts are summed in fp32 and rounded once; the trunk
    # logit's db sums the rounded cotangent, and no ReLU masks it.
    g_trunk = (gt_w + gt_v).to(dt)
    dw_t = common.prod(g_trunk.t(), logit_in, dt)
    db_t = g_trunk.to(acc).sum(0)
    gh = common.prod(g_trunk, mlp.logit.weight, dt).to(dt)
    g_enc, hidden = common.hidden_bwd(mlp, ins, outs, gh, enc.shape[1])
    if scales is not None:
        g_enc = g_enc * scales.reshape(1, -1)
    nb = 3 * n_freq
    flat = cos * g_enc[:, :nb] - sin * g_enc[:, nb:2 * nb]
    freqs = 2.0 ** torch.arange(field.min_deg, field.max_deg,
                                dtype=flat.dtype, device=flat.device)
    d_pts = (flat.reshape(-1, n_freq, 3) * freqs[:, None]).sum(1)
    dx = torch.cat([d_pts, g_enc[:, 2 * nb:]], dim=-1)
    grads = hidden + [dw_t, db_t, dw_w, db_w, dw_v, db_v]
    return dx.to(acc), [t.to(acc) for t in grads]


fused_se3_bwd_plain.calls = 0


def _is_f32(field) -> bool:
    return {field.trunk.dtype, field.w_net.dtype,
            field.v_net.dtype} == {torch.float32}


def check_covered(field) -> None:
    """Raise unless ``field`` is the trunk the CUDA kernels are compiled
    for, in bf16 or in float32 (the layer shapes are checked against the
    compiled table apart)."""
    have = dict(embed=field.embed_ch if field.use_metadata else 0,
                min_deg=field.min_deg, max_deg=field.max_deg)
    dtypes = {field.trunk.dtype, field.w_net.dtype, field.v_net.dtype}
    if have != common.SE3_FLAGSHIP or len(dtypes) != 1 \
            or dtypes - {torch.bfloat16, torch.float32} \
            or field.trunk.skips != (4,):
        raise NotImplementedError(f'{common.NOT_COVERED}; got an SE(3) trunk '
                                  f'with {have}, skips {field.trunk.skips}, '
                                  f'{dtypes}')


def _launch_args(field, x_raw, scales):
    """Checked inputs of a kernel launch: the padded window row or None and
    the packed blobs (the trunk's one weight blob, its biases, the shapes;
    in float32 also the weights transposed layer by layer, last)."""
    check = lambda: check_covered(field)
    dtype = torch.float32 if _is_f32(field) else torch.bfloat16
    layers = se3_layers(field)
    w_blob, b_blob, shapes = common.pack_layers(field, layers, check,
                                                dtype=dtype)
    check()
    if dtype == torch.float32:
        f32.check_layout(shapes, common.SE3_LAYERS, 'se3')
        blobs = (w_blob, b_blob, shapes, common.pack_layers(
            field, layers, check, transposed=True, dtype=dtype)[0])
    else:
        common.check_layout(shapes, common.SE3_LAYERS, 'se3')
        blobs = (w_blob, b_blob, shapes)
    dev = x_raw.device
    build.check_tensor('x_raw', x_raw,
                       (x_raw.shape[0], 3 + common.SE3_FLAGSHIP['embed']),
                       torch.float32, dev)
    scales = common.padded_scales(scales, field.trunk.hidden(0).in_features,
                                  shapes[0][1], dev)
    return scales, blobs


def _forward(field, x_raw, scales):
    """(P, 8) fp32 [w | v | 0 0]: the plain version on CPU tensors, the
    kernel on CUDA tensors."""
    if common.runs_plain(x_raw, 'fused_se3_wv'):
        out = fused_se3_plain(field, x_raw, scales)
        return F.pad(out, (0, OUT_PAD - out.shape[1]))
    scales, (w_blob, b_blob, _, *f32_blobs) = _launch_args(field, x_raw,
                                                           scales)
    if f32_blobs:
        return f32.fused_se3_f32(f32_blobs[0], b_blob, x_raw, scales)
    p = x_raw.shape[0]
    out = torch.empty((p, OUT_PAD), dtype=torch.float32, device=x_raw.device)
    if p:
        common.launch('hn_fused_se3_fwd', x_raw.device, x_raw.data_ptr(),
                      None if scales is None else scales.data_ptr(),
                      w_blob.data_ptr(), b_blob.data_ptr(), out.data_ptr(), p)
        fused_se3_wv.launches += 1
    return out


def fused_se3_wv(field, x_raw, scales=None):
    """Trunk forward; (w, v), each (P, 3) fp32.

    CPU tensors take ``fused_se3_plain``; CUDA tensors launch the kernel
    (the flagship's trunk, bf16 or float32) or raise. Differentiable in
    ``x_raw`` and in the field's parameters (``FusedSE3Fn``).
    """
    params = common.layer_params(se3_layers(field))
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x_raw, *params)):
        out = FusedSE3Fn.apply(field, x_raw, scales, *params)
    else:
        out = _forward(field, x_raw, scales)
    return out[:, :3], out[:, 3:6]


fused_se3_wv.launches = 0


class FusedSE3Fn(torch.autograd.Function):
    """The trunk with its hand-written backward: the forward keeps the raw
    input alone, the backward recomputes. Gradients of a field shared by two
    levels add up in autograd."""

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
            dx_raw, grads = fused_se3_bwd(ctx.field, x_raw, g.contiguous(),
                                          ctx.scales)
        return (None, dx_raw, None, *grads)


def fused_se3_bwd(field, x_raw, g, scales=None):
    """Trunk backward (see ``fused_se3_bwd_plain``): CPU tensors take the
    plain version, CUDA tensors launch the kernel or raise. The bf16 kernel
    reads the trunk's one weight blob (no transposed form), adds dW / db
    into ``fused_level.FB_GRAD_COPIES`` buffers that are summed here, and
    gets a per-block spill scratch (the trunk's plan spills); in float32
    the trunk's steps (``f32.fused_se3_bwd_f32``) read both forms."""
    if common.runs_plain(x_raw, 'fused_se3_bwd'):
        return fused_se3_bwd_plain(field, x_raw, g, scales)
    # fused_level models kernel B's block, which this kernel runs; it
    # imports this module, so it is imported here.
    fl = importlib.import_module('hypernerf_tpu_torch.kernels.fused_level')
    scales, (w_blob, b_blob, shapes, *f32_blobs) = _launch_args(field, x_raw,
                                                                scales)
    p = x_raw.shape[0]
    build.check_tensor('g', g, (p, OUT_PAD), torch.float32, x_raw.device)
    if f32_blobs:
        dx_raw, grads = f32.fused_se3_bwd_f32(w_blob, f32_blobs[0], b_blob,
                                              shapes, x_raw, g, scales)
        n_w = sum(n * k for n, k in shapes)
        return dx_raw, common.unpack_grads(grads[:n_w], grads[n_w:],
                                           se3_layers(field), shapes)
    dx_raw, dw, db = fl.launch_field_bwd('se3', 'hn_fused_se3_bwd',
                                         fused_se3_bwd, [], x_raw, scales, g,
                                         w_blob, b_blob, shapes)
    return dx_raw, common.unpack_grads(dw, db, se3_layers(field), shapes)


fused_se3_bwd.launches = 0
