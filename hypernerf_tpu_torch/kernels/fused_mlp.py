"""The template MLP alone, forward and backward: the positional encoding of
raw [xyz | hyper] rows, the trunk, the bottleneck, the alpha head on
[bottleneck | per-ray alpha condition] and the rgb branch on [bottleneck |
per-ray rgb condition].

``fused_template`` is the wrapper. On CUDA tensors it launches the
hand-written Hopper kernel of ``csrc/modular_fwd.cu``, the template's stage
of the level forward (``csrc/level_fwd.cuh``) run alone on that kernel's
block, which replaces the TPU kernel
``hypernerf_tpu/ops/pallas/fused_mlp.py`` ``_fwd_call``; its plan is
``fused_level.stage_plan``'s. On CPU tensors it runs
``fused_template_plain``, the same function composed from
this package's modules. When a gradient is wanted the call goes through
``FusedTemplateFn``, whose backward is ``fused_template_bwd``: kernel A (for
the TPU kernel's ``_bwd_call``; it is also the template half of the level
backward), a sequence of hand-written kernels over chunks of whole rays
(``template_bwd_chunks``: ``csrc/template_rowprod.cu``, ``template_dw.cu``,
``template_bwd.cu``) on CUDA tensors, and
``fused_template_bwd_plain``, written out without autograd and with the
kernel's rounding points, on CPU tensors. On a CUDA tensor a wrapper launches
its kernel or raises.

The CUDA kernels are compiled for the flagship template (8 x 256 with a skip
after layer 4, bottleneck 128, rgb branch 4 x 128, bf16) in four encoding
layouts (``layout``): the flagship's posenc_orig (xyz at 10 bands, 4 hyper
coordinates at 6 bands, 39 condition features), the Nerfies encoding of the
anneal configuration (``common.NERFIES``: xyz over degrees 0..10 with its
identity, the hyper coordinates over 0..4 without, 27 condition features),
whose every band is weighted by the annealing window row ``scales``, an
input of every call (``template_scales``), the plane configuration's
posenc_orig of 8 hyper coordinates (``common.PLANE``: 167 encoded columns in
192, raw rows of 16 columns, its own kernels), and the Nerfies encoding of
8 hyper coordinates (``common.NERFIES_PLANE``, the plane_anneal
configurations: 127 columns in 128, raw rows of 16 columns, the window
row). A template without hyper coordinates (static NeRF) runs through the flagship's kernels: its encoding
is packed with zero weight columns where the hyper bands would be, which is
exact, and those columns' dW is dropped on unpack.

A template whose modules compute in float32 takes the float32 kernels
(``f32.fused_template_f32``, the float32 level forward's template stage,
and kernel A at float32, ``f32.fused_template_bwd_f32``) in each of the
four layouts (the Nerfies ones with their window row), 4 hyper
coordinates or none, the plane layouts' 8, any rgb condition width of its
layout and the alpha condition or none (``check_f32_covered``).

The conditions (the JAX model's ``get_condition_inputs``): the rgb condition
is any width a layout covers (``common.FLAGSHIP['rgb_cond']``: the view
directions' encoding, with the nerf embedding after it, the embedding alone,
or 0 columns, where the rgb branch's condition columns are zero in the
packed weight and in the tile), a width of the call; the alpha condition is
None or the kEmbed-column embedding. The alpha head's packed layer (layer
10, 8 x 128) holds its bottleneck columns only, so that no table offset
moves; its condition columns are a vector of their own
(``alpha_cond_weight``), which the kernels dot with each row's condition and
add to the head's product, and whose dW kernel A writes after the layers'
[dW | db] (``ALPHA_TAIL`` floats).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from hypernerf_tpu_torch.kernels import build, common
from hypernerf_tpu_torch.models.modules import NerfMLP, dense


class Template(NamedTuple):
    """A template module and its encoding: bands of the xyz and of the hyper
    coordinates, and the layout (``nerfies``: the Nerfies encoding from
    degree 0, identity columns on the xyz alone; else posenc_orig). (A
    ``fused_level.Level`` carries the same four fields and serves as one.)"""
    template: NerfMLP
    xyz_freq: int
    hyper_freq: int
    nerfies: bool = False


def n_hyper(tmpl) -> int:
    """Hyper coordinates the template's encoding holds (0: static)."""
    enc = tmpl.template.trunk.hidden(0).in_features
    per = 2 * tmpl.hyper_freq + (0 if tmpl.nerfies else 1)
    return (enc - 3 * (1 + 2 * tmpl.xyz_freq)) // per


PLANE_LAYOUTS = ('plane', 'nerfies_plane')


def layout(tmpl) -> str:
    """The compiled encoding layout a template takes: 'nerfies' (4 hyper
    coordinates) or 'nerfies_plane' (8) in the Nerfies encoding, 'plane' (8
    hyper coordinates in posenc_orig) or 'orig' (the flagship's, and the
    static template's)."""
    plane = n_hyper(tmpl) == common.PLANE['hyper_out']
    if tmpl.nerfies:
        return 'nerfies_plane' if plane else 'nerfies'
    return 'plane' if plane else 'orig'


def raw_pad(tmpl) -> int:
    """Columns of the template's raw rows [xyz | hyper | 0] and of their
    cotangent."""
    return (common.PLANE_RAW_PAD if layout(tmpl) in PLANE_LAYOUTS
            else common.RAW_PAD)


def enc_pad(t: NerfMLP) -> int:
    """The compiled slots of the template's encoding: 128, or the plane
    layout's 192."""
    enc = t.trunk.hidden(0).in_features
    return common.TMPL_ENC_PAD if enc <= common.TMPL_ENC_PAD \
        else common.PLANE_ENC_PAD


def encoding_segments(tmpl, nh: int):
    """The encoding's segments as ``common.encoding_scales`` takes them:
    (channels, bands, first degree, identity) of the xyz, then of the ``nh``
    hyper coordinates (none when 0)."""
    hyper_ident = not tmpl.nerfies
    segs = ((3, tmpl.xyz_freq, 0, True),)
    if nh:
        segs += ((nh, tmpl.hyper_freq, 0, hyper_ident),)
    return segs


def template_scales(tmpl, nerf_alpha=None, hyper_alpha=None, device=None):
    """The window row of a Nerfies template at the annealing alphas (fp32,
    one weight per encoded feature: band k's sin and cos columns weigh
    ``posenc_window``'s weight of band k, identity columns 1; an alpha of
    None leaves its bands fully on), as the JAX model's
    ``_template_enc_scales`` builds it; None for the original encoding."""
    if not tmpl.nerfies:
        return None
    segs = encoding_segments(tmpl, n_hyper(tmpl))
    return common.encoding_scales(segs, [nerf_alpha, hyper_alpha][:len(segs)],
                                  device)


def template_layers(t: NerfMLP, enc_pad: int = 0, cond_pad: int = 0):
    """Every Linear of the template in kernel order with its input segments;
    the encoding is padded to ``enc_pad`` columns and the condition to
    ``cond_pad`` (default: to 16). The alpha head's segment is the
    bottleneck's: its alpha condition columns are packed apart
    (``alpha_cond_weight``)."""
    enc = t.trunk.hidden(0).in_features
    tw = t.bottleneck.in_features
    bw = t.bottleneck.out_features
    cond = t.rgb_branch.hidden(0).in_features - bw
    return (common.mlp_layers(t.trunk, [(enc, enc_pad or common.pad16(enc))])
            + [(t.bottleneck, [(tw, tw)]), (t.alpha_head, [(bw, bw)])]
            + common.mlp_layers(t.rgb_branch,
                                [(bw, bw),
                                 (cond, cond_pad or common.pad16(cond))]))


def kernel_template_layers(t: NerfMLP):
    """``template_layers`` padded to the compiled slots (``enc_pad``)."""
    return template_layers(t, enc_pad(t), common.COND_PAD)


def _segments(tmpl, x_raw):
    """((raw columns, channels, bands, identity), ...) of the encoding's
    segments."""
    return [(x_raw[:, at:at + ch], ch, f, ident)
            for at, (ch, f, _, ident) in zip(
                (0, 3), encoding_segments(tmpl, n_hyper(tmpl)))]


def _encode(tmpl, x_raw, scales):
    """(the segments' fp32 (sin, cos), the encoding in the compute dtype):
    each feature rounded, then times the window row and rounded again
    (``common.scaled``), as the kernels encode."""
    segs = _segments(tmpl, x_raw)
    trigs = [common.posenc_trig(x, f) for x, _, f, _ in segs]
    feat = torch.cat([torch.cat(([x] if ident else []) + [sin, cos], dim=-1)
                      for (x, _, _, ident), (sin, cos) in zip(segs, trigs)],
                     dim=-1)
    dt = tmpl.template.dtype
    return segs, trigs, common.scaled(feat.to(dt), scales, dt)


def _recompute(tmpl, x_raw, rgb_cond, scales=None, alpha_cond=None):
    """The forward with everything the backward needs kept."""
    t = tmpl.template
    dt = t.dtype
    p, r = x_raw.shape[0], rgb_cond.shape[0]
    segs, trigs, x = _encode(tmpl, x_raw, scales)
    ins, outs, tl_in = common.mlp_recompute(t.trunk, x)
    hl = dense(tl_in, t.trunk.logit, dt, relu=True)
    bneck = dense(hl, t.bottleneck, dt).to(dt)

    def rows(c):
        return c.to(dt).repeat_interleave(p // r, dim=0)

    r_in = torch.cat([bneck, rows(rgb_cond)], dim=-1)
    a_in = bneck if alpha_cond is None else torch.cat(
        [bneck, rows(alpha_cond)], dim=-1)
    r_ins, r_outs, rl_in = common.mlp_recompute(t.rgb_branch, r_in)
    return dict(segs=segs, trigs=trigs, x=x, ins=ins, outs=outs, tl_in=tl_in,
                hl=hl, bneck=bneck, a_in=a_in, r_in=r_in, r_ins=r_ins,
                r_outs=r_outs, rl_in=rl_in)


def fused_template_plain(tmpl, x_raw, rgb_cond, scales=None,
                         alpha_cond=None):
    """Plain PyTorch template forward.

    Args:
      x_raw: (P, ``raw_pad``) fp32 raw rows [xyz | hyper | 0].
      rgb_cond: (R, C) per-ray rgb condition (C may be 0); each row serves
        P / R consecutive rows of ``x_raw``.
      scales: a Nerfies template's (enc,) fp32 window row
        (``template_scales``), or None (no window).
      alpha_cond: (R, Ca) per-ray alpha condition, or None.

    Returns:
      (P, 4) fp32 [rgb logits (3) | raw sigma].
    """
    fused_template_plain.calls += 1
    p, r = x_raw.shape[0], rgb_cond.shape[0]
    feat = _encode(tmpl, x_raw, scales)[2]
    raw = tmpl.template(feat.reshape(r, p // r, -1), rgb_cond, alpha_cond)
    return torch.cat([raw['rgb'], raw['alpha']], dim=-1).reshape(p, -1).to(
        common.acc_dtype(tmpl.template.dtype))


fused_template_plain.calls = 0


def fused_template_bwd_plain(tmpl, raw_t, rgb_cond, g, scales=None,
                             alpha_cond=None):
    """Plain template backward: recompute from ``raw_t``, then walk back.

    Args:
      raw_t: (P, ``raw_pad``) fp32 [xyz | hyper | 0]; rgb_cond: (R, C);
      g: (P, 4) fp32 cotangent of [rgb logits | raw sigma];
      scales, alpha_cond: as ``fused_template_plain`` takes them.

    Returns:
      dx_t (P, ``raw_pad``) fp32, d rgb_cond (R, C) fp32 summed per ray,
      [dW, db, ...] of the template's layers in kernel order, fp32, in each
      ``nn.Linear``'s shapes, and d alpha_cond (R, Ca) fp32 summed per ray
      (None without an alpha condition).
    """
    fused_template_bwd_plain.calls += 1
    t = tmpl.template
    dt, acc = t.dtype, common.acc_dtype(t.dtype)
    p, r = raw_t.shape[0], rgb_cond.shape[0]
    n_rgb = t.rgb_branch.logit.out_features
    v = _recompute(tmpl, raw_t, rgb_cond, scales, alpha_cond)

    g = g.to(acc)
    dw_rl, db_rl, gg = common.head_bwd(t.rgb_branch.logit, v['rl_in'],
                                       g[:, :n_rgb], dt)
    g_rin, rgb_grads = common.hidden_bwd(t.rgb_branch, v['r_ins'],
                                         v['r_outs'], gg.to(dt),
                                         v['r_in'].shape[1])
    bw = v['bneck'].shape[1]
    # The alpha head on [bneck | alpha condition]: its cotangent's condition
    # columns are the condition's, summed per ray below.
    dw_a, db_a, ga = common.head_bwd(t.alpha_head, v['a_in'], g[:, n_rgb:],
                                     dt)
    g_b = g_rin[:, :bw] + ga[:, :bw]
    dw_bn, db_bn, g_hl = common.head_bwd(t.bottleneck, v['hl'], g_b, dt)
    g_hl = torch.where(v['hl'].to(acc) > 0, g_hl,
                       torch.zeros_like(g_hl)).to(dt)
    dw_tl = common.prod(g_hl.t(), v['tl_in'], dt)
    db_tl = g_hl.to(acc).sum(0)
    gh = common.prod(g_hl, t.trunk.logit.weight, dt).to(dt)
    g_x, trunk_grads = common.hidden_bwd(t.trunk, v['ins'], v['outs'], gh,
                                         v['x'].shape[1])

    if scales is not None:  # the window's VJP: a band of weight 0 passes none
        g_x = g_x * scales.reshape(1, -1)
    dx, at = [], 0
    for (_, ch, f, ident), trig in zip(v['segs'], v['trigs']):
        width = ch * (2 * f + (1 if ident else 0))
        dx.append(common.posenc_bwd(g_x[:, at:at + width], trig, ch, f,
                                    ident))
        at += width
    dx_t = torch.cat(dx, dim=-1).to(acc)
    dx_t = F.pad(dx_t, (0, raw_pad(tmpl) - dx_t.shape[1]))
    d_cond = g_rin[:, bw:].reshape(r, p // r, -1).sum(1).to(acc)
    d_alpha = None if alpha_cond is None else \
        ga[:, bw:].reshape(r, p // r, -1).sum(1).to(acc)
    grads = (trunk_grads + [dw_tl, db_tl, dw_bn, db_bn, dw_a, db_a]
             + rgb_grads + [dw_rl, db_rl])
    return dx_t, d_cond, [t_.to(acc) for t_ in grads], d_alpha


fused_template_bwd_plain.calls = 0


def cond_width(tmpl) -> int:
    """Columns of the template's rgb condition."""
    t = tmpl.template
    return t.rgb_branch.hidden(0).in_features - t.bottleneck.out_features


def alpha_cond_width(tmpl) -> int:
    """Columns of the template's alpha condition (0: none)."""
    t = tmpl.template
    return t.alpha_head.in_features - t.bottleneck.out_features


# fp32 slots after the layers' [dW | db] in kernel A's gradient buffer: the
# alpha head's condition columns' dW.
ALPHA_TAIL = common.FLAGSHIP['embed']


def check_covered(tmpl) -> None:
    """Raise unless the template has the widths of one of the compiled
    layouts (``common.FLAGSHIP``'s, ``common.NERFIES``, ``common.PLANE`` or
    ``common.NERFIES_PLANE``: an rgb condition of one of the layout's
    widths, an alpha condition of ``common.ALPHA_COND``) in bf16; a
    template in float32 is ``check_f32_covered``'s."""
    t = tmpl.template
    if {t.trunk.dtype, t.rgb_branch.dtype, t.dtype} == {torch.float32}:
        return check_f32_covered(tmpl)
    nh = n_hyper(tmpl)
    widths = {'nerfies': common.NERFIES, 'plane': common.PLANE,
              'nerfies_plane': common.NERFIES_PLANE,
              'orig': common.FLAGSHIP}[layout(tmpl)]
    have = dict(xyz_freq=tmpl.xyz_freq, rgb_cond=cond_width(tmpl),
                alpha_cond=alpha_cond_width(tmpl))
    if nh:
        have.update(hyper_out=nh, hyper_freq=tmpl.hyper_freq)
    want = {**common.FLAGSHIP, **widths, 'alpha_cond': common.ALPHA_COND}
    dtypes = {t.trunk.dtype, t.rgb_branch.dtype, t.dtype}
    if any(v not in want[k] if isinstance(want[k], tuple) else want[k] != v
           for k, v in have.items()) or dtypes != {torch.bfloat16}:
        raise NotImplementedError(f'{common.NOT_COVERED}; got {have}, '
                                  f'{dtypes}')


# The float32 kernels' template layouts: layout -> its compiled widths
# (the hyper coordinates, their bands, the rgb condition's widths).
F32_LAYOUTS = {'orig': common.FLAGSHIP,
               'nerfies': {**common.FLAGSHIP, **common.NERFIES},
               'plane': {**common.FLAGSHIP, **common.PLANE},
               'nerfies_plane': {**common.FLAGSHIP, **common.NERFIES_PLANE}}


def check_f32_covered(tmpl) -> None:
    """Raise unless the template is the float32 kernels' (the level's
    template, the template alone and kernel A): all in float32, the xyz at
    10 bands and, posenc_orig, 4 hyper coordinates at 6 (the flagship's)
    or, Nerfies, at 4 without identity, or the plane layouts' 8 at the
    same bands, or none (static); an rgb condition of one of its layout's
    widths (``F32_LAYOUTS``), the alpha condition of
    ``common.ALPHA_COND``. Other widths or bands raise naming ROADMAP
    A.13."""
    t = tmpl.template
    dtypes = {t.trunk.dtype, t.rgb_branch.dtype, t.dtype}
    have = dict(layout=layout(tmpl), hyper=n_hyper(tmpl),
                rgb_cond=cond_width(tmpl), alpha_cond=alpha_cond_width(tmpl))
    if dtypes != {torch.float32}:
        raise NotImplementedError(f'{common.NOT_COVERED}; got {dtypes}')
    widths = F32_LAYOUTS[have['layout']]
    bands = (tmpl.xyz_freq, tmpl.hyper_freq)[:1 + bool(have['hyper'])]
    if (have['hyper'] not in (widths['hyper_out'], 0)
            or have['rgb_cond'] not in widths['rgb_cond']
            or have['alpha_cond'] not in common.ALPHA_COND
            or bands != (widths['xyz_freq'],
                         widths['hyper_freq'])[:len(bands)]):
        raise NotImplementedError(f'{common.NOT_COVERED}; got {have}, bands '
                                  f'{bands}')


def alpha_cond_weight(t: NerfMLP, dtype=torch.bfloat16):
    """The alpha head's condition columns as the kernels take them: (Ca,)
    in ``dtype`` (bf16, or the float32 kernels' fp32), cached on the
    template as ``common.packed`` caches the blobs (on the weight's storage
    and version counter, one entry a dtype); None without an alpha
    condition."""
    w = t.alpha_head.weight
    bw = t.bottleneck.out_features
    if w.shape[1] == bw:
        return None
    key = (w.data_ptr(), w._version)
    attr = '_alpha_cond_w' + common.packed_attr(dtype)[len('_packed'):]
    cached = getattr(t, attr, None)
    if cached is None or cached[0] != key:
        cached = (key, w.detach()[0, bw:].to(dtype).contiguous())
        object.__setattr__(t, attr, cached)
    return cached[1]


def kernel_scales(tmpl, scales, device):
    """The window row as the kernels take it: None for the original
    encoding (which refuses a row), the Nerfies row zero-padded to
    ``common.TMPL_ENC_PAD`` (a row of ones when None): its presence is what
    selects the Nerfies layout in the C code."""
    if not tmpl.nerfies:
        if scales is not None:
            raise ValueError('the original encoding takes no window row')
        return None
    enc = tmpl.template.trunk.hidden(0).in_features
    if scales is None:
        scales = torch.ones(enc, dtype=torch.float32, device=device)
    return common.padded_scales(scales, enc, common.TMPL_ENC_PAD, device)


def cond_args(tmpl, rgb_cond, alpha_cond, rays: int, dev,
              dtype=torch.bfloat16):
    """The kernels' condition inputs in ``dtype`` (bf16, or the float32
    kernels' fp32), checked: the rgb condition (R, C), and the alpha
    condition (R, Ca) and the alpha head's condition columns
    (``alpha_cond_weight``), each None without an alpha condition."""
    rgbc = rgb_cond.detach().to(dtype).contiguous()
    build.check_tensor('rgb_cond', rgbc, (rays, cond_width(tmpl)), dtype,
                       dev)
    aw = alpha_cond_weight(tmpl.template, dtype)
    if (aw is None) != (alpha_cond is None):
        raise ValueError('an alpha condition goes with a template whose alpha '
                         'head takes one, and only with one')
    if aw is None:
        return rgbc, None, None
    alphac = alpha_cond.detach().to(dtype).contiguous()
    build.check_tensor('alpha_cond', alphac, (rays, aw.shape[0]), dtype,
                       dev)
    return rgbc, alphac, aw


def _launch_args(tmpl, x_raw, rgb_cond, transposed: bool, alpha_cond=None):
    """Checked inputs of a kernel launch: the conditions (``cond_args``),
    the rows per condition row and the packed blobs, whose shapes are the
    template's layers of the compiled table of its layout."""
    layers = kernel_template_layers(tmpl.template)
    check = lambda: check_covered(tmpl)
    packs = [common.pack_layers(tmpl.template, layers, check)]
    if transposed:
        packs.append(common.pack_layers(tmpl.template, layers, check,
                                        transposed=True))
    if layout(tmpl) in PLANE_LAYOUTS:  # a plane table of its layout
        common.check_layout(packs[0][2], common.PLANE_TEMPLATE_LAYERS,
                            layout(tmpl))
    else:
        common.check_layout(packs[0][2], common.TEMPLATE_LAYERS)
    dev = x_raw.device
    p, r = x_raw.shape[0], rgb_cond.shape[0]
    conds = cond_args(tmpl, rgb_cond, alpha_cond, r, dev)
    build.check_tensor('x_raw', x_raw, (p, raw_pad(tmpl)), torch.float32,
                       dev)
    if r == 0 or p % r:
        raise ValueError(f'{p} samples do not divide into {r} rays')
    return conds, p // r, layers, packs


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forward(tmpl, x_raw, rgb_cond, scales=None, alpha_cond=None):
    if common.runs_plain(x_raw, 'fused_template'):
        return fused_template_plain(tmpl, x_raw, rgb_cond, scales,
                                    alpha_cond)
    if tmpl.template.dtype == torch.float32:
        from hypernerf_tpu_torch.kernels import f32  # f32 builds on this
        (_, wt_blob, b_blob, _), _, (cond, scales, alpha), s = \
            _f32_launch_args(tmpl, x_raw, rgb_cond, scales, alpha_cond)
        return f32.fused_template_f32(wt_blob, b_blob, x_raw, n_hyper(tmpl),
                                      cond, s, scales, alpha)
    (rgbc, alphac, aw), s, _, ((w_blob, b_blob, _),) = _launch_args(
        tmpl, x_raw, rgb_cond, False, alpha_cond)
    scales = kernel_scales(tmpl, scales, x_raw.device)
    p = x_raw.shape[0]
    out = torch.empty((p, 4), dtype=torch.float32, device=x_raw.device)
    entry = ('hn_fused_template_fwd_plane' if layout(tmpl) in PLANE_LAYOUTS
             else 'hn_fused_template_fwd')
    common.launch(entry, x_raw.device, x_raw.data_ptr(), rgbc.data_ptr(),
                  _ptr(alphac), _ptr(aw), _ptr(scales), w_blob.data_ptr(),
                  b_blob.data_ptr(), out.data_ptr(), p, s, rgbc.shape[1])
    fused_template.launches += 1
    return out


def fused_template(tmpl, x_raw, rgb_cond, scales=None,
                   alpha_cond=None) -> torch.Tensor:
    """Template forward; (P, 4) fp32 [rgb logits | raw sigma]. ``scales``:
    a Nerfies template's window row (``template_scales``) or None;
    ``alpha_cond``: (R, Ca) per-ray alpha condition, or None.

    CPU tensors take ``fused_template_plain``; CUDA tensors launch the kernel
    (flagship widths, any of the four layouts, bf16 or float32) or raise.
    Differentiable in ``x_raw``, both conditions and the template's
    parameters (``FusedTemplateFn``).
    """
    params = common.layer_params(template_layers(tmpl.template))
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x_raw, rgb_cond, alpha_cond, *params)):
        return FusedTemplateFn.apply(tmpl, scales, x_raw, rgb_cond,
                                     alpha_cond, *params)
    return _forward(tmpl, x_raw, rgb_cond, scales, alpha_cond)


fused_template.launches = 0


class FusedTemplateFn(torch.autograd.Function):
    """The template with its hand-written backward: the forward keeps the
    raw input and the conditions, the backward recomputes."""

    @staticmethod
    def forward(ctx, tmpl, scales, x_raw, rgb_cond, alpha_cond, *params):
        x_raw, rgb_cond = x_raw.detach(), rgb_cond.detach()
        alpha_cond = None if alpha_cond is None else alpha_cond.detach()
        with torch.no_grad():
            out = _forward(tmpl, x_raw, rgb_cond, scales, alpha_cond)
        ctx.tmpl, ctx.scales = tmpl, scales
        ctx.alpha_cond = alpha_cond
        ctx.save_for_backward(x_raw, rgb_cond)
        return out

    @staticmethod
    def backward(ctx, g):
        x_raw, rgb_cond = ctx.saved_tensors
        alpha_cond = ctx.alpha_cond
        with torch.no_grad():
            dx, d_cond, grads, d_alpha = fused_template_bwd(
                ctx.tmpl, x_raw, rgb_cond, g.contiguous(), ctx.scales,
                alpha_cond)
        if d_alpha is not None:
            d_alpha = d_alpha.to(alpha_cond.dtype)
        return (None, None, dx, d_cond.to(rgb_cond.dtype), d_alpha, *grads)


# ---------------------------------------------------------------------------
# Kernel A: the template backward as a short sequence of kernels over chunks
# of whole rays (csrc/template_rowprod.cu, template_dw.cu, template_bwd.cu).
# A chunk is recomputed layer by layer into a stash of every wide layer's
# bf16 output, then walked back from the top one layer at a time: the
# cotangent through the layer (``rowprod``) and the layer's dW / db
# (``dw``), each a ``wgmma`` product over the whole chunk.

# Stash columns, in order: the encoding (its compiled slots: 128, or the
# plane layout's 192), the trunk's hidden outputs, the trunk logit, the
# bottleneck and the rgb branch's hidden outputs (bf16, one row per sample).
# The condition is gathered per ray, not stashed.
# The float32 kernel A stashes the condition too, ``cond`` columns after the
# bottleneck's 128 (``f32.TEMPLATE_STASH``).
def stash_columns(enc: int = common.TMPL_ENC_PAD, cond: int = 0):
    return ((('enc', enc),) + tuple((f'h{i}', 256) for i in range(8))
            + (('hl', 256), ('bneck', 128 + cond))
            + tuple((f'r{j}', 128) for j in range(4)))


class Stash(NamedTuple):
    """A stash's column plan: each buffer's width and first column, and the
    row's width (the stash's leading dimension, which names the layout to
    the bf16 kernels: 3072, or the plane layout's 3136; the float32 kernel
    A's is 3120)."""
    widths: dict
    col: dict
    width: int


def column_plan(columns) -> Stash:
    """The plan of a stash of ``columns``, (name, width) in order."""
    widths = dict(columns)
    return Stash(widths, dict(zip(widths, itertools.accumulate(
        widths.values(), initial=0))), sum(widths.values()))


def stash_plan(enc: int = common.TMPL_ENC_PAD, cond: int = 0) -> Stash:
    return column_plan(stash_columns(enc, cond))


STASH_COLUMNS = stash_columns()
STASH_WIDTHS, STASH_COL, STASH_WIDTH = stash_plan()
# The wide layers in recompute order: (template layer, stash inputs, stash
# output, ReLU). Layer 11's input is [bneck | condition]: the condition's
# part is added per ray. Layers 10 and 15 are the alpha and rgb heads.
WIDE_LAYERS = ([(0, ('enc',), 'h0', True)]
               + [(i, (f'h{i - 1}',), f'h{i}', True) for i in range(1, 5)]
               + [(5, ('h4', 'enc'), 'h5', True), (6, ('h5',), 'h6', True),
                  (7, ('h6',), 'h7', True), (8, ('h7',), 'hl', True),
                  (9, ('hl',), 'bneck', False), (11, ('bneck',), 'r0', True)]
               + [(11 + j, (f'r{j - 1}',), f'r{j}', True)
                  for j in range(1, 4)])
CHUNK_ROWS = 1 << 19  # rows of a chunk: its stash is 3 GiB
SPLITS = 64  # row ranges of a chunk, one dW / db slab each
GBUF = 256  # bf16 columns of a cotangent buffer


def chunk_plan(n_rows: int, samples: int, max_rows: int = CHUNK_ROWS):
    """[(row0, row1)] cutting ``n_rows`` rows of rays of ``samples`` rows
    into chunks of whole rays, each at most ``max_rows`` rows (or one ray)."""
    if samples <= 0 or n_rows % samples:
        raise ValueError(f'{n_rows} rows do not divide into rays of '
                         f'{samples}')
    step = max(1, max_rows // samples) * samples
    return [(r0, min(n_rows, r0 + step)) for r0 in range(0, n_rows, step)]


def _segs(plan: Stash, names):
    """(col0, w0, col1) of a layer input made of stash columns ``names``."""
    return (plan.col[names[0]], plan.widths[names[0]],
            plan.col[names[-1]] if len(names) > 1 else 0)


def tiles(width: int) -> int:
    """128-column tiles that cover ``width`` columns."""
    return -(-width // 128)


def template_bwd_chunks(ops, raw_t, rgbc, samples, g, w, wt, b, w_off,
                        b_off, n_grads, max_rows: int = CHUNK_ROWS,
                        scales=None, alpha=None):
    """Kernel A's sequence. ``ops`` launches the steps (``_KernelOps`` on
    the card); ``w`` / ``wt`` / ``b``: each template layer's packed bf16
    weight, its transpose and its bias; ``w_off`` / ``b_off``: each layer's
    offsets in the fp32 [dW | db] buffer of ``n_grads`` floats; ``scales``:
    the Nerfies layout's padded window row (``kernel_scales``), or None for
    the original encoding; ``alpha``: (alpha condition (R, Ca) bf16, the
    alpha head's condition columns (Ca,) bf16) or None. With an alpha
    condition the buffer's last ``ALPHA_TAIL`` floats take the condition
    columns' dW (``n_grads`` counts them), and one more step per chunk
    (``alpha_cond_bwd``) writes them and d alpha_cond.

    The encoding's width is layer 0's padded input (``w[0]``: 128, or the
    plane layout's 192, whose raw rows and dx_t are 16 columns wide): it
    sets the stash's plan (``stash_plan``) and the encoding's cotangent
    buffer, [the skip's part | layer 0's], each ``tiles(enc)`` 128-column
    tiles wide, whose columns past the encoding the products fill with
    zeros (the weight rows past it read as zero).

    Returns dx_t (P, raw_t's columns), d rgb_cond (R, C), the [dW | db]
    buffer and d alpha_cond (R, Ca) or None; ``ops.stash_bytes`` is set to
    the bytes of the stash it allocated."""
    dev, f32, bf = raw_t.device, torch.float32, torch.bfloat16
    p, s = raw_t.shape[0], samples
    plan = chunk_plan(p, s, max_rows)
    rows = max(r1 - r0 for r0, r1 in plan)
    enc = w[0].shape[1]
    sp = stash_plan(enc)
    stash = torch.empty((rows, sp.width), dtype=bf, device=dev)
    ops.stash_bytes = stash.nbytes
    half = 128 * tiles(enc)  # layer 0's part of the encoding's cotangent
    bufs = [torch.empty((rows, GBUF), dtype=bf, device=dev)
            for _ in range(2)]
    bufs.append(torch.empty((rows, 2 * half), dtype=bf, device=dev))
    ray_bias = torch.empty((rows // s, w[11].shape[0]), dtype=f32,
                           device=dev)
    slab = torch.empty((ops.splits, n_grads), dtype=f32, device=dev)
    grads = torch.zeros((n_grads,), dtype=f32, device=dev)
    dx_t = torch.empty((p, raw_t.shape[1]), dtype=f32, device=dev)
    d_cond = torch.empty((rgbc.shape[0], rgbc.shape[1]), dtype=f32,
                         device=dev)
    d_alpha = None if alpha is None else torch.empty(
        alpha[0].shape, dtype=f32, device=dev)
    col = sp.col
    cond_col = sp.widths['bneck']  # rgb layer 0's input: [bneck | cond]
    for r0, r1 in plan:
        n, q0, q1 = r1 - r0, r0 // s, r1 // s
        raw_c, g_c, cond_c = raw_t[r0:r1], g[r0:r1], rgbc[q0:q1]
        slab.zero_()
        # Recompute into the stash.
        ops.encode(raw_c, stash, col['enc'], n, scales)
        ops.ray_bias(cond_c, w[11], cond_col, ray_bias, q1 - q0)
        for l, ins, out, relu in WIDE_LAYERS:
            ops.rowprod(stash, n, _segs(sp, ins), w[l],
                        sum(sp.widths[i] for i in ins), 0,
                        sp.widths[out] // 128, stash, col[out], bias=b[l],
                        ray_bias=ray_bias if l == 11 else None, samples=s,
                        relu=relu)
        # Walk back: the rgb head, the rgb branch, the condition, the alpha
        # head and the bottleneck, the trunk.
        cur, nxt, enc_g = bufs
        ops.rgb_head(g_c, stash, col['r3'], w[15], cur, slab, w_off[15],
                     b_off[15], n)
        for l, ins, _, _ in reversed(WIDE_LAYERS):
            n_out, k_pad = w[l].shape
            width = sum(sp.widths[i] for i in ins)
            ops.dw(cur, n, n_out, stash, _segs(sp, ins), tiles(width), slab,
                   w_off[l], k_pad, -1 if l == 9 else b_off[l])
            red = (0, n_out, 0)
            if l == 11:  # [bneck | condition], no mask
                ops.rowprod(cur, n, red, wt[l], n_out, 0, 2, nxt, 0)
                ops.cond_bwd(cur, nxt, cond_col, cond_c, d_cond[q0:q1],
                             slab, w_off[l], k_pad, q1 - q0, s)
                ops.bneck_prep(g_c, nxt, stash, col['bneck'], w[10], cur,
                               slab, w_off[10], b_off[10], b_off[9], n)
                if alpha is not None:
                    ops.alpha_cond_bwd(g_c, alpha[0][q0:q1], alpha[1],
                                       d_alpha[q0:q1], slab,
                                       n_grads - ALPHA_TAIL, q1 - q0, s)
                continue  # the bottleneck's cotangent is in cur
            if l == 0:  # the encoding's cotangent, layer 0's part
                ops.rowprod(cur, n, red, wt[l], n_out, 0, tiles(enc), enc_g,
                            half)
                continue
            ops.rowprod(cur, n, red, wt[l], n_out, 0,
                        sp.widths[ins[0]] // 128, nxt, 0, mask=stash,
                        mask_col0=col[ins[0]])
            if l == 5:  # the skip's part of the encoding's cotangent
                ops.rowprod(cur, n, red, wt[l], n_out, 256, tiles(enc),
                            enc_g, 0)
            cur, nxt = nxt, cur
        ops.posenc_bwd(raw_c, enc_g, dx_t[r0:r1], n, scales)
        ops.reduce(slab, grads)
    return dx_t, d_cond, grads, d_alpha


class _KernelOps:
    """The steps of ``template_bwd_chunks`` as launches of the CUDA kernels
    on ``device``'s current stream; made, and used, inside
    ``torch.cuda.device(device)``. Every buffer's leading dimension is
    passed from its tensor; the narrow steps are compiled for this module's
    layouts (``stash_plan``'s two widths, ``GBUF``, the condition after the
    bottleneck, the rgb condition widths of ``common.FLAGSHIP`` and
    ``common.NERFIES``, an alpha condition of kEmbed columns) and their
    entry points refuse another, which raises here. The encoding's two
    steps take the layout from the raw rows' width (8, or 16 for the two
    plane layouts), the window row (the Nerfies layouts) and, for the plane
    layout, its stash (3136 columns) or its encoding cotangent's buffer
    (512)."""

    splits = SPLITS

    def __init__(self, device):
        self.lib = build.library()
        self.stream = torch.cuda.current_stream(device).cuda_stream
        self.stash_bytes = 0

    def _go(self, name, *args):
        build.check(getattr(self.lib, name)(*args, self.stream), name)

    def encode(self, raw_t, stash, enc_col, n, scales):
        self._go('hn_tmpl_encode', raw_t.data_ptr(), raw_t.shape[1],
                 stash.data_ptr(), stash.shape[1], enc_col, n, _ptr(scales))

    def ray_bias(self, cond, w11, cond_col, out, rays):
        self._go('hn_tmpl_ray_bias', cond.data_ptr(), w11.data_ptr(),
                 out.data_ptr(), rays, w11.shape[1], cond_col, cond.shape[1])

    def rowprod(self, a, n, segs, w, n_red, w_row0, n_tiles, out, out_col0,
                bias=None, ray_bias=None, samples=1, relu=False, mask=None,
                mask_col0=0):
        ptr = lambda t: None if t is None else t.data_ptr()
        self._go('hn_tmpl_rowprod', a.data_ptr(), n, a.shape[1], *segs,
                 w.data_ptr(), w.shape[0], w.shape[1], n_red, w_row0,
                 n_tiles, out.data_ptr(), out.shape[1], out_col0, ptr(bias),
                 ptr(ray_bias), 0 if ray_bias is None else ray_bias.shape[1],
                 samples, int(relu), ptr(mask),
                 0 if mask is None else mask.shape[1], mask_col0)

    def dw(self, g, n, n_out, h, segs, n_kin_tiles, slab, w_off, k_pad,
           b_off):
        self._go('hn_tmpl_dw', g.data_ptr(), g.shape[1], h.data_ptr(),
                 h.shape[1], n, n_out, *segs, n_kin_tiles, slab.data_ptr(),
                 slab.shape[1], w_off, k_pad, b_off, slab.shape[0])

    def rgb_head(self, g4, stash, r3_col, w15, gout, slab, w_off, b_off, n):
        self._go('hn_tmpl_rgb_head', g4.data_ptr(), stash.data_ptr(),
                 stash.shape[1], r3_col, w15.data_ptr(), gout.data_ptr(),
                 gout.shape[1], slab.data_ptr(), slab.shape[1], w_off, b_off,
                 n, slab.shape[0])

    def cond_bwd(self, gout, gin, cond_col, cond, d_cond, slab, w_off, k_pad,
                 rays, samples):
        self._go('hn_tmpl_cond_bwd', gout.data_ptr(), gout.shape[1],
                 gin.data_ptr(), gin.shape[1], cond_col, cond.data_ptr(),
                 d_cond.data_ptr(), slab.data_ptr(), slab.shape[1], w_off,
                 k_pad, rays, samples, slab.shape[0], cond.shape[1])

    def alpha_cond_bwd(self, g4, alpha_cond, aw, d_alpha, slab, tail_off,
                       rays, samples):
        self._go('hn_tmpl_alpha_cond_bwd', g4.data_ptr(),
                 alpha_cond.data_ptr(), aw.data_ptr(), d_alpha.data_ptr(),
                 slab.data_ptr(), slab.shape[1], tail_off, rays, samples,
                 slab.shape[0], alpha_cond.shape[1])

    def bneck_prep(self, g4, gin, stash, bneck_col, w10, gb, slab, w_off,
                   b_off, b9_off, n):
        self._go('hn_tmpl_bneck_prep', g4.data_ptr(), gin.data_ptr(),
                 gin.shape[1], stash.data_ptr(), stash.shape[1], bneck_col,
                 w10.data_ptr(), gb.data_ptr(), gb.shape[1], slab.data_ptr(),
                 slab.shape[1], w_off, b_off, b9_off, n, slab.shape[0])

    def posenc_bwd(self, raw_t, enc_g, dx_t, n, scales):
        self._go('hn_tmpl_posenc_bwd', raw_t.data_ptr(), raw_t.shape[1],
                 enc_g.data_ptr(), enc_g.shape[1], dx_t.data_ptr(), n,
                 _ptr(scales))

    def reduce(self, slab, grads):
        self._go('hn_tmpl_reduce', slab.data_ptr(), slab.shape[0],
                 slab.shape[1], grads.data_ptr())


def layer_views(w_blob, wt_blob, b_blob, shapes):
    """Each layer's (n_pad, k_pad) weight, (k_pad, n_pad) transpose and
    bias as views of the packed blobs, and its dW / db offsets in the
    packed [dW | db] layout (all the layers' dW, then their db)."""
    n_w = sum(n * k for n, k in shapes)
    w, wt, b, w_off, b_off = [], [], [], [], []
    at_w = at_b = 0
    for n, k in shapes:
        w.append(w_blob[at_w:at_w + n * k].view(n, k))
        wt.append(wt_blob[at_w:at_w + n * k].view(k, n))
        b.append(b_blob[at_b:at_b + n])
        w_off.append(at_w)
        b_off.append(n_w + at_b)
        at_w += n * k
        at_b += n
    return w, wt, b, w_off, b_off, n_w + at_b


def unpack_template_grads(grads, layers, shapes, n_w: int, alpha: bool):
    """Kernel A's fp32 [dW | db (| the alpha condition columns' dW)] ->
    [dW, db, ...] in each ``nn.Linear``'s shapes (``common.unpack_grads``;
    the alpha head's dW gets its condition columns from the tail)."""
    if not alpha:
        return common.unpack_grads(grads[:n_w], grads[n_w:], layers, shapes)
    out = common.unpack_grads(grads[:n_w], grads[n_w:-ALPHA_TAIL], layers,
                              shapes)
    ca = layers[10][0].in_features - layers[10][1][0][0]
    out[20] = torch.cat([out[20], grads[-ALPHA_TAIL:][None, :ca]], dim=1)
    return out


def fused_template_bwd(tmpl, raw_t, rgb_cond, g, scales=None,
                       alpha_cond=None):
    """Template backward (see ``fused_template_bwd_plain``): CPU tensors
    take the plain version, CUDA tensors launch kernel A's sequence
    (``template_bwd_chunks``) or raise. dW / db are deterministic: each
    chunk's slabs are summed in a fixed order. ``fused_template_bwd
    .stash_bytes`` holds the bytes of the last launched call's stash.
    Returns (dx_t, d rgb_cond, [dW, db, ...], d alpha_cond or None)."""
    if common.runs_plain(raw_t, 'fused_template_bwd'):
        return fused_template_bwd_plain(tmpl, raw_t, rgb_cond, g, scales,
                                        alpha_cond)
    if tmpl.template.dtype == torch.float32:
        return _template_bwd_f32(tmpl, raw_t, rgb_cond, g, scales, alpha_cond)
    (rgbc, alphac, aw), s, layers, ((w_blob, b_blob, shapes),
                                    (wt_blob, _, _)) = \
        _launch_args(tmpl, raw_t, rgb_cond, True, alpha_cond)
    dev = raw_t.device
    scales = kernel_scales(tmpl, scales, dev)
    build.check_tensor('g', g, (raw_t.shape[0], 4), torch.float32, dev)
    w, wt, b, w_off, b_off, n_grads = layer_views(w_blob, wt_blob, b_blob,
                                                  shapes)
    alpha = None if aw is None else (alphac, aw)
    if alpha is not None:
        n_grads += ALPHA_TAIL
    with torch.cuda.device(dev):
        ops = _KernelOps(dev)
        dx_t, d_cond, grads, d_alpha = template_bwd_chunks(
            ops, raw_t, rgbc, s, g, w, wt, b, w_off, b_off, n_grads,
            scales=scales, alpha=alpha)
    fused_template_bwd.launches += 1
    fused_template_bwd.stash_bytes = ops.stash_bytes
    return (dx_t, d_cond, unpack_template_grads(grads, layers, shapes,
                                                b_off[0], alpha is not None),
            d_alpha)


fused_template_bwd.launches = 0
fused_template_bwd.stash_bytes = 0


def f32_template_args(tmpl, rgb_cond, scales, alpha_cond, rays: int, dev):
    """The float32 kernels' template inputs of a call, checked: the fp32 rgb
    condition (R, C), the window row as ``kernel_scales`` makes it (None
    for posenc_orig; 128 fp32 for the Nerfies layouts, whose presence
    selects that layout in the C code) and (the fp32 alpha condition (R,
    Ca), the alpha head's fp32 condition columns) or None."""
    cond, alphac, aw = cond_args(tmpl, rgb_cond, alpha_cond, rays, dev,
                                 torch.float32)
    return (cond, kernel_scales(tmpl, scales, dev),
            None if aw is None else (alphac, aw))


def _f32_launch_args(tmpl, x_raw, rgb_cond, scales, alpha_cond):
    """The float32 kernels' checked inputs for the template
    ``check_f32_covered`` admits: its packed fp32 blobs (w, wt, b, shapes),
    its layers, ``f32_template_args`` and the rows per condition row."""
    from hypernerf_tpu_torch.kernels import f32  # f32 builds on this module
    layers = kernel_template_layers(tmpl.template)
    check = lambda: check_f32_covered(tmpl)
    w_blob, b_blob, shapes = common.pack_layers(
        tmpl.template, layers, check, dtype=torch.float32)
    wt_blob = common.pack_layers(tmpl.template, layers, check,
                                 transposed=True, dtype=torch.float32)[0]
    check_f32_covered(tmpl)
    if layout(tmpl) in PLANE_LAYOUTS:  # a plane table of its layout
        f32.check_layout(shapes, common.PLANE_TEMPLATE_LAYERS, layout(tmpl))
    else:
        f32.check_layout(shapes, common.TEMPLATE_LAYERS)
    dev = x_raw.device
    p, r = x_raw.shape[0], rgb_cond.shape[0]
    build.check_tensor('x_raw', x_raw, (p, raw_pad(tmpl)), torch.float32,
                       dev)
    if r == 0 or p % r:
        raise ValueError(f'{p} samples do not divide into {r} rays')
    return ((w_blob, wt_blob, b_blob, shapes), layers,
            f32_template_args(tmpl, rgb_cond, scales, alpha_cond, r, dev),
            p // r)


def _template_bwd_f32(tmpl, raw_t, rgb_cond, g, scales, alpha_cond):
    """Kernel A at float32 (``f32.fused_template_bwd_f32``) for the
    template ``check_f32_covered`` admits, with its hyper coordinates or
    none, its layout's window row and its conditions; returns as
    ``fused_template_bwd``."""
    from hypernerf_tpu_torch.kernels import f32  # f32 builds on this module
    (w_blob, wt_blob, b_blob, shapes), layers, (cond, scales, alpha), s = \
        _f32_launch_args(tmpl, raw_t, rgb_cond, scales, alpha_cond)
    build.check_tensor('g', g, (raw_t.shape[0], 4), torch.float32,
                       raw_t.device)
    dx_t, d_cond, grads, d_alpha = f32.fused_template_bwd_f32(
        w_blob, wt_blob, b_blob, shapes, raw_t, cond, s, g,
        hyper=n_hyper(tmpl), scales=scales, alpha=alpha)
    n_w = sum(n * k for n, k in shapes)
    return (dx_t, d_cond, unpack_template_grads(grads, layers, shapes, n_w,
                                                alpha is not None), d_alpha)
