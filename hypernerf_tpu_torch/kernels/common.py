"""Shared by the kernels' wrappers: the choice between a kernel and its plain
version (``runs_plain``) and, for the MLP kernels (``fused_level``,
``fused_mlp``, ``fused_field``), how an ``nn.Linear`` chain is packed into the blobs the
CUDA kernels read and its gradients unpacked, the packed-weight cache, and
the building blocks of the plain backward versions (no autograd) with the
kernels' rounding points — the cotangent is rounded to the compute dtype
before every product, a hidden layer's db sums the rounded cotangent, a
head's db the fp32 one, ReLU masks come from the stored rounded outputs.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from hypernerf_tpu_torch.kernels import build
from hypernerf_tpu_torch.models.modules import MLP, dense
from hypernerf_tpu_torch.ops.posenc import posenc_window

# The widths the CUDA kernels are compiled for (NerfConfig's flagship).
FLAGSHIP = dict(embed=8, warp_freq=10, hyper_sheet_freq=7, hyper_out=4,
                xyz_freq=10, hyper_freq=6, rgb_cond=39)
# Layers of the compiled table (csrc/level_common.cuh): warp, sheet, template.
WARP_LAYERS, SHEET_LAYERS, TEMPLATE_LAYERS = slice(0, 7), slice(7, 14), \
    slice(14, 30)
# The kernels' codes of the warp types. SE(3) and quaternion share a second
# compiled table, whose first nine layers are the trunk (6 hidden layers, the
# trunk logit, the w and the v head) on the Nerfies encoding below.
WARP_CODES = {'translation': 0, 'se3': 1, 'quaternion': 2}
SE3_LAYERS = slice(0, 9)
SE3_FLAGSHIP = dict(embed=8, min_deg=0, max_deg=8)
NOT_COVERED = ('the CUDA kernels cover the flagship widths in bf16 only; '
               'other widths are ROADMAP item A.13 (kernel generality)')


def pad16(x: int) -> int:
    return (x + 15) // 16 * 16


def mlp_layers(mlp: MLP, in_segs):
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


def layer_params(layers):
    """[weight, bias] of every Linear of ``layers``, in order."""
    return [p for lin, _ in layers for p in (lin.weight, lin.bias)]


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


def pack_layers(owner: torch.nn.Module, layers, check=None,
                transposed: bool = False):
    """The kernels' bf16 weight and bias blobs for ``layers`` and the
    (n_pad, k_pad) of each layer, cached on ``owner`` (the module that holds
    those layers).

    With ``transposed`` the first blob holds every layer as (k_pad, n_pad),
    which is how the backward kernels read a weight for ``g @ W``. ``check``
    runs before a (re)pack and raises on what the kernels do not cover.

    The cache is keyed on each parameter's storage and version counter (and
    on the layers' padded layout), so it is repacked after
    ``load_state_dict``, ``.to()``, an optimizer step or any in-place op on
    the parameter itself (``with torch.no_grad(): p.add_(...)``). A write
    through ``p.data`` bumps no version counter and leaves the cache stale:
    change parameters only through the parameter. Neither does
    ``torch.optim.Adam(fused=True)``, which
    ``training.train_state.make_train_step`` therefore refuses. Each module
    owns its cache, so a warp field or a sheet shared by two levels is
    packed once per optimizer step.
    """
    cached = packed(owner, layers, check)
    if transposed and 'wt' not in cached:
        cached['wt'] = torch.cat([w.t().reshape(-1)
                                  for w, _ in cached['packed']]).contiguous()
    return cached['wt' if transposed else 'w'], cached['b'], cached['shapes']


def packed(owner: torch.nn.Module, layers, check=None) -> dict:
    """The cache entry behind ``pack_layers``: 'key', 'packed' [(w, b)],
    'shapes', the blobs 'w' and 'b' and, once asked for, 'wt'."""
    key = (tuple((p.data_ptr(), p._version) for p in layer_params(layers)),
           tuple(tuple(segs) for _, segs in layers))
    cached = getattr(owner, '_packed', None)
    if cached is None or cached['key'] != key:
        if check is not None:
            check()
        pairs = [_pack_layer(lin, segs, torch.bfloat16)
                 for lin, segs in layers]
        cached = dict(
            key=key, packed=pairs,
            shapes=[tuple(w.shape) for w, _ in pairs],
            w=torch.cat([w.reshape(-1) for w, _ in pairs]).contiguous(),
            b=torch.cat([b for _, b in pairs]).contiguous())
        object.__setattr__(owner, '_packed', cached)
    return cached


def unpack_grads(dw_blob, db_blob, layers, shapes):
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


@functools.cache
def kernel_layout(warp: str = 'translation'):
    """[(n_pad, k_pad)] of the compiled layer table of the level with warp
    type ``warp``, in layer order."""
    lib = build.library()
    n = (ctypes.c_int * 64)()
    k = (ctypes.c_int * 64)()
    count = lib.hn_fused_level_layout(WARP_CODES[warp], ctypes.addressof(n),
                                      ctypes.addressof(k), 64)
    return [(n[i], k[i]) for i in range(count)]


def check_layout(shapes, table: slice, warp: str = 'translation') -> None:
    """Raise unless packed ``shapes`` are rows ``table`` of the compiled
    layer table of warp type ``warp``."""
    if shapes != kernel_layout(warp)[table]:
        raise NotImplementedError(f'{NOT_COVERED}; layer shapes {shapes}')


def grad_buffer(shapes, device):
    """A zeroed fp32 [dW | db] buffer in the packed layout of ``shapes``,
    which every block of a backward kernel adds into, and the length of its
    dW part."""
    n_w = sum(n * k for n, k in shapes)
    n_b = sum(n for n, _ in shapes)
    return torch.zeros((n_w + n_b,), dtype=torch.float32, device=device), n_w


# ---------------------------------------------------------------------------
# Plain backward building blocks.


def acc_dtype(dt):
    return torch.promote_types(dt, torch.float32)


def prod(a, b, dt):
    """a @ b with compute-dtype operands summed in at least fp32."""
    acc = acc_dtype(dt)
    return a.to(dt).to(acc) @ b.to(dt).to(acc)


def encoding_scales(segments, alphas, device=None) -> torch.Tensor:
    """The fp32 window row over the encoded features of ``segments``.

    A segment is (channels, bands) — posenc_orig: identity first, bands from
    degree 0 — or (channels, bands, min_deg, use_identity); 0 bands is a raw
    pass-through. ``alphas`` holds one entry per segment: None (fully on) or
    the ``posenc_window`` alpha, with bands counted from ``min_deg``.
    Identity and pass-through features weigh 1, band k's sin and cos features
    the window's weight of band k.
    """
    parts = []
    for seg, alpha in zip(segments, alphas):
        ch, n_freq, min_deg, ident = (*seg, 0, True) if len(seg) == 2 else seg
        ones = torch.ones(ch, dtype=torch.float32, device=device)
        if n_freq == 0:
            parts.append(ones)
            continue
        if ident:
            parts.append(ones)
        band = (torch.ones(n_freq, dtype=torch.float32, device=device)
                if alpha is None else
                posenc_window(min_deg, min_deg + n_freq, alpha, device))
        band = band.repeat_interleave(ch)
        parts += [band, band]
    return torch.cat(parts)


def scaled(enc, scales, dt):
    """The rounded encoding times the window row, rounded again."""
    if scales is None:
        return enc
    return (enc.to(acc_dtype(dt)) * scales.reshape(1, -1)).to(dt)


def padded_scales(scales, enc: int, enc_pad: int, device):
    """The window row as a kernel takes it: fp32, contiguous, zero-padded
    from ``enc`` to ``enc_pad`` features; None stays None."""
    if scales is None:
        return None
    scales = F.pad(scales.detach().reshape(-1).float(),
                   (0, enc_pad - enc)).contiguous()
    build.check_tensor('scales', scales, (enc_pad,), torch.float32, device)
    return scales


def posenc_trig(x, n_freqs: int):
    """fp32 (sin, cos) of the band products of (P, C) ``x``, each
    (P, n_freqs * C) with band k of channel c at k * C + c."""
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    xb = (x[:, None, :] * freqs[:, None]).reshape(x.shape[0], -1)
    return torch.sin(xb), torch.cos(xb)


def posenc_bwd(g_enc, trig, ch: int, n_freqs: int):
    """VJP of ``posenc_orig`` from the recompute's (sin, cos): cotangent
    (P, ch * (1 + 2 F)) of [x | sin | cos] -> (P, ch)."""
    sin, cos = trig
    nb = ch * n_freqs
    flat = cos * g_enc[:, ch:ch + nb] - sin * g_enc[:, ch + nb:ch + 2 * nb]
    freqs = 2.0 ** torch.arange(n_freqs, dtype=flat.dtype, device=flat.device)
    dx = (flat.reshape(-1, n_freqs, ch) * freqs[:, None]).sum(1)
    return g_enc[:, :ch] + dx


def mlp_recompute(mlp: MLP, x):
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


def head_bwd(layer, x_in, g, dt):
    """A linear fp32 head: (dW, db, fp32 g @ W). The cotangent is rounded
    for the products; db sums the fp32 one."""
    g_c = g.to(dt)
    return (prod(g_c.t(), x_in, dt), g.sum(0).to(acc_dtype(dt)),
            prod(g_c, layer.weight, dt))


def hidden_bwd(mlp: MLP, ins, outs, gh, in_w: int):
    """Back through the hidden chain. ``gh``: compute-dtype cotangent of the
    logit's input. Returns the fp32 cotangent of the MLP's input and
    [dW, db, ...] of the hidden layers in order."""
    dt, acc = mlp.dtype, acc_dtype(mlp.dtype)
    width = mlp.hidden(0).out_features
    g_in = torch.zeros((gh.shape[0], in_w), dtype=acc, device=gh.device)
    if (mlp.depth - 1) in mlp.skips:
        g_in = g_in + gh[:, width:].to(acc)
        gh = gh[:, :width]
    grads = [None] * mlp.depth
    for i in range(mlp.depth - 1, -1, -1):
        gh = torch.where(outs[i].to(acc) > 0, gh, torch.zeros_like(gh))
        grads[i] = (prod(gh.t(), ins[i], dt), gh.to(acc).sum(0))
        gh = prod(gh, mlp.hidden(i).weight, dt).to(dt)
        if i > 0 and (i - 1) in mlp.skips:
            g_in = g_in + gh[:, width:].to(acc)
            gh = gh[:, :width]
    return g_in + gh.to(acc), [t for pair in grads for t in pair]


def runs_plain(t: torch.Tensor, name: str) -> bool:
    """Whether wrapper ``name``, given ``t``, runs its plain version (a CPU
    tensor) or launches its kernel (a CUDA tensor); raises on any other
    device. Every wrapper, forward and backward, decides here and looks this
    name up on the module at call time, so a caller that wants the plain
    versions on the card, to time them or to hold a step against them,
    rebinds this one name for the duration (``chip_smoke.plain_versions``).
    Nothing in the package does."""
    if t.device.type == 'cpu':
        return True
    if t.device.type != 'cuda':
        raise ValueError(f'{name}: no kernel for {t.device}')
    return False


def launch(fn_name: str, device, *args) -> None:
    """Call C entry point ``fn_name`` of the kernel library on ``device``'s
    current stream (appended as the last argument); raise on a CUDA error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        build.check(getattr(build.library(), fn_name)(*args, stream), fn_name)
