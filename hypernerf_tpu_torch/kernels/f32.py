"""The float32 kernels, hand-written CUDA on FFMA (``csrc/f32_chain.cuh``,
``f32_level.cu``, ``f32_steps.cu``, ``f32_tangents.cu``): the level
forward (row 1 at ``compute_dtype='float32'``) and the two halves of its
backward, kernel A (the template backward, row 9) and kernel B (the fields
backward, row 5); the per-module path's: the template alone (row 8), a
field alone (row 10) and a field alone backward (row 11); the SE(3) trunk
alone, forward (row 12) and backward (row 13); and the Jacobians of the
elastic loss: the translation warp's J, forward (row 14) and backward (row
15), and the SE(3) / quaternion trunk's (w, v) with their point-tangents,
forward (row 16) and backward (row 17), with or without the trunk's window
row. The bf16 kernels are untouched:
``fused_level``, ``fused_fields_bwd``, ``fused_template_bwd``,
``fused_template``, ``fused_field``, ``fused_field_bwd``, ``fused_se3_wv``,
``fused_se3_bwd``, ``fused_warp_jacobian``, ``fused_jacobian_bwd``,
``fused_se3_wv_tangents`` and ``fused_se3_jacobian_bwd`` take these where
the modules compute in float32, on
every level table (``common.TABLE_CODES``, 0 to 8): the translation warp,
or the SE(3) or the quaternion warp (the trunk and the retraction, with
or without the ``warp_alpha`` window row), with the bendy sheet (the
sheet tables, codes 0 to 2) or without it (the plane tables, 3 to 8,
axis_aligned_plane: the hyper coordinates are the ray's 8 GLO
coordinates, raw rows of 16 columns), and the template in its layouts,
posenc_orig or, given the template's window row, the Nerfies encoding
(``common.NERFIES``: the hyper coordinates over 4 bands without
identity, 95 columns in the same 128, each times its window weight; with
the plane's 8 coordinates 127), with 4 hyper coordinates, the plane's 8
(posenc_orig: 167 columns in ``PLANE_ENC``) or none (static), any rgb
condition width the layout has (39, 47, 8, 0; Nerfies 27, 35, 8, 0) and
the 8-column alpha condition or none; and their modules alone (a field
alone, the warp field or the sheet, with or without a window row).
``fused_level._check_covered``, ``fused_mlp.check_f32_covered`` and the
other wrappers' checks refuse the rest (other bands and widths), naming
ROADMAP A.13.

Float32 is the TPU kernels' float32: fp32 operands, fp32 sums, fp32
epilogues, nothing rounded to bf16 — the plain versions' arithmetic at that
dtype (``fused_level_plain``, ``fused_template_bwd_plain``,
``fused_fields_bwd_plain``), which the CPU tests hold to the JAX kernels.

The level forward is one kernel (a tile of 64 samples through all 30 layers
in shared memory); the template alone and a field alone and the trunk alone
are its stages, run alone on raw rows; the Jacobians' forwards run a field
alone's or the trunk alone's stages on a tile of 16 points x their four
streams (the primal row and three tangent rows). Kernels A and B, a field
alone backward, the trunk alone backward and the Jacobians' backwards are
sequences of generic steps over chunks of whole rays or of points
(``template_bwd_steps``, ``fields_bwd_steps``, ``field_bwd_steps``,
``se3_bwd_steps``, ``jacobian_bwd_steps``; the trunk's walk is
``_trunk_steps``, a field's ``_field_steps``): each wide layer's fp32
output is recomputed into a stash (at most ``STASH_BYTES`` a chunk), then
the chunk is walked back a layer at a time — the cotangent through the
layer (``rowprod``, masked by the input's ReLU) and the layer's dW / db
over row ranges (``dw``, one slab per range, as many ranges as fill the
card twice: ``split_count``; summed into the layer's gradient in a fixed
order by ``reduce``). ``ops`` launches the steps: ``_KernelOps`` on the
card; the tests pass a PyTorch model of each C entry point.

Every wrapper adds one to its ``launches`` where it launches its kernel (a
call of kernel A or B, of a field or the trunk alone backward or of a
Jacobian's backward, whatever its steps).
"""

from __future__ import annotations

import torch

from hypernerf_tpu_torch.kernels import build, common, fused_mlp

# The flagship's encodings: warp field and sheet bands, the template's xyz
# and hyper bands and hyper coordinates; the Nerfies layout's hyper bands.
WARP_FREQ, SHEET_FREQ, XYZ_FREQ, HYPER_FREQ = 10, 7, 10, 6
NERF_HYPER_FREQ = common.NERFIES['hyper_freq']
N_HYPER = 4
COND_PAD = common.COND_PAD
# csrc/f32_chain.cuh and f32_level.cu: the level forward's tile of
# TILE_ROWS rows, in passes of up to WIDE_COLS columns (the Wide tile) with
# a double-buffered weight tile of DEPTH x WIDE_COLS; its shared memory: X
# (128 features), H0 and H1 (256), that weight tile, per-row scratch (3 + 8
# + 8 + 1 floats) and the rows' ray indices, of 64 rows each, 4 bytes a
# value; a plane table's carve (``level_smem_bytes``) has X of its
# template's encoding slots (PLANE_ENC for the posenc_orig plane layout)
# and 16 raw rows ([warped | 8 hyper | 0]) where the sheet tables have 8.
# The steps' Step tile: STEP_ROWS x STEP_COLS a block.
THREADS, TILE_ROWS, WIDE_COLS, DEPTH = 256, 64, 256, 16
STEP_ROWS = STEP_COLS = 128
PLANE_ENC = common.PLANE_ENC_PAD


def level_smem_bytes(xf: int = 128, raw: int = common.RAW_PAD) -> int:
    """The level forward's (and the template alone's) dynamic shared
    memory with X of ``xf`` features and ``raw`` raw rows
    (csrc/f32_level.cu ``carve_bytes``)."""
    return 4 * (TILE_ROWS * (xf + 2 * 256 + 3 + raw + 8 + 1 + 1)
                + 2 * DEPTH * WIDE_COLS)


LEVEL_SMEM_BYTES = level_smem_bytes()
PLANE_SMEM_BYTES = level_smem_bytes(PLANE_ENC, common.PLANE_RAW_PAD)
# The static shared memory of rowprod: two chunks of each operand, the
# activations' rows padded by 4 (csrc/f32_steps.cu kALd).
STEP_SMEM_BYTES = 4 * 2 * (DEPTH * (STEP_ROWS + 4) + DEPTH * STEP_COLS)
SMEM_LIMIT = 232448  # bytes a block may use on sm_90
# A chunk's stash at most (the bf16 kernel A's, 2^19 rows of 3072 bf16).
STASH_BYTES = 3 << 30
MAX_SPLITS = 512  # row ranges of a layer's dW pass, one slab each
# A field alone's dynamic shared memory (csrc/f32_level.cu
# kFieldSmemBytes): X of the warp field's 80 encoding features, H0 and H1
# of 128, the Narrow tile's weight chunks, the same per-row scratch.
FIELD_SMEM_BYTES = 4 * (TILE_ROWS * (80 + 2 * 128 + 3 + 8 + 8 + 1 + 1)
                        + 2 * DEPTH * WIDE_COLS // 2)


def template_enc(hyper: int, nerfies: bool = False) -> int:
    """Stash columns of the template's encoding with ``hyper`` hyper
    coordinates, each layout's encoded columns padded to 16: posenc_orig
    128 for the flagship's 4 (115 encoded) and 176 for the plane's 8 (167,
    in PLANE_ENC packed columns), the Nerfies layout 96 (95: the hyper
    coordinates without identity, over 4 bands) and 128 for the plane's 8
    (127), 64 for none (63)."""
    per = 2 * NERF_HYPER_FREQ if nerfies else 1 + 2 * HYPER_FREQ
    return common.pad16(3 * (1 + 2 * XYZ_FREQ) + hyper * per)


def template_stash(hyper: int = N_HYPER,
                   nerfies: bool = False) -> fused_mlp.Stash:
    """Kernel A's stash: the bf16 kernel A's columns with the encoding's
    ``template_enc(hyper, nerfies)``, the rgb condition (padded to 48) after
    the bottleneck's 128, one fp32 row per sample; its wide layers are the
    bf16 kernel A's, layer 11 reading [bottleneck | condition] from the
    stash. An encoding narrower than its packed columns (the Nerfies
    layout's 96 of 128, the plane layout's 176 of 192, a template without
    hyper coordinates' 64 of 128) runs the first and skip layers' products
    on its own columns, their packed weights' other columns unread, and
    their dW there zero."""
    return fused_mlp.stash_plan(enc=template_enc(hyper, nerfies),
                                cond=COND_PAD)


TEMPLATE_STASH = template_stash()
# A field's layers: the template trunk's first six (the skip at layer 5).
FIELD_LAYERS = fused_mlp.WIDE_LAYERS[:6]


def field_stash(enc: int, width: int) -> fused_mlp.Stash:
    """Kernel B's stash of one field: its encoding and six hidden outputs."""
    return fused_mlp.column_plan((('enc', enc),) + tuple(
        (f'h{i}', width) for i in range(6)))


WARP_STASH = field_stash(80, 128)
SHEET_STASH = field_stash(64, 64)
# A field alone by its bands: its stash and its rows of the float32 table
# (the index the forward's entry point takes is 0 for the warp, 1 for the
# sheet).
FIELDS = {WARP_FREQ: (WARP_STASH, common.WARP_LAYERS, 0),
          SHEET_FREQ: (SHEET_STASH, common.SHEET_LAYERS, 1)}
# The SE(3) / quaternion trunk (csrc/f32_level.cu kTrunk*): its encoding's
# columns, 48 bands and the embedding in 64; its stash, the encoding, six
# hidden outputs and the linear trunk logit (960 columns); the wide layers
# of its recompute, a field's and the logit (no ReLU); the columns of the
# heads' outputs a row (csrc/f32_steps.cu kVCol: [w | 0 | v | 0]). A
# field alone's shared memory with the trunk's 64 encoding features
# (kTrunkSmemBytes).
SE3_ENC = common.pad16(2 * 3 * common.SE3_FLAGSHIP['max_deg']
                       + common.SE3_FLAGSHIP['embed'])
SE3_STASH = fused_mlp.column_plan((('enc', SE3_ENC),) + tuple(
    (f'h{i}', 128) for i in range(6)) + (('trunk', 128),))
TRUNK_LAYERS = FIELD_LAYERS + [(6, ('h5',), 'trunk', False)]
V_COL = 8
# The Jacobians' rows a point (csrc/f32_tangents.cu kStreams): its primal
# row and its three tangent rows.
STREAMS = 4
TRUNK_SMEM_BYTES = 4 * (TILE_ROWS * (SE3_ENC + 2 * 128 + 3 + 8 + 8 + 1 + 1)
                        + 2 * DEPTH * WIDE_COLS // 2)


def chunk_rows(stash: fused_mlp.Stash) -> int:
    """The most rows a chunk of ``stash`` may hold within STASH_BYTES."""
    return STASH_BYTES // (4 * stash.width)


def split_count(n_out: int, k: int, rows: int, sms: int) -> int:
    """Row ranges of a dW pass over ``rows`` rows of a layer of ``n_out``
    outputs and ``k`` inputs on a card of ``sms`` SMs: enough blocks of 128
    x 128 (STEP_ROWS x STEP_COLS) for two blocks an SM, twice over, each
    range at least 16 rows (a chunk of the kernel)."""
    tiles = -(-n_out // STEP_ROWS) * -(-k // STEP_COLS)
    return max(1, min(MAX_SPLITS, -(-4 * sms // tiles), rows // 16))


def scratch_floats(ops, shapes, rows: int) -> int:
    """Floats of the per-layer slabs of a dW pass, the largest layer's:
    ``ops.split_count`` ranges of [dW | db] (n_pad * k_pad + n_pad)."""
    return max(ops.split_count(n, k, rows) * (n * k + n) for n, k in shapes)


# ---------------------------------------------------------------------------
# The walks back.


class _Walk:
    """One chunk walked back through an MLP's layers (``layer_views`` of
    packed blobs; a cotangent through layer l is g w[l]): each layer's dW /
    db over row ranges into ``scratch`` and from there, summed in order,
    into ``grads``, and the cotangent of its input into one of two buffers
    in turn (``bufs``: (n, width) views; the current cotangent is in
    ``bufs[at]``). A layer's db sums the cotangent's first ``db_rows`` rows
    (None: every row; the Jacobians' primal rows)."""

    def __init__(self, ops, w, w_off, b_off, scratch, grads, bufs,
                 db_rows=None):
        self.ops, self.w, self.w_off, self.b_off = ops, w, w_off, b_off
        self.scratch, self.grads, self.bufs, self.at = scratch, grads, bufs, 0
        self.db_rows = db_rows

    def _dw(self, g, l, h, h1=None):
        """Layer ``l``'s dW (its first ``g.shape[1]`` rows) and db from
        output cotangent ``g`` and input [h | h1], added to ``grads``."""
        n_out, ldc = g.shape[1], self.w[l].shape[1]
        k = h.shape[1] + (0 if h1 is None else h1.shape[1])
        if k > ldc:  # narrower: dw writes zeros past k
            raise ValueError(f'layer {l}: an input of {k} columns, {ldc} '
                             f'packed')
        splits = self.ops.split_count(n_out, k, g.shape[0])
        size = n_out * ldc
        slabs = self.scratch[:splits * (size + n_out)].view(splits,
                                                            size + n_out)
        self.ops.dw(g, h, h1, slabs, 0, ldc, size, self.db_rows)
        w_at, b_at = self.w_off[l], self.b_off[l]
        self.ops.reduce(slabs[:, :size], self.grads[w_at:w_at + size])
        self.ops.reduce(slabs[:, size:], self.grads[b_at:b_at + n_out])

    def head(self, g, l, h, mask=None):
        """A linear head ``l`` on ReLU output ``h`` with output cotangent
        ``g``: its dW / db, and h's cotangent, masked by h's ReLU (or by
        ``mask``: rows that repeat, the Jacobians' primal rows), into
        bufs[0]."""
        self._dw(g, l, h)
        self.at = 0
        y = self.bufs[0][:, :h.shape[1]]
        self.ops.rowprod(g, self.w[l], y, mask=h if mask is None else mask)
        return y

    def layer(self, x, l, h, h1=None, enc_g=None, relu_in=True, mask=None):
        """Layer ``l`` on [h | h1] with output cotangent ``x``: its dW / db;
        h's cotangent (masked by h's ReLU, or by ``mask`` as ``head`` takes
        it, where ``relu_in``) into the other buffer, which is returned;
        h1's (the skip's encoding) into ``enc_g``."""
        self._dw(x, l, h, h1)
        self.at ^= 1
        y = self.bufs[self.at][:, :h.shape[1]]
        mask = (h if mask is None else mask) if relu_in else None
        self.ops.rowprod(x, self.w[l], y, mask=mask)
        if h1 is not None:
            k = h.shape[1]
            self.ops.rowprod(x, self.w[l][:, k:k + h1.shape[1]], enc_g)
        return y

    def first(self, x, l, enc, enc_g):
        """The first layer on the encoding: its dW / db, and its part of
        the encoding's cotangent added into ``enc_g``."""
        self._dw(x, l, enc)
        self.ops.rowprod(x, self.w[l], enc_g, accumulate=True)


def _recompute(ops, wt, b, cols, layers, primal=None):
    """The forward of the wide ``layers`` into the stash: x wt[l], wt the
    layers' transposes. With ``primal`` the stash's rows are a chunk's
    streams (the Jacobians': its first ``primal`` rows the points' primal
    rows, the tangent rows after them): the primal rows take the bias and
    the ReLU; the tangent rows no bias, and where the layer has a ReLU its
    point's primal mask (the primal output's rows, which repeat)."""
    for l, ins, out, relu in layers:
        a1 = cols(ins[1]) if len(ins) > 1 else None
        k0 = wt[l].shape[0] - (0 if a1 is None else a1.shape[1])
        x, y = cols(ins[0])[:, :k0], cols(out)[:, :wt[l].shape[1]]
        if primal is None:
            ops.rowprod(x, wt[l], y, bias=b[l], relu=relu, a1=a1)
            continue
        ops.rowprod(x[:primal], wt[l], y[:primal], bias=b[l], relu=relu,
                    a1=None if a1 is None else a1[:primal])
        ops.rowprod(x[primal:], wt[l], y[primal:],
                    mask=y[:primal] if relu else None,
                    a1=None if a1 is None else a1[primal:])


def template_bwd_steps(ops, w, wt, b, w_off, b_off, n_grads, raw_t, cond,
                       samples, g, max_rows=None, hyper=N_HYPER, scales=None,
                       alpha=None):
    """Kernel A at float32 (the template's 16 layers: ``layer_views``
    of its packed fp32 blobs), chunk by chunk. raw_t (P, 8) [warped | hyper
    | 0] with ``hyper`` hyper coordinates (4, or 0: static; the plane
    layouts' 8 in (P, 16) rows), cond (R, C) the
    rgb condition, g (P, 4) the output's cotangent; ``scales`` the Nerfies
    layout's window row (``fused_mlp.kernel_scales``: 128 fp32) or None
    (posenc_orig); ``alpha`` (the alpha condition (R, Ca) fp32, its weights
    in the alpha head (Ca,) fp32) or None, whose dW goes to the buffer's
    last ``fused_mlp.ALPHA_TAIL`` floats (``n_grads`` counts them). Returns
    dx_t (P, raw_t's columns, zero past the hyper coordinates), d cond (R,
    C), the [dW | db] buffer and d alpha_cond (R, Ca) or None. dx_t is
    computed whether or not the caller reads it (a static template's
    points take no gradient)."""
    dev, f32 = raw_t.device, torch.float32
    p, s = raw_t.shape[0], samples
    nerfies = scales is not None
    sp = template_stash(hyper, nerfies)
    hf = NERF_HYPER_FREQ if nerfies else HYPER_FREQ
    plan = fused_mlp.chunk_plan(p, s, max_rows or chunk_rows(sp))
    rows = max(r1 - r0 for r0, r1 in plan)
    stash = torch.empty((rows, sp.width), dtype=f32, device=dev)
    bufs = [torch.empty((rows, 256), dtype=f32, device=dev)
            for _ in range(2)]
    enc_g = torch.empty((rows, sp.widths['enc']), dtype=f32, device=dev)
    scratch = torch.empty((scratch_floats(ops, [t.shape for t in w], rows),),
                          dtype=f32, device=dev)
    grads = torch.zeros((n_grads,), dtype=f32, device=dev)
    dx_t = torch.empty((p, raw_t.shape[1]), dtype=f32, device=dev)
    c = cond.shape[1]
    d_cond = torch.empty((cond.shape[0], c), dtype=f32, device=dev)
    d_alpha = None if alpha is None else torch.empty(
        alpha[0].shape, dtype=f32, device=dev)
    bw = w[9].shape[0]  # the bottleneck's width
    for r0, r1 in plan:
        n, q0, q1 = r1 - r0, r0 // s, r1 // s

        def cols(name, n=n):
            return stash[:n, sp.col[name]:sp.col[name] + sp.widths[name]]

        raw_c, g_c = raw_t[r0:r1], g[r0:r1]
        ops.tmpl_encode(raw_c, XYZ_FREQ, hyper, hf, cols('enc'),
                        ident1=not nerfies, scales=scales)
        ops.cond_rows(cond[q0:q1], s, cols('bneck')[:, bw:])
        _recompute(ops, wt, b, cols, fused_mlp.WIDE_LAYERS)
        walk = _Walk(ops, w, w_off, b_off, scratch, grads,
                     [t[:n] for t in bufs])
        # The rgb head and branch, then layer 11 on [bottleneck |
        # condition] (the condition's cotangent summed per ray), the alpha
        # head's cotangent added to the bottleneck's.
        x = walk.head(g_c[:, :3], 15, cols('r3'))
        for l, name in ((14, 'r2'), (13, 'r1'), (12, 'r0')):
            x = walk.layer(x, l, cols(name))
        y = walk.layer(x, 11, cols('bneck'), relu_in=False)
        ops.ray_sum(y[:, bw:bw + c], s, d_cond[q0:q1])
        walk._dw(g_c[:, 3:4], 10, cols('bneck')[:, :bw])
        if alpha is not None:  # the alpha condition's columns, per ray
            ca = alpha[1].shape[0]
            slabs = scratch[:ops.split_count(1, ca, q1 - q0) * ca].view(
                -1, ca)
            ops.alpha_cond_bwd(g_c[:, 3:4], alpha[0][q0:q1], alpha[1], s,
                               d_alpha[q0:q1], slabs)
            tail = n_grads - fused_mlp.ALPHA_TAIL
            ops.reduce(slabs, grads[tail:tail + ca])
        ops.rowprod(g_c[:, 3:4], w[10], y[:, :bw], accumulate=True)
        # The bottleneck (linear) and the trunk, the skip's encoding part
        # and layer 0's into enc_g, then the posenc VJP.
        x = y[:, :bw]
        for l, name in ((9, 'hl'), (8, 'h7'), (7, 'h6'), (6, 'h5')):
            x = walk.layer(x, l, cols(name))
        x = walk.layer(x, 5, cols('h4'), cols('enc'), enc_g[:n])
        for l, name in ((4, 'h3'), (3, 'h2'), (2, 'h1'), (1, 'h0')):
            x = walk.layer(x, l, cols(name))
        walk.first(x, 0, cols('enc'), enc_g[:n])
        ops.tmpl_posenc_bwd(raw_c, XYZ_FREQ, hyper, hf, enc_g[:n],
                            dx_t[r0:r1], ident1=not nerfies, scales=scales)
    return dx_t, d_cond, grads, d_alpha


def _field_steps(ops, w, wt, b, w_off, b_off, sp, encode, stash, bufs,
                 enc_g, g, scratch, grads, primal=None):
    """One field (its 7 layers: ``layer_views``) on a chunk: encode (the
    step ``encode(out)``) and recompute into ``stash`` (plan ``sp``), then
    walk back from ``g``, the cotangent of its head's output, to the
    encoding's cotangent (``enc_g``). With ``primal`` (the translation
    Jacobian's backward) the stash holds a chunk's ``primal`` points' four
    streams (``_recompute``'s) and the walk runs on the tangent rows after
    the primal ones, ``g`` theirs: each masked by its point's primal
    output, every db zero (J reaches the biases only through the masks)."""
    n, top = g.shape[0], primal or 0

    def cols(name, rows=slice(top, top + n)):
        return stash[rows, sp.col[name]:sp.col[name] + sp.widths[name]]

    def mask(name):
        return None if primal is None else cols(name, slice(0, primal))

    encode(cols('enc', slice(0, top + n)))
    _recompute(ops, wt, b, lambda name: cols(name, slice(0, top + n)),
               FIELD_LAYERS, primal)
    walk = _Walk(ops, w, w_off, b_off, scratch, grads, [t[:n] for t in bufs],
                 db_rows=None if primal is None else 0)
    x = walk.head(g, 6, cols('h5'), mask('h5'))
    x = walk.layer(x, 5, cols('h4'), cols('enc'), enc_g, mask=mask('h4'))
    for l, name in ((4, 'h3'), (3, 'h2'), (2, 'h1'), (1, 'h0')):
        x = walk.layer(x, l, cols(name), mask=mask(name))
    walk.first(x, 0, cols('enc'), enc_g)


def _trunk_steps(ops, w, wt, b, w_off, b_off, encode, heads, stash, bufs,
                 enc_g, scratch, grads, primal=None):
    """The SE(3) / quaternion trunk (its 9 layers: ``layer_views``) on a
    chunk: encode (the step ``encode(out)``) and recompute into ``stash``
    (SE3_STASH), then take the heads' cotangent [d w | d v] from
    ``heads(trunk)`` (given the recomputed trunk logit: the cotangent of
    the trunk alone backward, or kernel B's heads and retraction VJP) and
    walk back to the encoding's cotangent (``enc_g``). The w and v heads
    both read the trunk logit, which has no ReLU: their cotangents through
    it are summed and nothing masks them. With ``primal`` (the trunk
    tangents' backward) the rows are a chunk's ``primal`` points' four
    streams (``_recompute``'s): every row carries a cotangent, masked by
    its point's primal output; dW sums every row, db the primal rows."""
    n, sp = enc_g.shape[0], SE3_STASH

    def cols(name):
        return stash[:n, sp.col[name]:sp.col[name] + sp.widths[name]]

    def mask(name):
        return None if primal is None else cols(name)[:primal]

    encode(cols('enc'))
    _recompute(ops, wt, b, cols, TRUNK_LAYERS, primal)
    g = heads(cols('trunk'))
    walk = _Walk(ops, w, w_off, b_off, scratch, grads, [t[:n] for t in bufs],
                 db_rows=primal)
    walk._dw(g[:, :3], 7, cols('trunk'))
    walk._dw(g[:, 3:6], 8, cols('trunk'))
    x = walk.bufs[0][:, :sp.widths['trunk']]
    ops.rowprod(g[:, :3], w[7], x)
    ops.rowprod(g[:, 3:6], w[8], x, accumulate=True)
    x = walk.layer(x, 6, cols('h5'), mask=mask('h5'))
    x = walk.layer(x, 5, cols('h4'), cols('enc'), enc_g, mask=mask('h4'))
    for l, name in ((4, 'h3'), (3, 'h2'), (2, 'h1'), (1, 'h0')):
        x = walk.layer(x, l, cols(name), mask=mask(name))
    walk.first(x, 0, cols('enc'), enc_g)


def fields_bwd_steps(ops, w, wt, b, w_off, b_off, n_grads, z_vals, origins,
                     directions, embed, dx_t, max_rows=None, code=0,
                     scales=None):
    """Kernel B at float32 (``layer_views`` of the level's packed fp32
    blobs: with table code 0 the warp field's layers 0..6 and the sheet's
    7..13; with code 1 or 2, SE(3) or quaternion, the trunk's 0..8 and the
    sheet's 9..15, ``scales`` the trunk's window row or None; a plane
    table, codes 3 to 8, has no sheet: the warp of code % 3 alone, its
    layers 0..6 or 0..8), chunk by chunk: each field recomputed and walked
    back in one stash, then the rows' point and embedding cotangents and
    their per-ray sums. The trunk takes its heads' cotangent from the
    retraction's VJP, which also gives the point's direct term. Without a
    sheet the hyper coordinates are the embedding: d hyper, dx_t[:, 3:11],
    joins each row's d embed (the plane rows). Returns d z_vals (R, S),
    d_ray (R, 14) [d origins | d directions | d embed] and the [dW | db]
    buffer."""
    dev, f32 = z_vals.device, torch.float32
    r, s = z_vals.shape
    p, e = r * s, embed.shape[1]
    warp_code = code % len(common.WARP_CODES)
    screw, plane = warp_code != 0, code >= len(common.WARP_CODES)
    wsp = SE3_STASH if screw else WARP_STASH
    plan = fused_mlp.chunk_plan(p, s, max_rows or chunk_rows(wsp))
    rows = max(r1 - r0 for r0, r1 in plan)
    stash = torch.empty((rows, wsp.width), dtype=f32, device=dev)
    bufs = [torch.empty((rows, 128), dtype=f32, device=dev)
            for _ in range(2)]
    enc_w = torch.empty((rows, wsp.widths['enc']), dtype=f32, device=dev)
    if not plane:
        enc_s = torch.empty((rows, SHEET_STASH.widths['enc']), dtype=f32,
                            device=dev)
    per_row = torch.empty((rows, 6 + e), dtype=f32, device=dev)
    if screw:  # the heads' outputs [w | v] and cotangent [d w | d v]
        wv = torch.empty((rows, 2 * V_COL), dtype=f32, device=dev)
        g_wv = torch.empty((rows, 8), dtype=f32, device=dev)
    scratch = torch.empty((scratch_floats(ops, [t.shape for t in w], rows),),
                          dtype=f32, device=dev)
    grads = torch.zeros((n_grads,), dtype=f32, device=dev)
    d_z = torch.empty((r, s), dtype=f32, device=dev)
    d_ray = torch.empty((r, 6 + e), dtype=f32, device=dev)
    z_flat, dz_flat = z_vals.reshape(-1), d_z.view(-1)
    nw = 9 if screw else 7
    warp, sheet = slice(0, nw), slice(nw, nw + 7)
    for r0, r1 in plan:
        n, q0, q1 = r1 - r0, r0 // s, r1 // s
        rays = (z_flat[r0:r1], origins[q0:q1], directions[q0:q1],
                embed[q0:q1], s)
        dx_c = dx_t[r0:r1]
        if screw:
            def heads(trunk, n=n, rays=rays, dx_c=dx_c):
                for l, col in ((7, 0), (8, V_COL)):
                    ops.rowprod(trunk, wt[l], wv[:n, col:col + V_COL],
                                bias=b[l])
                ops.retract_bwd(warp_code, *rays[:3], s, wv[:n],
                                dx_c[:, :3], g_wv[:n], per_row[:n, :3])
                return g_wv[:n]

            _trunk_steps(ops, w[warp], wt[warp], b[warp], w_off[warp],
                         b_off[warp],
                         lambda enc, rays=rays: ops.trunk_encode(
                             None, *rays, scales, enc),
                         heads, stash, bufs, enc_w[:n], scratch, grads)
        else:
            _field_steps(ops, w[warp], wt[warp], b[warp], w_off[warp],
                         b_off[warp], WARP_STASH,
                         lambda enc, rays=rays: ops.field_encode(
                             *rays, WARP_FREQ, enc),
                         stash, bufs, enc_w[:n], dx_c[:, :3], scratch, grads)
        if plane:
            ops.plane_rows(screw, *rays, dx_c,
                           per_row[:n, :3] if screw else None, enc_w[:n],
                           WARP_FREQ, scales, dz_flat[r0:r1], per_row[:n])
            ops.ray_sum(per_row[:n], s, d_ray[q0:q1])
            continue
        _field_steps(ops, w[sheet], wt[sheet], b[sheet], w_off[sheet],
                     b_off[sheet], SHEET_STASH,
                     lambda enc, rays=rays: ops.field_encode(
                         *rays, SHEET_FREQ, enc),
                     stash, bufs, enc_s[:n], dx_c[:, 3:3 + N_HYPER], scratch,
                     grads)
        if screw:
            ops.screw_rows(*rays, per_row[:n, :3], enc_w[:n], scales,
                           enc_s[:n], SHEET_FREQ, dz_flat[r0:r1],
                           per_row[:n])
        else:
            ops.fields_rows(*rays, dx_c, enc_w[:n], WARP_FREQ, enc_s[:n],
                            SHEET_FREQ, dz_flat[r0:r1], per_row[:n])
        ops.ray_sum(per_row[:n], s, d_ray[q0:q1])
    return d_z, d_ray, grads


def se3_bwd_steps(ops, w, wt, b, w_off, b_off, n_grads, x_raw, g,
                  scales=None, max_rows=None):
    """The SE(3) trunk alone backward at float32 (its 9 layers:
    ``layer_views`` of its packed fp32 blobs), chunk by chunk: the trunk's
    steps from raw rows x_raw (P, 11) [points | embedding] (``scales`` the
    window row or None) and g (P, 8) [d w | d v | 0 0]. Returns dx_raw (P,
    11) [the encoding's VJP for the points | the embedding's columns of the
    encoding's cotangent], both times the window row, and the [dW | db]
    buffer."""
    dev, f32 = x_raw.device, torch.float32
    p = x_raw.shape[0]
    plan = fused_mlp.chunk_plan(p, 1, max_rows or chunk_rows(SE3_STASH))
    rows = max(r1 - r0 for r0, r1 in plan)
    stash = torch.empty((rows, SE3_STASH.width), dtype=f32, device=dev)
    bufs = [torch.empty((rows, 128), dtype=f32, device=dev)
            for _ in range(2)]
    enc_g = torch.empty((rows, SE3_ENC), dtype=f32, device=dev)
    scratch = torch.empty((scratch_floats(ops, [t.shape for t in w], rows),),
                          dtype=f32, device=dev)
    grads = torch.zeros((n_grads,), dtype=f32, device=dev)
    dx = torch.empty((p, x_raw.shape[1]), dtype=f32, device=dev)
    for r0, r1 in plan:
        n, x_c = r1 - r0, x_raw[r0:r1]
        _trunk_steps(ops, w, wt, b, w_off, b_off,
                     lambda enc: ops.trunk_encode(x_c, None, None, None,
                                                  None, 0, scales, enc),
                     lambda trunk, g_c=g[r0:r1]: g_c, stash, bufs,
                     enc_g[:n], scratch, grads)
        ops.trunk_posenc_bwd(x_c, scales, enc_g[:n], dx[r0:r1])
    return dx, grads


def field_bwd_steps(ops, w, wt, b, w_off, b_off, n_grads, freq, x_raw, g,
                    max_rows=None, scales=None):
    """A field alone backward at float32 (its 7 layers: ``layer_views`` of
    its packed fp32 blobs; ``freq`` its bands, a key of FIELDS), chunk by
    chunk: kernel B's steps on the one field, from raw rows x_raw (P, 3 + E)
    [points | embedding] (encoded by ``tmpl_encode`` with 0 bands on the
    embedding: its identity; times the window row ``scales``, the field's
    packed encoding columns of fp32, where it is not None) and g (P,
    n_out), the cotangent of the head's outputs. Returns dx_raw (P, 3 + E)
    [the posenc VJP of the points | the embedding's columns of the
    encoding's cotangent], both through the window row, and the [dW | db]
    buffer."""
    dev, f32 = x_raw.device, torch.float32
    p, e = x_raw.shape[0], x_raw.shape[1] - 3
    sp = FIELDS[freq][0]
    plan = fused_mlp.chunk_plan(p, 1, max_rows or chunk_rows(sp))
    rows = max(r1 - r0 for r0, r1 in plan)
    stash = torch.empty((rows, sp.width), dtype=f32, device=dev)
    bufs = [torch.empty((rows, sp.widths['h0']), dtype=f32, device=dev)
            for _ in range(2)]
    enc_g = torch.empty((rows, sp.widths['enc']), dtype=f32, device=dev)
    scratch = torch.empty((scratch_floats(ops, [t.shape for t in w], rows),),
                          dtype=f32, device=dev)
    grads = torch.zeros((n_grads,), dtype=f32, device=dev)
    dx = torch.empty((p, 3 + e), dtype=f32, device=dev)
    for r0, r1 in plan:
        n, x_c = r1 - r0, x_raw[r0:r1]
        _field_steps(ops, w, wt, b, w_off, b_off, sp,
                     lambda enc: ops.tmpl_encode(x_c, freq, e, 0, enc,
                                                 scales=scales),
                     stash, bufs, enc_g[:n], g[r0:r1], scratch, grads)
        ops.tmpl_posenc_bwd(x_c, freq, e, 0, enc_g[:n], dx[r0:r1],
                            scales=scales)
    return dx, grads


def jacobian_bwd_steps(ops, w, wt, b, w_off, b_off, n_grads, x_raw, g,
                       trunk=False, scales=None, max_points=None):
    """A Jacobian's backward at float32, chunk by chunk of points: the
    translation warp's (row 15; the warp field's 7 layers) or, with
    ``trunk``, the SE(3) / quaternion trunk tangents' (row 17; the trunk's
    9 layers), both ``layer_views`` of the packed fp32 blobs. A chunk's n
    points run as their four streams (stream s of point q at stash row
    s n + q: ``stream_encode``, times the window row ``scales`` or None),
    recomputed and walked back from the output's cotangent g, each row
    masked by its point's primal output (``stream_cot`` hands each stream
    its columns of g). J (P, 9) reaches only the tangent rows
    (``_field_steps``: every db zero); [w | v | dw | dv] (P, 24) reaches
    all four streams (``_trunk_steps``: db over the primal rows). The
    encoding's cotangent is pulled back to the points through the window
    row (``stream_enc_bwd``). Returns dx_raw (P, 11) [d points | d embed,
    zero for J] and the [dW | db] buffer."""
    sp, enc_w, walked, cot_w = (
        (SE3_STASH, SE3_ENC, STREAMS, 8) if trunk else
        (WARP_STASH, WARP_STASH.widths['enc'], STREAMS - 1, 4))
    dev, f32 = x_raw.device, torch.float32
    p = x_raw.shape[0]
    plan = fused_mlp.chunk_plan(p, 1,
                                max_points or chunk_rows(sp) // STREAMS)
    n = max(r1 - r0 for r0, r1 in plan) if p else 0
    stash = torch.empty((STREAMS * n, sp.width), dtype=f32, device=dev)
    bufs = [torch.empty((walked * n, 128), dtype=f32, device=dev)
            for _ in range(2)]
    enc_g = torch.empty((walked * n, enc_w), dtype=f32, device=dev)
    cot = torch.empty((walked * n, cot_w), dtype=f32, device=dev)
    scratch = torch.empty(
        (scratch_floats(ops, [t.shape for t in w], walked * n),), dtype=f32,
        device=dev)
    grads = torch.zeros((n_grads,), dtype=f32, device=dev)
    dx = torch.empty((p, x_raw.shape[1]), dtype=f32, device=dev)
    for r0, r1 in plan:
        m, x_c = r1 - r0, x_raw[r0:r1]
        rows = walked * m
        ops.stream_cot(trunk, g[r0:r1], cot[:rows])

        def encode(enc, x_c=x_c):
            ops.stream_encode(trunk, x_c, scales, enc)
        if trunk:
            _trunk_steps(ops, w, wt, b, w_off, b_off, encode,
                         lambda _, c=cot[:rows]: c, stash, bufs,
                         enc_g[:rows], scratch, grads, primal=m)
        else:
            _field_steps(ops, w, wt, b, w_off, b_off, sp, encode, stash,
                         bufs, enc_g[:rows], cot[:rows, :3], scratch, grads,
                         primal=m)
        ops.stream_enc_bwd(trunk, x_c, scales, enc_g[:rows], dx[r0:r1])
    return dx, grads


# ---------------------------------------------------------------------------
# The launches.


def _ptr(t):
    return None if t is None else t.data_ptr()


def _ld(t) -> int:
    """The leading dimension of a 2-d view whose rows are contiguous."""
    if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1):
        raise ValueError(f'want a 2-d view with contiguous rows, got '
                         f'{tuple(t.shape)} strides {t.stride()}')
    return t.stride(0)


class _KernelOps:
    """The steps of ``template_bwd_steps``, ``fields_bwd_steps``,
    ``field_bwd_steps``, ``se3_bwd_steps`` and the Jacobians' backwards as
    launches of csrc/f32_steps.cu (and f32_tangents.cu's stream steps) on
    ``device``'s current stream; made and
    used inside ``torch.cuda.device(device)``. Every operand is a 2-d view
    whose rows are contiguous; its pointer and leading dimension are read
    from the view."""

    def __init__(self, device):
        self.lib = build.library()
        self.stream = torch.cuda.current_stream(device).cuda_stream
        self.sms = torch.cuda.get_device_properties(
            device).multi_processor_count

    def split_count(self, n_out, k, rows):
        return split_count(n_out, k, rows, self.sms)

    def _go(self, name, *args):
        build.check(getattr(self.lib, name)(*args, self.stream), name)

    def rowprod(self, a, w, out, bias=None, relu=False, mask=None,
                accumulate=False, a1=None):
        """out = epi([a | a1] @ w[:K, :N]): w a layer's weight (g W) or
        its transpose (x W^T); row r of out masked by row r % (the mask's
        rows) of ``mask`` (fewer rows than out: they repeat)."""
        k0 = a.shape[1]
        k = k0 + (0 if a1 is None else a1.shape[1])
        self._go('hn_f32_rowprod', a.data_ptr(), _ld(a), k0,
                 _ptr(a1), 0 if a1 is None else _ld(a1), k, w.data_ptr(),
                 _ld(w), out.shape[1], _ptr(bias), int(relu),
                 _ptr(mask), 0 if mask is None else _ld(mask),
                 0 if mask is None else mask.shape[0],
                 out.data_ptr(), _ld(out), int(accumulate), a.shape[0])

    def dw(self, g, h, h1, slab, w_off, ldc, b_off, db_rows=None):
        """A layer's dW (and db, over g's first ``db_rows`` rows: None,
        every row) over row ranges into the rows of ``slab``."""
        k0 = h.shape[1]
        k = k0 + (0 if h1 is None else h1.shape[1])
        self._go('hn_f32_dw', g.data_ptr(), _ld(g), g.shape[1], h.data_ptr(),
                 _ld(h), k0, _ptr(h1), 0 if h1 is None else _ld(h1), k,
                 slab.data_ptr(), slab.shape[1], w_off, ldc, b_off,
                 g.shape[0] if db_rows is None else db_rows, g.shape[0],
                 slab.shape[0])

    def reduce(self, slabs, grads):
        """grads += the (splits, n) view ``slabs`` summed over its rows, in
        order."""
        self._go('hn_f32_reduce', slabs.data_ptr(), slabs.shape[0],
                 _ld(slabs), slabs.shape[1], grads.data_ptr())

    def field_encode(self, z, o, d, emb, samples, freq, out):
        self._go('hn_f32_field_encode', z.data_ptr(), o.data_ptr(),
                 d.data_ptr(), emb.data_ptr(), emb.shape[1], samples, freq,
                 out.data_ptr(), _ld(out), out.shape[1], out.shape[0])

    def tmpl_encode(self, raw, f0, ch1, f1, out, ident1=True, scales=None):
        """[posenc_orig of the xyz (f0 bands) | of the ch1 other columns (f1
        bands; without identity unless ``ident1``: the Nerfies posenc) |
        0] of raw rows, times the window row ``scales`` (fp32, out's
        columns) where it is not None."""
        self._go('hn_f32_tmpl_encode', raw.data_ptr(), _ld(raw), f0, ch1, f1,
                 out.data_ptr(), _ld(out), out.shape[1], out.shape[0],
                 int(ident1), _ptr(scales))

    def cond_rows(self, cond, samples, out):
        self._go('hn_f32_cond_rows', cond.data_ptr(), cond.shape[1], samples,
                 out.data_ptr(), _ld(out), out.shape[1], out.shape[0])

    def tmpl_posenc_bwd(self, raw, f0, ch1, f1, g, dx, ident1=True,
                        scales=None):
        """``tmpl_encode``'s VJP: the encoding's cotangent ``g`` times the
        window row where there is one, then each segment's posenc VJP."""
        self._go('hn_f32_tmpl_posenc_bwd', raw.data_ptr(), _ld(raw), f0, ch1,
                 f1, g.data_ptr(), _ld(g), dx.data_ptr(), _ld(dx),
                 raw.shape[0], int(ident1), _ptr(scales))

    def alpha_cond_bwd(self, g, alpha, aw, samples, d_alpha, slabs):
        """The alpha condition's step: d_alpha (R, Ca) = the per-ray sum of
        ``g`` (P, 1, the raw sigma's cotangent) times the alpha head's
        condition weights ``aw``; each ray range's part of those weights'
        dW into a row of ``slabs`` (splits, Ca)."""
        self._go('hn_f32_alpha_cond_bwd', g.data_ptr(), _ld(g),
                 alpha.data_ptr(), aw.data_ptr(), aw.shape[0], samples,
                 d_alpha.data_ptr(), slabs.data_ptr(), _ld(slabs),
                 alpha.shape[0], slabs.shape[0])

    def fields_rows(self, z, o, d, emb, samples, dxt, gw, f0, gs, f1, dz,
                    rows):
        self._go('hn_f32_fields_rows', z.data_ptr(), o.data_ptr(),
                 d.data_ptr(), samples, dxt.data_ptr(), _ld(dxt),
                 gw.data_ptr(), _ld(gw), f0, gs.data_ptr(), _ld(gs), f1,
                 emb.shape[1], dz.data_ptr(), rows.data_ptr(), z.shape[0])

    def ray_sum(self, x, samples, out):
        self._go('hn_f32_ray_sum', x.data_ptr(), _ld(x), x.shape[1], samples,
                 out.data_ptr(), out.shape[0])

    def trunk_encode(self, x, z, o, d, emb, samples, scales, out):
        """The trunk's encoding of raw rows ``x`` or, with ``z``, of the
        rays' samples (``x`` None)."""
        e = x.shape[1] - 3 if z is None else emb.shape[1]
        self._go('hn_f32_trunk_encode', _ptr(x), 0 if x is None else _ld(x),
                 _ptr(z), _ptr(o), _ptr(d), _ptr(emb), e, samples,
                 _ptr(scales), out.data_ptr(), _ld(out), out.shape[0])

    def trunk_posenc_bwd(self, x, scales, g, dx):
        self._go('hn_f32_trunk_posenc_bwd', x.data_ptr(), _ld(x),
                 _ptr(scales), g.data_ptr(), _ld(g), dx.data_ptr(), _ld(dx),
                 x.shape[0])

    def retract_bwd(self, code, z, o, d, samples, wv, dxt, g_wv, dp):
        """Warp code 1 (SE(3)) or 2 (quaternion)."""
        self._go('hn_f32_retract_bwd', int(code == 2), z.data_ptr(),
                 o.data_ptr(), d.data_ptr(), samples, wv.data_ptr(), _ld(wv),
                 dxt.data_ptr(), _ld(dxt), g_wv.data_ptr(), _ld(g_wv),
                 dp.data_ptr(), _ld(dp), z.shape[0])

    def screw_rows(self, z, o, d, emb, samples, dpd, gt, scales, gs, f1, dz,
                   rows):
        self._go('hn_f32_screw_rows', z.data_ptr(), o.data_ptr(),
                 d.data_ptr(), samples, dpd.data_ptr(), _ld(dpd),
                 gt.data_ptr(), _ld(gt), _ptr(scales), gs.data_ptr(), _ld(gs),
                 f1, emb.shape[1], dz.data_ptr(), rows.data_ptr(), z.shape[0])

    def stream_encode(self, trunk, x, scales, out):
        """The four streams' encoding of raw rows ``x`` (n, 11) into
        ``out``'s 4 n rows, the warp field's or (``trunk``) the trunk's,
        times the window row ``scales`` or None."""
        self._go('hn_f32_stream_encode', int(trunk), x.data_ptr(), _ld(x),
                 _ptr(scales), out.data_ptr(), _ld(out), out.shape[1],
                 x.shape[0])

    def stream_cot(self, trunk, g, out):
        """J's (n, 9) or, with ``trunk``, [w | v | dw | dv]'s (n, 24)
        cotangent ``g`` as the rows of its streams (3 n or 4 n)."""
        self._go('hn_f32_stream_cot', int(trunk), g.data_ptr(), _ld(g),
                 out.data_ptr(), _ld(out), g.shape[0])

    def stream_enc_bwd(self, trunk, x, scales, g, dx):
        """dx (n, 11) of raw rows ``x`` from the streams' encoding
        cotangent ``g`` (the trunk's 4 n rows, the warp field's 3 n tangent
        rows)."""
        self._go('hn_f32_stream_enc_bwd', int(trunk), x.data_ptr(), _ld(x),
                 _ptr(scales), g.data_ptr(), _ld(g), dx.data_ptr(), _ld(dx),
                 x.shape[0])

    def plane_rows(self, screw, z, o, d, emb, samples, dxt, dpd, g, f0,
                   scales, dz, rows):
        """A plane table's rows: the translation warp's (``dpd`` None) or
        the trunk's (``dpd`` the retraction's direct term, ``scales`` its
        window row or None) encoding cotangent ``g``, with d hyper from
        ``dxt``."""
        self._go('hn_f32_plane_rows', int(screw), z.data_ptr(),
                 o.data_ptr(), d.data_ptr(), samples, dxt.data_ptr(),
                 _ld(dxt), _ptr(dpd), 0 if dpd is None else _ld(dpd),
                 g.data_ptr(), _ld(g), f0, _ptr(scales), emb.shape[1],
                 dz.data_ptr(), rows.data_ptr(), z.shape[0])


def kernel_layout(warp: str = 'translation'):
    """[(n_pad, k_pad)] of the compiled float32 table ``warp`` (a key of
    ``common.TABLE_CODES``) in layer order (``hn_f32_table_layout``): the
    flagship table; with the SE(3) / quaternion warp the trunk's rows,
    then the flagship table's from the sheet on; a plane table's warp,
    then its template's 16 (the first layer and the skip at 192 and 448
    columns in the posenc_orig plane layout)."""
    import ctypes
    n = (ctypes.c_int * 64)()
    k = (ctypes.c_int * 64)()
    count = build.library().hn_f32_table_layout(
        common.TABLE_CODES[warp], ctypes.addressof(n), ctypes.addressof(k),
        64)
    return [(n[i], k[i]) for i in range(count)]


def check_layout(shapes, table: slice = slice(None),
                 warp: str = 'translation') -> None:
    """Raise unless packed ``shapes`` are rows ``table`` of the compiled
    float32 table ``warp`` (a key of ``common.TABLE_CODES``; all of it: a
    level; ``common.TEMPLATE_LAYERS``: a template alone, with or without
    hyper coordinates, whose encoding packs to the same 128 columns, or
    ``common.PLANE_TEMPLATE_LAYERS`` of a plane table: a template of its
    layout; ``common.WARP_LAYERS`` / ``SHEET_LAYERS``: a field alone;
    ``common.SE3_LAYERS`` of the 'se3' table: the trunk alone)."""
    if list(shapes) != kernel_layout(warp)[table]:
        raise NotImplementedError(f'{common.NOT_COVERED}; layer shapes '
                                  f'{shapes}')


def fused_level_f32(wt_blob, b_blob, z_vals, origins, directions, embed,
                    cond, want_raw_t: bool, code: int = 0, scales=None,
                    tmpl_scales=None, alpha=None):
    """Launch the float32 level forward (csrc/f32_level.cu) on the packed
    fp32 blobs of the level's table (table code ``code``: 0 the
    translation warp's, 1 and 2 the SE(3) / quaternion warp's, with the
    trunk's window row ``scales`` or None; 3 to 8 the plane tables'), its
    weights transposed layer by layer: (out (R * S, 4), raw_t (R * S, 8),
    (R * S, 16) in a plane table, or None). ``tmpl_scales``: the
    template's window row (128 fp32: the Nerfies layouts) or None;
    ``alpha``: (the alpha condition (R, 8), its weights in the alpha head
    (8,)) fp32, or None. The inputs are checked by the caller (fp32,
    contiguous)."""
    dev = z_vals.device
    r, s = z_vals.shape
    out = torch.empty((r * s, 4), dtype=torch.float32, device=dev)
    raw = (common.PLANE_RAW_PAD if code >= len(common.WARP_CODES)
           else common.RAW_PAD)
    raw_t = torch.empty((r * s, raw), dtype=torch.float32,
                        device=dev) if want_raw_t else None
    common.launch('hn_f32_level_fwd', dev, z_vals.data_ptr(),
                  origins.data_ptr(), directions.data_ptr(),
                  embed.data_ptr(), cond.data_ptr(), cond.shape[1],
                  wt_blob.data_ptr(), b_blob.data_ptr(), code, _ptr(scales),
                  _ptr(tmpl_scales), *_alpha_ptrs(alpha), out.data_ptr(),
                  _ptr(raw_t), r, s)
    fused_level_f32.launches += 1
    return out, raw_t


fused_level_f32.launches = 0


def _alpha_ptrs(alpha):
    """The alpha condition's two pointers, or two nulls."""
    return (None, None) if alpha is None else (alpha[0].data_ptr(),
                                               alpha[1].data_ptr())


def fused_template_f32(wt_blob, b_blob, x_raw, hyper: int, cond,
                       samples: int, scales=None, alpha=None):
    """Launch the float32 template alone (csrc/f32_level.cu, the level
    forward's template stage) on the template's packed fp32 blobs, its
    weights transposed layer by layer: (P, 4) [rgb logits | raw sigma].
    x_raw (P, 8) [xyz | hyper | 0] with ``hyper`` hyper coordinates (4 or
    0; the plane layouts' 8 in (P, 16) rows), cond (P / samples, C);
    ``scales`` and ``alpha`` as ``fused_level_f32`` takes ``tmpl_scales``
    and ``alpha``. The inputs are checked by the caller (fp32,
    contiguous)."""
    dev, p = x_raw.device, x_raw.shape[0]
    out = torch.empty((p, 4), dtype=torch.float32, device=dev)
    common.launch('hn_f32_template_fwd', dev, x_raw.data_ptr(), _ld(x_raw),
                  hyper, cond.data_ptr(), cond.shape[1], _ptr(scales),
                  *_alpha_ptrs(alpha), wt_blob.data_ptr(), b_blob.data_ptr(),
                  out.data_ptr(), p, samples)
    fused_template_f32.launches += 1
    return out


fused_template_f32.launches = 0


def fused_field_f32(freq: int, wt_blob, b_blob, x_raw, scales=None):
    """Launch the float32 field alone (csrc/f32_level.cu, the level
    forward's field stage) of ``freq`` bands (a key of FIELDS) on the
    field's packed fp32 blobs, its weights transposed layer by layer: (P,
    8) [the head's outputs | 0]. x_raw (P, 11) [points | embedding] and the
    window row ``scales`` (the packed encoding's columns of fp32) or None,
    checked by the caller."""
    dev, p = x_raw.device, x_raw.shape[0]
    out = torch.empty((p, 8), dtype=torch.float32, device=dev)
    if p:
        common.launch('hn_f32_field_fwd', dev, FIELDS[freq][2],
                      x_raw.data_ptr(), _ptr(scales), wt_blob.data_ptr(),
                      b_blob.data_ptr(), out.data_ptr(), p)
        fused_field_f32.launches += 1
    return out


fused_field_f32.launches = 0


def fused_field_bwd_f32(w_blob, wt_blob, b_blob, shapes, freq: int, x_raw,
                        g, scales=None):
    """Launch a field alone backward at float32 (``field_bwd_steps``) on
    the field's packed fp32 blobs: (dx_raw (P, 11), [dW | db]). g (P,
    n_out) the cotangent of the head's outputs, ``scales`` the window row
    or None."""
    dev = x_raw.device
    w, wt, b, w_off, b_off, n_grads = fused_mlp.layer_views(
        w_blob, wt_blob, b_blob, shapes)
    with torch.cuda.device(dev):
        ops = _KernelOps(dev)
        res = field_bwd_steps(ops, w, wt, b, w_off, b_off, n_grads, freq,
                              x_raw, g, scales=scales)
    fused_field_bwd_f32.launches += 1
    return res


fused_field_bwd_f32.launches = 0


def fused_se3_f32(wt_blob, b_blob, x_raw, scales):
    """Launch the float32 SE(3) trunk alone (csrc/f32_level.cu, the level
    forward's trunk stage) on the trunk's packed fp32 blobs, its weights
    transposed layer by layer: (P, 8) [w | v | 0 0]. x_raw (P, 11) [points
    | embedding] and the window row ``scales`` (64 fp32) or None, checked by
    the caller."""
    dev, p = x_raw.device, x_raw.shape[0]
    out = torch.empty((p, 8), dtype=torch.float32, device=dev)
    if p:
        common.launch('hn_f32_trunk_fwd', dev, x_raw.data_ptr(),
                      _ptr(scales), wt_blob.data_ptr(), b_blob.data_ptr(),
                      out.data_ptr(), p)
        fused_se3_f32.launches += 1
    return out


fused_se3_f32.launches = 0


def fused_se3_bwd_f32(w_blob, wt_blob, b_blob, shapes, x_raw, g, scales):
    """Launch the SE(3) trunk alone backward at float32 (``se3_bwd_steps``)
    on the trunk's packed fp32 blobs: (dx_raw (P, 11), [dW | db]). g (P, 8)
    [d w | d v | 0 0]."""
    dev = x_raw.device
    w, wt, b, w_off, b_off, n_grads = fused_mlp.layer_views(
        w_blob, wt_blob, b_blob, shapes)
    with torch.cuda.device(dev):
        ops = _KernelOps(dev)
        res = se3_bwd_steps(ops, w, wt, b, w_off, b_off, n_grads, x_raw, g,
                            scales)
    fused_se3_bwd_f32.launches += 1
    return res


fused_se3_bwd_f32.launches = 0


def fused_template_bwd_f32(w_blob, wt_blob, b_blob, shapes, raw_t, cond,
                           samples, g, hyper: int = N_HYPER, scales=None,
                           alpha=None):
    """Launch kernel A at float32 (``template_bwd_steps``, with the window
    row ``scales`` and the alpha condition ``alpha`` as it takes them) on
    the template's packed fp32 blobs: (dx_t, d cond, [dW | db (| the alpha
    condition's dW)], d alpha_cond or None)."""
    dev = raw_t.device
    w, wt, b, w_off, b_off, n_grads = fused_mlp.layer_views(
        w_blob, wt_blob, b_blob, shapes)
    if alpha is not None:
        n_grads += fused_mlp.ALPHA_TAIL
    with torch.cuda.device(dev):
        ops = _KernelOps(dev)
        res = template_bwd_steps(ops, w, wt, b, w_off, b_off, n_grads, raw_t,
                                 cond, samples, g, hyper=hyper, scales=scales,
                                 alpha=alpha)
    fused_template_bwd_f32.launches += 1
    return res


fused_template_bwd_f32.launches = 0


def fused_fields_bwd_f32(w_blob, wt_blob, b_blob, shapes, z_vals, origins,
                         directions, embed, dx_t, code: int = 0,
                         scales=None):
    """Launch kernel B at float32 (``fields_bwd_steps``) on the field
    layers' views of the level's packed fp32 blobs (``shapes``: layers
    0..13, or with table code 1 or 2 the trunk's and the sheet's, 0..15;
    ``scales`` the trunk's window row or None; a plane table's warp alone,
    0..6 or 0..8): (d z_vals, d_ray (R, 14), [dW | db])."""
    dev = z_vals.device
    w, wt, b, w_off, b_off, n_grads = fused_mlp.layer_views(
        w_blob, wt_blob, b_blob, shapes)
    with torch.cuda.device(dev):
        ops = _KernelOps(dev)
        res = fields_bwd_steps(ops, w, wt, b, w_off, b_off, n_grads, z_vals,
                               origins, directions, embed, dx_t, code=code,
                               scales=scales)
    fused_fields_bwd_f32.launches += 1
    return res


fused_fields_bwd_f32.launches = 0


def fused_jacobian_f32(wt_blob, b_blob, x_raw):
    """Launch the float32 translation Jacobian's forward (row 14,
    csrc/f32_tangents.cu) on the warp field's packed fp32 blobs, its
    weights transposed layer by layer: (P, 9) J. x_raw (P, 11) [points |
    embedding], checked by the caller."""
    dev, p = x_raw.device, x_raw.shape[0]
    out = torch.empty((p, 9), dtype=torch.float32, device=dev)
    if p:
        common.launch('hn_f32_jacobian_fwd', dev, x_raw.data_ptr(),
                      wt_blob.data_ptr(), b_blob.data_ptr(), out.data_ptr(),
                      p)
        fused_jacobian_f32.launches += 1
    return out


fused_jacobian_f32.launches = 0


def fused_jacobian_bwd_f32(w_blob, wt_blob, b_blob, shapes, x_raw, g):
    """Launch the translation Jacobian's backward at float32 (row 15,
    ``jacobian_bwd_steps``) on the warp field's packed fp32 blobs: (dx_raw
    (P, 11), [dW | db]). g (P, 9) J's cotangent."""
    dev = x_raw.device
    w, wt, b, w_off, b_off, n_grads = fused_mlp.layer_views(
        w_blob, wt_blob, b_blob, shapes)
    with torch.cuda.device(dev):
        ops = _KernelOps(dev)
        res = jacobian_bwd_steps(ops, w, wt, b, w_off, b_off, n_grads, x_raw,
                                 g)
    fused_jacobian_bwd_f32.launches += 1
    return res


fused_jacobian_bwd_f32.launches = 0


def fused_se3_jacobian_f32(wt_blob, b_blob, x_raw, scales):
    """Launch the float32 trunk tangents' forward (row 16,
    csrc/f32_tangents.cu) on the trunk's packed fp32 blobs, its weights
    transposed layer by layer: (P, 24) [w | v | dw | dv]. x_raw (P, 11) and
    the window row ``scales`` (64 fp32) or None, checked by the caller."""
    dev, p = x_raw.device, x_raw.shape[0]
    out = torch.empty((p, 24), dtype=torch.float32, device=dev)
    if p:
        common.launch('hn_f32_se3_jacobian_fwd', dev, x_raw.data_ptr(),
                      _ptr(scales), wt_blob.data_ptr(), b_blob.data_ptr(),
                      out.data_ptr(), p)
        fused_se3_jacobian_f32.launches += 1
    return out


fused_se3_jacobian_f32.launches = 0


def fused_se3_jacobian_bwd_f32(w_blob, wt_blob, b_blob, shapes, x_raw, g,
                               scales):
    """Launch the trunk tangents' backward at float32 (row 17,
    ``jacobian_bwd_steps``) on the trunk's packed fp32 blobs: (dx_raw
    (P, 11), [dW | db]). g (P, 24) the cotangent of [w | v | dw | dv]."""
    dev = x_raw.device
    w, wt, b, w_off, b_off, n_grads = fused_mlp.layer_views(
        w_blob, wt_blob, b_blob, shapes)
    with torch.cuda.device(dev):
        ops = _KernelOps(dev)
        res = jacobian_bwd_steps(ops, w, wt, b, w_off, b_off, n_grads,
                                 x_raw, g, trunk=True, scales=scales)
    fused_se3_jacobian_bwd_f32.launches += 1
    return res


fused_se3_jacobian_bwd_f32.launches = 0
