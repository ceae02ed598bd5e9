"""The float32 kernels, hand-written CUDA on FFMA (``csrc/f32_chain.cuh``,
``f32_level.cu``, ``f32_steps.cu``): the level forward (row 1 at
``compute_dtype='float32'``) and the two halves of its backward, kernel A
(the template backward, row 9) and kernel B (the fields backward, row 5);
and the per-module path's: the template alone (row 8), a field alone (row
10) and a field alone backward (row 11). The bf16 kernels are untouched:
``fused_level``, ``fused_fields_bwd``, ``fused_template_bwd``,
``fused_template``, ``fused_field`` and ``fused_field_bwd`` take these
where the modules compute in float32, at the flagship table's widths: the
translation warp and the bendy sheet (a field alone: either), the
posenc_orig template with 4 hyper coordinates or none (static), a 39-column
rgb condition, no alpha condition and no window row.
``fused_level._check_covered`` and ``fused_mlp.check_f32_covered`` refuse
the rest, naming ROADMAP A.13.1's sub-item (the screw warps, the plane and
Nerfies layouts, the conditions' widths, the Jacobians).

Float32 is the TPU kernels' float32: fp32 operands, fp32 sums, fp32
epilogues, nothing rounded to bf16 — the plain versions' arithmetic at that
dtype (``fused_level_plain``, ``fused_template_bwd_plain``,
``fused_fields_bwd_plain``), which the CPU tests hold to the JAX kernels.

The level forward is one kernel (a tile of 64 samples through all 30 layers
in shared memory); the template alone and a field alone are its stages, run
alone on raw rows. Kernels A and B and a field alone backward are sequences
of generic steps over chunks of whole rays (``template_bwd_steps``,
``fields_bwd_steps``, ``field_bwd_steps``): each
wide layer's fp32 output is recomputed into a stash (at most
``STASH_BYTES`` a chunk), then the chunk is walked back a layer at a time —
the cotangent through the layer (``rowprod``, masked by the input's ReLU)
and the layer's dW / db over row ranges (``dw``, one slab per range, as
many ranges as fill the card twice: ``split_count``; summed into the
layer's gradient in a fixed order by ``reduce``). ``ops`` launches the
steps: ``_KernelOps`` on the card; the tests pass a PyTorch model of each C
entry point.

Every wrapper adds one to its ``launches`` where it launches its kernel (a
call of kernel A or B or of a field alone backward, whatever its steps).
"""

from __future__ import annotations

import torch

from hypernerf_tpu_torch.kernels import build, common, fused_mlp

# The flagship's encodings: warp field and sheet bands, the template's xyz
# and hyper bands and hyper coordinates.
WARP_FREQ, SHEET_FREQ, XYZ_FREQ, HYPER_FREQ = 10, 7, 10, 6
N_HYPER = 4
COND_PAD = common.COND_PAD
# csrc/f32_chain.cuh and f32_level.cu: the level forward's tile of
# TILE_ROWS rows, in passes of up to WIDE_COLS columns (the Wide tile) with
# a double-buffered weight tile of DEPTH x WIDE_COLS; its shared memory: X
# (128 features), H0 and H1 (256), that weight tile, per-row scratch (3 + 8
# + 8 + 1 floats) and the rows' ray indices, of 64 rows each, 4 bytes a
# value. The steps' Step tile: STEP_ROWS x STEP_COLS a block.
THREADS, TILE_ROWS, WIDE_COLS, DEPTH = 256, 64, 256, 16
STEP_ROWS = STEP_COLS = 128
LEVEL_SMEM_BYTES = 4 * (TILE_ROWS * (128 + 2 * 256 + 3 + 8 + 8 + 1 + 1)
                        + 2 * DEPTH * WIDE_COLS)
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


def template_enc(hyper: int) -> int:
    """Stash columns of the template's encoding with ``hyper`` hyper
    coordinates: 128 for the flagship's 4 (115 encoded), 64 for none (63)."""
    return common.pad16(3 * (1 + 2 * XYZ_FREQ) + hyper * (1 + 2 * HYPER_FREQ))


def template_stash(hyper: int = N_HYPER) -> fused_mlp.Stash:
    """Kernel A's stash: the bf16 kernel A's columns with the encoding's
    ``template_enc(hyper)``, the rgb condition (padded to 48) after the
    bottleneck's 128, one fp32 row per sample; its wide layers are the bf16
    kernel A's, layer 11 reading [bottleneck | condition] from the stash.
    A template without hyper coordinates stashes 64 encoding columns: its
    first and skip layers' products run on those, their packed weights'
    other columns unread, and their dW there zero."""
    return fused_mlp.stash_plan(enc=template_enc(hyper), cond=COND_PAD)


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
    ``bufs[at]``)."""

    def __init__(self, ops, w, w_off, b_off, scratch, grads, bufs):
        self.ops, self.w, self.w_off, self.b_off = ops, w, w_off, b_off
        self.scratch, self.grads, self.bufs, self.at = scratch, grads, bufs, 0

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
        self.ops.dw(g, h, h1, slabs, 0, ldc, size)
        w_at, b_at = self.w_off[l], self.b_off[l]
        self.ops.reduce(slabs[:, :size], self.grads[w_at:w_at + size])
        self.ops.reduce(slabs[:, size:], self.grads[b_at:b_at + n_out])

    def head(self, g, l, h):
        """A linear head ``l`` on ReLU output ``h`` with output cotangent
        ``g``: its dW / db, and h's cotangent, masked, into bufs[0]."""
        self._dw(g, l, h)
        self.at = 0
        y = self.bufs[0][:, :h.shape[1]]
        self.ops.rowprod(g, self.w[l], y, mask=h)
        return y

    def layer(self, x, l, h, h1=None, enc_g=None, relu_in=True):
        """Layer ``l`` on [h | h1] with output cotangent ``x``: its dW / db;
        h's cotangent (masked by h's ReLU where ``relu_in``) into the other
        buffer, which is returned; h1's (the skip's encoding) into
        ``enc_g``."""
        self._dw(x, l, h, h1)
        self.at ^= 1
        y = self.bufs[self.at][:, :h.shape[1]]
        self.ops.rowprod(x, self.w[l], y, mask=h if relu_in else None)
        if h1 is not None:
            k = h.shape[1]
            self.ops.rowprod(x, self.w[l][:, k:k + h1.shape[1]], enc_g)
        return y

    def first(self, x, l, enc, enc_g):
        """The first layer on the encoding: its dW / db, and its part of
        the encoding's cotangent added into ``enc_g``."""
        self._dw(x, l, enc)
        self.ops.rowprod(x, self.w[l], enc_g, accumulate=True)


def _recompute(ops, wt, b, cols, layers):
    """The forward of the wide ``layers`` into the stash: x wt[l], wt the
    layers' transposes."""
    for l, ins, out, relu in layers:
        a1 = cols(ins[1]) if len(ins) > 1 else None
        k0 = wt[l].shape[0] - (0 if a1 is None else a1.shape[1])
        ops.rowprod(cols(ins[0])[:, :k0], wt[l],
                    cols(out)[:, :wt[l].shape[1]], bias=b[l], relu=relu,
                    a1=a1)


def template_bwd_steps(ops, w, wt, b, w_off, b_off, n_grads, raw_t, cond,
                       samples, g, max_rows=None, hyper=N_HYPER):
    """Kernel A at float32 (the template's 16 layers: ``layer_views``
    of its packed fp32 blobs), chunk by chunk. raw_t (P, 8) [warped | hyper
    | 0] with ``hyper`` hyper coordinates (4, or 0: static), cond (R, C) the
    rgb condition, g (P, 4) the output's cotangent. Returns dx_t (P, 8)
    (zero past the hyper coordinates), d cond (R, C) and the [dW | db]
    buffer. dx_t is computed whether or not the caller reads it (a static
    template's points take no gradient)."""
    dev, f32 = raw_t.device, torch.float32
    p, s = raw_t.shape[0], samples
    sp = template_stash(hyper)
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
    bw = w[9].shape[0]  # the bottleneck's width
    for r0, r1 in plan:
        n, q0, q1 = r1 - r0, r0 // s, r1 // s

        def cols(name, n=n):
            return stash[:n, sp.col[name]:sp.col[name] + sp.widths[name]]

        raw_c, g_c = raw_t[r0:r1], g[r0:r1]
        ops.tmpl_encode(raw_c, XYZ_FREQ, hyper, HYPER_FREQ, cols('enc'))
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
        ops.tmpl_posenc_bwd(raw_c, XYZ_FREQ, hyper, HYPER_FREQ, enc_g[:n],
                            dx_t[r0:r1])
    return dx_t, d_cond, grads


def _field_steps(ops, w, wt, b, w_off, b_off, sp, encode, stash, bufs,
                 enc_g, g, scratch, grads):
    """One field (its 7 layers: ``layer_views``) on a chunk: encode (the
    step ``encode(out)``) and recompute into ``stash`` (plan ``sp``), then
    walk back from ``g``, the cotangent of its head's output, to the
    encoding's cotangent (``enc_g``)."""
    n = g.shape[0]

    def cols(name):
        return stash[:n, sp.col[name]:sp.col[name] + sp.widths[name]]

    encode(cols('enc'))
    _recompute(ops, wt, b, cols, FIELD_LAYERS)
    walk = _Walk(ops, w, w_off, b_off, scratch, grads, [t[:n] for t in bufs])
    x = walk.head(g, 6, cols('h5'))
    x = walk.layer(x, 5, cols('h4'), cols('enc'), enc_g)
    for l, name in ((4, 'h3'), (3, 'h2'), (2, 'h1'), (1, 'h0')):
        x = walk.layer(x, l, cols(name))
    walk.first(x, 0, cols('enc'), enc_g)


def fields_bwd_steps(ops, w, wt, b, w_off, b_off, n_grads, z_vals, origins,
                     directions, embed, dx_t, max_rows=None):
    """Kernel B at float32 (the warp field's layers 0..6 and the sheet's
    7..13: ``layer_views`` of the level's packed fp32 blobs), chunk by
    chunk: each field recomputed and walked back in one stash, then the
    rows' point and embedding cotangents and their per-ray sums. Returns
    d z_vals (R, S), d_ray (R, 14) [d origins | d directions | d embed] and
    the [dW | db] buffer."""
    dev, f32 = z_vals.device, torch.float32
    r, s = z_vals.shape
    p, e = r * s, embed.shape[1]
    plan = fused_mlp.chunk_plan(p, s, max_rows or chunk_rows(WARP_STASH))
    rows = max(r1 - r0 for r0, r1 in plan)
    stash = torch.empty((rows, WARP_STASH.width), dtype=f32, device=dev)
    bufs = [torch.empty((rows, 128), dtype=f32, device=dev)
            for _ in range(2)]
    enc_w = torch.empty((rows, WARP_STASH.widths['enc']), dtype=f32,
                        device=dev)
    enc_s = torch.empty((rows, SHEET_STASH.widths['enc']), dtype=f32,
                        device=dev)
    per_row = torch.empty((rows, 6 + e), dtype=f32, device=dev)
    scratch = torch.empty((scratch_floats(ops, [t.shape for t in w], rows),),
                          dtype=f32, device=dev)
    grads = torch.zeros((n_grads,), dtype=f32, device=dev)
    d_z = torch.empty((r, s), dtype=f32, device=dev)
    d_ray = torch.empty((r, 6 + e), dtype=f32, device=dev)
    z_flat, dz_flat = z_vals.reshape(-1), d_z.view(-1)
    warp, sheet = slice(0, 7), slice(7, 14)
    for r0, r1 in plan:
        n, q0, q1 = r1 - r0, r0 // s, r1 // s
        rays = (z_flat[r0:r1], origins[q0:q1], directions[q0:q1],
                embed[q0:q1], s)
        dx_c = dx_t[r0:r1]
        for part, sp, freq, out, enc_g in (
                (warp, WARP_STASH, WARP_FREQ, dx_c[:, :3], enc_w),
                (sheet, SHEET_STASH, SHEET_FREQ, dx_c[:, 3:3 + N_HYPER],
                 enc_s)):
            _field_steps(ops, w[part], wt[part], b[part], w_off[part],
                         b_off[part], sp,
                         lambda enc, freq=freq: ops.field_encode(*rays, freq,
                                                                 enc),
                         stash, bufs, enc_g[:n], out, scratch, grads)
        ops.fields_rows(*rays, dx_c, enc_w[:n], WARP_FREQ, enc_s[:n],
                        SHEET_FREQ, dz_flat[r0:r1], per_row[:n])
        ops.ray_sum(per_row[:n], s, d_ray[q0:q1])
    return d_z, d_ray, grads


def field_bwd_steps(ops, w, wt, b, w_off, b_off, n_grads, freq, x_raw, g,
                    max_rows=None):
    """A field alone backward at float32 (its 7 layers: ``layer_views`` of
    its packed fp32 blobs; ``freq`` its bands, a key of FIELDS), chunk by
    chunk: kernel B's steps on the one field, from raw rows x_raw (P, 3 + E)
    [points | embedding] (encoded by ``tmpl_encode`` with 0 bands on the
    embedding: its identity) and g (P, n_out), the cotangent of the head's
    outputs. Returns dx_raw (P, 3 + E) [the posenc VJP of the points | the
    embedding's columns of the encoding's cotangent] and the [dW | db]
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
                     lambda enc: ops.tmpl_encode(x_c, freq, e, 0, enc),
                     stash, bufs, enc_g[:n], g[r0:r1], scratch, grads)
        ops.tmpl_posenc_bwd(x_c, freq, e, 0, enc_g[:n], dx[r0:r1])
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
    """The steps of ``template_bwd_steps`` / ``fields_bwd_steps`` as
    launches of csrc/f32_steps.cu on ``device``'s current stream; made and
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
        its transpose (x W^T)."""
        k0 = a.shape[1]
        k = k0 + (0 if a1 is None else a1.shape[1])
        self._go('hn_f32_rowprod', a.data_ptr(), _ld(a), k0,
                 _ptr(a1), 0 if a1 is None else _ld(a1), k, w.data_ptr(),
                 _ld(w), out.shape[1], _ptr(bias), int(relu),
                 _ptr(mask), 0 if mask is None else _ld(mask),
                 out.data_ptr(), _ld(out), int(accumulate), a.shape[0])

    def dw(self, g, h, h1, slab, w_off, ldc, b_off):
        k0 = h.shape[1]
        k = k0 + (0 if h1 is None else h1.shape[1])
        self._go('hn_f32_dw', g.data_ptr(), _ld(g), g.shape[1], h.data_ptr(),
                 _ld(h), k0, _ptr(h1), 0 if h1 is None else _ld(h1), k,
                 slab.data_ptr(), slab.shape[1], w_off, ldc, b_off,
                 g.shape[0], slab.shape[0])

    def reduce(self, slabs, grads):
        """grads += the (splits, n) view ``slabs`` summed over its rows, in
        order."""
        self._go('hn_f32_reduce', slabs.data_ptr(), slabs.shape[0],
                 _ld(slabs), slabs.shape[1], grads.data_ptr())

    def field_encode(self, z, o, d, emb, samples, freq, out):
        self._go('hn_f32_field_encode', z.data_ptr(), o.data_ptr(),
                 d.data_ptr(), emb.data_ptr(), emb.shape[1], samples, freq,
                 out.data_ptr(), _ld(out), out.shape[1], out.shape[0])

    def tmpl_encode(self, raw, f0, ch1, f1, out):
        self._go('hn_f32_tmpl_encode', raw.data_ptr(), _ld(raw), f0, ch1, f1,
                 out.data_ptr(), _ld(out), out.shape[1], out.shape[0])

    def cond_rows(self, cond, samples, out):
        self._go('hn_f32_cond_rows', cond.data_ptr(), cond.shape[1], samples,
                 out.data_ptr(), _ld(out), out.shape[1], out.shape[0])

    def tmpl_posenc_bwd(self, raw, f0, ch1, f1, g, dx):
        self._go('hn_f32_tmpl_posenc_bwd', raw.data_ptr(), _ld(raw), f0, ch1,
                 f1, g.data_ptr(), _ld(g), dx.data_ptr(), _ld(dx),
                 raw.shape[0])

    def fields_rows(self, z, o, d, emb, samples, dxt, gw, f0, gs, f1, dz,
                    rows):
        self._go('hn_f32_fields_rows', z.data_ptr(), o.data_ptr(),
                 d.data_ptr(), samples, dxt.data_ptr(), _ld(dxt),
                 gw.data_ptr(), _ld(gw), f0, gs.data_ptr(), _ld(gs), f1,
                 emb.shape[1], dz.data_ptr(), rows.data_ptr(), z.shape[0])

    def ray_sum(self, x, samples, out):
        self._go('hn_f32_ray_sum', x.data_ptr(), _ld(x), x.shape[1], samples,
                 out.data_ptr(), out.shape[0])


def kernel_layout():
    """[(n_pad, k_pad)] of the compiled float32 table, in layer order."""
    import ctypes
    n = (ctypes.c_int * 64)()
    k = (ctypes.c_int * 64)()
    count = build.library().hn_f32_level_layout(ctypes.addressof(n),
                                                ctypes.addressof(k), 64)
    return [(n[i], k[i]) for i in range(count)]


def check_layout(shapes, table: slice = slice(None)) -> None:
    """Raise unless packed ``shapes`` are rows ``table`` of the compiled
    float32 table (all of it: a level; ``common.TEMPLATE_LAYERS``: a
    template alone, with or without hyper coordinates, whose encoding packs
    to the same 128 columns; ``common.WARP_LAYERS`` / ``SHEET_LAYERS``: a
    field alone)."""
    if list(shapes) != kernel_layout()[table]:
        raise NotImplementedError(f'{common.NOT_COVERED}; layer shapes '
                                  f'{shapes}')


def fused_level_f32(wt_blob, b_blob, z_vals, origins, directions, embed,
                    cond, want_raw_t: bool):
    """Launch the float32 level forward (csrc/f32_level.cu) on the packed
    fp32 blobs of the flagship table, its weights transposed layer by layer:
    (out (R * S, 4), raw_t (R * S, 8) or None). The inputs are checked by
    the caller (fp32, contiguous)."""
    dev = z_vals.device
    r, s = z_vals.shape
    out = torch.empty((r * s, 4), dtype=torch.float32, device=dev)
    raw_t = torch.empty((r * s, 8), dtype=torch.float32,
                        device=dev) if want_raw_t else None
    common.launch('hn_f32_level_fwd', dev, z_vals.data_ptr(),
                  origins.data_ptr(), directions.data_ptr(),
                  embed.data_ptr(), cond.data_ptr(), cond.shape[1],
                  wt_blob.data_ptr(), b_blob.data_ptr(), out.data_ptr(),
                  _ptr(raw_t), r, s)
    fused_level_f32.launches += 1
    return out, raw_t


fused_level_f32.launches = 0


def fused_template_f32(wt_blob, b_blob, x_raw, hyper: int, cond,
                       samples: int):
    """Launch the float32 template alone (csrc/f32_level.cu, the level
    forward's template stage) on the template's packed fp32 blobs, its
    weights transposed layer by layer: (P, 4) [rgb logits | raw sigma].
    x_raw (P, 8) [xyz | hyper | 0] with ``hyper`` hyper coordinates (4 or
    0), cond (P / samples, C). The inputs are checked by the caller (fp32,
    contiguous)."""
    dev, p = x_raw.device, x_raw.shape[0]
    out = torch.empty((p, 4), dtype=torch.float32, device=dev)
    common.launch('hn_f32_template_fwd', dev, x_raw.data_ptr(), _ld(x_raw),
                  hyper, cond.data_ptr(), cond.shape[1], wt_blob.data_ptr(),
                  b_blob.data_ptr(), out.data_ptr(), p, samples)
    fused_template_f32.launches += 1
    return out


fused_template_f32.launches = 0


def fused_field_f32(freq: int, wt_blob, b_blob, x_raw):
    """Launch the float32 field alone (csrc/f32_level.cu, the level
    forward's field stage) of ``freq`` bands (a key of FIELDS) on the
    field's packed fp32 blobs, its weights transposed layer by layer: (P,
    8) [the head's outputs | 0]. x_raw (P, 11) [points | embedding],
    checked by the caller."""
    dev, p = x_raw.device, x_raw.shape[0]
    out = torch.empty((p, 8), dtype=torch.float32, device=dev)
    if p:
        common.launch('hn_f32_field_fwd', dev, FIELDS[freq][2],
                      x_raw.data_ptr(), wt_blob.data_ptr(), b_blob.data_ptr(),
                      out.data_ptr(), p)
        fused_field_f32.launches += 1
    return out


fused_field_f32.launches = 0


def fused_field_bwd_f32(w_blob, wt_blob, b_blob, shapes, freq: int, x_raw,
                        g):
    """Launch a field alone backward at float32 (``field_bwd_steps``) on
    the field's packed fp32 blobs: (dx_raw (P, 11), [dW | db]). g (P,
    n_out) the cotangent of the head's outputs."""
    dev = x_raw.device
    w, wt, b, w_off, b_off, n_grads = fused_mlp.layer_views(
        w_blob, wt_blob, b_blob, shapes)
    with torch.cuda.device(dev):
        ops = _KernelOps(dev)
        res = field_bwd_steps(ops, w, wt, b, w_off, b_off, n_grads, freq,
                              x_raw, g)
    fused_field_bwd_f32.launches += 1
    return res


fused_field_bwd_f32.launches = 0


def fused_template_bwd_f32(w_blob, wt_blob, b_blob, shapes, raw_t, cond,
                           samples, g, hyper: int = N_HYPER):
    """Launch kernel A at float32 (``template_bwd_steps``) on the
    template's packed fp32 blobs: (dx_t, d cond, [dW | db])."""
    dev = raw_t.device
    w, wt, b, w_off, b_off, n_grads = fused_mlp.layer_views(
        w_blob, wt_blob, b_blob, shapes)
    with torch.cuda.device(dev):
        ops = _KernelOps(dev)
        res = template_bwd_steps(ops, w, wt, b, w_off, b_off, n_grads, raw_t,
                                 cond, samples, g, hyper=hyper)
    fused_template_bwd_f32.launches += 1
    return res


fused_template_bwd_f32.launches = 0


def fused_fields_bwd_f32(w_blob, wt_blob, b_blob, shapes, z_vals, origins,
                         directions, embed, dx_t):
    """Launch kernel B at float32 (``fields_bwd_steps``) on the field
    layers' views of the level's packed fp32 blobs (``shapes``: layers
    0..13): (d z_vals, d_ray (R, 14), [dW | db])."""
    dev = z_vals.device
    w, wt, b, w_off, b_off, n_grads = fused_mlp.layer_views(
        w_blob, wt_blob, b_blob, shapes)
    with torch.cuda.device(dev):
        ops = _KernelOps(dev)
        res = fields_bwd_steps(ops, w, wt, b, w_off, b_off, n_grads, z_vals,
                               origins, directions, embed, dx_t)
    fused_fields_bwd_f32.launches += 1
    return res


fused_fields_bwd_f32.launches = 0
