"""Kernel A's plan (``kernels/fused_mlp.py``): the chunks of whole rays, the
stash's column plan and the sequence of steps ``template_bwd_chunks``
launches, on the CPU.

The sequence is run here through ``TorchOps``, which computes each step's
contract (the C entry points of ``csrc/template_rowprod.cu``,
``template_dw.cu`` and ``template_bwd.cu``) in PyTorch at the kernels'
rounding points, and is held to the plain backward
``fused_template_bwd_plain``, the definition of the function. The CUDA
kernels themselves are held to the plain version on the card by
``chip_smoke.py``.

Tolerances: the plain version chunk by chunk against itself whole in
float32, dx_t exactly (per-row work) and the sums over chunks (d rgb_cond,
dW, db) to 1e-6 relative; the step sequence against the plain version in
bf16, relative L2 1e-2 per output (the same rounding points, fp32 sums in
another order, so a bf16 rounding flips here and there).
"""

import ctypes

import numpy as np
import pytest
import torch

from hypernerf_tpu_torch.kernels import build, common, fused_mlp
from hypernerf_tpu_torch.kernels.fused_mlp import (
    STASH_COL, STASH_COLUMNS, STASH_WIDTH, STASH_WIDTHS, WIDE_LAYERS,
    chunk_plan, fused_template_bwd_plain, layer_views, stash_plan,
    template_bwd_chunks, template_layers)
from hypernerf_tpu_torch.ops.posenc import posenc, posenc_orig
from tests.test_torch_fused_mlp import _port_template, _setup

BF = torch.bfloat16
PLANE_STASH = stash_plan(common.PLANE_ENC_PAD).width


@pytest.mark.parametrize('rows,samples,max_rows', [
    (481, 13, 100), (481, 13, 1 << 19), (100, 1, 32), (64, 1, 64),
    (1 << 21, 128, 1 << 19), (1 << 20, 64, 1 << 19), (512, 128, 100),
    (13, 13, 1)])
def test_chunk_plan_cuts_whole_rays(rows, samples, max_rows):
    """Every row in exactly one chunk, in order; a chunk is whole rays and
    at most max_rows rows unless one ray is longer."""
    plan = chunk_plan(rows, samples, max_rows)
    assert plan[0][0] == 0 and plan[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
    for r0, r1 in plan:
        assert r0 % samples == 0 and r1 % samples == 0 and r1 > r0
        assert r1 - r0 <= max(max_rows, samples)
    if max_rows >= rows:
        assert plan == [(0, rows)]


def test_chunk_plan_of_the_train_step():
    """16384 rays at S = 128: four chunks of 4096 rays (2^19 rows, a 3 GiB
    stash each); at S = 64 two."""
    assert chunk_plan(16384 * 128, 128) == [
        (i << 19, (i + 1) << 19) for i in range(4)]
    assert len(chunk_plan(16384 * 64, 64)) == 2
    assert (1 << 19) * STASH_WIDTH * 2 == 3 << 30


def test_chunk_plan_of_the_train_step_at_64_plus_128():
    """The fine level at S = 192 (``--n_fine 128``): 2730 rays a chunk
    (524,160 rows), so 16384 rays are six such chunks and a ragged last one
    of 4 rays (768 rows), each within the 3 GiB stash."""
    plan = chunk_plan(16384 * 192, 192)
    assert len(plan) == 7
    assert [r1 - r0 for r0, r1 in plan] == [2730 * 192] * 6 + [4 * 192]
    assert max(r1 - r0 for r0, r1 in plan) * STASH_WIDTH * 2 <= 3 << 30


def test_chunk_plan_refuses_rows_that_are_not_whole_rays():
    with pytest.raises(ValueError):
        chunk_plan(100, 13)


@torch.no_grad()
@pytest.mark.parametrize('per,max_rows', [(8, 16), (8, 24), (1, 8),
                                          (1, 1000)])
def test_plain_backward_by_chunks_equals_the_whole(per, max_rows):
    """The plain backward run chunk by chunk through the plan, d rgb_cond
    concatenated and dW / db summed, equals it run on all rows (float32)."""
    x, cond, cot, pairs = _setup('hyper', per)
    tmpl = _port_template('hyper', pairs, 'float32')
    x, cond, cot = map(torch.from_numpy, (x, cond, cot))
    s = x.shape[0] // cond.shape[0]
    dx, dc, grads, _ = fused_template_bwd_plain(tmpl, x, cond, cot)
    parts = [fused_template_bwd_plain(tmpl, x[r0:r1], cond[r0 // s:r1 // s],
                                      cot[r0:r1])
             for r0, r1 in chunk_plan(x.shape[0], s, max_rows)]
    assert len(parts) > 1 or max_rows >= x.shape[0]
    assert torch.equal(torch.cat([p[0] for p in parts]), dx)
    for got, want in [(torch.cat([p[1] for p in parts]), dc)] + [
            (sum(p[2][i] for p in parts), g) for i, g in enumerate(grads)]:
        torch.testing.assert_close(got, want, rtol=1e-6,
                                   atol=1e-6 * want.abs().max().item())


# Templates whose conditions are not the configuration's own: (its
# configuration, overrides); rgb condition widths 8 and 0.
CONDITION_CASES = {'embed_only': ('nerf_embed', dict(use_viewdirs=False)),
                   'no_viewdirs': ('flagship', dict(use_viewdirs=False))}


def _flagship_template(config='flagship'):
    from hypernerf_tpu_torch.flagship import (flagship_model,
                                              load_probe_weights)
    config, over = CONDITION_CASES.get(config, (config, {}))
    model = load_probe_weights(flagship_model('cpu', config=config, **over))
    return model.template_of('fine')


def test_stash_column_plan_matches_the_template():
    """3,072 columns, one per output of every wide layer (and the
    encoding), each as wide as the layer that writes it; every wide layer
    reads its input from stash columns as wide as its padded input (layer
    11 also reads the 39 condition features, padded to 48, per ray)."""
    assert STASH_WIDTH == 3072 == sum(w for _, w in STASH_COLUMNS)
    assert [STASH_COL[n] for n, _ in STASH_COLUMNS] == list(
        np.cumsum([0] + [w for _, w in STASH_COLUMNS])[:-1])
    layers = template_layers(_flagship_template().template, enc_pad=128)
    assert len(layers) == 16
    outs = [out for _, _, out, _ in WIDE_LAYERS]
    assert sorted(outs) == sorted(n for n, _ in STASH_COLUMNS if n != 'enc')
    for l, ins, out, relu in WIDE_LAYERS:
        lin, segs = layers[l]
        assert lin.out_features == STASH_WIDTHS[out]
        cond = 48 if l == 11 else 0
        assert sum(p for _, p in segs) == sum(
            STASH_WIDTHS[i] for i in ins) + cond
        assert relu == (l != 9)
    assert sorted(l for l, *_ in WIDE_LAYERS) == [
        l for l in range(16) if l not in (10, 15)]  # the two heads
    assert STASH_WIDTHS['enc'] == common.pad16(3 * 21 + 4 * 13)
    # The plane layout's stash: 64 more encoding columns, the same layers.
    plane = stash_plan(common.PLANE_ENC_PAD)
    assert plane.width == PLANE_STASH == 3136
    assert plane.widths == {**STASH_WIDTHS, 'enc': 192}
    assert all(plane.col[n] == STASH_COL[n] + 64 for n in STASH_COL
               if n != 'enc')
    layers = fused_mlp.kernel_template_layers(
        _flagship_template('plane').template)
    assert [sum(p for _, p in layers[l][1]) for l in (0, 5)] == [192, 448]


class TorchOps:
    """The steps of ``template_bwd_chunks`` in PyTorch, each the contract
    of its C entry point: bf16 buffers, fp32 sums, bf16 rounding where the
    kernels round, dW / db slabs per row range."""

    def __init__(self, splits):
        self.splits = splits
        self.stash_bytes = 0

    @staticmethod
    def _cols(segs, width):
        c0, w0, c1 = segs
        return [c0 + j if j < w0 else c1 + j - w0 for j in range(width)]

    def _ranges(self, n, tile=1):
        t = -(-n // tile)
        return [(t * z // self.splits * tile,
                 min(n, t * (z + 1) // self.splits * tile))
                for z in range(self.splits)]

    def encode(self, raw_t, stash, enc_col, n, scales):
        # The raw rows' width, the window row and the stash's width name the
        # layout: the plane's stash holds 192 encoding columns of 8 hyper
        # coordinates (raw rows of 16 columns); raw rows of 16 columns with a
        # window row are the Nerfies plane layout's.
        width = 192 if stash.shape[1] == PLANE_STASH else 128
        ch = 8 if raw_t.shape[1] == 16 else 4
        if scales is None:
            enc = torch.cat([posenc_orig(raw_t[:, :3], 10),
                             posenc_orig(raw_t[:, 3:3 + ch], 6)], -1)
        else:  # the Nerfies layouts, each feature rounded, windowed, rounded
            enc = torch.cat([posenc(raw_t[:, :3], 0, 10, True),
                             posenc(raw_t[:, 3:3 + ch], 0, 4)], -1)
        enc = torch.nn.functional.pad(enc, (0, width - enc.shape[1])).to(BF)
        if scales is not None:
            enc = (enc.float() * scales).to(BF)
        stash[:n, enc_col:enc_col + width] = enc

    def ray_bias(self, cond, w11, cond_col, out, rays):
        width = cond.shape[1]
        out[:rays] = cond.float() @ w11[:, cond_col:cond_col
                                        + width].float().t()

    def rowprod(self, a, n, segs, w, n_red, w_row0, n_tiles, out, out_col0,
                bias=None, ray_bias=None, samples=1, relu=False, mask=None,
                mask_col0=0):
        width = 128 * n_tiles
        wsub = torch.zeros(width, n_red)
        have = w[w_row0:w_row0 + width, :n_red].float()
        wsub[:have.shape[0]] = have
        acc = a[:n, self._cols(segs, n_red)].float() @ wsub.t()
        if bias is not None:
            acc = acc + bias[w_row0:w_row0 + width].float()
        if ray_bias is not None:
            acc = acc + ray_bias[torch.arange(n) // samples, :width]
        if relu:
            acc = acc.clamp_min(0)
        if mask is not None:
            acc = torch.where(mask[:n, mask_col0:mask_col0 + width].float()
                              > 0, acc, torch.zeros_like(acc))
        out[:n, out_col0:out_col0 + width] = acc.to(BF)

    def dw(self, g, n, n_out, h, segs, n_kin_tiles, slab, w_off, k_pad,
           b_off):
        # A ragged last tile (the plane layout's 192 and 448 inputs) writes
        # no column at k_pad or past it.
        width = 128 * n_kin_tiles
        hh = h[:n, self._cols(segs, width)].float()
        gg = g[:n, :n_out].float()
        keep = min(width, k_pad)
        for z, (r0, r1) in enumerate(self._ranges(n, 64)):
            slab[z, w_off:w_off + n_out * k_pad].view(n_out, k_pad)[
                :, :keep] = (gg[r0:r1].t() @ hh[r0:r1])[:, :keep]
            if b_off >= 0:
                slab[z, b_off:b_off + n_out] = gg[r0:r1].sum(0)

    def rgb_head(self, g4, stash, r3_col, w15, gout, slab, w_off, b_off, n):
        gr = g4[:n, :3]
        gb = gr.to(BF).float()
        h = stash[:n, r3_col:r3_col + 128].float()
        v = gb @ w15[:3].float()
        gout[:n, :128] = torch.where(h > 0, v, torch.zeros_like(v)).to(BF)
        for z, (r0, r1) in enumerate(self._ranges(n)):
            slab[z, w_off:w_off + 3 * 128].view(3, 128)[:] = \
                gb[r0:r1].t() @ h[r0:r1]
            slab[z, b_off:b_off + 3] = gr[r0:r1].sum(0)

    def cond_bwd(self, gout, gin, cond_col, cond, d_cond, slab, w_off, k_pad,
                 rays, samples):
        width = cond.shape[1]
        n, c = rays * samples, slice(cond_col, cond_col + width)
        d_cond[:] = gin[:n, c].float().view(rays, samples, width).sum(1)
        gs = gout[:n, :128].float().view(rays, samples, 128).sum(1)
        for z, (q0, q1) in enumerate(self._ranges(rays)):
            slab[z, w_off:w_off + 128 * k_pad].view(128, k_pad)[:, c] = \
                gs[q0:q1].t() @ cond[q0:q1].float()

    def alpha_cond_bwd(self, g4, alpha_cond, aw, d_alpha, slab, tail_off,
                       rays, samples):
        # Per ray: the sum of bf16(g_sigma) over its rows, times the alpha
        # head's condition weights (d alpha_cond) and times the condition
        # (the condition columns' dW, one slab per range of rays).
        gs = g4[:rays * samples, 3].to(BF).float().view(rays, samples).sum(1)
        d_alpha[:] = gs[:, None] * aw.float()
        width = alpha_cond.shape[1]
        for z, (q0, q1) in enumerate(self._ranges(rays)):
            slab[z, tail_off:tail_off + width] = \
                gs[q0:q1] @ alpha_cond[q0:q1].float()

    def bneck_prep(self, g4, gin, stash, bneck_col, w10, gb, slab, w_off,
                   b_off, b9_off, n):
        gs = g4[:n, 3]
        gsb = gs.to(BF).float()
        v = gin[:n, :128].float() + gsb[:, None] * w10[0].float()
        gb[:n, :128] = v.to(BF)
        h = stash[:n, bneck_col:bneck_col + 128].float()
        for z, (r0, r1) in enumerate(self._ranges(n)):
            slab[z, b9_off:b9_off + 128] = v[r0:r1].sum(0)
            slab[z, w_off:w_off + 128] = gsb[r0:r1] @ h[r0:r1]
            slab[z, b_off] = gs[r0:r1].sum()

    def posenc_bwd(self, raw_t, enc_g, dx_t, n, scales):
        # [the skip's part | layer 0's], each half of the buffer (the
        # plane layout's 256 columns); 8 hyper coordinates in raw rows of 16
        # columns.
        half = enc_g.shape[1] // 2
        gx = enc_g[:n, :half].float() + enc_g[:n, half:].float()
        hyper, ident = (6, True) if scales is None else (4, False)
        ch = 8 if raw_t.shape[1] == 16 else 4
        if scales is not None:
            gx = gx * scales
        dx_t[:, :3] = common.posenc_bwd(
            gx[:, :63], common.posenc_trig(raw_t[:, :3], 10), 3, 10)
        width = ch * (2 * hyper + ident)
        dx_t[:, 3:3 + ch] = common.posenc_bwd(
            gx[:, 63:63 + width],
            common.posenc_trig(raw_t[:, 3:3 + ch], hyper), ch, hyper, ident)
        dx_t[:, 3 + ch:] = 0

    def reduce(self, slab, grads):
        grads += slab.sum(0)


@torch.no_grad()
@pytest.mark.parametrize('config,rays,samples,max_rows', [
    ('flagship', 37, 13, 100), ('flagship', 96, 1, 40),
    ('static', 20, 16, 1 << 19), ('anneal', 37, 13, 100),
    ('plane', 37, 13, 100), ('plane_anneal', 20, 16, 1 << 19),
    ('nerf_embed', 37, 13, 100), ('embed_only', 37, 13, 100),
    ('no_viewdirs', 20, 16, 1 << 19), ('flagship', 7, 192, 3 * 192)])
def test_kernel_sequence_matches_the_plain_backward(config, rays, samples,
                                                    max_rows):
    """``template_bwd_chunks`` (several chunks, ragged rows, 3 slabs)
    through ``TorchOps`` reproduces ``fused_template_bwd_plain`` at the
    flagship widths in bf16: the stash columns, the order of the steps, the
    masks, the skip's two cotangents, the heads and the condition; for
    ``anneal`` the Nerfies layout with its window row at hyper_alpha 1.5
    and a 27-column condition; for ``plane`` the 192-column encoding of 8
    hyper coordinates (raw rows and dx_t of 16 columns; the first and skip
    layers' products at K 192 and 448, their dW over ragged last tiles; the
    encoding's cotangents in a buffer of 2 x 256 columns); for
    ``plane_anneal`` the Nerfies plane layout (8 hyper coordinates over
    degrees 0..4, 127 columns in 128, raw rows of 16 columns, the window
    row); for ``nerf_embed`` and ``embed_only`` the alpha condition's step (d
    alpha_cond per ray, the alpha head's condition columns' dW after the
    layers' [dW | db]) with a 47- and an 8-column rgb condition; for
    ``no_viewdirs`` a 0-column rgb condition (its steps run on an empty
    condition, rgb layer 0's condition columns are zero); the flagship at
    S = 192 (64 + 128) in chunks of 3 rays and a last one of 1."""
    tmpl = _flagship_template(config)
    t = tmpl.template
    rs = np.random.RandomState(rays + samples)
    p = rays * samples
    hyper = fused_mlp.n_hyper(tmpl)
    x = np.zeros((p, fused_mlp.raw_pad(tmpl)), np.float32)
    x[:, :3] = rs.randn(p, 3) * 0.4
    if config != 'static':
        x[:, 3:3 + hyper] = rs.randn(p, hyper) * 0.3
    raw = torch.from_numpy(x)
    width = fused_mlp.cond_width(tmpl)
    cond = torch.from_numpy(rs.randn(rays, width).astype(np.float32)).to(BF)
    g = torch.from_numpy(rs.randn(p, 4).astype(np.float32))
    scales = fused_mlp.template_scales(tmpl, 10.0, 1.5)
    alpha = None
    if fused_mlp.alpha_cond_width(tmpl):
        alpha = torch.from_numpy(rs.randn(rays, 8).astype(np.float32)).to(BF)
    want = fused_template_bwd_plain(tmpl, raw, cond, g, scales, alpha)
    if scales is not None:
        scales = torch.nn.functional.pad(scales, (0, 128 - scales.shape[0]))

    layers = fused_mlp.kernel_template_layers(t)
    w_blob, b_blob, shapes = common.pack_layers(t, layers)
    wt_blob = common.pack_layers(t, layers, transposed=True)[0]
    w, wt, b, w_off, b_off, n_grads = layer_views(w_blob, wt_blob, b_blob,
                                                  shapes)
    ops = TorchOps(3)
    kw = {}
    if alpha is not None:
        kw = dict(alpha=(alpha, fused_mlp.alpha_cond_weight(t)))
        n_grads += fused_mlp.ALPHA_TAIL
    dx_t, d_cond, grads, d_alpha = template_bwd_chunks(
        ops, raw, cond, samples, g, w, wt, b, w_off, b_off, n_grads,
        max_rows, scales, **kw)
    rows = max(r1 - r0 for r0, r1 in chunk_plan(p, samples, max_rows))
    assert ops.stash_bytes == rows * stash_plan(shapes[0][1]).width * 2
    assert dx_t.shape == (p, x.shape[1])
    got = [dx_t, d_cond] + fused_mlp.unpack_template_grads(
        grads, layers, shapes, b_off[0], alpha is not None)
    want = [want[0], want[1]] + want[2] + [want[3]]
    if alpha is None:
        assert d_alpha is None and want.pop() is None
    else:
        got.append(d_alpha)
        assert got[2 + 20].shape == (1, 136)  # the alpha head's dW
    assert len(got) == len(want) == 34 + (alpha is not None)
    for i, (a, e) in enumerate(zip(got, want)):
        assert a.shape == e.shape, i
        if e.numel() == 0:  # a zero-width condition's cotangent
            continue
        if config == 'static' and i == 0:
            assert torch.equal(a[:, 3:], torch.zeros_like(a[:, 3:]))
        l2 = ((a - e).norm() / e.norm().clamp_min(1e-30)).item()
        assert l2 < 1e-2, (i, l2)


class _RecordingLibrary:
    """Stands in for the kernel library: records each entry point's
    arguments and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@torch.no_grad()
def test_kernel_launches_match_the_c_signatures(monkeypatch):
    """``_KernelOps`` passes each C entry point of kernel A as many
    arguments as ``build``'s ctypes signature declares, of the declared
    kinds, and the narrow steps get the stash's and the cotangent buffers'
    leading dimensions from the tensors (their entry points check them
    against the layout they were compiled for)."""
    lib = _RecordingLibrary()
    monkeypatch.setattr(build, 'library', lambda: lib)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: type('S', (), {'cuda_stream': 7}))
    t = _flagship_template().template
    layers = template_layers(t, enc_pad=128)
    w_blob, b_blob, shapes = common.pack_layers(t, layers)
    wt_blob = common.pack_layers(t, layers, transposed=True)[0]
    w, wt, b, w_off, b_off, n_grads = layer_views(w_blob, wt_blob, b_blob,
                                                  shapes)
    rays, samples = 6, 4
    p = rays * samples
    ops = fused_mlp._KernelOps('cpu')
    template_bwd_chunks(ops, torch.zeros(p, 8), torch.zeros(rays, 39,
                                                            dtype=BF),
                        samples, torch.zeros(p, 4), w, wt, b, w_off, b_off,
                        n_grads, max_rows=12)
    assert ops.stash_bytes == 12 * STASH_WIDTH * 2
    names = [n for n, _ in lib.calls]
    assert names.count('hn_tmpl_reduce') == 2  # two chunks
    assert len(names) == 2 * 50  # 50 launches a chunk
    ints = (ctypes.c_int, ctypes.c_longlong)
    for name, args in lib.calls:
        argtypes = build._SIGNATURES[name][0]
        assert len(args) == len(argtypes), name
        for i, (a, kind) in enumerate(zip(args, argtypes)):
            if kind in ints:
                assert isinstance(a, int) and not isinstance(a, bool), \
                    (name, i)
            else:
                assert a is None or isinstance(a, int), (name, i)
        assert args[-1] == 7, name  # the stream
    lds = {name: args for name, args in lib.calls}
    assert lds['hn_tmpl_encode'][1] == lds['hn_tmpl_posenc_bwd'][1] == 8
    assert lds['hn_tmpl_encode'][3:5] == (STASH_WIDTH, STASH_COL['enc'])
    assert lds['hn_tmpl_rgb_head'][2] == STASH_WIDTH
    assert lds['hn_tmpl_rgb_head'][6] == fused_mlp.GBUF
    assert lds['hn_tmpl_cond_bwd'][1] == lds['hn_tmpl_cond_bwd'][3] == \
        fused_mlp.GBUF
    assert lds['hn_tmpl_cond_bwd'][4] == STASH_WIDTHS['bneck']
    assert lds['hn_tmpl_ray_bias'][5] == STASH_WIDTHS['bneck']
    assert lds['hn_tmpl_bneck_prep'][2] == lds['hn_tmpl_bneck_prep'][8] == \
        fused_mlp.GBUF
    assert lds['hn_tmpl_bneck_prep'][4] == STASH_WIDTH
    assert lds['hn_tmpl_posenc_bwd'][3] == fused_mlp.GBUF


@torch.no_grad()
def test_plane_kernel_launches_match_the_c_signatures(monkeypatch):
    """At the plane layout the same 50 launches a chunk pass the entry
    points the layout's buffers: a stash of 3136 columns (its encoding's
    192 at column 0; hn_tmpl_encode, hn_tmpl_rgb_head and hn_tmpl_bneck_prep
    take their layout from it), raw rows and dx_t of 16 columns, the
    encoding's cotangent buffer of 2 x 256 columns (hn_tmpl_posenc_bwd's
    ``e_ld``); layer 0's and the skip layer's products reduce over 192 and
    448, their cotangents fill two output tiles each and their dW two and
    four tiles of a 192- and 448-column k_pad."""
    lib = _RecordingLibrary()
    monkeypatch.setattr(build, 'library', lambda: lib)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: type('S', (), {'cuda_stream': 7}))
    t = _flagship_template('plane').template
    layers = fused_mlp.kernel_template_layers(t)
    w_blob, b_blob, shapes = common.pack_layers(t, layers)
    wt_blob = common.pack_layers(t, layers, transposed=True)[0]
    views = layer_views(w_blob, wt_blob, b_blob, shapes)
    rays, samples = 6, 4
    p = rays * samples
    ops = fused_mlp._KernelOps('cpu')
    dx_t = template_bwd_chunks(ops, torch.zeros(p, 16),
                               torch.zeros(rays, 39, dtype=BF), samples,
                               torch.zeros(p, 4), *views, max_rows=12)[0]
    assert dx_t.shape == (p, 16)
    assert ops.stash_bytes == 12 * PLANE_STASH * 2
    names = [n for n, _ in lib.calls]
    assert len(names) == 2 * 50 and names.count('hn_tmpl_reduce') == 2
    for name, args in lib.calls:
        assert len(args) == len(build._SIGNATURES[name][0]), name
    first = {}
    for name, args in lib.calls:
        first.setdefault(name, args)
    assert first['hn_tmpl_encode'][1] == first['hn_tmpl_posenc_bwd'][1] == 16
    assert first['hn_tmpl_encode'][3:5] == (PLANE_STASH, 0)
    assert first['hn_tmpl_rgb_head'][2] == PLANE_STASH
    assert first['hn_tmpl_bneck_prep'][4] == PLANE_STASH
    assert first['hn_tmpl_posenc_bwd'][3] == 512
    rowprods = [args for name, args in lib.calls[:50]
                if name == 'hn_tmpl_rowprod']
    # (n_red, w_row0, n_col_tiles, out_ld, out_col0) of each row product.
    red = [(a[9], a[10], a[11], a[13], a[14]) for a in rowprods]
    assert (192, 0, 2, PLANE_STASH, 192) in red  # layer 0's recompute
    assert (448, 0, 2, PLANE_STASH, 192 + 5 * 256) in red  # the skip's
    assert (256, 256, 2, 512, 0) in red  # the skip's part of d enc
    assert (256, 0, 2, 512, 256) in red  # layer 0's part of d enc
    dws = [(a[9], a[13]) for name, a in lib.calls[:50]
           if name == 'hn_tmpl_dw']
    assert (2, 192) in dws and (4, 448) in dws  # (tiles, k_pad), ragged


@torch.no_grad()
def test_nerfies_plane_kernel_launches_match_the_c_signatures(monkeypatch):
    """At the Nerfies plane layout (``plane_anneal``) the same 50 launches
    a chunk pass the 128-column layouts' buffers (a stash of 3072 columns,
    the encoding's cotangent buffer of 2 x 128), raw rows and dx_t of 16
    columns, which with the window row select the layout in
    hn_tmpl_encode and hn_tmpl_posenc_bwd (``raw_ld``); the first and skip
    layers reduce over 128 and 384, as the other 128-column layouts'."""
    lib = _RecordingLibrary()
    monkeypatch.setattr(build, 'library', lambda: lib)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: type('S', (), {'cuda_stream': 7}))
    tmpl = _flagship_template('plane_anneal')
    assert fused_mlp.layout(tmpl) == 'nerfies_plane'
    t = tmpl.template
    layers = fused_mlp.kernel_template_layers(t)
    w_blob, b_blob, shapes = common.pack_layers(t, layers)
    wt_blob = common.pack_layers(t, layers, transposed=True)[0]
    views = layer_views(w_blob, wt_blob, b_blob, shapes)
    rays, samples = 6, 4
    p = rays * samples
    scales = fused_mlp.kernel_scales(tmpl, None, torch.device('cpu'))
    ops = fused_mlp._KernelOps('cpu')
    dx_t = template_bwd_chunks(ops, torch.zeros(p, 16),
                               torch.zeros(rays, 27, dtype=BF), samples,
                               torch.zeros(p, 4), *views, max_rows=12,
                               scales=scales)[0]
    assert dx_t.shape == (p, 16)
    assert ops.stash_bytes == 12 * STASH_WIDTH * 2
    names = [n for n, _ in lib.calls]
    assert len(names) == 2 * 50 and names.count('hn_tmpl_reduce') == 2
    for name, args in lib.calls:
        assert len(args) == len(build._SIGNATURES[name][0]), name
    first = {}
    for name, args in lib.calls:
        first.setdefault(name, args)
    assert first['hn_tmpl_encode'][1] == first['hn_tmpl_posenc_bwd'][1] == 16
    assert first['hn_tmpl_encode'][3:5] == (STASH_WIDTH, 0)
    assert first['hn_tmpl_encode'][6] == first['hn_tmpl_posenc_bwd'][6] \
        == scales.data_ptr()
    assert first['hn_tmpl_posenc_bwd'][3] == fused_mlp.GBUF
    red = [(a[9], a[13]) for name, a in lib.calls[:50]
           if name == 'hn_tmpl_rowprod']
    assert (128, STASH_WIDTH) in red and (384, STASH_WIDTH) in red
