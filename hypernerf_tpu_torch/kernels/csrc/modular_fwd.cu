// The per-module forward kernels for Hopper (sm_90a): a field alone, the
// template alone and the SE(3) / quaternion trunk alone, each one stage of
// the level forward (level_fwd.cuh) run on the level forward's block, from
// the stage's own weight blob.
//
// Replaces hypernerf_tpu/ops/pallas/fused_field.py `_fused` (:495, the tile
// body `_forward_tile_gen` :331-354 over `_encode_gen` :181-213),
// hypernerf_tpu/ops/pallas/fused_mlp.py `_fwd_call` (:656, the tile body
// `_forward_tile_gen` :319-379 with the in-kernel encoding of
// `enc_segments`) and hypernerf_tpu/ops/pallas/fused_se3.py `_fused` (:374,
// the tile body `_forward_tile_gen` :200-226 over `_encode_gen` :91-112),
// for the flagship widths.
//
// A field alone (hn_fused_field_fwd): the warp field (layers 0..6 of
// TransTable: posenc_orig(pts, 10) ++ embed -> 6 x 128 -> 3) or the hyper
// sheet (layers 7..13: posenc_orig(pts, 7) ++ embed -> 6 x 64 -> 4), skip
// after layer 4. In: x_raw (P, 11) fp32 rows [pts | embed]; an optional
// window row `scales` (the padded encoding width, fp32); the field's own
// packed bf16 weights (out, in) and biases. Out: (P, 8) fp32 [MLP output |
// 0]; the warp's residual (pts + output) is the caller's. A per-module
// sheet is TransTable's layers whatever the warp.
// The template alone (hn_fused_template_fwd): posenc_orig(xyz, 10) ++
// posenc_orig(hyper (4), 6) -> trunk 8 x 256 (skip after 4, ReLU logit) ->
// bottleneck 128 -> alpha head on [bottleneck | alpha condition]; rgb
// branch 4 x 128 on [bottleneck | rgb condition] -> rgb logits (layers
// 14..29); or, given the window row `scales` (128 fp32), the anneal
// configuration's layout: scales * [posenc(xyz, 0..10, identity) ++
// posenc(hyper, 0..4)] (level_common.cuh TmplLayout; template_fwd.cuh's
// kernel, instantiated here for posenc_orig, in template_fwd_anneal.cu for
// the Nerfies layout and in template_fwd_plane.cu, entry point
// hn_fused_template_fwd_plane, for the plane configuration's: posenc_orig
// of 8 hyper coordinates, 167 columns in 192, layers 7..22 of PlaneTable,
// x_raw (P, 16), on a block of two 448-column tiles and a ring of 5
// stages; that entry point, given a window row, runs the Nerfies plane
// layout's, instantiated in level_fwd_nerf_plane.cu: the Nerfies encoding
// of 8 hyper coordinates, 127 columns in 128, on the level's block). In:
// x_raw (P, 8) fp32 rows [xyz | hyper | 0]; rgb_cond (P / S, cond_w)
// bf16, one row per S consecutive rows, any S >= 1, cond_w from 0
// (no rgb condition) to 48 (39 or 27 the view directions' encoding, 47 or
// 35 with the nerf embedding after it, 8 the embedding alone); alpha_cond
// (P / S, 8) bf16 and alpha_w (8) bf16, the alpha head's condition columns,
// or both null (level_fwd.cuh Cond); the template's own blobs. Out: (P, 4)
// fp32 [rgb logits | raw sigma]. A template without hyper coordinates
// (static NeRF: 63 encoded inputs) runs through the same kernel: the
// wrapper packs zero weight columns for the hyper bands, whose encoding of
// the zero input ([0 | sin 0 | cos 0]) then adds exactly nothing.
// The trunk alone (hn_fused_se3_fwd): the Nerfies posenc(pts, degrees 0..8,
// no identity) ++ embed (56 -> 64) -> 6 x 128 (skip after layer 4) ->
// linear 128 -> 128, rounded -> the w and the v head, 128 -> 3 each
// (layers 0..8 of Se3Table, the level's screw_stage without its
// retraction). In: x_raw (P, 11) fp32 rows [pts | embed]; an optional
// window row `scales` (64 fp32, `warp_alpha`); the trunk's own blobs. Out:
// (P, 8) fp32 [w | v | 0 0]; the retraction is the caller's.
// Rounding points are the level kernel's (level_fwd.cuh); a window row
// multiplies the rounded feature, which is rounded again.
//
// Bound: the template does 686,976 multiply-adds a row against 48 bytes
// moved, the warp field 100,480, the sheet 27,520 and the trunk 113,408
// against 76 bytes, so operations bound all four (8192 x 128 rows: 1.457,
// 0.213, 0.058 and 0.240 ms at the card's dense bf16 rate).
// Design: the level forward's block (a persistent grid; consumer
// warpgroups, each with its 64-row activation tile resident in swizzled
// shared memory; `wgmma` products; the stage's weights streamed by TMA
// through the ring from tensor maps built over the stage's own blob; the
// `cvt.relu` / `stmatrix` epilogue), running one stage with the level
// kernel's own device functions: the chain warp field -> sheet -> template
// computes the level kernel's numbers bit for bit. The template runs the
// level's block of two 384-column tiles. A field's row work (its inputs and
// encoding, latency-bound chains of sincos and stores) took half and more
// of a step of two tiles while the warpgroups ran in lockstep
// (tools/trace_level_fwd.py, an H100 80GB HBM3 at 700 W), and a field
// reads and writes only the first 256 (warp) or 128 (sheet) columns: so
// the warp field's block takes three tiles and the sheet's four, whose row
// work hides one another's latency and drifts apart from other tiles'
// products. The trunk reads and writes 128 hidden and 64 encoded columns
// and has the warp field's row work (27 sincos pairs a row against 30), so
// it takes the warp field's block of three 256-column tiles.

#include "template_fwd.cuh"

namespace {
namespace lf {

// A field alone: its layers [kFirst, kLast) of MT, its bands and outputs,
// and its block. A field's layers read and write the first 256 (the warp)
// or 128 (the sheet) columns of a tile, so three or four tiles fit a block
// beside the ring: twelve or sixteen consumer warps, whose row work hides
// one another's latency and overlaps other tiles' products.
template <int L0, int F, int OUT, class Blk_>
struct FieldStage {
  static constexpr int kFirst = L0, kLast = L0 + 7, kBands = F, kOut = OUT;
  using Blk = Blk_;
};
using WarpStage = FieldStage<0, kWarpF, 3, Block<3, 256>>;
using SheetStage = FieldStage<MT::kWarp, kHypF, kHypOut, Block<4, 128>>;
static_assert(SheetStage::kLast == MT::kFields, "the sheet ends the fields");

// The SE(3) / quaternion trunk alone: layers [0, kWarp) of Se3Table on the
// warp field's block.
struct TrunkStage {
  using T = Se3Table;
  using Blk = Block<3, 256>;
  static constexpr int kFirst = 0, kLast = T::kWarp;
  static_assert(kSe3HeadV + 1 == kLast, "the heads end the trunk");
};

// A field's row inputs: x_raw rows [pts | embed] into rows.in, zeros past
// P. The tile's rows are one run of 64 x 11 floats: every thread's loads go
// out before the first store.
__device__ __forceinline__ void field_rows(const Group& g, long long row0,
                                           long long n_points,
                                           const float* __restrict__ x_raw) {
  constexpr int kIn = 3 + kEmbed, kN = kRows * kIn, kEach = (kN + 127) / 128;
  const float* src = x_raw + row0 * kIn;
  const long long valid = (n_points - row0) * kIn;
  float v[kEach];
#pragma unroll
  for (int i = 0; i < kEach; ++i) {
    const int e = g.tid + 128 * i;
    v[i] = e < kN && e < valid ? src[e] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kEach; ++i) {
    const int e = g.tid + 128 * i;
    if (e < kN) g.rows->in[e / kIn][e % kIn] = v[i];
  }
}

template <class S>
__global__ void __launch_bounds__(S::Blk::kThreads, 1)
    field_fwd_kernel(const __grid_constant__ Maps<MT> maps,
                     const float* __restrict__ x_raw,
                     const float* __restrict__ scales,
                     const bf16* __restrict__ B, float* __restrict__ out,
                     long long n_points) {
  Group g;
  Ring ring;
  const bf16* Bs;
  using Blk = typename S::Blk;
  if (!enter_block<Blk, MT, S::kFirst, S::kLast>(maps, B, n_points, g, ring,
                                                 Bs))
    return;
  Rows& rw = *g.rows;
  const long long n_steps = tile_steps<Blk>(n_points);
  for (long long step = blockIdx.x; step < n_steps;
       step += gridDim.x, ++g.it) {
    const long long row0 = first_row<Blk>(g, step);
    field_rows(g, row0, n_points, x_raw);
    g.sync();
    field_stage<MT, S::kFirst, S::kBands>(g, ring, Bs, scales, &rw.head[0][0],
                                          S::kOut);
    // [out | 0], a row as two float4 (the head ended in a barrier).
    const int r = g.tid >> 1, h = g.tid & 1;
    if (row0 + r < n_points) {
      const float* v = rw.head[r] + 4 * h;
      float o[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) o[c] = 4 * h + c < S::kOut ? v[c] : 0.f;
      reinterpret_cast<float4*>(out)[2 * (row0 + r) + h] =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

__global__ void __launch_bounds__(TrunkStage::Blk::kThreads, 1)
    trunk_fwd_kernel(const __grid_constant__ Maps<Se3Table> maps,
                     const float* __restrict__ x_raw,
                     const float* __restrict__ scales,
                     const bf16* __restrict__ B, float* __restrict__ out,
                     long long n_points) {
  using S = TrunkStage;
  Group g;
  Ring ring;
  const bf16* Bs;
  if (!enter_block<S::Blk, S::T, S::kFirst, S::kLast>(maps, B, n_points, g,
                                                      ring, Bs))
    return;
  Rows& rw = *g.rows;
  const long long n_steps = tile_steps<S::Blk>(n_points);
  for (long long step = blockIdx.x; step < n_steps;
       step += gridDim.x, ++g.it) {
    const long long row0 = first_row<S::Blk>(g, step);
    field_rows(g, row0, n_points, x_raw);
    g.sync();
    trunk_stage<S::T>(g, ring, Bs, scales);
    // [w | v | 0 0], a row as two float4 (the heads ended in a barrier).
    const int r = g.tid >> 1, h = g.tid & 1;
    if (row0 + r < n_points) {
      const float* v = rw.head[r] + 4 * h;
      reinterpret_cast<float4*>(out)[2 * (row0 + r) + h] =
          h ? make_float4(v[0], v[1], 0.f, 0.f)
            : make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <class S>
int launch_field(const void* x_raw, const void* scales, const void* weights,
                 const void* biases, void* out, long long n_points,
                 void* stream) {
  static std::atomic<int> configured[kMaxDevices];
  unsigned grid = 0;
  using Blk = typename S::Blk;
  int status =
      block_grid<Blk>(field_fwd_kernel<S>, configured, n_points, &grid);
  if (status || grid == 0) return status;
  Maps<MT> maps;
  status = make_maps<MT>(&maps, static_cast<const bf16*>(weights), S::kFirst,
                         S::kLast);
  if (status) return status;
  field_fwd_kernel<S><<<grid, Blk::kThreads, Blk::kSmemBytes,
                        (cudaStream_t)stream>>>(
      maps, static_cast<const float*>(x_raw),
      static_cast<const float*>(scales), static_cast<const bf16*>(biases),
      static_cast<float*>(out), n_points);
  return (int)cudaGetLastError();
}

}  // namespace lf
}  // namespace

// which: 0 the warp field (layers 0..6 of the table), 1 the hyper sheet
// (layers 7..13). weights / biases: that field's seven layers alone.
// scales: null, or the padded encoding width of fp32 window weights.
extern "C" int hn_fused_field_fwd(int which, const void* x_raw,
                                  const void* scales, const void* weights,
                                  const void* biases, void* out,
                                  long long n_points, void* stream) {
  if (n_points <= 0) return (int)cudaErrorInvalidValue;
  if (which == 0)
    return lf::launch_field<lf::WarpStage>(x_raw, scales, weights, biases,
                                           out, n_points, stream);
  if (which == 1)
    return lf::launch_field<lf::SheetStage>(x_raw, scales, weights, biases,
                                            out, n_points, stream);
  return (int)cudaErrorInvalidValue;
}

// weights / biases: the trunk's nine layers alone (layers 0..8 of Se3Table).
// scales: null, or the 64 fp32 window weights of its encoding.
extern "C" int hn_fused_se3_fwd(const void* x_raw, const void* scales,
                                const void* weights, const void* biases,
                                void* out, long long n_points, void* stream) {
  using namespace lf;
  using S = TrunkStage;
  if (n_points <= 0) return (int)cudaErrorInvalidValue;
  static std::atomic<int> configured[kMaxDevices];
  unsigned grid = 0;
  int status = block_grid<S::Blk>(trunk_fwd_kernel, configured, n_points,
                                  &grid);
  if (status) return status;
  Maps<S::T> maps;
  status = make_maps<S::T>(&maps, static_cast<const bf16*>(weights),
                           S::kFirst, S::kLast);
  if (status) return status;
  trunk_fwd_kernel<<<grid, S::Blk::kThreads, S::Blk::kSmemBytes,
                     (cudaStream_t)stream>>>(
      maps, static_cast<const float*>(x_raw),
      static_cast<const float*>(scales), static_cast<const bf16*>(biases),
      static_cast<float*>(out), n_points);
  return (int)cudaGetLastError();
}

// weights / biases: the template's 16 layers alone (layers 14..29 of the
// table). samples: consecutive rows that share one row of rgb_cond.
extern "C" int hn_fused_template_fwd(HN_TEMPLATE_FWD_ARGS) {
  if (n_points <= 0 || samples <= 0 ||
      lf::bad_conditions(rgb_cond, alpha_cond, alpha_w, cond_w))
    return (int)cudaErrorInvalidValue;
  if (scales) return hn_template_fwd_anneal(HN_TEMPLATE_FWD_PASS);
  return lf::launch_template<OrigEnc>(HN_TEMPLATE_FWD_PASS);
}

// The plan of per-module stage `stage` (0 the warp field, 1 the sheet, 2 the
// template, 3 the SE(3) trunk, 4 the plane configuration's template, 5 the
// Nerfies plane layout's template; lf::forward_plan of its block over its
// layers of the table, TransTable's or, for the trunk, Se3Table's, for a
// plane template its plane table's):
// config[0:8], in_cols[i] for its i-th layer, and the weight loads of one
// step of tiles. Returns the number of loads (written up to max_loads), or
// -1 for an unknown stage.
extern "C" int hn_modular_fwd_plan(int stage, int* config, int* in_cols,
                                   int* loads, int max_loads) {
  using namespace lf;
  switch (stage) {
    case 0:
      return forward_plan<WarpStage::Blk, MT>(WarpStage::kFirst,
                                              WarpStage::kLast, config,
                                              in_cols, loads, max_loads);
    case 1:
      return forward_plan<SheetStage::Blk, MT>(SheetStage::kFirst,
                                               SheetStage::kLast, config,
                                               in_cols, loads, max_loads);
    case 2:
      return forward_plan<LevelBlock, MT>(MT::kFields, MT::kNum, config,
                                          in_cols, loads, max_loads);
    case 3:
      return forward_plan<TrunkStage::Blk, TrunkStage::T>(
          TrunkStage::kFirst, TrunkStage::kLast, config, in_cols, loads,
          max_loads);
    case 4:
      return forward_plan<PlaneBlock, PlaneTable>(
          PlaneTable::kFields, PlaneTable::kNum, config, in_cols, loads,
          max_loads);
    case 5: {
      using T = PlaneTableOf<NerfPlaneEnc>;
      return forward_plan<TmplBlock<NerfPlaneEnc>, T>(
          T::kFields, T::kNum, config, in_cols, loads, max_loads);
    }
  }
  return -1;
}

#ifdef HN_LEVEL_FWD_TRACE
// The clocks block 0 recorded (level_fwd.cuh), as [group][pair][layer][4].
extern "C" int hn_modular_fwd_trace(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, lf::level_fwd_trace,
                                   sizeof(lf::level_fwd_trace));
}
#endif
