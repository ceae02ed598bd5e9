// One field MLP alone, backward, for Hopper (sm_90a): kernel B's block
// (fields_bwd.cuh) walking back one field from the field's own blobs.
//
// Replaces hypernerf_tpu/ops/pallas/fused_field.py `_fused_bwd` (:532, the
// tile body `_backward_tile_gen` :379-417 with the posenc VJP
// `_encode_bwd_gen` :233-266) for the two fields modular_fwd.cu computes:
// the translation warp (layers 0..6 of TransTable: posenc_orig(pts, 10) ++
// embed -> 6 x 128 -> 3) and the hyper sheet (layers 7..13:
// posenc_orig(pts, 7) ++ embed -> 6 x 64 -> 4), skip after layer 4.
//
// In:  x_raw (P, 11) fp32 [pts | embed] per sample; an optional window row
//      `scales` over the padded encoding (fp32); g (P, 8) fp32 =
//      d[output | 0]; the field's packed bf16 weights (out, in) and biases.
// Out: dx_raw (P, 11) fp32 per sample (the caller sums the embedding's part
//      per ray and adds the warp's residual); fp32 dW / db of the field's
//      seven layers in the packed layout, added into kGradCopies buffers
//      (block b into copy b % kGradCopies; the wrapper sums them).
// Rounding points are kernel B's and the JAX kernel's: the encoding is
// rounded to bf16 (times the window row, rounded again); every product takes
// bf16 operands with fp32 sums; the cotangent is rounded to bf16 after each
// ReLU mask; a hidden layer's db sums the rounded cotangent, the head's the
// fp32 one; layer 0's and the skip's parts of d enc are summed in fp32 and
// times the window row before the posenc VJP.
//
// Bound: three multiply-adds per weight and sample (the recompute, g W and
// g^T h) against 120 bytes moved: operations bound it (16384 x 128 rows:
// 1.278 ms for the warp field, 0.350 for the sheet at the card's dense bf16
// rate).
//
// Design: kernel B's (fields_bwd.cuh): a persistent grid of block tiles of
// 128 rows on two consumer warpgroups and a producer warpgroup; the field
// recomputed with `wgmma` into the slab pool by the field's row of buf_plan
// (the sheet fits the pool; the warp field spills its first outputs to a
// per-block scratch and reloads them); the weights streamed by TMA through
// the ring (the field's hidden layers forward, then backward, from tensor
// maps over the field's own blob), read K-major by the recompute and
// MN-major by g W, so no transposed copy exists; dW as 64 x 64 `wgmma` units
// added once per block tile. What differs from kernel B: the rows come from
// x_raw and g, not from rays and dx_t; dx_raw is written per row (no ray
// sums, nothing passed through); the window row scales the encoding and its
// cotangent.

#include "fields_bwd.cuh"

namespace {
namespace fb {

using FT = TransTable;  // a field alone is TransTable's layers

// Field F (kTransWarp or kSheet) alone: its layers [kFirst, kLast) of FT,
// its bands and outputs, and where its blobs sit in the level's.
template <int F>
struct Alone {
  static constexpr int kFirst = base<FT, F>(), kLast = kFirst + 7;
  static constexpr int kBands = F == kSheet ? kHypF : kWarpF;
  static constexpr int kOut = F == kSheet ? kHypOut : 3;
  static constexpr long long kW0 = weight_offset<FT>(kFirst);
  static constexpr long long kNW = weight_offset<FT>(kLast) - kW0;
  static constexpr int kB0 = bias_offset<FT>(kFirst);
  static constexpr int kNB = bias_offset<FT>(kLast) - kB0;
  static_assert(lf::whole_runs<FT>(kFirst, kLast), "the field's maps");
  static_assert((kNW + kNB) % 4 == 0, "each gradient copy starts 16-byte "
                "aligned for the float4 adds");
};

// A block tile's loads: the field's six hidden layers forward, then
// backward.
template <int F>
__device__ __forceinline__ void produce_alone(const lf::Maps<FT>& maps,
                                              Ring& ring) {
  produce_run<FT, Alone<F>::kFirst, false>(
      maps, ring, std::make_integer_sequence<int, 6>());
  produce_run<FT, Alone<F>::kFirst, true>(
      maps, ring, std::make_integer_sequence<int, 6>());
}

constexpr int kIn = 3 + kEmbed;  // x_raw's and dx_raw's columns

// Row inputs of the warpgroup's rows [row0, row0 + 64): x_raw into rows.in,
// g[:, 0:kOut] into rows.hg (the head's fp32 cotangent); zeros past P. The
// rows' x_raw is one run of 64 x 11 floats: every thread's loads go out
// before the first store.
template <int kOut>
__device__ __forceinline__ void alone_rows(const Ctx& c, long long row0,
                                           long long n_points,
                                           const float* __restrict__ x_raw,
                                           const float* __restrict__ g) {
  constexpr int kN = kRows * kIn, kEach = (kN + 127) / 128;
  Rows& rw = *c.rows;
  const int R0 = c.group * kRows;
  const float* src = x_raw + row0 * kIn;
  const long long valid = (n_points - row0) * kIn;
  float v[kEach];
#pragma unroll
  for (int i = 0; i < kEach; ++i) {
    const int e = c.tid + 128 * i;
    v[i] = e < kN && e < valid ? src[e] : 0.f;
  }
  // g: a row as two float4, a thread each.
  const int r = c.tid >> 1, h = c.tid & 1;
  const float4 gv = row0 + r < n_points
                        ? reinterpret_cast<const float4*>(g)[2 * (row0 + r) + h]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kEach; ++i) {
    const int e = c.tid + 128 * i;
    if (e < kN) rw.in[R0 + e / kIn][e % kIn] = v[i];
  }
  const float gg[4] = {gv.x, gv.y, gv.z, gv.w};
  float* hg = rw.hg[R0 + r] + 4 * h;
#pragma unroll
  for (int q = 0; q < 4; ++q) hg[q] = 4 * h + q < kOut ? gg[q] : 0.f;
}

// dx_raw of the warpgroup's rows from rows.acc[:, 0:11], rows below P.
__device__ __forceinline__ void alone_dx(const Ctx& c, long long row0,
                                         long long n_points,
                                         float* __restrict__ dx_raw) {
  constexpr int kN = kRows * kIn, kEach = (kN + 127) / 128;
  const Rows& rw = *c.rows;
  const int R0 = c.group * kRows;
  float* dst = dx_raw + row0 * kIn;
  const long long valid = (n_points - row0) * kIn;
#pragma unroll
  for (int i = 0; i < kEach; ++i) {
    const int e = c.tid + 128 * i;
    if (e < kN && e < valid) dst[e] = rw.acc[R0 + e / kIn][e % kIn];
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads, 1)
    field_bwd_kernel(const __grid_constant__ lf::Maps<FT> maps,
                     const float* __restrict__ x_raw,
                     const float* __restrict__ scales,
                     const float* __restrict__ g_out,
                     const bf16* __restrict__ W, const bf16* __restrict__ B,
                     float* __restrict__ dx_raw, float* __restrict__ grads,
                     uint8_t* __restrict__ scratch, long long n_points) {
  using A = Alone<F>;
  uint8_t* base;
  Ring ring;
  Rows* rows;
  uint64_t* reload;
  lay_out(base, ring, rows, reload);
  const long long n_tiles = (n_points + kTileRows - 1) / kTileRows;
  const int group = threadIdx.x >> 7;

  if (group == kGroups) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kGroups)
      for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        produce_alone<F>(maps, ring);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  Ctx c{smem_addr(base), rows, ring, reload,
        scratch + (size_t)blockIdx.x * kSpillSlabs * kSlabBytes, group,
        (int)(threadIdx.x & 127), 0};
#ifdef HN_FIELDS_BWD_TRACE
  c.last = clock64();
#endif
  // The blobs and the gradient copies hold this field's layers alone; the
  // device functions index them by the level's layer table.
  const bf16* Wl = W - A::kW0;
  const bf16* Bl = B - A::kB0;
  float* copy = grads + (blockIdx.x % kGradCopies) * (A::kNW + A::kNB);
  float* grad_w = copy - A::kW0;
  float* grad_b = copy + A::kNW - A::kB0;
  Rows& rw = *rows;
  for (long long tile = blockIdx.x; tile < n_tiles;
       tile += gridDim.x, ++c.it) {
    const long long row0 = tile * kTileRows + group * kRows;
    alone_rows<A::kOut>(c, row0, n_points, x_raw, g_out);
    c.sync();
    c.mark(kCyRow);
    encode_field<F, A::kBands>(c, scales);
    fence_async_smem();
    c.sync();
    spill_enc<F>(c);
    c.mark(kCyEnc);
    fwd_layer<FT, F, 0, true>(c, Bl);
    fwd_layer<FT, F, 1, true>(c, Bl);
    fwd_layer<FT, F, 2, true>(c, Bl);
    fwd_layer<FT, F, 3, true>(c, Bl);
    fwd_layer<FT, F, 4, true>(c, Bl);
    fwd_layer<FT, F, 5, true>(c, Bl);
    // Every spill written before any reload reads it.
    if (F == kTransWarp && c.tid == 0) {
      bulk_wait_all();
      fence_async_global();
    }
    c.block_sync();
    c.mark(kCyBar);
    head_back<FT, F>(c, Wl, grad_w, grad_b);
    back_layer<FT, F, 5>(c, grad_w, grad_b);
    back_layer<FT, F, 4>(c, grad_w, grad_b);
    back_layer<FT, F, 3>(c, grad_w, grad_b);
    back_layer<FT, F, 2>(c, grad_w, grad_b);
    back_layer<FT, F, 1>(c, grad_w, grad_b);
    back_layer<FT, F, 0>(c, grad_w, grad_b);
    encoding_vjp<F, A::kBands>(c, &rw.acc[0][0], 20, scales);
    c.sync();
    alone_dx(c, row0, n_points, dx_raw);
    c.mark(kCyRay);
  }
}

// Host side: the tensor maps of the field's blob (level_fwd.cuh's,
// cached), the shared-memory attribute once per device, `blocks`
// persistent blocks.
template <int F>
int launch_field_bwd(const void* x_raw, const void* scales, const void* g,
                     const void* weights, const void* biases, void* dx_raw,
                     void* grads, void* scratch, long long n_points,
                     int blocks, void* stream) {
  static std::atomic<int> configured[kMaxDevices];
  int dev = 0, sms = 0;
  int status = current_device(&dev, &sms);
  if (status) return status;
  if (!configured[dev].load(std::memory_order_relaxed)) {
    const cudaError_t err = cudaFuncSetAttribute(
        field_bwd_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured[dev].store(1, std::memory_order_relaxed);
  }
  lf::Maps<FT> maps;
  status = lf::make_maps<FT>(&maps, static_cast<const bf16*>(weights),
                             Alone<F>::kFirst, Alone<F>::kLast);
  if (status) return status;
  field_bwd_kernel<F><<<blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      maps, static_cast<const float*>(x_raw),
      static_cast<const float*>(scales), static_cast<const float*>(g),
      static_cast<const bf16*>(weights), static_cast<const bf16*>(biases),
      static_cast<float*>(dx_raw), static_cast<float*>(grads),
      static_cast<uint8_t*>(scratch), n_points);
  return (int)cudaGetLastError();
}

}  // namespace fb
}  // namespace

// which: 0 the warp field (layers 0..6 of the table), 1 the hyper sheet
// (layers 7..13). weights / biases: that field's seven layers alone.
// scales: null, or the padded encoding width of fp32 window weights. g: (P,
// 8) fp32. grads: [dW | db] of the seven layers in the packed layout, in
// fb::kGradCopies copies one after the other (block b adds into copy b %
// fb::kGradCopies), zero on entry. scratch: blocks x fb::kSpillSlabs x 16 KB
// of spill slabs where the field's plan spills (the warp field), else
// unused. blocks: hn_fused_fields_bwd_blocks(n_points).
extern "C" int hn_fused_field_bwd(int which, const void* x_raw,
                                  const void* scales, const void* g,
                                  const void* weights, const void* biases,
                                  void* dx_raw, void* grads, void* scratch,
                                  long long n_points, int blocks,
                                  void* stream) {
  if (n_points <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  if (which == 0)
    return fb::launch_field_bwd<fb::kTransWarp>(x_raw, scales, g, weights,
                                                biases, dx_raw, grads,
                                                scratch, n_points, blocks,
                                                stream);
  if (which == 1)
    return fb::launch_field_bwd<fb::kSheet>(x_raw, scales, g, weights,
                                            biases, dx_raw, grads, scratch,
                                            n_points, blocks, stream);
  return (int)cudaErrorInvalidValue;
}

// The plan of field `which` alone (0 the warp field, 1 the sheet):
// config[0:9] as hn_fused_fields_bwd_plan's (kernel B's block);
// table[0:54] the field's buffer plan, six ints per buffer (enc, h0..h5, T,
// skip), kernel B's row of that field; loads[3 i : 3 i + 3] = (layer of
// the table, 64-column box of K, box rows) of the i-th weight load of one
// block tile: the field's six hidden layers forward, then backward. Returns
// the number of loads (written up to max_loads), or -1 for another field.
extern "C" int hn_fused_field_bwd_plan(int which, int* config, int* table,
                                       int* loads, int max_loads) {
  using namespace fb;
  if (which != 0 && which != 1) return -1;
  plan_config(config);
  if (which == 0) {
    plan_table(kTransWarp, table);
    return plan_loads<FT>(Alone<kTransWarp>::kFirst, 6, loads, 0, max_loads);
  }
  plan_table(kSheet, table);
  return plan_loads<FT>(Alone<kSheet>::kFirst, 6, loads, 0, max_loads);
}

#ifdef HN_FIELDS_BWD_TRACE
// The cycles block 0 added up (fields_bwd.cuh), as [group][tile][kind];
// then zeroes them for the next launch.
extern "C" int hn_fields_bwd_trace(long long* out) {
  constexpr int kCount = fb::kGroups * fb::kTraceTiles * fb::kTraceKinds;
  static long long zero[kCount];
  int err = (int)cudaMemcpyFromSymbol(out, fb::fields_bwd_trace,
                                      sizeof(zero));
  if (err) return err;
  return (int)cudaMemcpyToSymbol(fb::fields_bwd_trace, zero, sizeof(zero));
}
#endif
