// One field MLP alone, forward, for Hopper (sm_90a).
//
// Replaces hypernerf_tpu/ops/pallas/fused_field.py `_fused` (:495, the tile
// body `_forward_tile_gen` :331-354 over `_encode_gen` :181-213) for the two
// fields of the flagship: the warp field (posenc_orig(pts, 10) ++ embed ->
// 6 x 128 -> 3) and the hyper sheet (posenc_orig(pts, 7) ++ embed -> 6 x 64
// -> 4), skip after layer 4, bf16.
//
// In:  x_raw (P, 11) fp32 rows [pts (3) | embed (8)], one per sample (the
//      embedding arrives already broadcast over a ray's samples); an optional
//      window row `scales` (padded encoding width, fp32); the field's packed
//      bf16 weights (out, in) and biases.
// Out: (P, 8) fp32 [MLP output | 0]. The warp's residual (pts + output) is
//      the caller's.
// Rounding points are the level kernel's (level_fwd.cuh): the encoding is
// rounded to bf16 (then times the window row, rounded again), products take
// bf16 operands with fp32 accumulation, bf16 biases added in fp32, ReLU then
// a rounding on hidden layers, the head stays fp32.
//
// Bound: 100,480 (warp) or 27,520 (sheet) multiply-adds per sample against
// 76 bytes moved, so operations bound it (2.1 M samples: 0.43 or 0.12 ms at
// the card's bf16 peak).
// Design: a block of 256 threads takes 64 rows and keeps their activations in
// one shared-memory tile; a layer reads one column range and writes another
// (two hidden ranges taken in turns, the encoding between them so that the
// skip layer's [h4 | enc] is one K range), as mma.sync m16n8k16 products with
// the weights from L2 (level_bwd.cuh). Two blocks fit an SM.

#include "field_bwd.cuh"

namespace {

// A field of the level's layer table (layers LB .. LB + 6), F bands, OUT
// outputs, and the column plan of its forward tile: h_a | enc | h_b.
template <int LB_, int F_, int OUT_>
struct Field {
  static constexpr int LB = LB_, F = F_, OUT = OUT_;
  static constexpr int W = layer_shape(LB_).n, E = layer_shape(LB_).k;
  static constexpr int colA = 0, colEnc = W, colB = W + E;
  using C = Cfg<4, 2 * W + E + 8, 8>;
  static constexpr size_t smem = sizeof(bf16) * C::ROWS * C::LD +
                                 sizeof(float) * C::ROWS * (12 + 8);
};
using WarpField = Field<0, kWarpF, 3>;
using SheetField = Field<7, kHypF, kHypOut>;

template <class FD>
__global__ void __launch_bounds__(FD::C::THREADS, 2)
field_fwd_kernel(const float* __restrict__ x_raw,
                 const float* __restrict__ scales,
                 const bf16* __restrict__ W, const bf16* __restrict__ B,
                 float* __restrict__ out, long long n_points) {
  using C = typename FD::C;
  constexpr int LB = FD::LB;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);                      // [ROWS][LD]
  float* rowin = reinterpret_cast<float*>(X + C::ROWS * C::LD);  // [ROWS][12]
  float* head = rowin + C::ROWS * 12;                            // [ROWS][8]
  // The blobs hold this field's layers alone; the helpers index them by the
  // level's layer table.
  const bf16* Wl = W - weight_offset(LB);
  const bf16* Bl = B - bias_offset(LB);

  const long long row0 = (long long)blockIdx.x * C::ROWS;
  const int tid = threadIdx.x;
  for (int e = tid; e < C::ROWS * 12; e += C::THREADS) {
    const int r = e / 12, c = e % 12;
    const long long p = row0 + r;
    rowin[e] = (c < 3 + kEmbed && p < n_points) ? x_raw[p * (3 + kEmbed) + c]
                                                : 0.f;
  }
  __syncthreads();
  encode_field<C, FD::F, FD::E>(X, FD::colEnc, rowin, scales);
  __syncthreads();
  fwd_layer<C, LB + 0, true>(X, FD::colEnc, FD::colA, Wl, Bl);
  fwd_layer<C, LB + 1, true>(X, FD::colA, FD::colB, Wl, Bl);
  fwd_layer<C, LB + 2, true>(X, FD::colB, FD::colA, Wl, Bl);
  fwd_layer<C, LB + 3, true>(X, FD::colA, FD::colB, Wl, Bl);
  fwd_layer<C, LB + 4, true>(X, FD::colB, FD::colA, Wl, Bl);
  fwd_layer<C, LB + 5, true>(X, FD::colA, FD::colB, Wl, Bl);  // [h4 | enc]
  head_fwd<C, LB + 6>(X, FD::colB, Wl, Bl, head);
  for (int e = tid; e < C::ROWS * 8; e += C::THREADS) {
    const int r = e / 8, c = e % 8;
    if (row0 + r < n_points)
      out[(row0 + r) * 8 + c] = c < FD::OUT ? head[e] : 0.f;
  }
}

template <class FD>
int launch_field_fwd(const void* x_raw, const void* scales, const void* W,
                     const void* B, void* out, long long n_points,
                     void* stream) {
  using C = typename FD::C;
  cudaError_t err = cudaFuncSetAttribute(
      field_fwd_kernel<FD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FD::smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_points + C::ROWS - 1) / C::ROWS;
  field_fwd_kernel<FD><<<(unsigned)blocks, C::THREADS, FD::smem,
                         (cudaStream_t)stream>>>(
      static_cast<const float*>(x_raw), static_cast<const float*>(scales),
      static_cast<const bf16*>(W), static_cast<const bf16*>(B),
      static_cast<float*>(out), n_points);
  return (int)cudaGetLastError();
}

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
    return launch_field_fwd<WarpField>(x_raw, scales, weights, biases, out,
                                       n_points, stream);
  if (which == 1)
    return launch_field_fwd<SheetField>(x_raw, scales, weights, biases, out,
                                        n_points, stream);
  return (int)cudaErrorInvalidValue;
}
