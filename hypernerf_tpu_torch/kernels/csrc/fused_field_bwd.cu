// One field MLP alone, backward, for Hopper (sm_90a).
//
// Replaces hypernerf_tpu/ops/pallas/fused_field.py `_fused_bwd` (:532, the
// tile body `_backward_tile_gen` :379-417 with the posenc VJP `_encode_bwd_gen`
// :233-266) for the two fields modular_fwd.cu computes.
//
// In:  x_raw (P, 11) fp32 [pts | embed] per sample, the optional window row,
//      g (P, 8) fp32 = d[output | 0], the field's packed bf16 weights, their
//      transposes and the biases.
// Out: dx_raw (P, 11) fp32 per sample (the caller sums the embedding's part
//      per ray), and fp32 dW / db of the field's seven layers in the packed
//      layout, added into one zeroed buffer.
// Per tile the forward is recomputed and walked back (field_bwd.cuh, the same
// device code as the level's fields backward): cotangent rounded to bf16
// before every product, ReLU masks from the stored bf16 outputs, db from the
// rounded cotangent on hidden layers and the fp32 one on the head, the posenc
// VJP from sincosf of the recompute's arguments with the window row scaling
// the encoding's cotangent.
//
// Bound: three multiply-adds per weight and sample (recompute, g W, g^T h):
// 0.6 MFLOP (warp) or 0.17 MFLOP (sheet) against 120 bytes moved, so
// operations bound it (2.1 M samples: 1.28 or 0.35 ms at the card's bf16
// peak).
// Design (level_bwd.cuh): a persistent grid, two blocks of 256 threads per SM,
// tiles of 32 rows in one shared-memory tile sized for the warp (68 KB), dW
// added with atomics straight into the one fp32 gradient buffer, which stays
// in L2; its last bits change from run to run. The tile's height, 32 rows per
// pass over the weights, is what limits it.

#include "field_bwd.cuh"

namespace {

template <class P, int LB, int F, int OUT>
__global__ void __launch_bounds__(CF::THREADS, 2)
field_bwd_kernel(const float* __restrict__ x_raw,
                 const float* __restrict__ scales,
                 const float* __restrict__ g_out, const bf16* __restrict__ W,
                 const bf16* __restrict__ Wt, const bf16* __restrict__ B,
                 float* __restrict__ dx_raw, float* __restrict__ grads,
                 long long n_points, long long n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);                        // [ROWS][LD]
  float* rowin = reinterpret_cast<float*>(X + CF::ROWS * CF::LD);  // [ROWS][12]
  float* hg = rowin + CF::ROWS * 12;   // [ROWS][8]: the head's fp32 cotangent
  float* dacc = hg + CF::ROWS * 8;     // [ROWS][12]: d[pts | embed]

  // The blobs and the gradient buffer hold this field's layers alone; the
  // helpers index them by the level's layer table.
  const bf16* Wl = W - weight_offset(LB);
  const bf16* Wtl = Wt - weight_offset(LB);
  const bf16* Bl = B - bias_offset(LB);
  float* grad_w = grads - weight_offset(LB);
  float* grad_b = grads + (weight_offset(LB + 7) - weight_offset(LB)) -
                  bias_offset(LB);
  const int tid = threadIdx.x;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * CF::ROWS;
    for (int e = tid; e < CF::ROWS * 12; e += CF::THREADS) {
      const int r = e / 12, c = e % 12;
      const long long p = row0 + r;
      rowin[e] = (c < 3 + kEmbed && p < n_points)
                     ? x_raw[p * (3 + kEmbed) + c]
                     : 0.f;
    }
    // Cotangents are zero on rows past the end: they add nothing.
    for (int e = tid; e < CF::ROWS * 8; e += CF::THREADS) {
      const int r = e / 8, c = e % 8;
      const long long p = row0 + r;
      hg[e] = (c < OUT && p < n_points) ? g_out[p * 8 + c] : 0.f;
    }
    __syncthreads();
    field_bwd<P, LB, F>(X, rowin, hg, dacc, Wl, Wtl, Bl, grad_w, grad_b,
                        scales);
    for (int e = tid; e < CF::ROWS * (3 + kEmbed); e += CF::THREADS) {
      const int r = e / (3 + kEmbed), c = e % (3 + kEmbed);
      if (row0 + r < n_points)
        dx_raw[(row0 + r) * (3 + kEmbed) + c] = dacc[r * 12 + c];
    }
    __syncthreads();
  }
}

constexpr size_t kSmemFB = sizeof(bf16) * CF::ROWS * CF::LD +
                           sizeof(float) * CF::ROWS * (12 + 8 + 12);

template <class P, int LB, int F, int OUT>
int launch_field_bwd(const void* x_raw, const void* scales, const void* g,
                     const void* W, const void* Wt, const void* B,
                     void* dx_raw, void* grads, long long n_points,
                     int blocks, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      field_bwd_kernel<P, LB, F, OUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemFB);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n_points + CF::ROWS - 1) / CF::ROWS;
  field_bwd_kernel<P, LB, F, OUT>
      <<<blocks, CF::THREADS, kSmemFB, (cudaStream_t)stream>>>(
          static_cast<const float*>(x_raw), static_cast<const float*>(scales),
          static_cast<const float*>(g), static_cast<const bf16*>(W),
          static_cast<const bf16*>(Wt), static_cast<const bf16*>(B),
          static_cast<float*>(dx_raw), static_cast<float*>(grads), n_points,
          tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of the persistent grid for n_points samples: two per SM, never more
// than there are tiles.
extern "C" int hn_fused_field_bwd_blocks(long long n_points) {
  const long long tiles = (n_points + CF::ROWS - 1) / CF::ROWS;
  const long long most = 2LL * sm_count();
  return (int)(tiles < most ? tiles : most);
}

// which: 0 the warp field, 1 the hyper sheet. weights, weights_t, biases:
// that field's seven layers alone. grads: [dW | db] of those layers in the
// packed layout, which every block adds into; it must be zero on entry.
extern "C" int hn_fused_field_bwd(int which, const void* x_raw,
                                  const void* scales, const void* g,
                                  const void* weights, const void* weights_t,
                                  const void* biases, void* dx_raw,
                                  void* grads, long long n_points, int blocks,
                                  void* stream) {
  if (n_points <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  if (which == 0)
    return launch_field_bwd<WarpPlan, 0, kWarpF, 3>(
        x_raw, scales, g, weights, weights_t, biases, dx_raw, grads, n_points,
        blocks, stream);
  if (which == 1)
    return launch_field_bwd<HypPlan, 7, kHypF, kHypOut>(
        x_raw, scales, g, weights, weights_t, biases, dx_raw, grads, n_points,
        blocks, stream);
  return (int)cudaErrorInvalidValue;
}
