// The SE(3) / quaternion warp field's trunk alone, backward, for Hopper
// (sm_90a).
//
// Replaces hypernerf_tpu/ops/pallas/fused_se3.py `_fused_bwd` (:412, the tile
// body `_backward_tile_gen` :234-282 with the encoding's VJP `_encode_bwd_gen`
// :126-151) for the trunk fused_se3.cu computes.
//
// In:  x_raw (P, 11) fp32 [pts | embed] per sample, the optional window row,
//      g (P, 8) fp32 = d[w | v | 0 0], the trunk's packed bf16 weights, their
//      transposes and the biases.
// Out: dx_raw (P, 11) fp32 per sample (the caller sums the embedding's part
//      per ray), and fp32 dW / db of the nine layers in the packed layout,
//      added into one zeroed buffer.
// Per tile the forward is recomputed and walked back (se3_trunk.cuh, the same
// device code as the level's fields backward in its screw-warp variants):
// g_w and g_v rounded to bf16 for the products while the heads' db sums the
// fp32 cotangent; the trunk logit's cotangent g_w W_w + g_v W_v rounded once,
// its db summing the rounded value, no ReLU mask on it; hidden layers' masks
// from the stored bf16 outputs; the skip part of the encoding's cotangent
// added in fp32; the window row on that cotangent; d pts from sincosf of the
// recompute's arguments (no identity term), d embed passing through.
//
// Bound: three multiply-adds per weight and sample (recompute, g W, g^T h):
// 0.68 MFLOP against 120 bytes moved, so operations bound it (2.1 M samples:
// 1.44 ms at the card's bf16 peak).
// Design (level_bwd.cuh): a persistent grid, two blocks of 256 threads per SM,
// tiles of 32 rows in one shared-memory tile (74 KB), dW added with atomics
// straight into the one fp32 gradient buffer, which stays in L2; its last
// bits change from run to run.

#include "se3_trunk.cuh"

namespace {

constexpr long long kGradW13 = weight_offset<Se3Table>(Se3Table::kWarp);

__global__ void __launch_bounds__(CS::THREADS, 2)
se3_bwd_kernel(const float* __restrict__ x_raw,
               const float* __restrict__ scales,
               const float* __restrict__ g_out, const bf16* __restrict__ W,
               const bf16* __restrict__ Wt, const bf16* __restrict__ B,
               float* __restrict__ dx_raw, float* __restrict__ grads,
               long long n_points, long long n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);                        // [ROWS][LD]
  float* rowin = reinterpret_cast<float*>(X + CS::ROWS * CS::LD);  // [ROWS][12]
  float* hgw = rowin + CS::ROWS * 12;  // [ROWS][8]: [d w | 0]
  float* hgv = hgw + CS::ROWS * 8;     // [ROWS][8]: [d v | 0]
  float* dacc = hgv + CS::ROWS * 8;    // [ROWS][12]: d[pts | embed]
  float* grad_b = grads + kGradW13;
  const int tid = threadIdx.x;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * CS::ROWS;
    for (int e = tid; e < CS::ROWS * 12; e += CS::THREADS) {
      const int r = e / 12, c = e % 12;
      const long long p = row0 + r;
      rowin[e] = (c < 3 + kEmbed && p < n_points)
                     ? x_raw[p * (3 + kEmbed) + c]
                     : 0.f;
    }
    // Cotangents are zero on rows past the end: they add nothing.
    for (int e = tid; e < CS::ROWS * 8; e += CS::THREADS) {
      const int r = e / 8, c = e % 8;
      const long long p = row0 + r;
      const bool on = c < 3 && p < n_points;
      hgw[e] = on ? g_out[p * 8 + c] : 0.f;
      hgv[e] = on ? g_out[p * 8 + 3 + c] : 0.f;
    }
    __syncthreads();
    se3_recompute<CS>(X, rowin, W, B, scales);
    se3_walk_back<CS>(X, rowin, hgw, hgv, dacc, W, Wt, grads, grad_b, scales);
    for (int e = tid; e < CS::ROWS * (3 + kEmbed); e += CS::THREADS) {
      const int r = e / (3 + kEmbed), c = e % (3 + kEmbed);
      if (row0 + r < n_points)
        dx_raw[(row0 + r) * (3 + kEmbed) + c] = dacc[r * 12 + c];
    }
    __syncthreads();
  }
}

constexpr size_t kSmem13 = sizeof(bf16) * CS::ROWS * CS::LD +
                           sizeof(float) * CS::ROWS * (12 + 8 + 8 + 12);

}  // namespace

// Blocks of the persistent grid for n_points samples: two per SM, never more
// than there are tiles.
extern "C" int hn_fused_se3_bwd_blocks(long long n_points) {
  const long long tiles = (n_points + CS::ROWS - 1) / CS::ROWS;
  const long long most = 2LL * sm_count();
  return (int)(tiles < most ? tiles : most);
}

// weights, weights_t, biases: the trunk's nine layers alone. grads: [dW | db]
// of those layers in the packed layout, which every block adds into; it must
// be zero on entry.
extern "C" int hn_fused_se3_bwd(const void* x_raw, const void* scales,
                                const void* g, const void* weights,
                                const void* weights_t, const void* biases,
                                void* dx_raw, void* grads, long long n_points,
                                int blocks, void* stream) {
  if (n_points <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      se3_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem13);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n_points + CS::ROWS - 1) / CS::ROWS;
  se3_bwd_kernel<<<blocks, CS::THREADS, kSmem13, (cudaStream_t)stream>>>(
      static_cast<const float*>(x_raw), static_cast<const float*>(scales),
      static_cast<const float*>(g), static_cast<const bf16*>(weights),
      static_cast<const bf16*>(weights_t), static_cast<const bf16*>(biases),
      static_cast<float*>(dx_raw), static_cast<float*>(grads), n_points,
      tiles);
  return (int)cudaGetLastError();
}
