// The SE(3) / quaternion warp field's trunk alone, forward, for Hopper
// (sm_90a).
//
// Replaces hypernerf_tpu/ops/pallas/fused_se3.py `_fused` (:374, the tile body
// `_forward_tile_gen` :200-226 over `_encode_gen` :91-112) for the flagship's
// SE(3) field: Nerfies posenc(pts, degrees 0..8, no identity) ++ embed
// (56 -> 64) -> 6 x 128 (skip after layer 4) -> linear 128 -> 128 -> the w and
// the v head, 128 -> 3 each; bf16.
//
// In:  x_raw (P, 11) fp32 rows [pts (3) | embed (8)], one per sample; an
//      optional window row `scales` (64 fp32 weights); the trunk's nine packed
//      bf16 layers (out, in) and biases.
// Out: (P, 8) fp32 [w (3) | v (3) | 0 0]. The retraction (w, v, pts) -> warped
//      is the caller's.
// Rounding points are the TPU kernel's: the encoding is rounded to bf16 (then
// times the window row, rounded again), products take bf16 operands with fp32
// accumulation, bf16 biases added in fp32, ReLU then a rounding on hidden
// layers, the trunk logit rounded without a ReLU, the heads stay fp32.
//
// Bound: 113,408 multiply-adds per sample against 76 bytes moved, so
// operations bound it (1 M samples: 0.24 ms at the card's bf16 peak).
// Design (as fused_field.cu): a block of 256 threads takes 64 rows and keeps
// their activations in one shared-memory tile h_a | enc | h_b; a layer reads
// one column range and writes the other, as mma.sync m16n8k16 products with
// the weights from L2 (level_bwd.cuh); the two heads run side by side on two
// warps. Two blocks fit an SM.

#include "se3_trunk.cuh"

namespace {

constexpr int kColA = 0, kColEnc = kSe3W, kColB = kSe3W + kSe3EncP;
using C12 = Cfg<4, 2 * kSe3W + kSe3EncP + 8, 8>;
constexpr size_t kSmem12 = sizeof(bf16) * C12::ROWS * C12::LD +
                           sizeof(float) * C12::ROWS * (12 + 8);

__global__ void __launch_bounds__(C12::THREADS, 2)
se3_fwd_kernel(const float* __restrict__ x_raw,
               const float* __restrict__ scales, const bf16* __restrict__ W,
               const bf16* __restrict__ B, float* __restrict__ out,
               long long n_points) {
  using C = C12;
  using T = Se3Table;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);                      // [ROWS][LD]
  float* rowin = reinterpret_cast<float*>(X + C::ROWS * C::LD);  // [ROWS][12]
  float* wv = rowin + C::ROWS * 12;                              // [ROWS][8]

  const long long row0 = (long long)blockIdx.x * C::ROWS;
  const int tid = threadIdx.x;
  // Rows past the end read zeros and are not written.
  for (int e = tid; e < C::ROWS * 12; e += C::THREADS) {
    const int r = e / 12, c = e % 12;
    const long long p = row0 + r;
    rowin[e] = (c < 3 + kEmbed && p < n_points) ? x_raw[p * (3 + kEmbed) + c]
                                                : 0.f;
  }
  __syncthreads();
  encode_se3<C>(X, kColEnc, rowin, scales);
  __syncthreads();
  fwd_layer<C, 0, true, T>(X, kColEnc, kColA, W, B);
  fwd_layer<C, 1, true, T>(X, kColA, kColB, W, B);
  fwd_layer<C, 2, true, T>(X, kColB, kColA, W, B);
  fwd_layer<C, 3, true, T>(X, kColA, kColB, W, B);
  fwd_layer<C, 4, true, T>(X, kColB, kColA, W, B);
  fwd_layer<C, 5, true, T>(X, kColA, kColB, W, B);  // [h4 | enc]
  fwd_layer<C, kSe3Trunk, false, T>(X, kColB, kColA, W, B);
  se3_heads_fwd<C>(X, kColA, W, B, wv);
  for (int e = tid; e < C::ROWS * 2; e += C::THREADS) {
    const int r = e / 2, half = e % 2;
    if (row0 + r < n_points)
      reinterpret_cast<float4*>(out)[(row0 + r) * 2 + half] =
          reinterpret_cast<const float4*>(wv)[e];
  }
}

}  // namespace

// weights / biases: the trunk's nine layers alone (Se3Table's layers 0..8).
// scales: null, or 64 fp32 window weights.
extern "C" int hn_fused_se3_fwd(const void* x_raw, const void* scales,
                                const void* weights, const void* biases,
                                void* out, long long n_points, void* stream) {
  if (n_points <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      se3_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem12);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_points + C12::ROWS - 1) / C12::ROWS;
  se3_fwd_kernel<<<(unsigned)blocks, C12::THREADS, kSmem12,
                   (cudaStream_t)stream>>>(
      static_cast<const float*>(x_raw), static_cast<const float*>(scales),
      static_cast<const bf16*>(weights), static_cast<const bf16*>(biases),
      static_cast<float*>(out), n_points);
  return (int)cudaGetLastError();
}
