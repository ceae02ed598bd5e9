// The translation warp's Jacobian, forward, for Hopper (sm_90a).
//
// Replaces hypernerf_tpu/ops/pallas/fused_jacobian.py `_fused_fwd` (:269, the
// tile body `_jac_fwd_tile` :132-165 with the tangent encoding
// `_tangent_encode` :76-100) for the flagship's warp field: posenc_orig(pts,
// 10) ++ embed (71 -> 80) -> 6 x 128 (skip after layer 4) -> 3, bf16.
//
// In:  x_raw (P, 11) fp32 rows [pts (3) | embed (8)], one per sample; the
//      field's packed bf16 weights (out, in) and biases.
// Out: J (P, 9) fp32, J[p][i * 3 + k] = d warped_i / d p_k = delta_ik +
//      d translation_i / d p_k (the jacrev layout; the identity is added
//      here).
// The three coordinate tangents ride the MLP as three more row blocks
// (jacobian.cuh): the tangent encoding [e_k | cos * 2^j | -sin * 2^j on
// channel k | 0] rounded to bf16; hidden layers t <- bf16((t W) * mask) with
// the mask of the primal row's fp32 pre-activation; the skip concatenates the
// tangent encoding; the head is linear, fp32 and without bias. Rounding points
// are the TPU kernel's.
//
// Bound: 100,480 multiply-adds per sample and row block, four row blocks,
// against 44 + 36 bytes moved per sample, so operations bound it (262,144
// samples: 0.21 ms at the card's bf16 peak).
// Design: fused_field.cu's plan h_a | enc | h_b on 16 points (64 rows, the
// four blocks), mma.sync m16n8k16 with the weights from L2, one weight
// fragment per k-step for all four blocks; the ReLU mask of a tangent element
// comes from the same thread's primal accumulator. Two blocks fit an SM.

#include "jacobian.cuh"

namespace {

constexpr int kColA14 = 0, kColEnc14 = kWarpW, kColB14 = kWarpW + kWarpEncP;
using C14 = JC<16, 2 * kWarpW + kWarpEncP + 8>;
constexpr size_t kSmem14 = sizeof(bf16) * C14::ROWS * C14::LD +
                           sizeof(float) * (C14::R * 12 + C14::ROWS * 8);

__global__ void __launch_bounds__(C14::THREADS, 2)
jacobian_fwd_kernel(const float* __restrict__ x_raw,
                    const bf16* __restrict__ W, const bf16* __restrict__ B,
                    float* __restrict__ jac, long long n_points) {
  using C = C14;
  using T = TransTable;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);                      // [ROWS][LD]
  float* rowin = reinterpret_cast<float*>(X + C::ROWS * C::LD);  // [R][12]
  float* head = rowin + C::R * 12;                               // [ROWS][8]

  const long long p0 = (long long)blockIdx.x * C::R;
  const int tid = threadIdx.x;
  // Points past the end read zeros and are not written.
  for (int e = tid; e < C::R * 12; e += C::THREADS) {
    const int q = e / 12, c = e % 12;
    const long long p = p0 + q;
    rowin[e] = (c < 3 + kEmbed && p < n_points) ? x_raw[p * (3 + kEmbed) + c]
                                                : 0.f;
  }
  __syncthreads();
  encode_trans_streams<C, kWarpF, kWarpEncP>(X, kColEnc14, rowin);
  __syncthreads();
  jac_layer<C, 0, true, T>(X, kColEnc14, kColA14, W, B);
  jac_layer<C, 1, true, T>(X, kColA14, kColB14, W, B);
  jac_layer<C, 2, true, T>(X, kColB14, kColA14, W, B);
  jac_layer<C, 3, true, T>(X, kColA14, kColB14, W, B);
  jac_layer<C, 4, true, T>(X, kColB14, kColA14, W, B);
  jac_layer<C, 5, true, T>(X, kColA14, kColB14, W, B);  // [h4 | enc]
  jac_head<C, 6, T>(X, kColB14, W, B, head);
  for (int e = tid; e < C::R * 9; e += C::THREADS) {
    const int q = e / 9, i = (e % 9) / 3, k = e % 3;
    if (p0 + q < n_points)
      jac[(p0 + q) * 9 + i * 3 + k] =
          (i == k ? 1.f : 0.f) + head[((1 + k) * C::R + q) * 8 + i];
  }
}

}  // namespace

// weights / biases: the warp field's seven layers (TransTable's 0..6).
extern "C" int hn_fused_jacobian_fwd(const void* x_raw, const void* weights,
                                     const void* biases, void* jac,
                                     long long n_points, void* stream) {
  if (n_points <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      jacobian_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem14);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_points + C14::R - 1) / C14::R;
  jacobian_fwd_kernel<<<(unsigned)blocks, C14::THREADS, kSmem14,
                        (cudaStream_t)stream>>>(
      static_cast<const float*>(x_raw), static_cast<const bf16*>(weights),
      static_cast<const bf16*>(biases), static_cast<float*>(jac), n_points);
  return (int)cudaGetLastError();
}
