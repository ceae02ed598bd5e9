// The SE(3) / quaternion trunk's primal (w, v) and their point-tangents,
// forward, for Hopper (sm_90a).
//
// Replaces hypernerf_tpu/ops/pallas/fused_se3_jacobian.py `_fused_fwd`
// (:286, the tile body `_jac_fwd_tile` :112-151 with the tangent encoding
// `_tangent_encode` :59-80) for the flagship's trunk (modular_fwd.cu's):
// Nerfies posenc(pts, degrees 0..8, no identity) ++ embed (56 -> 64) -> 6 x 128
// (skip after layer 4) -> linear 128 -> 128 -> the w and v heads, bf16.
//
// In:  x_raw (P, 11) fp32 rows [pts (3) | embed (8)]; an optional window row
//      `scales` (64 fp32 weights); the trunk's nine packed bf16 layers and
//      biases.
// Out: (P, 24) fp32 per point: [w (3) | v (3) | dw (9) | dv (9)], dw[i * 3 +
//      k] = d w_i / d p_k (dv alike). The retraction and its point-Jacobian
//      are the caller's (ops.rigid_body, ops.quaternion).
// The three coordinate tangents ride the trunk as three more row blocks
// (jacobian.cuh): the tangent encoding [cos * 2^m | -sin * 2^m on channel k
// | 0] times the window row, rounded once; hidden layers t <- bf16((t W) *
// mask); the trunk logit is linear, so its tangent passes unmasked (rounded to
// bf16 like its primal output, which carries the bias); the heads are linear
// and fp32, the bias on the primal rows alone. Rounding points are the TPU
// kernel's.
//
// Bound: 113,408 multiply-adds per sample and row block, four blocks, against
// 44 + 96 bytes moved per sample, so operations bound it (262,144 samples:
// 0.24 ms at the card's bf16 peak).
// Design (as fused_jacobian.cu): a column plan h_a | enc | h_b on 16
// points (64 rows), one weight fragment per k-step for all four blocks; the
// two heads run one after the other on warp 0. Two blocks fit an SM.

#include "jacobian.cuh"

namespace {

constexpr int kColA16 = 0, kColEnc16 = kSe3W, kColB16 = kSe3W + kSe3EncP;
using C16 = JC<16, 2 * kSe3W + kSe3EncP + 8>;
constexpr size_t kSmem16 = sizeof(bf16) * C16::ROWS * C16::LD +
                           sizeof(float) * (C16::R * 12 + 2 * C16::ROWS * 8);

__global__ void __launch_bounds__(C16::THREADS, 2)
se3_jacobian_fwd_kernel(const float* __restrict__ x_raw,
                        const float* __restrict__ scales,
                        const bf16* __restrict__ W,
                        const bf16* __restrict__ B, float* __restrict__ out,
                        long long n_points) {
  using C = C16;
  using T = Se3Table;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);                      // [ROWS][LD]
  float* rowin = reinterpret_cast<float*>(X + C::ROWS * C::LD);  // [R][12]
  float* hw = rowin + C::R * 12;                                 // [ROWS][8]
  float* hv = hw + C::ROWS * 8;                                  // [ROWS][8]

  const long long p0 = (long long)blockIdx.x * C::R;
  const int tid = threadIdx.x;
  for (int e = tid; e < C::R * 12; e += C::THREADS) {
    const int q = e / 12, c = e % 12;
    const long long p = p0 + q;
    rowin[e] = (c < 3 + kEmbed && p < n_points) ? x_raw[p * (3 + kEmbed) + c]
                                                : 0.f;
  }
  __syncthreads();
  encode_se3_streams<C>(X, kColEnc16, rowin, scales);
  __syncthreads();
  jac_layer<C, 0, true, T>(X, kColEnc16, kColA16, W, B);
  jac_layer<C, 1, true, T>(X, kColA16, kColB16, W, B);
  jac_layer<C, 2, true, T>(X, kColB16, kColA16, W, B);
  jac_layer<C, 3, true, T>(X, kColA16, kColB16, W, B);
  jac_layer<C, 4, true, T>(X, kColB16, kColA16, W, B);
  jac_layer<C, 5, true, T>(X, kColA16, kColB16, W, B);  // [h4 | enc]
  jac_layer<C, kSe3Trunk, false, T>(X, kColB16, kColA16, W, B);
  jac_head<C, kSe3HeadW, T>(X, kColA16, W, B, hw);
  jac_head<C, kSe3HeadV, T>(X, kColA16, W, B, hv);
  for (int e = tid; e < C::R * 24; e += C::THREADS) {
    const int q = e / 24, c = e % 24;
    if (p0 + q >= n_points) continue;
    float v;
    if (c < 6) {
      v = (c < 3 ? hw : hv)[q * 8 + c % 3];
    } else {
      const int d = c < 15 ? c - 6 : c - 15, i = d / 3, k = d % 3;
      v = (c < 15 ? hw : hv)[((1 + k) * C::R + q) * 8 + i];
    }
    out[(p0 + q) * 24 + c] = v;
  }
}

}  // namespace

// weights / biases: the trunk's nine layers alone (Se3Table's 0..8).
// scales: null, or 64 fp32 window weights.
extern "C" int hn_fused_se3_jacobian_fwd(const void* x_raw, const void* scales,
                                         const void* weights,
                                         const void* biases, void* out,
                                         long long n_points, void* stream) {
  if (n_points <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      se3_jacobian_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem16);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_points + C16::R - 1) / C16::R;
  se3_jacobian_fwd_kernel<<<(unsigned)blocks, C16::THREADS, kSmem16,
                            (cudaStream_t)stream>>>(
      static_cast<const float*>(x_raw), static_cast<const float*>(scales),
      static_cast<const bf16*>(weights), static_cast<const bf16*>(biases),
      static_cast<float*>(out), n_points);
  return (int)cudaGetLastError();
}
