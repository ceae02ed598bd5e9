// The translation warp's Jacobian, backward, for Hopper (sm_90a).
//
// Replaces hypernerf_tpu/ops/pallas/fused_jacobian.py `_fused_bwd` (:302, the
// tile body `_jac_bwd_tile` :168-208 with the tangent encoding's pullback
// `_tangent_encode_bwd` :103-129) for the field fused_jacobian.cu computes.
//
// In:  x_raw (P, 11) fp32 [pts | embed] per sample, g (P, 9) fp32 = dJ in J's
//      layout, the field's packed bf16 weights, their transposes and the
//      biases.
// Out: dx_raw (P, 11) fp32 = [d pts | 0]: d embed is exactly zero (the
//      embedding reaches J only through the ReLU masks, whose derivative is
//      zero), and fp32 dW of the seven layers in the packed layout, added into
//      one zeroed buffer; db is exactly zero (biases reach J only through the
//      masks), so the bias part of the buffer stays untouched.
// Only J carries a cotangent, so it flows down the tangent rows alone: the
// recompute (the forward's rounding) keeps every layer's tangent input and
// primal activation (the mask); then dW_head = t5^T g, g <- (g W_head) * mask5,
// and per hidden layer dW = t_in^T g, g <- (g W) * mask_below; the skip part
// and layer 0's part of the encoding's cotangent are summed and pulled back
// through the tangent encoding (the 4^j diagonal terms) to d pts.
// Rounding points: as the TPU kernel, which multiplies its fp32 cotangent by
// the bf16 weights and tangents without rounding it, the cotangent stays
// fp32: the head's dW and g W_head take the fp32 values, and every stored
// cotangent is an fp32 value held as two bf16 halves hi + lo (jacobian.cuh),
// which both enter every product: 16 mantissa bits, a relative error under
// 2^-16 per entry. Everything else sums in fp32.
//
// Bound: the recompute (100,480 multiply-adds per sample and row block, four
// blocks) and g W and t^T g on the three tangent blocks: 1.0 M multiply-adds
// per sample against 44 + 36 + 44 bytes, so operations bound it (262,144
// samples: 0.53 ms at the card's bf16 peak; the two halves double the work of
// the products, which is not counted).
// Design (level_bwd.cuh): a persistent grid, two blocks of 256 threads per SM,
// tiles of 8 points (32 rows: the four blocks) in one shared-memory tile
// (81 KB): h0..h4 | enc | h5 | g_hi | g_lo. The primal rows of the cotangent
// stay zero and ride the products with the tangent rows. dW is added with
// atomics straight into the one fp32 gradient buffer, which stays in L2; its
// last bits change from run to run.

#include "jacobian.cuh"

namespace {

using P15 = WarpPlan;                           // h0..h4 | enc | h5
constexpr int kW15 = kWarpW + kWarpEncP;        // cotangent width: 208
constexpr int kG15 = P15::g;                    // g_hi | g_lo
constexpr int kLd15 = P15::g + 2 * kW15 + 8;    // 1272
using C15 = JC<8, kLd15>;
constexpr size_t kSmem15 =
    sizeof(bf16) * C15::ROWS * C15::LD +
    sizeof(float) * (C15::R * 12 + C15::ROWS * 8 + C15::R * 12);

// Hidden layer I back: dW, then the cotangent through it (db stays zero).
template <int I>
__device__ __forceinline__ void jac_back15(bf16* X, const bf16* Wt,
                                           float* grad_w) {
  jac_dw_split<C15, I, TransTable, kW15>(X, kG15, P15::in(I), grad_w);
  jac_dx_split<C15, I, TransTable, kW15>(
      X, kG15, kG15, Wt, I > 0 ? P15::h(I > 0 ? I - 1 : 0) : 0,
      I > 0 ? kWarpW : 0);
}

__global__ void __launch_bounds__(C15::THREADS, 2)
jacobian_bwd_kernel(const float* __restrict__ x_raw,
                    const float* __restrict__ g_jac,
                    const bf16* __restrict__ W, const bf16* __restrict__ Wt,
                    const bf16* __restrict__ B, float* __restrict__ dx_raw,
                    float* __restrict__ grad_w, long long n_points,
                    long long n_tiles) {
  using C = C15;
  using T = TransTable;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);                      // [ROWS][LD]
  float* rowin = reinterpret_cast<float*>(X + C::ROWS * C::LD);  // [R][12]
  float* hg = rowin + C::R * 12;     // [ROWS][8]: the head's cotangent
  float* dacc = hg + C::ROWS * 8;    // [R][12]: d pts
  constexpr int kHead = 6;
  const int tid = threadIdx.x;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long p0 = tile * C::R;
    for (int e = tid; e < C::R * 12; e += C::THREADS) {
      const int q = e / 12, c = e % 12;
      const long long p = p0 + q;
      rowin[e] = (c < 3 + kEmbed && p < n_points)
                     ? x_raw[p * (3 + kEmbed) + c]
                     : 0.f;
    }
    // Tangent row k of point q takes column k of dJ: hg[(1 + k) R + q][i] =
    // g[q][i * 3 + k]. Primal rows and points past the end: zero.
    for (int e = tid; e < C::ROWS * 8; e += C::THREADS) {
      const int r = e / 8, i = e % 8;
      const int s = r / C::R, q = r % C::R;
      const long long p = p0 + q;
      hg[e] = (s > 0 && i < 3 && p < n_points)
                  ? g_jac[p * 9 + i * 3 + (s - 1)]
                  : 0.f;
    }
    __syncthreads();
    encode_trans_streams<C, kWarpF, kWarpEncP>(X, P15::enc, rowin);
    __syncthreads();
    jac_layer<C, 0, true, T>(X, P15::in(0), P15::h(0), W, B);
    jac_layer<C, 1, true, T>(X, P15::in(1), P15::h(1), W, B);
    jac_layer<C, 2, true, T>(X, P15::in(2), P15::h(2), W, B);
    jac_layer<C, 3, true, T>(X, P15::in(3), P15::h(3), W, B);
    jac_layer<C, 4, true, T>(X, P15::in(4), P15::h(4), W, B);
    jac_layer<C, 5, true, T>(X, P15::in(5), P15::h(5), W, B);

    // The head: dW[n][k] += sum_r g[r][n] t5[r][k] with the fp32 g, and
    // g5 = (g W_head) * mask5 split into two halves.
    {
      const bf16* wh = W + weight_offset<T>(kHead);
      float* dw = grad_w + weight_offset<T>(kHead);
      for (int e = tid; e < 8 * kWarpW; e += C::THREADS) {
        const int n = e / kWarpW, k = e % kWarpW;
        float s = 0.f;
        for (int r = C::R; r < C::ROWS; ++r)
          s += hg[r * 8 + n] * bf2f(X[r * C::LD + P15::h(5) + k]);
        atomicAdd(dw + e, s);
      }
      for (int e = tid; e < C::ROWS * kWarpW; e += C::THREADS) {
        const int r = e / kWarpW, k = e % kWarpW;
        float v = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          v += hg[r * 8 + n] * bf2f(wh[n * kWarpW + k]);
        if (!(bf2f(X[(r % C::R) * C::LD + P15::h(5) + k]) > 0.f)) v = 0.f;
        bf16* o = X + r * C::LD + kG15 + k;
        split_bf(v, o, o + kW15);
      }
      __syncthreads();
    }
    jac_back15<5>(X, Wt, grad_w);  // writes the skip part
    jac_back15<4>(X, Wt, grad_w);
    jac_back15<3>(X, Wt, grad_w);
    jac_back15<2>(X, Wt, grad_w);
    jac_back15<1>(X, Wt, grad_w);
    jac_back15<0>(X, Wt, grad_w);  // -> layer 0's part in g[0:80]

    // d pts from the tangent rows: the encoding's cotangent is layer 0's part
    // plus the skip part, each hi + lo, in fp32.
    for (int e = tid; e < C::R * 3; e += C::THREADS) {
      const int q = e / 3, c = e % 3;
      const bf16* gr = X + ((1 + c) * C::R + q) * C::LD + kG15;
      auto gx = [&](int f) {
        return (bf2f(gr[f]) + bf2f(gr[kW15 + f])) +
               (bf2f(gr[kWarpW + f]) + bf2f(gr[kW15 + kWarpW + f]));
      };
      dacc[q * 12 + c] = tangent_encode_dp<kWarpF, 0>(
          rowin[q * 12 + c], c, 3, 3 + 3 * kWarpF, gx);
    }
    __syncthreads();
    for (int e = tid; e < C::R * (3 + kEmbed); e += C::THREADS) {
      const int q = e / (3 + kEmbed), c = e % (3 + kEmbed);
      if (p0 + q < n_points)
        dx_raw[(p0 + q) * (3 + kEmbed) + c] = c < 3 ? dacc[q * 12 + c] : 0.f;
    }
    __syncthreads();
  }
}

}  // namespace

// Blocks of the persistent grid for n_points samples: two per SM, never more
// than there are tiles.
extern "C" int hn_fused_jacobian_bwd_blocks(long long n_points) {
  const long long tiles = (n_points + C15::R - 1) / C15::R;
  const long long most = 2LL * sm_count();
  return (int)(tiles < most ? tiles : most);
}

// weights, weights_t, biases: the warp field's seven layers. grads: [dW | db]
// of those layers in the packed layout, which every block adds into; it must
// be zero on entry (its db part stays zero).
extern "C" int hn_fused_jacobian_bwd(const void* x_raw, const void* g,
                                     const void* weights,
                                     const void* weights_t,
                                     const void* biases, void* dx_raw,
                                     void* grads, long long n_points,
                                     int blocks, void* stream) {
  if (n_points <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      jacobian_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem15);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n_points + C15::R - 1) / C15::R;
  jacobian_bwd_kernel<<<blocks, C15::THREADS, kSmem15,
                        (cudaStream_t)stream>>>(
      static_cast<const float*>(x_raw), static_cast<const float*>(g),
      static_cast<const bf16*>(weights), static_cast<const bf16*>(weights_t),
      static_cast<const bf16*>(biases), static_cast<float*>(dx_raw),
      static_cast<float*>(grads), n_points, tiles);
  return (int)cudaGetLastError();
}
