// Building blocks of the field backward kernels (the SE(3) and Jacobian
// backwards through field_bwd.cuh, se3_trunk.cuh, jacobian.cuh); the
// Jacobians' forward kernels (jacobian.cuh) take gemm and fwd_layer from
// here too. (The template backward, kernel A, works a layer at a time over a
// stash instead: template_rowprod.cu, template_dw.cu; the level's fields
// backward, kernel B, keeps a 128-row block tile resident: fields_bwd.cuh.)
//
// These kernels work the same way. A block takes tiles of C::ROWS sample rows,
// one after the other (a persistent grid). For a tile it recomputes the
// forward, keeping EVERY layer's bf16 output in one shared-memory tile
// X[ROWS][LD] (each layer has its own columns; the input of a skip layer sits
// right after the hidden columns it is concatenated to), then walks back with
// the cotangent held in bf16 in a region G of the same tile:
//   dW_l += g^T h_in   tensor cores, both operands read transposed from
//                      shared memory with ldmatrix.trans, fp32 accumulation,
//                      added into the one fp32 gradient buffer in device
//                      memory (`grad_w` below) with reductions: atomic adds
//                      whose result nobody waits for, so the memory's latency
//                      stays off the warp's path;
//   db_l += sum_r g    fp32 sum of the bf16-rounded cotangent (hidden
//                      layers) or of the fp32 one (heads);
//   g    <- bf16(g W)  tensor cores with W^T from L2, masked by the stored
//                      output of the layer below (ReLU), written in place.
// The buffer (2.8 MB for the template, 0.53 MB for the fields) stays in the
// 50 MB L2, so the adds never reach device memory. With one private buffer
// per block and a sum at the end (370 MB for the template) every tile's adds
// went to device memory and the kernels ran at its rate (measured on an H100:
// 249 ms against 136 ms for the template backward at 2.1 M samples, 56
// against 29 ms for the fields); 1, 2, 4 or 8 shared buffers took the same
// time, so there is one. Blocks add in an order that changes from run to run,
// so the last bits of dW / db are not deterministic. The narrow heads
// (out <= 4, padded to 8) run as scalar loops: they are under 1 % of the work.

#pragma once

#include "level_common.cuh"

namespace {

// MT m16 row tiles per block tile, LD row stride of X in bf16, NW warps.
template <int MT_, int LD_, int NW_>
struct Cfg {
  static constexpr int MT = MT_, ROWS = 16 * MT_, LD = LD_, NW = NW_;
  static constexpr int THREADS = 32 * NW_;
};

__device__ __forceinline__ float round_bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// n8 tiles per warp for an N-wide output.
template <class C, int N>
__host__ __device__ constexpr int tiles_per_warp() {
  return (N / 8 + C::NW - 1) / C::NW;
}

// acc[mt][i] = X[rows of m-tile mt, a_col : a_col + K] @ W^T for n8 tile
// j = warp + NW * i; W is (N, K) row-major in device memory.
template <class C, int N, int K>
__device__ __forceinline__ void gemm(
    const bf16* X, int a_col, const bf16* __restrict__ W,
    float (&acc)[C::MT][tiles_per_warp<C, N>()][4]) {
  constexpr int T = tiles_per_warp<C, N>();
  static_assert(K % 16 == 0 && N % 8 == 0, "mma tile");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][i][c] = 0.f;
  if (warp * 8 >= N) return;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t b[T][2];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int j = warp + C::NW * i;
      if (j * 8 < N) {
        const bf16* w = W + (size_t)(j * 8 + g) * K + k0 + 2 * t;
        b[i][0] = ldg32(w);
        b[i][1] = ldg32(w + 8);
      } else {
        b[i][0] = b[i][1] = 0u;
      }
    }
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
      const bf16* x = X + (mt * 16 + g) * C::LD + a_col + k0 + 2 * t;
      const uint32_t a0 = lds32(x), a1 = lds32(x + 8 * C::LD);
      const uint32_t a2 = lds32(x + 8), a3 = lds32(x + 8 * C::LD + 8);
#pragma unroll
      for (int i = 0; i < T; ++i)
        if ((warp + C::NW * i) * 8 < N)
          mma_bf16(acc[mt][i], a0, a1, a2, a3, b[i][0], b[i][1]);
    }
  }
}

// Recompute of hidden layer L: X[:, out_col : out_col + N] =
// bf16([relu](X[:, in_col : in_col + K] @ W_L^T + b_L)). The output columns
// are not the input's, so one barrier after the write is enough.
template <class C, int L, bool kRelu, class T = TransTable>
__device__ __forceinline__ void fwd_layer(bf16* X, int in_col, int out_col,
                                          const bf16* __restrict__ W,
                                          const bf16* __restrict__ B) {
  constexpr int N = layer_shape<T>(L).n, K = layer_shape<T>(L).k;
  constexpr int NT = tiles_per_warp<C, N>();
  float acc[C::MT][NT][4];
  gemm<C, N, K>(X, in_col, W + weight_offset<T>(L), acc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* bias = B + bias_offset<T>(L);
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int j = warp + C::NW * i;
    if (j * 8 >= N) continue;
    const int n = j * 8 + 2 * t;
    const float b0 = __bfloat162float(bias[n]);
    const float b1 = __bfloat162float(bias[n + 1]);
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
      const int r = mt * 16 + g;
      float v0 = acc[mt][i][0] + b0, v1 = acc[mt][i][1] + b1;
      float v2 = acc[mt][i][2] + b0, v3 = acc[mt][i][3] + b1;
      if (kRelu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
        v2 = fmaxf(v2, 0.f);
        v3 = fmaxf(v3, 0.f);
      }
      *reinterpret_cast<__nv_bfloat162*>(X + r * C::LD + out_col + n) =
          __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(X + (r + 8) * C::LD + out_col + n) =
          __floats2bfloat162_rn(v2, v3);
    }
  }
  __syncthreads();
}

// Forward of a head L (out <= 8 after padding): head[r][0:8] =
// fp32(X[:, in_col : in_col + K] @ W_L^T + b_L), one n8 tile on warp 0.
template <class C, int L, class T = TransTable>
__device__ __forceinline__ void head_fwd(const bf16* X, int in_col,
                                         const bf16* __restrict__ W,
                                         const bf16* __restrict__ B,
                                         float* head) {
  constexpr int K = layer_shape<T>(L).k;
  static_assert(layer_shape<T>(L).n == 8, "heads are padded to 8");
  float acc[C::MT][1][4];
  gemm<C, 8, K>(X, in_col, W + weight_offset<T>(L), acc);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (threadIdx.x < 32) {
    const bf16* bias = B + bias_offset<T>(L);
    const float b0 = __bfloat162float(bias[2 * t]);
    const float b1 = __bfloat162float(bias[2 * t + 1]);
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
      const int r = mt * 16 + g;
      head[r * 8 + 2 * t] = acc[mt][0][0] + b0;
      head[r * 8 + 2 * t + 1] = acc[mt][0][1] + b1;
      head[(r + 8) * 8 + 2 * t] = acc[mt][0][2] + b0;
      head[(r + 8) * 8 + 2 * t + 1] = acc[mt][0][3] + b1;
    }
  }
  __syncthreads();
}

// Cotangent through layer L: X[:, out_col : out_col + K] =
// bf16(X[:, g_col : g_col + N] @ W_L), zeroed where the stored activation
// X[:, mask_col + k] <= 0 for k < mask_w (the ReLU of the layer below; its
// skip input, k >= mask_w, has none). Wt holds W_L^T, (K, N) row-major. The
// output may overlap the input: everything is read before the barrier and
// written after it.
template <class C, int L, class T = TransTable>
__device__ __forceinline__ void bwd_dx(bf16* X, int g_col, int out_col,
                                       const bf16* __restrict__ Wt,
                                       int mask_col, int mask_w) {
  constexpr int N = layer_shape<T>(L).n, K = layer_shape<T>(L).k;
  constexpr int NT = tiles_per_warp<C, K>();
  float acc[C::MT][NT][4];
  gemm<C, K, N>(X, g_col, Wt + weight_offset<T>(L), acc);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int j = warp + C::NW * i;
    if (j * 8 >= K) continue;
    const int k = j * 8 + 2 * t;
    const bool masked = k < mask_w;  // mask_w is even: k, k + 1 alike
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        float v0 = acc[mt][i][2 * h], v1 = acc[mt][i][2 * h + 1];
        if (masked) {
          const __nv_bfloat162 m = *reinterpret_cast<const __nv_bfloat162*>(
              X + r * C::LD + mask_col + k);
          if (!(__low2float(m) > 0.f)) v0 = 0.f;
          if (!(__high2float(m) > 0.f)) v1 = 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(X + r * C::LD + out_col + k) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// dW_L[n][k] += sum_r X[r][g_col + n] * X[r][h_col + k] into the gradient
// buffer (same (N, K) layout as the weights; `grad_w` points at this kernel's
// first layer). A warp takes 16 x 16 pieces of dW: the m16n8k16 product with
// M = out, N = in, K = rows, so both operands are the transposes of what the
// tile stores, which ldmatrix.trans delivers. No barrier inside: it only
// reads X.
template <class C, int L, int L0, class T = TransTable>
__device__ __forceinline__ void bwd_dw(const bf16* X, int g_col, int h_col,
                                       float* __restrict__ grad_w) {
  constexpr int N = layer_shape<T>(L).n, K = layer_shape<T>(L).k;
  static_assert(N % 16 == 0 && K % 16 == 0, "16 x 16 pieces");
  float* dw = grad_w + (weight_offset<T>(L) - weight_offset<T>(L0));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q = lane >> 3, i8 = lane & 7;
  for (int unit = warp; unit < (N / 16) * (K / 16); unit += C::NW) {
    const int n0 = (unit / (K / 16)) * 16, k0 = (unit % (K / 16)) * 16;
    float c[2][4] = {};
#pragma unroll
    for (int rs = 0; rs < C::MT; ++rs) {
      uint32_t a[4], b[4];
      ldmatrix_x4_trans(a, X + (rs * 16 + (q >> 1) * 8 + i8) * C::LD + g_col +
                               n0 + (q & 1) * 8);
      ldmatrix_x4_trans(b, X + (rs * 16 + (q & 1) * 8 + i8) * C::LD + h_col +
                               k0 + (q >> 1) * 8);
      mma_bf16(c[0], a[0], a[1], a[2], a[3], b[0], b[1]);
      mma_bf16(c[1], a[0], a[1], a[2], a[3], b[2], b[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2* p = reinterpret_cast<float2*>(
            dw + (size_t)(n0 + g + 8 * h) * K + k0 + 8 * j + 2 * t);
        // No return value: a reduction, the warp does not wait for it.
        atomicAdd(p, make_float2(c[j][2 * h], c[j][2 * h + 1]));
      }
  }
}

// db_L[n] += sum_r float(X[r][g_col + n]): a hidden layer's bias gradient
// sums the bf16-rounded cotangent.
template <class C, int L, int L0, class T = TransTable>
__device__ __forceinline__ void bwd_db(const bf16* X, int g_col,
                                       float* __restrict__ grad_b) {
  constexpr int N = layer_shape<T>(L).n;
  float* db = grad_b + (bias_offset<T>(L) - bias_offset<T>(L0));
  for (int n = threadIdx.x; n < N; n += C::THREADS) {
    float s = 0.f;
    for (int r = 0; r < C::ROWS; ++r)
      s += __bfloat162float(X[r * C::LD + g_col + n]);
    atomicAdd(db + n, s);
  }
}

// A head L (out <= 8 after padding) with its fp32 cotangent hg[ROWS][8]
// (pad columns zero): dW_L[n][k] += sum_r bf16(hg[r][n]) * X[r][h_col + k]
// and db_L[n] += sum_r hg[r][n] (fp32, unrounded).
template <class C, int L, int L0, class T = TransTable>
__device__ __forceinline__ void head_dw_db(const bf16* X, int h_col,
                                           const float* hg,
                                           float* __restrict__ grad_w,
                                           float* __restrict__ grad_b) {
  constexpr int K = layer_shape<T>(L).k;
  static_assert(layer_shape<T>(L).n == 8, "heads are padded to 8");
  float* dw = grad_w + (weight_offset<T>(L) - weight_offset<T>(L0));
  float* db = grad_b + (bias_offset<T>(L) - bias_offset<T>(L0));
  for (int e = threadIdx.x; e < 8 * K; e += C::THREADS) {
    const int n = e / K, k = e % K;
    float s = 0.f;
    for (int r = 0; r < C::ROWS; ++r)
      s += round_bf(hg[r * 8 + n]) *
           __bfloat162float(X[r * C::LD + h_col + k]);
    atomicAdd(dw + e, s);
  }
  if (threadIdx.x < 8) {
    float s = 0.f;
    for (int r = 0; r < C::ROWS; ++r) s += hg[r * 8 + threadIdx.x];
    atomicAdd(db + threadIdx.x, s);
  }
}

// fp32 (bf16(hg[r][:]) @ W_L)[k] for a head L; W is the (8, K) weight.
template <int L, class T = TransTable>
__device__ __forceinline__ float head_dx(const float* hg_row,
                                         const bf16* __restrict__ W, int k) {
  constexpr int K = layer_shape<T>(L).k;
  const bf16* w = W + weight_offset<T>(L);
  float s = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n)
    s += round_bf(hg_row[n]) * __bfloat162float(w[n * K + k]);
  return s;
}

inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

}  // namespace
