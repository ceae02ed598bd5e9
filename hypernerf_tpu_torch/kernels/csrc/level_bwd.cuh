// Building blocks of the warp Jacobian forwards (jacobian.cuh: the
// translation warp's and the SE(3) trunk's), written for mma.sync on tiles
// that keep every layer's bf16 output in one shared-memory tile X[ROWS][LD]
// with the weights read from L2: the tile configuration and the m16n8k16
// product over it; and the bf16 rounding that kernel B and the trunk's code
// share (se3_trunk.cuh includes this). (The level's kernels, the fields
// backward and every backward of a field alone, the Jacobians' too, keep
// their tiles on Hopper's blocks instead: level_fwd.cuh, fields_bwd.cuh,
// fields_bwd_alone.cuh; the template backward, kernel A, works a layer at a
// time over a stash: template_rowprod.cu, template_dw.cu.)

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

}  // namespace
