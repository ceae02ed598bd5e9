// The float32 layer chain for Hopper (sm_90a): FFMA products of fp32
// activation tiles and fp32 weights, shared by the float32 level forward
// (f32_level.cu, row 1), the float32 steps of kernels A and B
// (f32_steps.cu, rows 9 and 5) and the float32 Jacobians' forwards
// (f32_tangents.cu, rows 14 and 16).
//
// Float32 here is the TPU kernels' float32 (`compute_dtype='float32'`,
// hypernerf_tpu/ops/pallas/fused_level.py FusedLevelSpec, fused_mlp.py
// FusedMLPSpec): every product takes fp32 operands and sums in fp32, every
// epilogue (bias, ReLU, heads) is fp32, nothing is rounded to bf16. The
// products run on the FFMA pipes, not the tensor cores: one TF32 pass
// keeps about three decimal digits, and three (3xTF32 `wgmma`, K = 8, both
// operands K-major) would rewrite the bf16 blocks, whose operands are
// MN-major (wgmma.cuh) and whose tiles no longer fit at fp32.
//
// Bound: operations. FFMA peaks at 66.9 TFLOP/s on an H100 SXM, where
// float32-exact products could reach 165 (3xTF32 at the dense 495); every
// layer of a level is a product of a few hundred columns, far above the
// card's 20 operations a byte at fp32.
//
// Design: a block of kThreads threads computes a tile of rows by output
// columns in passes of kDepth reduction columns, each thread a register
// tile of TR rows by TC columns (Tile): 8 x 8 sums where the tile is wide
// enough, so a step of the reduction reads two float4 of the activations
// (the same rows for every thread of a warp: one broadcast) and two of the
// weights from shared memory for 64 FFMA. A thread's columns are runs of
// four, CG * 4 apart (Tile::col), so that a quarter warp's float4 reads of
// the weight tile cover all 32 banks once. Activations sit in shared memory
// feature-major (column f of a tile's rows at f * ld), so a thread's rows
// are float4; weights stream through a double-buffered shared tile of
// kDepth x the block's columns, read from device memory (L2) as float4
// rows of a [k][n] operand (the transposed blob for a forward) and each
// chunk loaded into registers while the chunk before it is multiplied.

#pragma once

#include <cuda_runtime.h>

namespace f32 {

constexpr int kThreads = 256;
constexpr int kDepth = 16;  // reduction columns of a chunk

// A block's thread grid of (kThreads / CG) row groups by CG column groups,
// each thread TR rows by TC columns (TC a multiple of 4).
template <int TR_, int TC_, int CG_>
struct Tile {
  static constexpr int TR = TR_, TC = TC_, CG = CG_;
  static constexpr int kRows = (kThreads / CG) * TR;  // rows of the block
  static constexpr int kCols = CG * TC;               // columns of the block
  static constexpr int kWTile = kDepth * kCols;       // a weight chunk
  // This thread's first row; its column j < TC: run j / 4 of four columns
  // at (j / 4) * CG * 4 + 4 (t % CG).
  __device__ static int row() { return (threadIdx.x / CG) * TR; }
  __device__ static int col(int j) {
    return (j >> 2) * (CG * 4) + (threadIdx.x % CG) * 4 + (j & 3);
  }
};

// The level forward's tiles of 64 rows: 256 columns a pass (its 256-wide
// layers) or 128 (the others, whose heads of 8 use the first 8); the steps'
// tiles of 128 x 128.
using Wide = Tile<8, 8, 32>;
using Narrow = Tile<8, 4, 32>;
using Step = Tile<8, 8, 16>;
constexpr int kRows = Wide::kRows;  // 64, the level forward's tile
static_assert(Wide::kRows == Narrow::kRows, "one row tile");

template <class T>
__device__ __forceinline__ void zero(float (&acc)[T::TR][T::TC]) {
#pragma unroll
  for (int i = 0; i < T::TR; ++i)
#pragma unroll
    for (int j = 0; j < T::TC; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_kk a[kk * a_ld + row + i] * w[kk * T::kCols + col(j)]
// over one chunk; both operands in shared memory, 16-byte aligned.
template <class T>
__device__ __forceinline__ void chunk_fma(float (&acc)[T::TR][T::TC],
                                          const float* a, int a_ld,
                                          const float* w) {
  const int r = T::row(), c = T::col(0);
#pragma unroll
  for (int kk = 0; kk < kDepth; ++kk) {
    float x[T::TR], y[T::TC];
#pragma unroll
    for (int q = 0; q < T::TR / 4; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(a + kk * a_ld + r + 4 * q);
      x[4 * q] = v.x, x[4 * q + 1] = v.y, x[4 * q + 2] = v.z,
      x[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < T::TC / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(
          w + kk * T::kCols + c + q * T::CG * 4);
      y[4 * q] = v.x, y[4 * q + 1] = v.y, y[4 * q + 2] = v.z,
      y[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < T::TR; ++i)
#pragma unroll
      for (int j = 0; j < T::TC; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// A weight operand B(k, n) = w[k * ldw + n], k < K the reduction, n < N
// the outputs: a layer's packed (n_pad, k_pad) weight for a cotangent
// through it (g W), its transpose (k_pad, n_pad) for the forward (x W^T),
// so that a chunk's rows are contiguous in both. N, ldw and the pointer
// are multiples of 4 floats (16 bytes).
// A chunk [k0, k0 + kDepth) x [n0, n0 + T::kCols) of B, zero outside
// k < K, n < N: this thread's kVec float4, consecutive threads on
// consecutive float4 of a row (a warp reads 512 contiguous bytes).
template <class T>
struct WChunk {
  static constexpr int kRowVec = T::kCols / 4;  // float4 a row of the tile
  static constexpr int kVec = T::kWTile / 4 / kThreads;
  float4 v[kVec];

  __device__ __forceinline__ void load(const float* w, long long ldw, int k0,
                                       int K, int n0, int N) {
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      const int f = threadIdx.x + q * kThreads;
      const int k = k0 + f / kRowVec, n = n0 + (f % kRowVec) * 4;
      v[q] = (k < K && n < N)
                 ? __ldg(reinterpret_cast<const float4*>(w + k * ldw + n))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // Into the shared tile ws[kk * T::kCols + c].
  __device__ __forceinline__ void store(float* ws) const {
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      const int f = threadIdx.x + q * kThreads;
      *reinterpret_cast<float4*>(ws + (f / kRowVec) * T::kCols +
                                 (f % kRowVec) * 4) = v[q];
    }
  }
};

// One input segment of a layer held in shared memory, feature-major: its
// feature f of tile row r at a[f * kRows + r]; k features, a multiple of
// kDepth.
struct Seg {
  const float* a;
  int k;
};

// The widths of a layer's segments joined.
template <int NSeg>
__device__ __forceinline__ int seg_width(const Seg (&segs)[NSeg]) {
  int K = 0;
#pragma unroll
  for (int s = 0; s < NSeg; ++s) K += segs[s].k;
  return K;
}

// One pass's product: acc[i][j] = sum_k x(T::row() + i, k) wt[k * ldw + n]
// for the pass's columns n = n0 + T::col(j), x the segments joined (K
// features); zero for n >= N. Every thread of the block calls it; it ends
// with a barrier, so ws may be refilled by the next pass.
template <class T, int NSeg>
__device__ __forceinline__ void pass_product(float (&acc)[T::TR][T::TC],
                                             const Seg (&segs)[NSeg],
                                             const float* w, int ldw, int K,
                                             int n0, int N, float* ws) {
  const int chunks = K / kDepth;
  zero<T>(acc);
  WChunk<T> wc;
  wc.load(w, ldw, 0, K, n0, N);
  wc.store(ws);
  __syncthreads();
  int seg = 0, at = 0;
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) wc.load(w, ldw, (ch + 1) * kDepth, K, n0, N);
    chunk_fma<T>(acc, segs[seg].a + at * kRows, kRows,
                 ws + (ch & 1) * T::kWTile);
    at += kDepth;
    if (at == segs[seg].k) {
      ++seg;
      at = 0;
    }
    if (ch + 1 < chunks) wc.store(ws + ((ch + 1) & 1) * T::kWTile);
    __syncthreads();
  }
}

// A layer on a tile held in shared memory, in passes of T::kCols output
// columns: out[n * kRows + r] = act(sum_k x(r, k) wt[k * ldw + n] +
// bias[n]) for n < N, x the segments joined, wt the layer's transposed
// weight, act ReLU or the identity. ws: the 2 x T::kWTile weight tile.
template <class T, int NSeg>
__device__ __forceinline__ void tile_passes(const Seg (&segs)[NSeg],
                                            const float* w, int ldw, int N,
                                            const float* bias, bool relu,
                                            float* out, float* ws) {
  const int K = seg_width(segs);
  const int r = T::row();
  for (int n0 = 0; n0 < N; n0 += T::kCols) {
    float acc[T::TR][T::TC];
    pass_product<T>(acc, segs, w, ldw, K, n0, N, ws);
#pragma unroll
    for (int j = 0; j < T::TC; ++j) {
      const int n = n0 + T::col(j);
      if (n >= N) continue;
      const float b = __ldg(bias + n);
#pragma unroll
      for (int q = 0; q < T::TR / 4; ++q) {
        float y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          y[i] = acc[4 * q + i][j] + b;
          if (relu) y[i] = fmaxf(y[i], 0.f);
        }
        *reinterpret_cast<float4*>(out + n * kRows + r + 4 * q) =
            make_float4(y[0], y[1], y[2], y[3]);
      }
    }
  }
  __syncthreads();
}

// A layer on a tile held in shared memory (tile_passes): 256 columns a
// pass where N is wider than 128, else 128. Every thread of the block
// calls it; it ends with a barrier, so `out` is ready for the next layer
// and the segments may be overwritten. ws: 2 x Wide::kWTile floats.
template <int NSeg>
__device__ void tile_layer(const Seg (&segs)[NSeg], const float* w, int ldw,
                           int N, const float* bias, bool relu, float* out,
                           float* ws) {
  if (N > Narrow::kCols)
    tile_passes<Wide>(segs, w, ldw, N, bias, relu, out, ws);
  else
    tile_passes<Narrow>(segs, w, ldw, N, bias, relu, out, ws);
}

// Feature f of posenc_orig(x, F) of a `ch`-channel point, the JAX package's
// layout [x | sin bands | cos bands], band k of channel c at k * ch + c:
// x's channel c is xs[c * stride]. Without `ident`, the Nerfies posenc from
// degree 0: [sin bands | cos bands]. Band arguments x * 2^k are exact; sin /
// cos are the accurate ones (no fast math).
__device__ __forceinline__ float posenc_feature(const float* xs, int stride,
                                                int ch, int F, int f,
                                                bool ident = true) {
  if (ident) {
    if (f < ch) return xs[f * stride];
    f -= ch;
  }
  const int nb = ch * F;
  const bool is_cos = f >= nb;
  if (is_cos) f -= nb;
  const float arg = xs[(f % ch) * stride] * (float)(1 << (f / ch));
  return is_cos ? cosf(arg) : sinf(arg);
}

// The VJP of posenc_orig for channel c of x: g_id + sum_k 2^k (cos(x 2^k)
// g_sin[k] - sin(x 2^k) g_cos[k]); g holds the encoding's cotangent [x |
// sin | cos] of `ch` channels and F bands at stride 1 (without `ident`,
// [sin | cos] and no identity term), each column first times the window
// row w (the segment's weights, aligned with g) where there is one.
__device__ __forceinline__ float posenc_vjp(float x, const float* g, int ch,
                                            int F, int c, bool ident = true,
                                            const float* w = nullptr) {
  const int at = ident ? ch : 0;
  float acc = 0.f;
  for (int k = 0; k < F; ++k) {
    const float scale = (float)(1 << k);
    const float arg = x * scale;
    const int fs = at + k * ch + c, fc = at + ch * F + k * ch + c;
    const float gs = w != nullptr ? g[fs] * w[fs] : g[fs];
    const float gc = w != nullptr ? g[fc] * w[fc] : g[fc];
    acc += scale * (cosf(arg) * gs - sinf(arg) * gc);
  }
  if (!ident) return acc;
  return (w != nullptr ? g[c] * w[c] : g[c]) + acc;
}

}  // namespace f32
