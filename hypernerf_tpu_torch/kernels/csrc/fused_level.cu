// One HyperNeRF level forward in one kernel, for Hopper (sm_90a).
//
// Replaces hypernerf_tpu/ops/pallas/fused_level.py `_fused` (forward,
// fused_level.py:1322) in its ray-native mode, for the flagship spec with
// each of its three warp types (translation, SE(3), quaternion:
// `_warp_fwd_tile_gen` :330-344): bendy sheet, posenc_orig encodings, no alpha
// condition.
// When asked (training) it also writes the template's raw input
// raw_t = [warped | hyper | 0] (P, 8) fp32, the residual the TPU kernel
// saves for its backward (fused_level.py:1339-1344).
// Per sample row p of ray p / S:
//   pts    = o + z * d
//   warped = pts + WarpMLP(posenc_orig(pts, 10) ++ embed)        6 x 128
//            or, SE(3) / quaternion (se3_trunk.cuh):
//            (w, v) = heads(Trunk(posenc(pts, 0..8) ++ embed))    6 x 128 + 128
//            warped = retraction(w, v, pts), fp32, one thread per row
//   hyper  = HyperMLP(posenc_orig(pts, 7) ++ embed)               6 x 64 -> 4
//   h      = Trunk(posenc_orig(warped, 10) ++ posenc_orig(hyper, 6))  8 x 256,
//            skip at 4, ReLU logit 256
//   b      = Bottleneck(h)                                        256 -> 128
//   out    = [RgbBranch(b ++ rgb_cond) | AlphaHead(b)]            (P, 4) fp32
// Rounding points are the JAX kernel's: each encoding is rounded to bf16
// before its first product; every product takes bf16 operands with fp32
// accumulation; biases are bf16, added in fp32; a hidden layer applies its
// ReLU and then rounds to bf16 (the bottleneck rounds without a ReLU); the
// warp, hyper, alpha and rgb heads stay fp32.
//
// Bound: about 1.66 MFLOP of matrix products per sample (829k bf16 weights,
// 1.66 MB, which L2 holds), so at a render chunk of 8192 rays x 128 samples
// the level is a 1.7 TFLOP chain of narrow (64..256 wide) products whose
// activations must never reach device memory (1 GB per layer if they did).
// Design: a block of 256 threads takes 64 sample rows and keeps their whole
// activation tile, 64 x 392 bf16 (49 KB), in shared memory for all 30
// layers; each layer runs as mma.sync m16n8k16 bf16 products, A from shared
// memory, B (the weights, stored (out, in) as torch keeps them) straight
// from L2 through the read-only path, fp32 accumulators in registers, and
// writes its output back in place after a barrier. Two blocks fit an SM.
// The encodings are computed in registers in fp32 and written to the tile.
// Streaming weights through shared memory with TMA and wgmma is left for
// a later change.

#include <type_traits>

#include "se3_trunk.cuh"

namespace {

constexpr int kRows = 64;  // sample rows per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMT = kRows / 16;  // m16 tiles per block

// Activation tile: row stride in bf16. +8 staggers rows by 4 banks so the
// mma A-fragment loads (8 rows x 4 words) hit 32 distinct banks.
constexpr int kLd = kTrunkW + kTmplEncP + 8;  // 392
// Column plan of the tile (inputs of a skip layer sit right after the
// hidden columns, so [h | enc] is one contiguous K range):
//   warp      h [0, 128)   enc [128, 208)
//   hyper     h [0, 64)    enc [64, 128)
//   template  h [0, 256)   enc [256, 384)
//   rgb       b/h [0, 128) rgb_cond [128, 176)

// The tile as the shared device code (se3_trunk.cuh) sees it.
using CL = Cfg<kMT, kLd, kWarps>;

// n8 tiles per warp for an N-wide layer.
template <int N>
struct Tiles {
  static constexpr int v = (N / 8 + kWarps - 1) / kWarps;
};

// acc[mt][i] = X[rows of m-tile mt, a_col : a_col + K] @ W^T for n8 tile
// j = warp + kWarps * i; W is (N, K) row-major.
template <int N, int K>
__device__ __forceinline__ void gemm(const bf16* X, int a_col,
                                     const bf16* __restrict__ W,
                                     float (&acc)[kMT][Tiles<N>::v][4]) {
  constexpr int T = Tiles<N>::v;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][i][c] = 0.f;
  if (warp * 8 >= N) return;  // narrow heads: idle warps
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t b[T][2];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int j = warp + kWarps * i;
      if (j * 8 < N) {
        const bf16* w = W + (size_t)(j * 8 + g) * K + k0 + 2 * t;
        b[i][0] = ldg32(w);
        b[i][1] = ldg32(w + 8);
      } else {
        b[i][0] = b[i][1] = 0u;
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const bf16* x = X + (mt * 16 + g) * kLd + a_col + k0 + 2 * t;
      const uint32_t a0 = lds32(x), a1 = lds32(x + 8 * kLd);
      const uint32_t a2 = lds32(x + 8), a3 = lds32(x + 8 * kLd + 8);
#pragma unroll
      for (int i = 0; i < T; ++i)
        if ((warp + kWarps * i) * 8 < N)
          mma_bf16(acc[mt][i], a0, a1, a2, a3, b[i][0], b[i][1]);
    }
  }
}

// Hidden layer L: reads X[:, a_col : a_col + K], writes bf16
// [relu](acc + b) to X[:, 0 : N] in place.
template <int L, bool kRelu, class T = TransTable>
__device__ __forceinline__ void hidden_layer(bf16* X, int a_col,
                                             const bf16* __restrict__ W,
                                             const bf16* __restrict__ B) {
  constexpr int N = layer_shape<T>(L).n, K = layer_shape<T>(L).k;
  constexpr int NT = Tiles<N>::v;
  float acc[kMT][NT][4];
  gemm<N, K>(X, a_col, W + weight_offset<T>(L), acc);
  __syncthreads();  // every read of X done before the in-place write
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* bias = B + bias_offset<T>(L);
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int j = warp + kWarps * i;
    if (j * 8 >= N) continue;
    const int n = j * 8 + 2 * t;
    const float b0 = __bfloat162float(bias[n]);
    const float b1 = __bfloat162float(bias[n + 1]);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int r = mt * 16 + g;
      float v0 = acc[mt][i][0] + b0, v1 = acc[mt][i][1] + b1;
      float v2 = acc[mt][i][2] + b0, v3 = acc[mt][i][3] + b1;
      if (kRelu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
        v2 = fmaxf(v2, 0.f);
        v3 = fmaxf(v3, 0.f);
      }
      *reinterpret_cast<__nv_bfloat162*>(X + r * kLd + n) =
          __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(X + (r + 8) * kLd + n) =
          __floats2bfloat162_rn(v2, v3);
    }
  }
  __syncthreads();
}

// Head L (N = 8): head[r][0:8] = fp32 acc + b.
template <int L, class T = TransTable>
__device__ __forceinline__ void head_layer(const bf16* X, int a_col,
                                           const bf16* __restrict__ W,
                                           const bf16* __restrict__ B,
                                           float* head) {
  constexpr int N = layer_shape<T>(L).n, K = layer_shape<T>(L).k;
  static_assert(N == 8, "heads are one n8 tile");
  float acc[kMT][1][4];
  gemm<N, K>(X, a_col, W + weight_offset<T>(L), acc);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (threadIdx.x < 32) {
    const bf16* bias = B + bias_offset<T>(L);
    const float b0 = __bfloat162float(bias[2 * t]);
    const float b1 = __bfloat162float(bias[2 * t + 1]);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int r = mt * 16 + g;
      head[r * 8 + 2 * t] = acc[mt][0][0] + b0;
      head[r * 8 + 2 * t + 1] = acc[mt][0][1] + b1;
      head[(r + 8) * 8 + 2 * t] = acc[mt][0][2] + b0;
      head[(r + 8) * 8 + 2 * t + 1] = acc[mt][0][3] + b1;
    }
  }
  __syncthreads();
}

// Field encoding [posenc_orig(pts, F) | embed | 0 pad] into X[:, col:col+KP].
template <int F, int KP>
__device__ __forceinline__ void encode_field(bf16* X, int col,
                                             const float* rowin) {
  constexpr int kPts = 3 * (1 + 2 * F);
  for (int e = threadIdx.x; e < kRows * KP; e += kThreads) {
    const int r = e / KP, f = e % KP;
    const float* in = rowin + r * 12;  // [pts(3) | embed(8) | pad]
    float v = 0.f;
    if (f < kPts)
      v = posenc_at<3, F>(in, f);
    else if (f < kPts + kEmbed)
      v = in[3 + f - kPts];
    X[r * kLd + col + f] = __float2bfloat16_rn(v);
  }
}

// kWarp: 0 the translation warp, 1 SE(3), 2 quaternion (Se3Table's layers:
// the trunk, its two heads, then the retraction in fp32, one thread per row).
template <int kWarp>
__global__ void __launch_bounds__(kThreads, 2)
fused_level_fwd_kernel(const float* __restrict__ zs,
                       const float* __restrict__ origins,
                       const float* __restrict__ dirs,
                       const float* __restrict__ embed,
                       const bf16* __restrict__ rgb_cond,
                       const float* __restrict__ warp_scales,
                       const bf16* __restrict__ W, const bf16* __restrict__ B,
                       float* __restrict__ out, float* __restrict__ raw_t,
                       long long n_points, int samples) {
  using T = typename std::conditional<kWarp == 0, TransTable, Se3Table>::type;
  constexpr int H0 = T::kWarp, T0 = T::kFields;  // first sheet / template layer
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);                    // [kRows][kLd]
  float* rowin = reinterpret_cast<float*>(X + kRows * kLd);    // [kRows][12]
  float* rawt = rowin + kRows * 12;  // [kRows][8]: warped(3) | hyper(4)
  float* head = rawt + kRows * 8;    // [kRows][8]
  float* outv = head + kRows * 8;    // [kRows][4]: rgb logits | raw sigma
  int* ray_of = reinterpret_cast<int*>(outv + kRows * 4);     // [kRows]

  const long long row0 = (long long)blockIdx.x * kRows;
  const int tid = threadIdx.x;

  // Per-row inputs: the sample position and the ray's embedding.
  if (tid < kRows) {
    const long long p = row0 + tid;
    const bool valid = p < n_points;
    const long long ray = valid ? p / samples : 0;
    const float z = valid ? zs[p] : 0.f;
    float* in = rowin + tid * 12;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      in[c] = __fadd_rn(origins[3 * ray + c], __fmul_rn(z, dirs[3 * ray + c]));
#pragma unroll
    for (int c = 0; c < kEmbed; ++c) in[3 + c] = embed[ray * kEmbed + c];
    ray_of[tid] = (int)ray;
  }
  __syncthreads();

  if constexpr (kWarp == 0) {
    // Warp field -> warped = pts + delta.
    encode_field<kWarpF, kWarpEncP>(X, kWarpW, rowin);
    __syncthreads();
    hidden_layer<0, true>(X, kWarpW, W, B);
    hidden_layer<1, true>(X, 0, W, B);
    hidden_layer<2, true>(X, 0, W, B);
    hidden_layer<3, true>(X, 0, W, B);
    hidden_layer<4, true>(X, 0, W, B);
    hidden_layer<5, true>(X, 0, W, B);
    head_layer<6>(X, 0, W, B, head);
    for (int e = tid; e < kRows * 3; e += kThreads) {
      const int r = e / 3, c = e % 3;
      rawt[r * 8 + c] = rowin[r * 12 + c] + head[r * 8 + c];
    }
  } else {
    // SE(3) / quaternion trunk -> (w, v) -> warped = retraction(w, v, pts).
    encode_se3<CL>(X, kSe3W, rowin, warp_scales);
    __syncthreads();
    hidden_layer<0, true, T>(X, kSe3W, W, B);
    hidden_layer<1, true, T>(X, 0, W, B);
    hidden_layer<2, true, T>(X, 0, W, B);
    hidden_layer<3, true, T>(X, 0, W, B);
    hidden_layer<4, true, T>(X, 0, W, B);
    hidden_layer<5, true, T>(X, 0, W, B);
    hidden_layer<kSe3Trunk, false, T>(X, 0, W, B);  // rounded, no ReLU
    se3_heads_fwd<CL>(X, 0, W, B, head);
    if (tid < kRows)
      retract<kWarp == 2>(head + tid * 8, head + tid * 8 + 3,
                          rowin + tid * 12, rawt + tid * 8);
  }
  __syncthreads();

  // Hyper sheet -> hyper coordinates.
  encode_field<kHypF, kHypEncP>(X, kHypW, rowin);
  __syncthreads();
  hidden_layer<H0 + 0, true, T>(X, kHypW, W, B);
  hidden_layer<H0 + 1, true, T>(X, 0, W, B);
  hidden_layer<H0 + 2, true, T>(X, 0, W, B);
  hidden_layer<H0 + 3, true, T>(X, 0, W, B);
  hidden_layer<H0 + 4, true, T>(X, 0, W, B);
  hidden_layer<H0 + 5, true, T>(X, 0, W, B);
  head_layer<H0 + 6, T>(X, 0, W, B, head);
  for (int e = tid; e < kRows * kHypOut; e += kThreads) {
    const int r = e / kHypOut, c = e % kHypOut;
    rawt[r * 8 + 3 + c] = head[r * 8 + c];
  }
  __syncthreads();
  // Training keeps the template's raw input for the backward kernels.
  if (raw_t != nullptr && tid < kRows && row0 + tid < n_points) {
    const float* rt = rawt + tid * 8;
    float4* dst = reinterpret_cast<float4*>(raw_t) + 2 * (row0 + tid);
    dst[0] = make_float4(rt[0], rt[1], rt[2], rt[3]);
    dst[1] = make_float4(rt[4], rt[5], rt[6], 0.f);
  }

  // Template encoding [posenc_orig(warped, 10) | posenc_orig(hyper, 6)].
  for (int e = tid; e < kRows * kTmplEncP; e += kThreads) {
    const int r = e / kTmplEncP, f = e % kTmplEncP;
    const float* rt = rawt + r * 8;
    float v = 0.f;
    if (f < kTmplXyz)
      v = posenc_at<3, kXyzF>(rt, f);
    else if (f < kTmplEnc)
      v = posenc_at<kHypOut, kHypEncF>(rt + 3, f - kTmplXyz);
    X[r * kLd + kTrunkW + f] = __float2bfloat16_rn(v);
  }
  __syncthreads();
  hidden_layer<T0 + 0, true, T>(X, kTrunkW, W, B);
  hidden_layer<T0 + 1, true, T>(X, 0, W, B);
  hidden_layer<T0 + 2, true, T>(X, 0, W, B);
  hidden_layer<T0 + 3, true, T>(X, 0, W, B);
  hidden_layer<T0 + 4, true, T>(X, 0, W, B);
  hidden_layer<T0 + 5, true, T>(X, 0, W, B);
  hidden_layer<T0 + 6, true, T>(X, 0, W, B);
  hidden_layer<T0 + 7, true, T>(X, 0, W, B);
  hidden_layer<T0 + 8, true, T>(X, 0, W, B);   // trunk logit (ReLU)
  hidden_layer<T0 + 9, false, T>(X, 0, W, B);  // bottleneck (rounded, no ReLU)
  head_layer<T0 + 10, T>(X, 0, W, B, head);     // alpha
  if (tid < kRows) outv[tid * 4 + 3] = head[tid * 8];
  // rgb condition after the bottleneck: X[:, 128 : 176].
  for (int e = tid; e < kRows * kCondP; e += kThreads) {
    const int r = e / kCondP, f = e % kCondP;
    X[r * kLd + kBneck + f] =
        f < kCond ? rgb_cond[(size_t)ray_of[r] * kCond + f]
                  : __float2bfloat16_rn(0.f);
  }
  __syncthreads();
  hidden_layer<T0 + 11, true, T>(X, 0, W, B);
  hidden_layer<T0 + 12, true, T>(X, 0, W, B);
  hidden_layer<T0 + 13, true, T>(X, 0, W, B);
  hidden_layer<T0 + 14, true, T>(X, 0, W, B);
  head_layer<T0 + 15, T>(X, 0, W, B, head);  // rgb logits

  if (tid < kRows && row0 + tid < n_points) {
    const float* h = head + tid * 8;
    reinterpret_cast<float4*>(out)[row0 + tid] =
        make_float4(h[0], h[1], h[2], outv[tid * 4 + 3]);
  }
}

constexpr size_t kSmemBytes = sizeof(bf16) * kRows * kLd +
                              sizeof(float) * kRows * (12 + 8 + 8 + 4) +
                              sizeof(int) * kRows;

}  // namespace

// The compiled layer table of the level with warp `warp_type` (0 translation,
// 1 SE(3), 2 quaternion: the last two share one table).
extern "C" int hn_fused_level_layout(int warp_type, int* n, int* k,
                                     int max_layers) {
  const int count = warp_type == 0 ? TransTable::kNum : Se3Table::kNum;
  for (int l = 0; l < count && l < max_layers; ++l) {
    const Shape s = warp_type == 0 ? TransTable::shape(l) : Se3Table::shape(l);
    n[l] = s.n;
    k[l] = s.k;
  }
  return count;
}

namespace {

template <int kWarp>
int launch_level_fwd(const void* z, const void* origins, const void* dirs,
                     const void* embed, const void* rgb_cond,
                     const void* warp_scales, const void* weights,
                     const void* biases, void* out, void* raw_t,
                     long long n_points, int samples, void* stream) {
  const long long blocks = (n_points + kRows - 1) / kRows;
  cudaError_t err = cudaFuncSetAttribute(
      fused_level_fwd_kernel<kWarp>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (blocks > 0) {
    fused_level_fwd_kernel<kWarp><<<(unsigned)blocks, kThreads, kSmemBytes,
                                    (cudaStream_t)stream>>>(
        static_cast<const float*>(z), static_cast<const float*>(origins),
        static_cast<const float*>(dirs), static_cast<const float*>(embed),
        static_cast<const bf16*>(rgb_cond),
        static_cast<const float*>(warp_scales),
        static_cast<const bf16*>(weights), static_cast<const bf16*>(biases),
        static_cast<float*>(out), static_cast<float*>(raw_t), n_points,
        samples);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// warp_type: 0 translation, 1 SE(3), 2 quaternion; weights / biases in that
// type's table. warp_scales: null, or the 64 fp32 window weights of the SE(3)
// / quaternion trunk's encoding (unused by the translation warp).
extern "C" int hn_fused_level_fwd(int warp_type, const void* z,
                                  const void* origins, const void* dirs,
                                  const void* embed, const void* rgb_cond,
                                  const void* warp_scales, const void* weights,
                                  const void* biases, void* out, void* raw_t,
                                  long long n_rays, int samples,
                                  void* stream) {
  const long long n_points = n_rays * samples;
  switch (warp_type) {
    case 0:
      return launch_level_fwd<0>(z, origins, dirs, embed, rgb_cond,
                                 warp_scales, weights, biases, out, raw_t,
                                 n_points, samples, stream);
    case 1:
      return launch_level_fwd<1>(z, origins, dirs, embed, rgb_cond,
                                 warp_scales, weights, biases, out, raw_t,
                                 n_points, samples, stream);
    case 2:
      return launch_level_fwd<2>(z, origins, dirs, embed, rgb_cond,
                                 warp_scales, weights, biases, out, raw_t,
                                 n_points, samples, stream);
  }
  return (int)cudaErrorInvalidValue;
}
