// One HyperNeRF level forward in one kernel, for Hopper (sm_90a): the kernel
// template and its launcher, instantiated once per warp type by
// level_fwd_trans.cu, level_fwd_se3.cu and level_fwd_quat.cu (one nvcc
// process each); fused_level.cu holds the entry point that dispatches to
// them.
//
// Replaces hypernerf_tpu/ops/pallas/fused_level.py `_fused` (forward,
// fused_level.py:1322; `_fwd_call_pipelined`, :1019, is a schedule of the
// same function) in its ray-native mode, for the flagship spec with each of
// its three warp types (translation, SE(3), quaternion:
// `_warp_fwd_tile_gen` :330-344): bendy sheet, posenc_orig encodings, no
// alpha condition. When asked (training) it also writes the template's raw
// input raw_t = [warped | hyper | 0] (P, 8) fp32, the residual the TPU
// kernel saves for its backward (fused_level.py:1339-1344).
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
// ReLU and then rounds to bf16 (the bottleneck and the SE(3) trunk logit
// round without a ReLU); the warp, hyper, alpha and rgb heads stay fp32.
//
// Bound: 828,928 multiply-adds a row with the translation warp (1.66 MB of
// bf16 weights), so at a render chunk of 8192 rays x 128 samples the level
// is a 1.7 TFLOP chain of narrow (8..256 wide) products, 1.73 ms at the
// card's dense bf16 rate; its activations must never reach device memory.
// The weights do not fit in an SM (227 KB of shared memory), so they are
// streamed from L2 for every tile of rows: at 128 rows a block that is
// 1.66 MB x 8192 = 13.6 GB a call, which may set the pace.
//
// Design: a persistent grid, one block per SM, walks pairs of 64-row tiles.
// A block is two consumer warpgroups and a producer warpgroup, one thread
// of which issues the loads; `setmaxnreg` moves registers from the producer
// (40 a thread) to the consumers (232), whose 256-wide layers hold 128 fp32
// accumulators a thread.
//  - Each consumer warpgroup owns one tile of rows and keeps its whole
//    activation tile, 64 rows x 384 bf16 columns (48 KB), in shared memory
//    for all 30 (32) layers, as six 64-column boxes in the 128-byte-swizzled
//    K-major layout that `wgmma` reads A from through a descriptor. Every
//    layer is `wgmma` m64nNk16 products (N = 128 twice for the 256-wide
//    trunk, 128, 64, and 8 for the heads) into fp32 registers; the epilogue
//    adds the bias (every layer's, copied to shared memory once per block),
//    applies the ReLU and rounds in one conversion, and writes the output
//    back in place, in the swizzled layout, with `stmatrix`. A warpgroup
//    reads and writes only its own rows, so layers are separated by
//    warpgroup barriers only.
//  - The weights stream by TMA through a ring of kStages stages shared by
//    the two warpgroups: a stage is one box of a layer's (N, K) weight, 64
//    columns (K) by up to 128 rows (N), straight from the packed blob
//    (pack_level), one 2-d tensor map per run of layers of one shape. Each
//    stage has a full mbarrier (the TMA's bytes) and an empty one (each
//    consumer warp arrives once it has retired the products that read it).
//    The producer runs ahead across layers and across row tiles.
//  - The per-row work (the ray inputs, the three encodings with sin and cos
//    of one argument together, the heads' fp32 outputs, the retraction, the
//    rgb condition, raw_t and the output) is spread over the warpgroup's 128
//    threads.
// What the card shows (tools/trace_level_fwd.py): the weight stream is not
// the limit (under 3 % of a tile's cycles wait for a stage); the products
// run near the tensor rate, but the two warpgroups settle into lockstep,
// so the epilogues and the row work, which are bound by the latency of
// their instruction chains, do not overlap the products.

#pragma once

#include <type_traits>
#include <utility>

#include "se3_trunk.cuh"
#include "wgmma.cuh"

namespace {
namespace lf {

constexpr int kGroups = 2;                     // consumer warpgroups
constexpr int kThreads = 128 * (kGroups + 1);  // + the producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kRows = 64;                      // rows of a warpgroup's tile
constexpr int kCols = kTrunkW + kTmplEncP;     // 384 columns of the tile
constexpr int kBoxBytes = kRows * 128;         // 64 rows x 64 bf16 columns
constexpr int kXBytes = kCols / kBoxCols * kBoxBytes;  // 48 KB
constexpr int kStageRows = 128;                // weight rows of a stage
constexpr int kStageBytes = kStageRows * 128;  // 16 KB
constexpr int kStages = 6;
constexpr int kArrivals = 4 * kGroups;         // consumer warps per stage

// Column plan of the tile (every K segment starts on a 64-column box):
//   warp      h [0, 128)   enc [128, 208)   (SE(3): enc [128, 192))
//   hyper     h [0, 64)    enc [64, 128)
//   template  h [0, 256)   enc [256, 384)
//   rgb       b/h [0, 128) rgb_cond [128, 176)
// A hidden layer writes [0, N); the heads write fp32 rows.
constexpr int kWarpEnc = kWarpW, kHypEnc = kHypW, kTmplEnc0 = kTrunkW;
constexpr int kCondCol = kBneck;
static_assert(kWarpW == kSe3W, "both warps encode at column 128");
static_assert(kWarpEnc % kBoxCols == 0 && kHypEnc % kBoxCols == 0 &&
                  kTmplEnc0 % kBoxCols == 0 && kCondCol % kBoxCols == 0,
              "every K segment starts on a box");

// The per-row fp32 scratch of a warpgroup.
struct Rows {
  float in[kRows][12];   // pts (3) | embed (8) | pad
  float raw[kRows][8];   // warped (3) | hyper (4) | 0
  float head[kRows][8];  // a head's outputs
  float sigma[kRows];
  int ray[kRows];
};

// Every layer's bias (bf16), copied to shared memory once per block: the
// larger table's.
constexpr int kBiasBytes =
    2 * (bias_offset<Se3Table>(Se3Table::kNum) >
                 bias_offset<TransTable>(TransTable::kNum)
             ? bias_offset<Se3Table>(Se3Table::kNum)
             : bias_offset<TransTable>(TransTable::kNum));
static_assert(kBiasBytes % 16 == 0 &&
                  2 * bias_offset<TransTable>(TransTable::kNum) % 16 == 0,
              "the biases copy in 16-byte pieces");

constexpr int kSmemBytes = 1024 + kGroups * kXBytes + kStages * kStageBytes +
                           kGroups * (int)sizeof(Rows) + kBiasBytes +
                           2 * kStages * 8;
static_assert(kSmemBytes <= 232448, "fits an SM's shared memory");

// The layer table of warp type kWarp (0 translation, 1 SE(3), 2 quaternion).
template <int kWarp>
using Table =
    typename std::conditional<kWarp == 0, TransTable, Se3Table>::type;

// The first tile column of layer l's input.
template <class T>
__host__ __device__ constexpr int in_col(int l) {
  return l == 0 ? kWarpEnc
                : l == T::kWarp ? kHypEnc : l == T::kFields ? kTmplEnc0 : 0;
}

// Weight loads of one layer: 64-column boxes of K by row halves of N.
__host__ __device__ constexpr int k_boxes(Shape s) {
  return (s.k + kBoxCols - 1) / kBoxCols;
}
__host__ __device__ constexpr int n_halves(Shape s) {
  return (s.n + kStageRows - 1) / kStageRows;
}
__host__ __device__ constexpr int box_rows(Shape s) {
  return s.n < kStageRows ? s.n : kStageRows;
}

// The tensor maps: one per run of consecutive layers of one shape, each a
// 2-d (count x N, K) view of the blob at the run's first layer.
template <class T>
__host__ __device__ constexpr bool same_shape(int a, int b) {
  return T::shape(a).n == T::shape(b).n && T::shape(a).k == T::shape(b).k;
}
template <class T>
__host__ __device__ constexpr int map_first(int l) {
  while (l > 0 && same_shape<T>(l - 1, l)) --l;
  return l;
}
template <class T>
__host__ __device__ constexpr int map_index(int l) {
  int m = 0;
  for (int i = 1; i <= l; ++i) m += same_shape<T>(i - 1, i) ? 0 : 1;
  return m;
}
template <class T>
__host__ __device__ constexpr int map_count() {
  return map_index<T>(T::kNum - 1) + 1;
}
template <class T>
struct Maps {
  CUtensorMap m[map_count<T>()];
};

// The ring's position, kept by the producer and by every consumer thread
// alike: stage s of parity phase, in a ring of kN stages of kStageBytes
// (fields_bwd.cuh's ring has fewer).
template <int kN>
struct RingOf {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int s, phase;
  __device__ __forceinline__ uint8_t* stage() const {
    return base + s * kStageBytes;
  }
  __device__ __forceinline__ void next() {
    if (++s == kN) {
      s = 0;
      phase ^= 1;
    }
  }
};
using Ring = RingOf<kStages>;

// -- the producer --------------------------------------------------------------

template <class T, int L, class R>
__device__ __forceinline__ void produce_layer(const Maps<T>& maps, R& ring) {
  constexpr Shape sh = T::shape(L);
  constexpr int kMap = map_index<T>(L);
  constexpr int kRow0 = (L - map_first<T>(L)) * sh.n;
#pragma unroll
  for (int kb = 0; kb < k_boxes(sh); ++kb)
#pragma unroll
    for (int nb = 0; nb < n_halves(sh); ++nb) {
      mbar_wait_bounded(&ring.empty[ring.s], ring.phase ^ 1);
      mbar_expect(&ring.full[ring.s], box_rows(sh) * 128);
      tma_load(ring.stage(), &maps.m[kMap], &ring.full[ring.s],
               kb * kBoxCols, kRow0 + nb * kStageRows);
      ring.next();
    }
}

template <class T, int... L>
__device__ __forceinline__ void produce_tile(const Maps<T>& maps, Ring& ring,
                                             std::integer_sequence<int, L...>) {
  (produce_layer<T, L>(maps, ring), ...);
}

// -- the consumers -------------------------------------------------------------

// A warpgroup's view: its tile, its rows, its barrier and thread.
struct Group {
  uint8_t* X;
  uint32_t xs;  // X's shared-memory address
  Rows* rows;
  int bar;  // named barrier id
  int tid;  // 0..127
  int it;   // the block's pair of tiles
  __device__ __forceinline__ void sync() const { named_barrier(bar, 128); }
};

// Where column c of row r sits in the tile at shared address xs: box
// c / 64, row r of 128 bytes, 16-byte chunk (c % 64) / 8 swizzled with r % 8
// (the TMA / wgmma 128-byte swizzle of a 1024-byte-aligned box).
__device__ __forceinline__ uint32_t x_at(uint32_t xs, int r, int c) {
  return xs + (c >> 6) * kBoxBytes + r * 128 +
         ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

__device__ __forceinline__ void sts16(uint32_t addr, bf16 v) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(addr),
               "h"(*reinterpret_cast<const unsigned short*>(&v)));
}
// Four 8 x 8 bf16 matrices to shared memory: this lane gives row lane % 8
// of matrix lane / 8 its address, and its 2-value fragment of each matrix
// (row lane / 4, columns 2 (lane % 4), + 1: an accumulator fragment's).
__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t m0, uint32_t m1,
                                        uint32_t m2, uint32_t m3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(addr),
      "r"(m0), "r"(m1), "r"(m2), "r"(m3));
}

// 2^k for 0 <= k < 127, exactly.
__device__ __forceinline__ float pow2(int k) {
  return __int_as_float((127 + k) << 23);
}

// Built with -DHN_LEVEL_FWD_TRACE, block 0 records the clock of thread 0
// of each warpgroup at four points of every layer of its first kTracePairs
// pairs of tiles: the product's start, its first stage ready, its products
// retired, the epilogue done (tools/trace_level_fwd.py reads them).
#ifdef HN_LEVEL_FWD_TRACE
constexpr int kTracePairs = 4;
__device__ long long level_fwd_trace[kGroups][kTracePairs][32][4];
#define LF_TRACE(g, L, ev)                                      \
  if (blockIdx.x == 0 && (g).it < kTracePairs && (g).tid == 0) \
  level_fwd_trace[(g).bar - 1][(g).it][L][ev] = clock64()
#else
#define LF_TRACE(g, L, ev)
#endif

template <int N>
struct Acc {
  static constexpr int H = N > kStageRows ? N / kStageRows : 1;  // halves
  static constexpr int W = N > kStageRows ? kStageRows : N;      // each
  float d[H][W / 2];
};

// acc = X[:, in_col : in_col + K] W_L^T, W_L's boxes taken from the ring
// in the producer's order (the 64-column boxes of K, each as one or two
// 128-row halves of N); every stage is released once its products have
// retired. Returns with every product of the layer retired.
template <class T, int L>
__device__ __forceinline__ void product(const Group& g, Ring& ring,
                                        Acc<T::shape(L).n>& acc) {
  constexpr Shape sh = T::shape(L);
  constexpr int kBox0 = in_col<T>(L) / kBoxCols;
  using A = Acc<sh.n>;
  const bool leader = (g.tid & 31) == 0;
  int prev = -1;
  LF_TRACE(g, L, 0);
#pragma unroll
  for (int kb = 0; kb < k_boxes(sh); ++kb) {
    const int steps = (sh.k - kb * kBoxCols) / 16 < 4
                          ? (sh.k - kb * kBoxCols) / 16 : 4;
#pragma unroll
    for (int h = 0; h < A::H; ++h) {
      mbar_wait_bounded(&ring.full[ring.s], ring.phase);
      if (kb + h == 0) LF_TRACE(g, L, 1);
      const uint8_t* b = ring.stage();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < steps)
          wgmma_ss(acc.d[h],
                   sw128_desc(g.X + (kBox0 + kb) * kBoxBytes + kk * 32, 16,
                              kAtomBytes),
                   sw128_desc(b + kk * 32, 16, kAtomBytes),
                   kb + kk > 0 ? 1 : 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0 && leader) mbar_arrive(&ring.empty[prev]);
      prev = ring.s;
      ring.next();
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < A::H; ++h) fence_fragment(acc.d[h]);
  if (leader) mbar_arrive(&ring.empty[prev]);
  g.sync();  // every warp's products retired before any in-place store
  LF_TRACE(g, L, 2);
}

// bf16x2 of ([relu] (acc + b)) for a pair of columns: the sum in fp32, then
// the ReLU and the rounding in one conversion (rounding keeps the sign, so
// relu(round(x)) = round(relu(x))).
template <bool kRelu>
__device__ __forceinline__ uint32_t bias_round(float a0, float a1,
                                               __nv_bfloat162 b) {
  const float v0 = a0 + __low2float(b), v1 = a1 + __high2float(b);
  uint32_t out;
  if (kRelu)
    asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(out) : "f"(v1), "f"(v0));
  else
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(out) : "f"(v1), "f"(v0));
  return out;
}

// Hidden layer L: X[:, 0 : N] = bf16([relu](acc + b)), in place, two n8
// column groups of the warp's 16 rows a `stmatrix`. Bs: the biases in
// shared memory, read before the products (a load still in flight would
// hold up the first `wgmma`); post() runs after the stores, before the
// layer's closing barrier.
template <class T, int L, bool kRelu, class Post>
__device__ __forceinline__ void hidden(const Group& g, Ring& ring,
                                       const bf16* Bs, Post post) {
  constexpr int N = T::shape(L).n;
  using A = Acc<N>;
  constexpr int J = A::W / 8;  // n8 column groups of a half
  const int warp = g.tid >> 5, lane = g.tid & 31, t = lane & 3;
  const __nv_bfloat162* bias =
      reinterpret_cast<const __nv_bfloat162*>(Bs + bias_offset<T>(L)) + t;
  __nv_bfloat162 bb[A::H][J];
#pragma unroll
  for (int h = 0; h < A::H; ++h)
#pragma unroll
    for (int j = 0; j < J; ++j) bb[h][j] = bias[(h * kStageRows + 8 * j) / 2];
  A acc;
  product<T, L>(g, ring, acc);
  // This lane's row address: row lane % 8 of matrix lane / 8, i.e. tile
  // row 16 warp + lane % 8 (+ 8 for odd matrices), n8 group + lane / 16.
  const int i7 = lane & 7, jo = lane >> 4;
  const uint32_t row = g.xs + (16 * warp + i7 + (lane & 8)) * 128;
#pragma unroll
  for (int h = 0; h < A::H; ++h)
#pragma unroll
    for (int j = 0; j < J; j += 2) {
      const float* d = acc.d[h] + 4 * j;
      const int jj = j + jo;
      stsm_x4(row + (h * 2 + (j >> 3)) * kBoxBytes + (((jj & 7) ^ i7) << 4),
              bias_round<kRelu>(d[0], d[1], bb[h][j]),
              bias_round<kRelu>(d[2], d[3], bb[h][j]),
              bias_round<kRelu>(d[4], d[5], bb[h][j + 1]),
              bias_round<kRelu>(d[6], d[7], bb[h][j + 1]));
    }
  post();
  fence_async_smem();
  g.sync();
  LF_TRACE(g, L, 3);
}

template <class T, int L, bool kRelu>
__device__ __forceinline__ void hidden(const Group& g, Ring& ring,
                                       const bf16* Bs) {
  hidden<T, L, kRelu>(g, ring, Bs, [] {});
}

// Head L (N = 8): dst[r * ld + c] = fp32 acc + b for c < n_out.
template <class T, int L>
__device__ __forceinline__ void head(const Group& g, Ring& ring,
                                     const bf16* Bs, float* dst, int ld,
                                     int n_out) {
  static_assert(T::shape(L).n == 8, "heads are 8 wide");
  Acc<8> acc;
  product<T, L>(g, ring, acc);
  const bf16* bias = Bs + bias_offset<T>(L);
  const int warp = g.tid >> 5, lane = g.tid & 31, q = lane >> 2, t = lane & 3;
  const int r = 16 * warp + q;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = 2 * t + (e & 1), rr = r + (e >= 2 ? 8 : 0);
    if (c < n_out)
      dst[rr * ld + c] = acc.d[0][e] + __bfloat162float(bias[c]);
  }
  g.sync();
  LF_TRACE(g, L, 3);
}

// Row inputs of tile rows [row0, row0 + 64): pts = o + z d (rounded as the
// plain version's o + z * d) and the ray for threads 0..63, the ray's
// embedding for 64..127; zeros past P.
__device__ __forceinline__ void row_inputs(const Group& g, long long row0,
                                           long long n_points, int samples,
                                           const float* __restrict__ zs,
                                           const float* __restrict__ origins,
                                           const float* __restrict__ dirs,
                                           const float* __restrict__ embed) {
  const int r = g.tid & (kRows - 1);
  const long long p = row0 + r;
  const bool valid = p < n_points;
  const long long ray = valid ? p / samples : 0;
  float* in = g.rows->in[r];
  if (g.tid < kRows) {
    const float z = valid ? zs[p] : 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      in[c] = valid ? __fadd_rn(origins[3 * ray + c],
                                __fmul_rn(z, dirs[3 * ray + c]))
                    : 0.f;
    g.rows->ray[r] = (int)ray;
  } else {
#pragma unroll
    for (int c = 0; c < kEmbed; ++c)
      in[3 + c] = valid ? embed[ray * kEmbed + c] : 0.f;
  }
}

// [posenc_orig(x, F) | extra | 0 pad] of CH channels x = src[r][0 : CH]
// into X[:, col : col + KP]: identity, sin and cos of band k of channel c
// at k * CH + c (argument x * 2^k, exact), then NX columns src[r][CH : CH +
// NX] (the embedding), then zeros.
template <int CH, int F, int NX, int KP, int LD>
__device__ __forceinline__ void encode_posenc(const Group& g, int col,
                                              const float (*src)[LD]) {
  constexpr int kPairs = CH * F, kRest = KP - 2 * kPairs;
#pragma unroll 4
  for (int e = g.tid; e < kRows * kPairs; e += 128) {
    const int r = e / kPairs, q = e % kPairs;
    float sn, cs;
    sincosf(src[r][q % CH] * pow2(q / CH), &sn, &cs);
    sts16(x_at(g.xs, r, col + CH + q), __float2bfloat16_rn(sn));
    sts16(x_at(g.xs, r, col + CH + kPairs + q), __float2bfloat16_rn(cs));
  }
  for (int e = g.tid; e < kRows * kRest; e += 128) {
    const int r = e / kRest, f = e % kRest;
    const int c = f < CH ? f : f + 2 * kPairs;
    const float v = f < CH + NX ? src[r][f] : 0.f;
    sts16(x_at(g.xs, r, col + c), __float2bfloat16_rn(v));
  }
}

// The template's encoding [posenc_orig(warped, 10) | posenc_orig(hyper, 6) |
// 0 pad] into X[:, 256 : 384] from rows.raw.
__device__ __forceinline__ void encode_template(const Group& g) {
  constexpr int kXyzPairs = 3 * kXyzF, kHypPairs = kHypOut * kHypEncF;
  constexpr int kRest = kTmplEncP - 2 * (kXyzPairs + kHypPairs);
  const float(*raw)[8] = g.rows->raw;
#pragma unroll 3
  for (int e = g.tid; e < kRows * kXyzPairs; e += 128) {
    const int r = e / kXyzPairs, q = e % kXyzPairs;
    float sn, cs;
    sincosf(raw[r][q % 3] * pow2(q / 3), &sn, &cs);
    sts16(x_at(g.xs, r, kTmplEnc0 + 3 + q), __float2bfloat16_rn(sn));
    sts16(x_at(g.xs, r, kTmplEnc0 + 3 + kXyzPairs + q),
          __float2bfloat16_rn(cs));
  }
#pragma unroll 3
  for (int e = g.tid; e < kRows * kHypPairs; e += 128) {
    const int r = e / kHypPairs, q = e % kHypPairs;
    float sn, cs;
    sincosf(raw[r][3 + q % kHypOut] * pow2(q / kHypOut), &sn, &cs);
    const int c = kTmplEnc0 + kTmplXyz + kHypOut + q;
    sts16(x_at(g.xs, r, c), __float2bfloat16_rn(sn));
    sts16(x_at(g.xs, r, c + kHypPairs), __float2bfloat16_rn(cs));
  }
  for (int e = g.tid; e < kRows * kRest; e += 128) {
    const int r = e / kRest, f = e % kRest;
    int c;
    float v = 0.f;
    if (f < 3) {
      c = f;
      v = raw[r][f];
    } else if (f < 3 + kHypOut) {
      c = kTmplXyz + f - 3;
      v = raw[r][f];
    } else {
      c = kTmplEnc + f - 3 - kHypOut;
    }
    sts16(x_at(g.xs, r, kTmplEnc0 + c), __float2bfloat16_rn(v));
  }
}

// The SE(3) / quaternion trunk's encoding (se3_trunk.cuh's math) into
// X[:, 128 : 192].
__device__ __forceinline__ void encode_se3_tile(
    const Group& g, const float* __restrict__ scales) {
  constexpr int kRest = kSe3EncP - 2 * kSe3Trig;
  const float(*in)[12] = g.rows->in;
#pragma unroll 4
  for (int e = g.tid; e < kRows * kSe3Trig; e += 128) {
    const int r = e / kSe3Trig, b = e % kSe3Trig;
    float sn, cs;
    sincosf(se3_band_arg(in[r], b), &sn, &cs);
    sts16(x_at(g.xs, r, kWarpEnc + b), se3_feature(sn, b, scales));
    sts16(x_at(g.xs, r, kWarpEnc + kSe3Trig + b),
          se3_feature(cs, kSe3Trig + b, scales));
  }
  for (int e = g.tid; e < kRows * kRest; e += 128) {
    const int r = e / kRest, f = e % kRest;
    const float v = f < kEmbed ? in[r][3 + f] : 0.f;
    sts16(x_at(g.xs, r, kWarpEnc + 2 * kSe3Trig + f),
          se3_feature(v, 2 * kSe3Trig + f, scales));
  }
}

// The rays' rgb condition (bf16) into X[:, 128 : 176], eight loads in
// flight a thread.
__device__ __forceinline__ void load_condition(const Group& g,
                                               const bf16* __restrict__ cond) {
#pragma unroll 8
  for (int e = g.tid; e < kRows * kCondP; e += 128) {
    const int r = e / kCondP, f = e % kCondP;
    const bf16 v = f < kCond ? cond[(size_t)g.rows->ray[r] * kCond + f]
                             : __float2bfloat16_rn(0.f);
    sts16(x_at(g.xs, r, kCondCol + f), v);
  }
}

template <int kWarp>
__global__ void __launch_bounds__(kThreads, 1)
    level_fwd_kernel(const __grid_constant__ Maps<Table<kWarp>> maps,
                     const float* __restrict__ zs,
                     const float* __restrict__ origins,
                     const float* __restrict__ dirs,
                     const float* __restrict__ embed,
                     const bf16* __restrict__ rgb_cond,
                     const float* __restrict__ warp_scales,
                     const bf16* __restrict__ B, float* __restrict__ out,
                     float* __restrict__ raw_t, long long n_points,
                     int samples) {
  using T = Table<kWarp>;
  constexpr int H0 = T::kWarp, T0 = T::kFields;  // first sheet / template
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ring_base = base + kGroups * kXBytes;
  Rows* rows = reinterpret_cast<Rows*>(ring_base + kStages * kStageBytes);
  bf16* Bs = reinterpret_cast<bf16*>(rows + kGroups);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(Bs) + kBiasBytes);
  uint64_t* empty = full + kStages;

  for (int i = threadIdx.x; i < 2 * bias_offset<T>(T::kNum) / 16;
       i += kThreads)
    reinterpret_cast<uint4*>(Bs)[i] = reinterpret_cast<const uint4*>(B)[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kArrivals);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const long long n_tiles = (n_points + kRows - 1) / kRows;
  const long long n_pairs = (n_tiles + kGroups - 1) / kGroups;
  Ring ring{ring_base, full, empty, 0, 0};
  const int group = threadIdx.x >> 7;

  if (group == kGroups) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kGroups)
      for (long long pair = blockIdx.x; pair < n_pairs; pair += gridDim.x)
        produce_tile<T>(maps, ring, std::make_integer_sequence<int, T::kNum>());
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  Group g{base + group * kXBytes, smem_addr(base + group * kXBytes),
          rows + group, 1 + group, (int)(threadIdx.x & 127), 0};
  Rows& rw = *g.rows;
  for (long long pair = blockIdx.x; pair < n_pairs;
       pair += gridDim.x, ++g.it) {
    const long long row0 = (pair * kGroups + group) * kRows;
    row_inputs(g, row0, n_points, samples, zs, origins, dirs, embed);
    g.sync();

    if constexpr (kWarp == 0) {
      // Warp field -> warped = pts + delta.
      encode_posenc<3, kWarpF, kEmbed, kWarpEncP, 12>(g, kWarpEnc, rw.in);
      fence_async_smem();
      g.sync();
      hidden<T, 0, true>(g, ring, Bs);
      hidden<T, 1, true>(g, ring, Bs);
      hidden<T, 2, true>(g, ring, Bs);
      hidden<T, 3, true>(g, ring, Bs);
      hidden<T, 4, true>(g, ring, Bs);
      hidden<T, 5, true>(g, ring, Bs);
      head<T, 6>(g, ring, Bs, &rw.head[0][0], 8, 3);
      for (int e = g.tid; e < kRows * 3; e += 128)
        rw.raw[e / 3][e % 3] = rw.in[e / 3][e % 3] + rw.head[e / 3][e % 3];
    } else {
      // SE(3) / quaternion trunk -> (w, v) -> warped = retraction(w, v, pts).
      encode_se3_tile(g, warp_scales);
      fence_async_smem();
      g.sync();
      hidden<T, 0, true>(g, ring, Bs);
      hidden<T, 1, true>(g, ring, Bs);
      hidden<T, 2, true>(g, ring, Bs);
      hidden<T, 3, true>(g, ring, Bs);
      hidden<T, 4, true>(g, ring, Bs);
      hidden<T, 5, true>(g, ring, Bs);
      hidden<T, kSe3Trunk, false>(g, ring, Bs);  // rounded, no ReLU
      head<T, kSe3HeadW>(g, ring, Bs, &rw.head[0][0], 8, 3);
      head<T, kSe3HeadV>(g, ring, Bs, &rw.head[0][3], 8, 3);
      if (g.tid < kRows)
        retract<kWarp == 2>(rw.head[g.tid], rw.head[g.tid] + 3, rw.in[g.tid],
                            rw.raw[g.tid]);
    }

    // Hyper sheet -> hyper coordinates (its head writes raw[:, 3:7]).
    encode_posenc<3, kHypF, kEmbed, kHypEncP, 12>(g, kHypEnc, rw.in);
    fence_async_smem();
    g.sync();
    hidden<T, H0 + 0, true>(g, ring, Bs);
    hidden<T, H0 + 1, true>(g, ring, Bs);
    hidden<T, H0 + 2, true>(g, ring, Bs);
    hidden<T, H0 + 3, true>(g, ring, Bs);
    hidden<T, H0 + 4, true>(g, ring, Bs);
    hidden<T, H0 + 5, true>(g, ring, Bs);
    head<T, H0 + 6>(g, ring, Bs, &rw.raw[0][3], 8, kHypOut);
    if (g.tid < kRows) rw.raw[g.tid][7] = 0.f;
    // Training keeps the template's raw input for the backward kernels.
    if (raw_t != nullptr && g.tid < kRows && row0 + g.tid < n_points) {
      const float* rt = rw.raw[g.tid];
      float4* dst = reinterpret_cast<float4*>(raw_t) + 2 * (row0 + g.tid);
      dst[0] = make_float4(rt[0], rt[1], rt[2], rt[3]);
      dst[1] = make_float4(rt[4], rt[5], rt[6], 0.f);
    }

    // Template.
    encode_template(g);
    fence_async_smem();
    g.sync();
    hidden<T, T0 + 0, true>(g, ring, Bs);
    hidden<T, T0 + 1, true>(g, ring, Bs);
    hidden<T, T0 + 2, true>(g, ring, Bs);
    hidden<T, T0 + 3, true>(g, ring, Bs);
    hidden<T, T0 + 4, true>(g, ring, Bs);
    hidden<T, T0 + 5, true>(g, ring, Bs);
    hidden<T, T0 + 6, true>(g, ring, Bs);
    hidden<T, T0 + 7, true>(g, ring, Bs);
    hidden<T, T0 + 8, true>(g, ring, Bs);    // trunk logit (ReLU)
    // The bottleneck (rounded, no ReLU), the condition beside it.
    hidden<T, T0 + 9, false>(g, ring, Bs,
                             [&] { load_condition(g, rgb_cond); });
    head<T, T0 + 10>(g, ring, Bs, rw.sigma, 1, 1);  // alpha
    hidden<T, T0 + 11, true>(g, ring, Bs);
    hidden<T, T0 + 12, true>(g, ring, Bs);
    hidden<T, T0 + 13, true>(g, ring, Bs);
    hidden<T, T0 + 14, true>(g, ring, Bs);
    head<T, T0 + 15>(g, ring, Bs, &rw.head[0][0], 8, 3);  // rgb logits
    if (g.tid < kRows && row0 + g.tid < n_points) {
      const float* h = rw.head[g.tid];
      reinterpret_cast<float4*>(out)[row0 + g.tid] =
          make_float4(h[0], h[1], h[2], rw.sigma[g.tid]);
    }
  }
}

// Host side: the tensor maps of the blob W (cached by address and shape),
// the shared-memory attribute once per device, a persistent grid.
template <int kWarp>
int launch_level_fwd(const void* z, const void* origins, const void* dirs,
                     const void* embed, const void* rgb_cond,
                     const void* warp_scales, const void* weights,
                     const void* biases, void* out, void* raw_t,
                     long long n_points, int samples, void* stream) {
  using T = Table<kWarp>;
  static std::atomic<int> configured[kMaxDevices];
  int dev = 0, sms = 0;
  int status = current_device(&dev, &sms);
  if (status) return status;
  if (!configured[dev].load(std::memory_order_relaxed)) {
    const cudaError_t err = cudaFuncSetAttribute(
        level_fwd_kernel<kWarp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured[dev].store(1, std::memory_order_relaxed);
  }
  if (n_points <= 0) return 0;
  Maps<T> maps;
  const bf16* w = static_cast<const bf16*>(weights);
  for (int l = 0; l < T::kNum; ++l) {
    if (map_first<T>(l) != l) continue;
    int count = 1;
    while (l + count < T::kNum && same_shape<T>(l, l + count)) ++count;
    const Shape s = T::shape(l);
    status = cached_tensor_map(&maps.m[map_index<T>(l)],
                               w + weight_offset<T>(l), (long long)count * s.n,
                               s.k, s.k, box_rows(s));
    if (status) return status;
  }
  const long long pairs = ((n_points + kRows - 1) / kRows + kGroups - 1) /
                          kGroups;
  const unsigned grid = (unsigned)(pairs < sms ? pairs : sms);
  level_fwd_kernel<kWarp><<<grid, kThreads, kSmemBytes,
                            (cudaStream_t)stream>>>(
      maps, static_cast<const float*>(z), static_cast<const float*>(origins),
      static_cast<const float*>(dirs), static_cast<const float*>(embed),
      static_cast<const bf16*>(rgb_cond),
      static_cast<const float*>(warp_scales), static_cast<const bf16*>(biases),
      static_cast<float*>(out), static_cast<float*>(raw_t), n_points, samples);
  return (int)cudaGetLastError();
}

}  // namespace lf
}  // namespace

// The three instantiations (level_fwd_{trans,se3,quat}.cu).
#define HN_LEVEL_FWD_ARGS                                                   \
  const void *z, const void *origins, const void *dirs, const void *embed, \
      const void *rgb_cond, const void *warp_scales, const void *weights,   \
      const void *biases, void *out, void *raw_t, long long n_points,       \
      int samples, void *stream
extern "C" int hn_level_fwd_trans(HN_LEVEL_FWD_ARGS);
extern "C" int hn_level_fwd_se3(HN_LEVEL_FWD_ARGS);
extern "C" int hn_level_fwd_quat(HN_LEVEL_FWD_ARGS);
