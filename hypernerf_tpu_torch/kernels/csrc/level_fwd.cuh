// One HyperNeRF level forward in one kernel, for Hopper (sm_90a): the kernel
// template and its launcher, instantiated once per warp type by
// level_fwd_trans.cu, level_fwd_se3.cu and level_fwd_quat.cu, for the
// translation warp with the Nerfies template layout (the anneal
// configuration) by level_fwd_anneal.cu and with the SE(3) / quaternion warp
// by level_fwd_anneal_screw.cu, for the translation warp with the plane
// layout (axis_aligned_plane slicing: no sheet, the hyper coordinates are the
// ray's embedding) by level_fwd_plane.cu and with the SE(3) / quaternion warp
// by level_fwd_plane_screw.cu, and with the Nerfies plane layout by
// level_fwd_nerf_plane.cu (translation) and level_fwd_nerf_plane_screw.cu
// (one nvcc process each);
// fused_level.cu holds the entry point that dispatches to them. Its three stages (the warp, the sheet, the template) are device
// functions on one block (enter_block), which modular_fwd.cu runs
// one at a time for the per-module path: a field alone, the template alone,
// the SE(3) / quaternion trunk alone (the screw warp's stage without its
// retraction); tangents_fwd.cu runs the warp field and the trunk with their
// point-tangent streams on the same block.
//
// Replaces hypernerf_tpu/ops/pallas/fused_level.py `_fused` (forward,
// fused_level.py:1322; `_fwd_call_pipelined`, :1019, is a schedule of the
// same function) in its ray-native mode, for the flagship spec with each of
// its three warp types (translation, SE(3), quaternion:
// `_warp_fwd_tile_gen` :330-344), each with the bendy sheet or the
// axis-aligned plane (`_fields_fwd_core_gen` :385-407: the embedding is the
// hyper coordinates), posenc_orig field encodings, the template in one of
// its layouts (level_common.cuh TmplLayout: posenc_orig, the windowed
// Nerfies encoding, `fused_level.py` :76-87, 166-172, and each of the two
// with 8 hyper coordinates for the plane; a template parameter) with its
// two per-ray conditions (Cond below: an rgb
// condition of any width up to kCondP, `FusedLevelSpec.rgb_cond_ch`, and an
// alpha condition, `alpha_cond_ch`, fused_mlp.py:359-362, the
// use_nerf_embed settings' appearance code). When asked (training) it also
// writes the template's raw input raw_t = [warped | hyper | 0] (P, 8) fp32, (P, 16) with the plane
// layout, the residual the TPU kernel saves for its backward
// (fused_level.py:1339-1344).
// Per sample row p of ray p / S:
//   pts    = o + z * d
//   warped = pts + WarpMLP(posenc_orig(pts, 10) ++ embed)        6 x 128
//            or, SE(3) / quaternion (se3_trunk.cuh):
//            (w, v) = heads(Trunk(posenc(pts, 0..8) ++ embed))    6 x 128 + 128
//            warped = retraction(w, v, pts), fp32, one thread per row
//   hyper  = HyperMLP(posenc_orig(pts, 7) ++ embed)               6 x 64 -> 4
//            or, plane: hyper = embed (8), fp32
//   h      = Trunk(posenc_orig(warped, 10) ++ posenc_orig(hyper, 6))  8 x 256,
//            skip at 4, ReLU logit 256; or, given the window row w:
//            Trunk(w * [posenc(warped, 0..10, identity) ++
//                       posenc(hyper, 0..4)])
//            (hyper: 4 coordinates, or the plane's 8)
//   b      = Bottleneck(h)                                        256 -> 128
//   out    = [RgbBranch(b ++ rgb_cond) | AlphaHead(b ++ alpha_cond)]  (P, 4)
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
//    threads. The rgb condition's width is an argument of the call: its
//    columns fill the tile's kCondP condition slots, zero past the width,
//    whose weight columns are zero in the packed blob too. The alpha
//    condition's kEmbed columns are the alpha head's input after the
//    bottleneck; the packed table keeps that head at 8 x kBneck, so that no
//    offset of the three tables moves, and its condition columns' weights
//    come as a vector of their own: a thread per row dots them with its
//    ray's condition (kEmbed fp32 multiply-adds) before the head, whose
//    epilogue adds the sum to the product of the bottleneck columns.
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

constexpr int kRows = 64;                      // rows of a warpgroup's tile
constexpr int kBoxBytes = kRows * 128;         // 64 rows x 64 bf16 columns
constexpr int kStageRows = 128;                // weight rows of a stage
constexpr int kStageBytes = kStageRows * 128;  // 16 KB
constexpr int kStages = 6;  // the ring's stages (the plane block's: 5)

// Column plan of the tile (every K segment starts on a 64-column box):
//   warp      h [0, 128)   enc [128, 208)   (SE(3): enc [128, 192))
//   hyper     h [0, 64)    enc [64, 128)
//   template  h [0, 256)   enc [256, 384)   (PlaneEnc: enc [256, 448))
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
                  2 * bias_offset<TransTable>(TransTable::kNum) % 16 == 0 &&
                  2 * bias_offset<PlaneTable>(PlaneTable::kNum) <=
                      kBiasBytes &&
                  2 * bias_offset<Se3PlaneTable>(Se3PlaneTable::kNum) <=
                      kBiasBytes,
              "the biases copy in 16-byte pieces");

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

// A block's shape: G consumer warpgroups, each with its own tile of kRows
// rows x XC columns (XC / 64 boxes), a ring of S stages, and the producer
// warpgroup; `setmaxnreg` moves registers from the producer to the
// consumers. The level, and the template alone, run LevelBlock (PlaneEnc:
// PlaneBlock); a field alone reads and writes fewer columns, so
// more tiles fit a block (modular_fwd.cu).
// setmaxnreg only moves registers within the block's allocation at launch,
// which is kThreads x kEntryRegs (ptxas gives a kernel that uses setmaxnreg
// all that its launch bounds allow): a consumer count past that waits for
// registers that never come (a G = 4 block at 112 consumer registers did,
// until its bounded wait trapped).
template <int G, int XC, int S = kStages>
struct Block {
  static constexpr int kGroups = G, kCols = XC, kStages = S;
  using Ring = RingOf<S>;
  static constexpr int kThreads = 128 * (G + 1);
  static constexpr int kEntryRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kXBytes = XC / kBoxCols * kBoxBytes;
  static constexpr int kArrivals = 4 * G;  // consumer warps per stage
  static constexpr int kProducerRegs = G == 3 ? 56 : 40;
  static constexpr int kConsumerRegs = G == 2 ? 232 : G == 3 ? 152 : 104;
  static constexpr int kSmemBytes = 1024 + G * kXBytes + S * kStageBytes +
                                    G * (int)sizeof(Rows) + kBiasBytes +
                                    2 * S * 8;
  static_assert(G >= 2 && G <= 4 && XC % kBoxCols == 0, "a block's shape");
  static_assert(kSmemBytes <= 232448, "fits an SM's shared memory");
  static_assert(G * kConsumerRegs + kProducerRegs <= (G + 1) * kEntryRegs,
                "fits the block's registers");
};
// The block of the level and of the template alone in template layout L:
// two tiles of the trunk's 256 columns and the encoding's. The plane
// layout's 448-column tiles leave room for a ring of 5 stages.
template <class L>
using TmplBlock = Block<2, kTrunkW + L::kEncP,
                        (L::kEncP > kTmplEncP ? kStages - 1 : kStages)>;
using LevelBlock = TmplBlock<OrigEnc>;   // 384 columns, 6 stages
using PlaneBlock = TmplBlock<PlaneEnc>;  // 448 columns, 5 stages
static_assert(std::is_same<LevelBlock, TmplBlock<NerfEnc>>::value &&
                  std::is_same<LevelBlock, TmplBlock<NerfPlaneEnc>>::value,
              "the three 128-column layouts run the level's block");
constexpr int kMaxGroups = 4;

// The layer table of warp type kWarp (0 translation, 1 SE(3), 2 quaternion).
template <int kWarp>
using Table =
    typename std::conditional<kWarp == 0, TransTable, Se3Table>::type;
// The table of the level of warp type kWarp with template layout L: a
// plane layout's has no sheet and the layout's encoding width.
template <int kWarp, class L>
using LevelTable = typename std::conditional<
    L::kPlane,
    typename std::conditional<kWarp == 0, PlaneTableOf<L>,
                              Se3PlaneTableOf<L>>::type,
    Table<kWarp>>::type;

// The first tile column of layer l's input (a table without a sheet has
// kWarp == kFields).
template <class T>
__host__ __device__ constexpr int in_col(int l) {
  return l == 0 ? kWarpEnc
                : l == T::kFields ? kTmplEnc0 : l == T::kWarp ? kHypEnc : 0;
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

// The loads of layers L0, L0 + 1, ... of one pair of row tiles: the stage's
// (or the level's) layers in order.
template <class T, int L0, class R, int... I>
__device__ __forceinline__ void produce_tile(const Maps<T>& maps, R& ring,
                                             std::integer_sequence<int, I...>) {
  (produce_layer<T, L0 + I>(maps, ring), ...);
}

// Whether layers [first, last) are whole runs of the tensor maps, so that a
// kernel that runs them alone finds each of its maps starting at a run.
template <class T>
__host__ __device__ constexpr bool whole_runs(int first, int last) {
  return map_first<T>(first) == first &&
         (last == T::kNum || map_first<T>(last) == last);
}

// The maps of layers [first, last) over a blob w that starts at layer
// `first` (the level's blob: first = 0; a stage's own blob: its first
// layer); whole_runs(first, last) must hold. A kernel that runs those
// layers alone reads no other map.
template <class T>
int make_maps(Maps<T>* maps, const bf16* w, int first, int last) {
  for (int l = first; l < last; ++l) {
    if (map_first<T>(l) != l) continue;
    int count = 1;
    while (l + count < last && same_shape<T>(l, l + count)) ++count;
    const Shape s = T::shape(l);
    const int status = cached_tensor_map(
        &maps->m[map_index<T>(l)],
        w + weight_offset<T>(l) - weight_offset<T>(first),
        (long long)count * s.n, s.k, s.k, box_rows(s));
    if (status) return status;
  }
  return 0;
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

// The tangent streams' rows (tangents_fwd.cu; fields_bwd.cuh's kTan): a tile
// of 64 rows holds 16 points x 4 streams (the primal row, then d / d p_k for
// k = 0, 1, 2), 4 points a warp. Row 16 w + 4 s + q is stream s of point 4
// w + q, so a lane's two accumulator rows (lane / 4 and lane / 4 + 8 of its
// warp's 16) are streams s and s + 2 of one point, the primal row on lanes
// 0..15, and lane & 15 holds the primal row of the point and columns that
// lane holds: a tangent's ReLU mask is one shuffle. A point past 15 goes to
// the next 64 rows (kernel B's block tile of 128 rows holds 32 points).
__host__ __device__ constexpr int tan_row(int point, int stream) {
  return ((point >> 2) << 4) | (stream << 2) | (point & 3);
}
__host__ __device__ constexpr int tan_stream(int row) {
  return (row >> 2) & 3;
}
__host__ __device__ constexpr int tan_point(int row) {
  return ((row >> 4) << 2) | (row & 3);
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
__device__ long long level_fwd_trace[kMaxGroups][kTracePairs][32][4];
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
template <class T, int L, class R>
__device__ __forceinline__ void product(const Group& g, R& ring,
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

// bf16x2 of (v0, v1), each zeroed where bit `bit` (`bit` + 1) of the mask
// word `on` is clear: a tangent row's pair under its primal row's ReLU mask
// (tan_row's layout).
__device__ __forceinline__ uint32_t masked_round(float v0, float v1,
                                                 uint32_t on, int bit) {
  const float m0 = (on >> bit) & 1u ? v0 : 0.f;
  const float m1 = (on >> (bit + 1)) & 1u ? v1 : 0.f;
  uint32_t out;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(out) : "f"(m1), "f"(m0));
  return out;
}

// Hidden layer L: X[:, 0 : N] = bf16([relu](acc + b)), in place, two n8
// column groups of the warp's 16 rows a `stmatrix`. Bs: the biases in
// shared memory, read before the products (a load still in flight would
// hold up the first `wgmma`); post() runs after the stores, before the
// layer's closing barrier.
template <class T, int L, bool kRelu, class R, class Post>
__device__ __forceinline__ void hidden(const Group& g, R& ring,
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

template <class T, int L, bool kRelu, class R>
__device__ __forceinline__ void hidden(const Group& g, R& ring,
                                       const bf16* Bs) {
  hidden<T, L, kRelu>(g, ring, Bs, [] {});
}

// Head L (N = 8): dst[r * ld + c] = fp32 acc + b for c < n_out; with kAdd,
// (acc + dst[r * ld + c]) + b (a term the caller put there).
template <class T, int L, bool kAdd = false, class R>
__device__ __forceinline__ void head(const Group& g, R& ring,
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
      dst[rr * ld + c] = (kAdd ? acc.d[0][e] + dst[rr * ld + c]
                               : acc.d[0][e]) +
                         __bfloat162float(bias[c]);
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

// A field's encoding gives each row two threads: thread r and thread r +
// 64 of the warpgroup, H = 0 and 1, take alternate columns of row r, so a
// warp runs one H and its loops have compile-time bounds and strides. The
// loops stay rolled: on an H100 80GB HBM3 at 700 W
// (tools/time_modular_fwd.py), unrolled in full they made the fields 3 %
// faster but the level forward 10 % slower (its code grew), and the same
// layout for the template's encoding made the template 5 to 11 % slower,
// so the template keeps its loop over the tile's elements.
// Thread H of row r: pairs q = H, H + 2, ... of posenc_orig over CH
// channels x[0 : CH] (the row of the warpgroup's Rows) and F bands (band q
// / CH of channel q % CH, argument x * 2^band, exact), sin at tile column
// COL + CH + q and cos at COL + CH + CH F + q; then its columns f = H, H +
// 2, ... of the rest (identity f < CH, then the NX extras x[CH : CH + NX],
// then zeros). Each feature goes through window_feature with the window
// weight of its column in the encoding.
template <int CH, int F, int NX, int KP, int COL, int H>
__device__ __forceinline__ void posenc_row(const Group& g, int r,
                                           const float* x,
                                           const float* __restrict__ scales) {
  constexpr int kPairs = CH * F, kRest = KP - 2 * kPairs;
#pragma unroll 1
  for (int q = H; q < kPairs; q += 2) {
    float sn, cs;
    sincosf(x[q % CH] * pow2(q / CH), &sn, &cs);
    sts16(x_at(g.xs, r, COL + CH + q), window_feature(sn, CH + q, scales));
    sts16(x_at(g.xs, r, COL + CH + kPairs + q),
          window_feature(cs, CH + kPairs + q, scales));
  }
#pragma unroll 1
  for (int f = H; f < kRest; f += 2) {
    const int c = f < CH ? f : f + 2 * kPairs;
    const float v = f < CH + NX ? x[f] : 0.f;
    sts16(x_at(g.xs, r, COL + c), window_feature(v, c, scales));
  }
}

// [posenc_orig(x, F) | extra | 0 pad] of CH channels x = src[r][0 : CH]
// into X[:, COL : COL + KP]: identity, sin and cos of band k of channel c
// at k * CH + c (argument x * 2^k, exact), then NX columns src[r][CH : CH +
// NX] (the embedding), then zeros. scales: null (the level), or a field's
// window row over the KP columns (window_feature).
template <int CH, int F, int NX, int KP, int COL, int LD>
__device__ __forceinline__ void encode_posenc(
    const Group& g, const float (*src)[LD],
    const float* __restrict__ scales) {
  const int r = g.tid & (kRows - 1);
  if (g.tid < kRows)
    posenc_row<CH, F, NX, KP, COL, 0>(g, r, src[r], scales);
  else
    posenc_row<CH, F, NX, KP, COL, 1>(g, r, src[r], scales);
}

// The template's encoding in layout L ([x | sin | cos] of the warped point,
// then the hyper coordinates' [x | sin | cos] or, Nerfies, [sin | cos], then
// 0 pad) into X[:, 256 : 256 + L::kEncP]: the warped point from rows.raw,
// the hyper coordinates from rows.raw[:, 3:] or, plane, from the embedding's
// columns rows.in[:, 3:11]. Each feature goes through window_feature:
// scales is null but for the Nerfies layout's window row (kTmplEncP
// weights).
template <class L>
__device__ __forceinline__ void encode_template(
    const Group& g, const float* __restrict__ scales) {
  constexpr int kXyzPairs = 3 * kXyzF, kHypPairs = L::kHyp * L::kHypF;
  constexpr int kRest = L::kEncP - 2 * (kXyzPairs + kHypPairs);
  const float(*raw)[8] = g.rows->raw;
  auto hyp = [&](int r) -> const float* {
    return L::kPlane ? g.rows->in[r] + 3 : raw[r] + 3;
  };
#pragma unroll 3
  for (int e = g.tid; e < kRows * kXyzPairs; e += 128) {
    const int r = e / kXyzPairs, q = e % kXyzPairs;
    float sn, cs;
    sincosf(raw[r][q % 3] * pow2(q / 3), &sn, &cs);
    sts16(x_at(g.xs, r, kTmplEnc0 + 3 + q), window_feature(sn, 3 + q, scales));
    sts16(x_at(g.xs, r, kTmplEnc0 + 3 + kXyzPairs + q),
          window_feature(cs, 3 + kXyzPairs + q, scales));
  }
#pragma unroll 3
  for (int e = g.tid; e < kRows * kHypPairs; e += 128) {
    const int r = e / kHypPairs, q = e % kHypPairs;
    float sn, cs;
    sincosf(hyp(r)[q % L::kHyp] * pow2(q / L::kHyp), &sn, &cs);
    const int c = kTmplXyz + L::kHypId + q;
    sts16(x_at(g.xs, r, kTmplEnc0 + c), window_feature(sn, c, scales));
    sts16(x_at(g.xs, r, kTmplEnc0 + c + kHypPairs),
          window_feature(cs, c + kHypPairs, scales));
  }
  // The identity columns, then the pad, zero whatever the window's weight.
  for (int e = g.tid; e < kRows * kRest; e += 128) {
    const int r = e / kRest, f = e % kRest;
    bf16 v = __float2bfloat16_rn(0.f);
    int c;
    if (f < 3) {
      c = f;
      v = window_feature(raw[r][f], c, scales);
    } else if (f < 3 + L::kHypId) {
      c = kTmplXyz + f - 3;
      v = window_feature(hyp(r)[f - 3], c, scales);
    } else {
      c = L::kEnc + f - 3 - L::kHypId;
    }
    sts16(x_at(g.xs, r, kTmplEnc0 + c), v);
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
    sts16(x_at(g.xs, r, kWarpEnc + b), window_feature(sn, b, scales));
    sts16(x_at(g.xs, r, kWarpEnc + kSe3Trig + b),
          window_feature(cs, kSe3Trig + b, scales));
  }
  for (int e = g.tid; e < kRows * kRest; e += 128) {
    const int r = e / kRest, f = e % kRest;
    const float v = f < kEmbed ? in[r][3 + f] : 0.f;
    sts16(x_at(g.xs, r, kWarpEnc + 2 * kSe3Trig + f),
          window_feature(v, 2 * kSe3Trig + f, scales));
  }
}

// The template's per-ray conditions: the rgb condition (bf16, rgb_w
// columns, 0 <= rgb_w <= kCondP: a layout's posenc of the view directions,
// the nerf embedding after it, the embedding alone, or none), and the alpha
// condition (bf16, kEmbed columns, the embedding; null: none) with the
// alpha head's weights of those columns (alpha_w, kEmbed bf16).
struct Cond {
  const bf16* rgb;
  const bf16* alpha;
  const bf16* alpha_w;
  int rgb_w;
};

// The rays' rgb condition (bf16, cond_w columns) into X[:, 128 : 176], zero
// past cond_w, eight loads in flight a thread.
__device__ __forceinline__ void load_condition(const Group& g,
                                               const bf16* __restrict__ cond,
                                               int cond_w) {
#pragma unroll 8
  for (int e = g.tid; e < kRows * kCondP; e += 128) {
    const int r = e / kCondP, f = e % kCondP;
    const bf16 v = f < cond_w ? cond[(size_t)g.rows->ray[r] * cond_w + f]
                              : __float2bfloat16_rn(0.f);
    sts16(x_at(g.xs, r, kCondCol + f), v);
  }
}

// rows.sigma[r] = the alpha condition's part of the alpha head's product
// for row r, sum_c bf16 alpha[ray][c] alpha_w[c] in fp32 (0 without one),
// which the head's epilogue adds to the bottleneck's part.
__device__ __forceinline__ void alpha_condition(const Group& g,
                                                const Cond& c) {
  if (g.tid >= kRows) return;
  float s = 0.f;
  if (c.alpha != nullptr) {
    const bf16* a = c.alpha + (size_t)g.rows->ray[g.tid] * kEmbed;
#pragma unroll
    for (int k = 0; k < kEmbed; ++k)
      s = fmaf(__bfloat162float(a[k]), __bfloat162float(c.alpha_w[k]), s);
  }
  g.rows->sigma[g.tid] = s;
}

// Steps of B::kGroups 64-row tiles (pairs, in the level's block) that
// cover n_points rows, and the first row of warpgroup g's tile of step
// `pair`.
template <class B>
__host__ __device__ __forceinline__ long long tile_steps(
    long long n_points) {
  return ((n_points + kRows - 1) / kRows + B::kGroups - 1) / B::kGroups;
}
template <class B>
__device__ __forceinline__ long long first_row(const Group& g,
                                               long long pair) {
  return (pair * B::kGroups + g.bar - 1) * kRows;
}

// -- the stages ---------------------------------------------------------------
// The level's three stages are runs of its layer table: the warp (layers
// [0, T::kWarp)), the sheet ([T::kWarp, T::kFields)) and the template
// ([T::kFields, T::kNum)). The level kernel calls them in turn; the
// per-module kernels (modular_fwd.cu) call one alone (or the screw warp's
// trunk_stage), with its own row inputs and outputs. A stage reads its rows from the warpgroup's Rows and
// leaves its outputs there.

// A field (layers L0 .. L0 + 6 of T: posenc_orig of rows.in's points over F
// bands and the embedding, at the tile column in_col(L0); six hidden
// layers; an 8-wide head) on the tile: the head's first n_out fp32 outputs
// of row r go to dst[8 r + c]. scales: null, or the window row.
template <class T, int L0, int F, class R>
__device__ __forceinline__ void field_stage(const Group& g, R& ring,
                                            const bf16* Bs,
                                            const float* __restrict__ scales,
                                            float* dst, int n_out) {
  encode_posenc<3, F, kEmbed, T::shape(L0).k, in_col<T>(L0)>(g, g.rows->in,
                                                             scales);
  fence_async_smem();
  g.sync();
  hidden<T, L0 + 0, true>(g, ring, Bs);
  hidden<T, L0 + 1, true>(g, ring, Bs);
  hidden<T, L0 + 2, true>(g, ring, Bs);
  hidden<T, L0 + 3, true>(g, ring, Bs);
  hidden<T, L0 + 4, true>(g, ring, Bs);
  hidden<T, L0 + 5, true>(g, ring, Bs);
  head<T, L0 + 6>(g, ring, Bs, dst, 8, n_out);
}

// The translation warp: rows.raw[:, 0:3] = warped = pts + WarpMLP(...).
template <class T, class R>
__device__ __forceinline__ void translation_stage(const Group& g, R& ring,
                                                  const bf16* Bs) {
  Rows& rw = *g.rows;
  field_stage<T, 0, kWarpF>(g, ring, Bs, nullptr, &rw.head[0][0], 3);
  for (int e = g.tid; e < kRows * 3; e += 128)
    rw.raw[e / 3][e % 3] = rw.in[e / 3][e % 3] + rw.head[e / 3][e % 3];
}

// The SE(3) / quaternion trunk (layers 0 .. kSe3HeadV of T) on rows.in:
// rows.head[:, 0:3] = w, rows.head[:, 3:6] = v. scales: null, or the
// window row.
template <class T, class R>
__device__ __forceinline__ void trunk_stage(const Group& g, R& ring,
                                            const bf16* Bs,
                                            const float* __restrict__ scales) {
  Rows& rw = *g.rows;
  encode_se3_tile(g, scales);
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
}

// The SE(3) / quaternion warp: trunk -> (w, v) -> rows.raw[:, 0:3] =
// retraction(w, v, pts).
template <class T, int kWarp, class R>
__device__ __forceinline__ void screw_stage(const Group& g, R& ring,
                                            const bf16* Bs,
                                            const float* __restrict__ scales) {
  Rows& rw = *g.rows;
  trunk_stage<T>(g, ring, Bs, scales);
  if (g.tid < kRows)
    retract<kWarp == 2>(rw.head[g.tid], rw.head[g.tid] + 3, rw.in[g.tid],
                        rw.raw[g.tid]);
}

// The hyper sheet: rows.raw[:, 3:7] = hyper coordinates, rows.raw[:, 7] = 0.
template <class T, class R>
__device__ __forceinline__ void sheet_stage(const Group& g, R& ring,
                                            const bf16* Bs) {
  field_stage<T, T::kWarp, kHypF>(g, ring, Bs, nullptr, &g.rows->raw[0][3],
                                  kHypOut);
  if (g.tid < kRows) g.rows->raw[g.tid][7] = 0.f;
}

// The template on rows.raw = [warped | hyper | 0] (plane: the hyper
// coordinates in rows.in, encode_template) and the conditions of the rows'
// rays rows.ray: out[row0 + r] = [rgb logits | raw sigma] for rows below P.
// The encoding's layout is L (level_common.cuh TmplLayout): posenc_orig, of
// 4 or (plane) 8 hyper coordinates (tmpl_scales unused), or the Nerfies
// layout with its window row tmpl_scales. Each layout is its own
// instantiation, so a kernel carries no code of another; the conditions
// (Cond) are arguments of the call.
template <class T, class L, class R>
__device__ __forceinline__ void template_stage(
    const Group& g, R& ring, const bf16* Bs, const Cond& cond,
    const float* __restrict__ tmpl_scales, float* __restrict__ out,
    long long row0, long long n_points) {
  constexpr int T0 = T::kFields;
  Rows& rw = *g.rows;
  static_assert(T::shape(T::kFields).k == L::kEncP, "the layout's table");
  encode_template<L>(g, L::kNerfies ? tmpl_scales : nullptr);
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
  // The bottleneck (rounded, no ReLU), the rgb condition beside it, the
  // alpha condition's part of the alpha head.
  hidden<T, T0 + 9, false>(g, ring, Bs,
                           [&] {
                             load_condition(g, cond.rgb, cond.rgb_w);
                             alpha_condition(g, cond);
                           });
  head<T, T0 + 10, true>(g, ring, Bs, rw.sigma, 1, 1);  // alpha
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

// -- the block ----------------------------------------------------------------

// Whether layers [first, last) of T read and write only the first `cols`
// columns of a tile.
template <class T>
__host__ __device__ constexpr bool fits_columns(int first, int last,
                                                int cols) {
  for (int l = first; l < last; ++l)
    if (in_col<T>(l) + k_boxes(T::shape(l)) * kBoxCols > cols ||
        T::shape(l).n > cols)
      return false;
  return true;
}

// A persistent block of shape Blk that runs layers [L0, L1) of T on steps
// of Blk::kGroups row tiles, step = blockIdx.x, + gridDim.x, ... <
// tile_steps<Blk>(n_points): lays out the shared memory, copies the biases
// of those layers (B holds them from layer L0 on) in once and sets up the
// ring's barriers. The producer warpgroup then issues every step's loads
// and the call returns false for it; for a consumer warpgroup it returns
// true with its Group, the ring and the biases, and the caller runs the
// steps (first_row gives a tile's row 0).
template <class Blk, class T, int L0, int L1>
__device__ __forceinline__ bool enter_block(const Maps<T>& maps,
                                            const bf16* __restrict__ B,
                                            long long n_points, Group& g,
                                            typename Blk::Ring& ring,
                                            const bf16*& Bs) {
  static_assert(whole_runs<T>(L0, L1), "the layers' maps are whole runs");
  static_assert(fits_columns<T>(L0, L1, Blk::kCols), "the layers fit a tile");
  constexpr int kB0 = bias_offset<T>(L0), kB1 = bias_offset<T>(L1);
  static_assert(2 * kB0 % 16 == 0 && 2 * (kB1 - kB0) % 16 == 0,
                "the biases copy in 16-byte pieces");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ring_base = base + Blk::kGroups * Blk::kXBytes;
  Rows* rows =
      reinterpret_cast<Rows*>(ring_base + Blk::kStages * kStageBytes);
  bf16* bias = reinterpret_cast<bf16*>(rows + Blk::kGroups);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(bias) + kBiasBytes);
  uint64_t* empty = full + Blk::kStages;

  for (int i = threadIdx.x; i < 2 * (kB1 - kB0) / 16; i += Blk::kThreads)
    reinterpret_cast<uint4*>(bias + kB0)[i] =
        reinterpret_cast<const uint4*>(B)[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < Blk::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], Blk::kArrivals);
    }
    fence_barrier_init();
  }
  __syncthreads();

  ring = typename Blk::Ring{ring_base, full, empty, 0, 0};
  Bs = bias;
  const int group = threadIdx.x >> 7;
  if (group == Blk::kGroups) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        Blk::kProducerRegs));
    const long long n_pairs = tile_steps<Blk>(n_points);
    if (threadIdx.x == 128 * Blk::kGroups)
      for (long long pair = blockIdx.x; pair < n_pairs; pair += gridDim.x)
        produce_tile<T, L0>(maps, ring,
                            std::make_integer_sequence<int, L1 - L0>());
    return false;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      Blk::kConsumerRegs));
  g = Group{base + group * Blk::kXBytes,
            smem_addr(base + group * Blk::kXBytes),
            rows + group, 1 + group, (int)(threadIdx.x & 127), 0};
  return true;
}

// The level of warp type kWarp with template layout L (a plane layout: no
// sheet, raw_t of 16 columns).
template <int kWarp, class L>
__global__ void __launch_bounds__(TmplBlock<L>::kThreads, 1)
    level_fwd_kernel(const __grid_constant__ Maps<LevelTable<kWarp, L>> maps,
                     const float* __restrict__ zs,
                     const float* __restrict__ origins,
                     const float* __restrict__ dirs,
                     const float* __restrict__ embed, const Cond cond,
                     const float* __restrict__ warp_scales,
                     const float* __restrict__ tmpl_scales,
                     const bf16* __restrict__ B, float* __restrict__ out,
                     float* __restrict__ raw_t, long long n_points,
                     int samples) {
  using T = LevelTable<kWarp, L>;
  using Blk = TmplBlock<L>;
  Group g;
  typename Blk::Ring ring;
  const bf16* Bs;
  if (!enter_block<Blk, T, 0, T::kNum>(maps, B, n_points, g, ring, Bs))
    return;
  const long long n_pairs = tile_steps<Blk>(n_points);
  for (long long pair = blockIdx.x; pair < n_pairs;
       pair += gridDim.x, ++g.it) {
    const long long row0 = first_row<Blk>(g, pair);
    row_inputs(g, row0, n_points, samples, zs, origins, dirs, embed);
    g.sync();
    if constexpr (kWarp == 0)
      translation_stage<T>(g, ring, Bs);
    else
      screw_stage<T, kWarp>(g, ring, Bs, warp_scales);
    // The sheet's stage starts with a barrier; without it the template's
    // encoding, which reads every row of rows.raw, waits here for the
    // warp's last writes (the retraction's or the residual's, each row by
    // one thread).
    if constexpr (!L::kPlane)
      sheet_stage<T>(g, ring, Bs);
    else
      g.sync();
    // Training keeps the template's raw input for the backward kernels.
    if (raw_t != nullptr && g.tid < kRows && row0 + g.tid < n_points) {
      const float* rt = g.rows->raw[g.tid];
      float4* dst = reinterpret_cast<float4*>(raw_t) +
                    L::kRaw / 4 * (row0 + g.tid);
      if constexpr (L::kPlane) {  // [warped | embed | 0]
        const float* e = g.rows->in[g.tid] + 3;
        dst[0] = make_float4(rt[0], rt[1], rt[2], e[0]);
        dst[1] = make_float4(e[1], e[2], e[3], e[4]);
        dst[2] = make_float4(e[5], e[6], e[7], 0.f);
        dst[3] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        dst[0] = make_float4(rt[0], rt[1], rt[2], rt[3]);
        dst[1] = make_float4(rt[4], rt[5], rt[6], 0.f);
      }
    }
    template_stage<T, L>(g, ring, Bs, cond, tmpl_scales, out, row0,
                         n_points);
  }
}

// -- host side ----------------------------------------------------------------

// The persistent grid of blocks of shape Blk for n_points rows (one block
// per SM, never more than there are steps of tiles; 0 for no rows), once
// `kernel`'s shared-memory size is set on the current device
// (`configured`: that kernel's flags).
template <class Blk, class K>
int block_grid(K kernel, std::atomic<int>* configured, long long n_points,
               unsigned* grid) {
  int dev = 0, sms = 0;
  const int status = current_device(&dev, &sms);
  if (status) return status;
  if (!configured[dev].load(std::memory_order_relaxed)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Blk::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured[dev].store(1, std::memory_order_relaxed);
  }
  const long long steps = n_points <= 0 ? 0 : tile_steps<Blk>(n_points);
  *grid = (unsigned)(steps < sms ? steps : sms);
  return 0;
}

// The plan of a kernel of block shape Blk for layers [first, last) of T:
// config[0:8] = rows of a warpgroup's tile, consumer warpgroups, ring
// stages, bytes of a stage, dynamic shared memory, threads, tile columns,
// tensor maps of the layers; in_cols[i] = the first tile column of layer
// first + i's input; loads[4 i : 4 i + 4] = (layer, 64-column box of K,
// 128-row half of N, box rows) of the i-th weight load of one step of
// Blk::kGroups row tiles, in the order the producer issues and the
// consumers take them. Returns the number of loads (written up to
// max_loads).
template <class Blk, class T>
int forward_plan(int first, int last, int* config, int* in_cols, int* loads,
                 int max_loads) {
  int maps = 0;
  for (int l = first; l < last; ++l) maps += map_first<T>(l) == l ? 1 : 0;
  const int c[] = {kRows,           Blk::kGroups,  Blk::kStages,
                   kStageBytes,     Blk::kSmemBytes, Blk::kThreads,
                   Blk::kCols,      maps};
  for (int i = 0; i < 8; ++i) config[i] = c[i];
  int n = 0;
  for (int l = first; l < last; ++l) {
    in_cols[l - first] = in_col<T>(l);
    const Shape s = T::shape(l);
    for (int kb = 0; kb < k_boxes(s); ++kb)
      for (int nb = 0; nb < n_halves(s); ++nb, ++n)
        if (n < max_loads) {
          loads[4 * n] = l;
          loads[4 * n + 1] = kb;
          loads[4 * n + 2] = nb;
          loads[4 * n + 3] = box_rows(s);
        }
  }
  return n;
}

// Whether the conditions of a call are out of what the kernels take: an rgb
// condition of 0..kCondP columns (a pointer unless 0), an alpha condition
// with its weights or neither.
inline bool bad_conditions(const void* rgb_cond, const void* alpha_cond,
                           const void* alpha_w, int cond_w) {
  return cond_w < 0 || cond_w > kCondP || (cond_w > 0 && !rgb_cond) ||
         (alpha_cond == nullptr) != (alpha_w == nullptr);
}

// Host side: the tensor maps of the blob W (cached by address and shape),
// the shared-memory attribute once per device, a persistent grid. L: the
// template's layout (template_stage).
template <int kWarp, class L>
int launch_level_fwd(const void* z, const void* origins, const void* dirs,
                     const void* embed, const void* rgb_cond,
                     const void* alpha_cond, const void* alpha_w,
                     const void* warp_scales, const void* tmpl_scales,
                     const void* weights, const void* biases, void* out,
                     void* raw_t, long long n_points, int samples,
                     int cond_w, void* stream) {
  using T = LevelTable<kWarp, L>;
  using Blk = TmplBlock<L>;
  static std::atomic<int> configured[kMaxDevices];
  unsigned grid = 0;
  int status = block_grid<Blk>(level_fwd_kernel<kWarp, L>, configured,
                               n_points, &grid);
  if (status || grid == 0) return status;
  Maps<T> maps;
  status = make_maps<T>(&maps, static_cast<const bf16*>(weights), 0, T::kNum);
  if (status) return status;
  level_fwd_kernel<kWarp, L><<<grid, Blk::kThreads, Blk::kSmemBytes,
                               (cudaStream_t)stream>>>(
      maps, static_cast<const float*>(z), static_cast<const float*>(origins),
      static_cast<const float*>(dirs), static_cast<const float*>(embed),
      Cond{static_cast<const bf16*>(rgb_cond),
           static_cast<const bf16*>(alpha_cond),
           static_cast<const bf16*>(alpha_w), cond_w},
      static_cast<const float*>(warp_scales),
      static_cast<const float*>(tmpl_scales), static_cast<const bf16*>(biases),
      static_cast<float*>(out), static_cast<float*>(raw_t), n_points, samples);
  return (int)cudaGetLastError();
}

}  // namespace lf
}  // namespace

// The twelve instantiations: each warp type with the posenc_orig layout
// (level_fwd_{trans,se3,quat}.cu), with the Nerfies layout
// (level_fwd_anneal.cu, level_fwd_anneal_screw.cu), with the plane layout
// (level_fwd_plane.cu, level_fwd_plane_screw.cu) and with the Nerfies plane
// layout (level_fwd_nerf_plane.cu, level_fwd_nerf_plane_screw.cu).
#define HN_LEVEL_FWD_ARGS                                                   \
  const void *z, const void *origins, const void *dirs, const void *embed, \
      const void *rgb_cond, const void *alpha_cond, const void *alpha_w,    \
      const void *warp_scales, const void *tmpl_scales,                     \
      const void *weights, const void *biases, void *out, void *raw_t,     \
      long long n_points, int samples, int cond_w, void *stream
// The arguments of HN_LEVEL_FWD_ARGS, passed on.
#define HN_LEVEL_FWD_PASS                                                  \
  z, origins, dirs, embed, rgb_cond, alpha_cond, alpha_w, warp_scales,    \
      tmpl_scales, weights, biases, out, raw_t, n_points, samples, cond_w, \
      stream
extern "C" int hn_level_fwd_trans(HN_LEVEL_FWD_ARGS);
extern "C" int hn_level_fwd_se3(HN_LEVEL_FWD_ARGS);
extern "C" int hn_level_fwd_quat(HN_LEVEL_FWD_ARGS);
extern "C" int hn_level_fwd_anneal(HN_LEVEL_FWD_ARGS);
extern "C" int hn_level_fwd_plane(HN_LEVEL_FWD_ARGS);
extern "C" int hn_level_fwd_anneal_se3(HN_LEVEL_FWD_ARGS);
extern "C" int hn_level_fwd_anneal_quat(HN_LEVEL_FWD_ARGS);
extern "C" int hn_level_fwd_plane_se3(HN_LEVEL_FWD_ARGS);
extern "C" int hn_level_fwd_plane_quat(HN_LEVEL_FWD_ARGS);
extern "C" int hn_level_fwd_nerf_plane(HN_LEVEL_FWD_ARGS);
extern "C" int hn_level_fwd_nerf_plane_se3(HN_LEVEL_FWD_ARGS);
extern "C" int hn_level_fwd_nerf_plane_quat(HN_LEVEL_FWD_ARGS);
