// The fields backward (kernel B) for Hopper (sm_90a): the kernel template
// and its launcher, instantiated once per warp type by fields_bwd_trans.cu,
// fields_bwd_se3.cu and fields_bwd_quat.cu, and for the levels without a
// sheet (axis_aligned_plane) by fields_bwd_plane.cu (the translation warp)
// and fields_bwd_plane_screw.cu (the SE(3) and the quaternion warp; one
// nvcc process each);
// fused_level.cu holds the entry points that dispatch to them. Its block,
// slab pool, buffer plan and walk-back also run one field alone, from the
// field's own blobs (fields_bwd_alone.cuh: a translation-table field, the
// SE(3) trunk, and the trunk or the translation warp field with its three
// point-tangent streams, whose epilogues take a tangent row's ReLU mask from
// its primal row: kTan below; the translation warp's Jacobian holds its
// cotangent as two bf16 halves: kTransJac below).
//
// Replaces hypernerf_tpu/ops/pallas/fused_level.py `_fields_bwd_call` (:846,
// the tile body `_fields_bwd_core_gen` :409-450 over fused_field.py
// `_backward_tile_gen` :379-418 and the ray-mode writes `_write_ray_grads`
// :250-269), which is also the fields half of `_fused_bwd_pipelined` (:1260)
// and `_fused_bwd` (:1397), for the flagship spec with each of its three warp
// types: translation, SE(3) and quaternion (`_warp_bwd_tile_gen` :545-584),
// each with the sheet or without it (axis_aligned_plane: the hyper
// coordinates are the embedding, `_fields_bwd_core_gen` :446-449). The
// template's layout does not reach this kernel: it reads the field layers
// of the level's blob alone.
//
// In:  z (R, S), origins / directions (R, 3), embed (R, 8) fp32, and
//      dx_t (P, 8) fp32 = d[warped | hyper | 0] from the template backward.
// Out: d z (R, S); per ray [d origins | d directions | d embed] (R, 14),
//      summed over the ray's samples; fp32 dW / db of the 7 warp and 7 hyper
//      layers (9 warp layers with the SE(3) / quaternion trunk) in the
//      packed layout, added into one buffer.
// Per block tile of 128 sample rows: pts = o + z d; the hyper sheet is
// recomputed and walked back from dx_t[:, 3:7], then the warp field from
// dx_t[:, 0:3] (whose residual also passes dx_t[:, 0:3] straight to d pts;
// with the SE(3) / quaternion trunk: (w, v) from the recomputed trunk, the
// retraction's hand-derived VJP in fp32 per row, then the trunk from
// [d w | d v], no residual); d pts and d embed are the sums of both. A
// plane level (dx_t (P, 16) = d[warped | hyper (8) | 0]) has no sheet: the
// warp field (or the trunk and the retraction) alone, and d embed = the
// warp's + dx_t[:, 3:11].
// Rounding points are the JAX kernel's: every product takes bf16 operands
// with fp32 sums; the cotangent is rounded to bf16 after each layer's ReLU
// mask; a hidden layer's db sums that rounded cotangent, a head's db the
// fp32 one; layer 0's and the skip's parts of d enc are summed in fp32
// before the posenc VJP; the window row multiplies the trunk encoding and
// its cotangent.
//
// Bound: 3 x 132.6 K multiply-adds a sample (the recompute, g W and g^T h)
// against 48 bytes moved: operations bound it (2.1 M samples: 1.6 ms at the
// card's dense bf16 rate).
//
// Design: a persistent grid, one block per SM, walks block tiles of 128
// rows. A block is two consumer warpgroups of 64 rows each and a producer
// warpgroup, one thread of which issues the weight loads (`setmaxnreg` moves
// its registers to the consumers).
//  - The weights stream by TMA through a ring of kStages stages that both
//    consumer warpgroups read: one stage is one 64-column box of K of a
//    layer's packed (N, K) weight (N <= 128 rows), straight from
//    pack_level's blob through level_fwd.cuh's tensor maps, in the order of
//    a block tile: the sheet's layers forward, then backward, then the
//    warp's. The forward products read a stage as their K-major B operand;
//    the cotangent product g W reads the same stage as an MN-major B
//    operand, so no transposed copy of the weights exists.
//  - A field's stored layer outputs live in a pool of kSlots slabs of 16 KB
//    (64 bf16 columns x 128 rows, the two warpgroups' 64-row halves one
//    after the other, 128-byte swizzle), one slab per 64-column box. Each
//    warpgroup recomputes its rows with `wgmma` (bias, ReLU and rounding in
//    the epilogue, `stmatrix` into its half). The walk-back writes each
//    cotangent over the layer output it was masked by (that output is then
//    dead). The warp field's 14 (15) slabs do not fit beside the ring, so
//    the plan (`buf_plan`, modelled by fused_level.fields_bwd_plan) spills
//    the first layers' outputs to a per-block scratch in device memory (it
//    stays in L2) by bulk copies as they are written, and reloads each one
//    layer before the walk-back needs it. The sheet fits.
//  - Per layer of the walk-back: dW = G^T H over the block's 128 rows as
//    `wgmma` m64n64 products with both operands MN-major, one 64 x 64 unit
//    of dW each, the units shared between the two warpgroups; each unit is
//    added into an fp32 gradient buffer (one of kGradCopies, which stay in
//    L2) once per block tile, as 16-byte vector reductions (`atomicAdd` on
//    float4: red.v4.f32),
//    db as fp32 column sums of G; then the cotangent g W per warpgroup, the
//    ReLU mask of the stored output and the bf16 rounding in its epilogue.
//    Two block barriers a layer: dW reads both halves of the layer's input
//    before either warpgroup writes the cotangent over it.
//  - The narrow heads (out <= 4), the encodings and their VJPs, the
//    retraction's VJP and the per-ray sums are per-row work on the cores.
// dW / db and the per-ray sums are added by the blocks in an order that
// changes from run to run: their last bits are not deterministic.
// What the card shows (tools/trace_fields_bwd.py): a block tile's products,
// its dW adds, its epilogues and its row work take about a quarter of its
// cycles each, in series: the two warpgroups run in lockstep, and the adds
// are held back by the L2, which every block adds the same lines into (less
// so since each block takes its units in a rotated order). The weight
// stream waits under 5 %. A second dW accumulator in flight, or the biases
// held through the products, made ptxas spill, which cost more than the
// overlap they bought (tools/time_fields_bwd.py, one process, in turns).

#pragma once

#include "level_fwd.cuh"

namespace {
namespace fb {

constexpr int kGroups = 2;                     // consumer warpgroups
constexpr int kThreads = 128 * (kGroups + 1);  // + the producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kRows = 64;                          // a warpgroup's rows
constexpr int kTileRows = kGroups * kRows;         // a block tile: 128
constexpr int kHalfBytes = kRows * 128;            // 8 KB
constexpr int kSlabBytes = kGroups * kHalfBytes;   // 16 KB
constexpr int kSlots = 8;                          // slabs of the pool
constexpr int kStages = 4;
constexpr int kStageBytes = 128 * 128;             // 128 weight rows
constexpr int kArrivals = 4 * kGroups;             // consumer warps a stage
constexpr int kSpillSlabs = 10;                    // scratch slabs a block
constexpr int kBarrierBlock = 3;                   // named barrier, 256
// Copies of the gradient buffer: block b adds into copy b % kGradCopies
// (the wrapper sums them), which spreads the L2's work on the same lines
// (4 copies: 4 % faster than 1 on an H100, tools/time_fields_bwd.py).
constexpr int kGradCopies = 4;

// Fields: the hyper sheet, the translation warp, the SE(3) / quaternion
// trunk, and the translation warp with its three point-tangent streams
// walked back for its Jacobian (kTransJac: the warp field's layers, its own
// buffer plan). Buffers of a field: its encoding, the hidden outputs h0..h5,
// the trunk logit T (SE(3)), the skip layer's part of d enc, and `lo`, where
// a cotangent held as two bf16 halves keeps its low half (kTransJac).
constexpr int kSheet = 0, kTransWarp = 1, kSe3Warp = 2, kTransJac = 3;
constexpr int kEnc = 0, kT = 7, kSkip = 8, kLo = 9, kBufs = 10;
__host__ __device__ constexpr int h_buf(int i) { return 1 + i; }

// Where each buffer of a field lives: its slot per 64-column box during the
// recompute (`fwd`, also the walk-back's unless reloaded), the scratch slab
// of its first box if it is spilled as it is written (-1: never), and the
// walk-back layer after which it is reloaded into `reload` (-1: never; it is
// there from the next layer on). A cotangent g_i overwrites h_i; d enc
// overwrites the encoding where layer 0 reads it. The `lo` row is a double
// buffer, never spilled: the low half of g_i lies in its `fwd` slots for odd
// i and in its `reload` slots for even i (lo_slot), so a layer writes the
// new low half while it reads the old one.
struct BufPlan {
  int fwd[2];
  int spill;
  int after;
  int reload[2];
};

// The plan tables, one line per buffer (enc, h0..h5, T, skip, lo).
// fields_bwd_plan_table begin
__host__ __device__ constexpr BufPlan buf_plan(int f, int b) {
  constexpr BufPlan t[4][kBufs] = {
      {{{0, -1}, -1, -1, {-1, -1}},  // sheet
       {{1, -1}, -1, -1, {-1, -1}},
       {{2, -1}, -1, -1, {-1, -1}},
       {{3, -1}, -1, -1, {-1, -1}},
       {{4, -1}, -1, -1, {-1, -1}},
       {{5, -1}, -1, -1, {-1, -1}},
       {{6, -1}, -1, -1, {-1, -1}},
       {{-1, -1}, -1, -1, {-1, -1}},
       {{7, -1}, -1, -1, {-1, -1}},
       {{-1, -1}, -1, -1, {-1, -1}}},
      {{{0, 1}, 0, 2, {6, 7}},  // translation warp
       {{2, 3}, 2, 3, {2, 3}},
       {{4, 5}, 4, 4, {4, 5}},
       {{6, 7}, 6, 5, {6, 7}},
       {{2, 3}, -1, -1, {-1, -1}},
       {{4, 5}, -1, -1, {-1, -1}},
       {{6, 7}, -1, -1, {-1, -1}},
       {{-1, -1}, -1, -1, {-1, -1}},
       {{0, 1}, -1, -1, {-1, -1}},
       {{-1, -1}, -1, -1, {-1, -1}}},
      {{{0, -1}, -1, -1, {-1, -1}},  // SE(3) / quaternion trunk
       {{1, 2}, 0, 3, {6, 7}},
       {{3, 4}, 2, 4, {2, 3}},
       {{5, 6}, 4, 5, {4, 5}},
       {{7, 1}, 6, 6, {6, 7}},
       {{2, 3}, -1, -1, {-1, -1}},
       {{4, 5}, -1, -1, {-1, -1}},
       {{6, 7}, -1, -1, {-1, -1}},
       {{1, -1}, -1, -1, {-1, -1}},
       {{-1, -1}, -1, -1, {-1, -1}}},
      {{{6, 7}, 8, 1, {0, 1}},  // translation warp's Jacobian (kTransJac)
       {{0, 1}, 0, 2, {4, 5}},
       {{2, 3}, 2, 3, {0, 1}},
       {{0, 1}, 4, 4, {4, 5}},
       {{2, 3}, 6, 5, {0, 1}},
       {{4, 5}, -1, -1, {-1, -1}},
       {{0, 1}, -1, -1, {-1, -1}},
       {{-1, -1}, -1, -1, {-1, -1}},
       {{-1, -1}, -1, -1, {-1, -1}},
       {{2, 3}, -1, -1, {6, 7}}},
  };
  return t[f][b];
}
// fields_bwd_plan_table end

// The slot of box `box` of buffer b when walk-back layer i runs (i = the
// top layer + 1: the head step).
__host__ __device__ constexpr int slot_at(int f, int b, int box, int i) {
  return buf_plan(f, b).after > i ? buf_plan(f, b).reload[box]
                                  : buf_plan(f, b).fwd[box];
}

// slot_at's `i` for the recompute: every buffer at its forward slots.
constexpr int kFwd = 99;

// The slot of box `box` of the low half of cotangent g_i (the lo row).
__host__ __device__ constexpr int lo_slot(int f, int i, int box) {
  return i % 2 ? buf_plan(f, kLo).fwd[box] : buf_plan(f, kLo).reload[box];
}


// The slot of box `box` (0 or 1) of buffer B at walk-back layer I, from
// compile-time constants.
template <int F, int B, int I>
__device__ __forceinline__ int slot_of(int box) {
  constexpr int s0 = slot_at(F, B, 0, I), s1 = slot_at(F, B, 1, I);
  return box ? s1 : s0;
}

// The tangent streams' rows (kTan): a block tile of 128 rows holds 32
// points x 4 streams, 16 points a warpgroup in level_fwd.cuh's tan_row
// layout (a tangent's ReLU mask is one shuffle).
using lf::tan_row;
using lf::tan_stream;
constexpr int kTanPoints = kTileRows / 4;  // points of a block tile

template <int kWarp>
using Table = lf::Table<kWarp>;
// The table of the level of warp type kWarp, with the sheet or (kPlane)
// without it: its field layers are those of every plane table of the warp
// type, whatever the template's layout.
template <int kWarp, bool kPlane>
using LevelTable = typename std::conditional<
    kPlane,
    typename std::conditional<kWarp == 0, PlaneTable, Se3PlaneTable>::type,
    Table<kWarp>>::type;

template <int kWarp>
__host__ __device__ constexpr int warp_field() {
  return kWarp == 0 ? kTransWarp : kSe3Warp;
}
// The field's first layer in the level's table, its width, its top hidden
// layer (local index; the SE(3) trunk logit is layer 6) and its encoding's
// padded width.
template <class T, int F>
__host__ __device__ constexpr int base() {
  return F == kSheet ? T::kWarp : 0;
}
__host__ __device__ constexpr int width(int f) {
  return f == kSheet ? kHypW : kWarpW;
}
__host__ __device__ constexpr int top(int f) { return f == kSe3Warp ? 6 : 5; }
__host__ __device__ constexpr int enc_cols(int f) {
  return f == kSheet ? kHypEncP : f == kSe3Warp ? kSe3EncP : kWarpEncP;
}

// Local layer i's input box kb: (buffer, its box).
__host__ __device__ constexpr int in_buf(int f, int i, int kb) {
  return i == 0                                    ? kEnc
         : i == 6                                  ? h_buf(5)
         : i == 5 && kb >= width(f) / kBoxCols     ? kEnc
                                                   : h_buf(i - 1);
}
__host__ __device__ constexpr int in_box(int f, int i, int kb) {
  return i == 5 && kb >= width(f) / kBoxCols ? kb - width(f) / kBoxCols : kb;
}
__host__ __device__ constexpr int out_buf(int i) {
  return i == 6 ? kT : h_buf(i);
}
// Where the cotangent product of local layer i writes box kb of its output
// (d of the layer's input): (buffer, box); masked unless it is d enc or the
// skip part.
__host__ __device__ constexpr int dx_buf(int f, int i, int kb) {
  return i == 0 ? kEnc
                : i == 5 && kb >= width(f) / kBoxCols ? kSkip
                                                      : in_buf(f, i, kb);
}
__host__ __device__ constexpr int dx_box(int f, int i, int kb) {
  return dx_buf(f, i, kb) == kSkip ? kb - width(f) / kBoxCols : kb;
}
__host__ __device__ constexpr bool dx_masked(int f, int i, int kb) {
  return dx_buf(f, i, kb) != kEnc && dx_buf(f, i, kb) != kSkip;
}
// kTransJac: whether input box kb of local layer i is an encoding box that
// holds no band column (the embedding's and the pad's, past posenc's 63):
// zero on the tangent rows, and the primal rows carry no cotangent, so its
// dW units and its part of d enc are exactly zero and reach nothing.
__host__ __device__ constexpr bool jac_dead(int f, int i, int kb) {
  return f == kTransJac && in_buf(f, i, kb) == kEnc &&
         in_box(f, i, kb) * kBoxCols >= kWarpPts;
}

// The slot of input box kb of local layer i at walk-back layer `at` (or
// kFwd), and where its cotangent product writes box kb; -1 past the
// layer's ni boxes.
__host__ __device__ constexpr int in_slot(int f, int i, int kb, int at,
                                          int ni) {
  return kb < ni ? slot_at(f, in_buf(f, i, kb), in_box(f, i, kb), at) : -1;
}
__host__ __device__ constexpr int dx_slot(int f, int i, int kb, int ni) {
  return kb < ni ? slot_at(f, dx_buf(f, i, kb), dx_box(f, i, kb), i) : -1;
}

// The per-row fp32 scratch of a block tile.
struct Rows {
  float in[kTileRows][12];   // pts (3) | embed (8) | pad
  float zd[kTileRows][4];    // z | direction
  // [0:8] d warped (then its part that reaches d pts directly) | d hyper |
  // 0; [8:19] the sheet's d[pts | embed]; at the end [0:14] the row's
  // [d pts | z d pts | d embed].
  float acc[kTileRows][20];
  float hg[kTileRows][8];    // a head's fp32 cotangent (SE(3): d w)
  // SE(3): [0:6] w | v, [8:11] d v (first the heads' partial sums); then
  // [0:11] the warp's d[pts | embed].
  float se3[kTileRows][16];
  int ray[kTileRows];
};

constexpr int kSmemBytes = 1024 + kSlots * kSlabBytes +
                           kStages * kStageBytes + (int)sizeof(Rows) +
                           (2 * kStages + kBufs) * 8;
static_assert(kSmemBytes <= 232448, "fits an SM's shared memory");

// Built with -DHN_FIELDS_BWD_TRACE, thread 0 of each consumer warpgroup of
// block 0 adds up the SM clock of its first kTraceTiles block tiles by
// kind of work (the kCy* kinds below; tools/trace_fields_bwd.py reads
// them).
#ifdef HN_FIELDS_BWD_TRACE
constexpr int kTraceTiles = 4, kTraceKinds = 10;
__device__ long long fields_bwd_trace[kGroups][kTraceTiles][kTraceKinds];
#endif

// The weight ring: level_fwd.cuh's, with this kernel's stages.
using Ring = lf::RingOf<kStages>;
static_assert(kStageBytes == lf::kStageBytes, "level_fwd.cuh's stages");

// A consumer warpgroup's view.
struct Ctx {
  uint32_t pool;  // shared address of slot 0
  Rows* rows;
  Ring ring;
  uint64_t* reload;  // one mbarrier per buffer
  uint8_t* scratch;  // this block's spill slabs
  int group, tid, it;
#ifdef HN_FIELDS_BWD_TRACE
  long long last;
#endif
  __device__ __forceinline__ uint32_t slab(int s) const {
    return pool + s * kSlabBytes;
  }
  __device__ __forceinline__ uint32_t half(int s) const {
    return slab(s) + group * kHalfBytes;
  }
  __device__ __forceinline__ void sync() const {
    named_barrier(1 + group, 128);
  }
  __device__ __forceinline__ void block_sync() const {
    named_barrier(kBarrierBlock, 128 * kGroups);
  }
  // Trace: the cycles since the last mark go to `kind`.
  __device__ __forceinline__ void mark(int kind) {
#ifdef HN_FIELDS_BWD_TRACE
    if (blockIdx.x == 0 && tid == 0 && it < kTraceTiles) {
      const long long t = clock64();
      fields_bwd_trace[group][it][kind] += t - last;
      last = t;
    }
#endif
  }
};

// Kinds of work the trace adds cycles to.
enum {
  kCyWait = 0,  // waits for a weight stage
  kCyMma,       // products until retired
  kCyEpi,       // epilogues
  kCyFlush,     // the dW / db adds
  kCyBar,       // block barriers, waits for a reload
  kCyRow,       // row inputs, the bias loads of a layer
  kCyEnc,       // encodings
  kCyHead,      // the head steps (and the SE(3) heads and retraction)
  kCyVjp,       // the encodings' VJPs
  kCyRay,       // d z, d pts and the per-ray sums
};

__device__ __forceinline__ float lds_bf(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return __bfloat162float(__ushort_as_bfloat16(v));
}
__device__ __forceinline__ uint32_t lds32s(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v));
}
__device__ __forceinline__ uint32_t pack_bf(float lo, float hi) {
  uint32_t out;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(out) : "f"(hi), "f"(lo));
  return out;
}
// Four 8 x 8 bf16 matrices from shared memory, the addresses as stsm_x4
// takes them; each lane gets its fragment (row lane / 4, columns 2 (lane %
// 4), + 1) of each matrix.
__device__ __forceinline__ void ldsm_x4(uint32_t (&m)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(m[0]), "=r"(m[1]), "=r"(m[2]), "=r"(m[3])
      : "r"(addr));
}
// bf16x2 of (v0, v1), each zeroed where its half of `mask` (a stored ReLU
// output) is not positive.
__device__ __forceinline__ uint32_t mask_pack(float v0, float v1,
                                              uint32_t mask) {
  if (!(__uint_as_float(mask << 16) > 0.f)) v0 = 0.f;
  if (!(__uint_as_float(mask & 0xffff0000u) > 0.f)) v1 = 0.f;
  return pack_bf(v0, v1);
}
// fp32 v as two bf16 halves hi = bf16(v), lo = bf16(v - hi) (v - hi is
// exact in fp32): hi + lo carries 16 of its 24 mantissa bits.
__device__ __forceinline__ float lo_half(float v) {
  return v - round_bf(v);
}
// mask_pack's masked pair as two bf16x2 halves.
__device__ __forceinline__ void mask_split(float v0, float v1, uint32_t mask,
                                           uint32_t& hi, uint32_t& lo) {
  if (!(__uint_as_float(mask << 16) > 0.f)) v0 = 0.f;
  if (!(__uint_as_float(mask & 0xffff0000u) > 0.f)) v1 = 0.f;
  hi = pack_bf(v0, v1);
  lo = pack_bf(lo_half(v0), lo_half(v1));
}
// The value a two-halves cotangent stores: round_bf(v) + round_bf(lo_half(v)).
__device__ __forceinline__ float split_value(float v) {
  return round_bf(v) + round_bf(lo_half(v));
}

// -- the producer --------------------------------------------------------------

template <class T, int kFirst, bool kReverse, int... I>
__device__ __forceinline__ void produce_run(const lf::Maps<T>& maps,
                                            Ring& ring,
                                            std::integer_sequence<int, I...>) {
  constexpr int n = sizeof...(I);
  (lf::produce_layer<T, kReverse ? kFirst + n - 1 - I : kFirst + I>(maps,
                                                                    ring),
   ...);
}

// A block tile's loads: the sheet's hidden layers forward, then backward
// (no sheet in the plane level), then the warp's (6 hidden layers, and the
// SE(3) trunk logit).
template <int kWarp, bool kPlane>
__device__ __forceinline__ void produce_tile(
    const lf::Maps<LevelTable<kWarp, kPlane>>& maps, Ring& ring) {
  using T = LevelTable<kWarp, kPlane>;
  constexpr int nw = top(warp_field<kWarp>()) + 1;
  if constexpr (!kPlane) {
    produce_run<T, T::kWarp, false>(maps, ring,
                                    std::make_integer_sequence<int, 6>());
    produce_run<T, T::kWarp, true>(maps, ring,
                                   std::make_integer_sequence<int, 6>());
  }
  produce_run<T, 0, false>(maps, ring, std::make_integer_sequence<int, nw>());
  produce_run<T, 0, true>(maps, ring, std::make_integer_sequence<int, nw>());
}

// -- the recompute -------------------------------------------------------------

// Local hidden layer I of field F: its output = bf16([relu](in W^T + b)) into
// the warpgroup's half of the output's slots; spilled if the plan says so.
// kTan (tan_row's layout): a tangent row gets no bias and, for a ReLU layer,
// its primal row's mask (pre-activation > 0): bf16(acc * mask).
template <class T, int F, int I, bool kRelu, bool kTan = false>
__device__ __forceinline__ void fwd_layer(Ctx& c, const bf16* __restrict__ B) {
  constexpr int L = base<T, F>() + I;
  constexpr Shape sh = T::shape(L);
  constexpr int N = sh.n, J = N / 8;
  constexpr int kOut = out_buf(I), NI = lf::k_boxes(sh);
  constexpr int kIn0 = in_slot(F, I, 0, kFwd, NI);
  constexpr int kIn1 = in_slot(F, I, 1, kFwd, NI);
  constexpr int kIn2 = in_slot(F, I, 2, kFwd, NI);
  constexpr int kIn3 = in_slot(F, I, 3, kFwd, NI);
  static_assert(NI <= 4, "at most 256 inputs");
  const int warp = c.tid >> 5, lane = c.tid & 31, t = lane & 3;
  const bool leader = lane == 0;
  // The biases are read in the epilogue: held through the products they
  // made ptxas spill.
  const __nv_bfloat162* bias =
      reinterpret_cast<const __nv_bfloat162*>(B + bias_offset<T>(L)) + t;
  float acc[N / 2];
  int prev = -1;
#pragma unroll
  for (int kb = 0; kb < lf::k_boxes(sh); ++kb) {
    const int left = (sh.k - kb * kBoxCols) / 16;
    const int steps = left < 4 ? left : 4;
    c.mark(kb == 0 ? kCyRow : kCyMma);
    mbar_wait_bounded(&c.ring.full[c.ring.s], c.ring.phase);
    c.mark(kCyWait);
    const uint32_t a = c.half(kb == 0   ? kIn0
                              : kb == 1 ? kIn1
                              : kb == 2 ? kIn2
                                        : kIn3);
    const uint32_t b = smem_addr(c.ring.stage());
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (kk < steps)
        wgmma_ss(acc, sw128_desc_at(a + kk * 32, 16, kAtomBytes),
                 sw128_desc_at(b + kk * 32, 16, kAtomBytes),
                 kb + kk > 0 ? 1 : 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0 && leader) mbar_arrive(&c.ring.empty[prev]);
    prev = c.ring.s;
    c.ring.next();
  }
  wgmma_wait<0>();
  fence_fragment(acc);
  if (leader) mbar_arrive(&c.ring.empty[prev]);
  // A slot this layer writes may still be read by an earlier spill.
  if (c.tid == 0) bulk_wait_read();
  c.sync();
  c.mark(kCyMma);
  const int i7 = lane & 7, jo = lane >> 4;
  const uint32_t row = (16 * warp + i7 + (lane & 8)) * 128;
  if constexpr (kTan) {
    // The primal row's mask of the lane's 2J columns (bit 2 j + e: column
    // 8 j + 2 t + e), from lane & 15; every bit set for a linear layer.
    static_assert(J <= 16, "a lane's mask in one word");
    uint32_t on = 0xffffffffu;
    if constexpr (kRelu) {
      on = 0u;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const __nv_bfloat162 b = bias[4 * j];
        on |= (acc[4 * j] + __low2float(b) > 0.f ? 1u : 0u) << (2 * j);
        on |= (acc[4 * j + 1] + __high2float(b) > 0.f ? 1u : 0u)
              << (2 * j + 1);
      }
      on = __shfl_sync(0xffffffffu, on, lane & 15);
    }
    const bool primal = lane < 16;  // the lane's first row is stream 0
#pragma unroll
    for (int j = 0; j < J; j += 2) {
      const __nv_bfloat162 bb[2] = {bias[4 * j], bias[4 * j + 4]};
      const float* d = acc + 4 * j;
      const int jj = j + jo;
      lf::stsm_x4(c.half(slot_of<F, kOut, kFwd>(j >> 3)) + row +
                      (((jj & 7) ^ i7) << 4),
                  primal ? lf::bias_round<kRelu>(d[0], d[1], bb[0])
                         : lf::masked_round(d[0], d[1], on, 2 * j),
                  lf::masked_round(d[2], d[3], on, 2 * j),
                  primal ? lf::bias_round<kRelu>(d[4], d[5], bb[1])
                         : lf::masked_round(d[4], d[5], on, 2 * j + 2),
                  lf::masked_round(d[6], d[7], on, 2 * j + 2));
    }
  } else {
#pragma unroll
    for (int j = 0; j < J; j += 2) {
      const __nv_bfloat162 bb[2] = {bias[4 * j], bias[4 * j + 4]};
      const float* d = acc + 4 * j;
      const int jj = j + jo;
      lf::stsm_x4(c.half(slot_of<F, kOut, kFwd>(j >> 3)) + row +
                      (((jj & 7) ^ i7) << 4),
                  lf::bias_round<kRelu>(d[0], d[1], bb[0]),
                  lf::bias_round<kRelu>(d[2], d[3], bb[0]),
                  lf::bias_round<kRelu>(d[4], d[5], bb[1]),
                  lf::bias_round<kRelu>(d[6], d[7], bb[1]));
    }
  }
  fence_async_smem();
  c.sync();
  constexpr int kSpill = buf_plan(F, kOut).spill;
  if constexpr (kSpill >= 0) {
    if (c.tid == 0) {
#pragma unroll
      for (int box = 0; box < N / kBoxCols; ++box)
        bulk_store(c.scratch + (kSpill + box) * kSlabBytes +
                       c.group * kHalfBytes,
                   c.half(slot_of<F, kOut, kFwd>(box)), kHalfBytes);
      bulk_commit();
    }
  }
  c.mark(kCyEpi);
}

// Spill an encoding the plan spills (each warpgroup its half).
template <int F>
__device__ __forceinline__ void spill_enc(Ctx& c) {
  constexpr int kSpill = buf_plan(F, kEnc).spill;
  if constexpr (kSpill >= 0) {
    if (c.tid == 0) {
#pragma unroll
      for (int box = 0; box < (enc_cols(F) + 63) / 64; ++box)
        bulk_store(c.scratch + (kSpill + box) * kSlabBytes +
                       c.group * kHalfBytes,
                   c.half(slot_of<F, kEnc, kFwd>(box)), kHalfBytes);
      bulk_commit();
    }
  }
}

// [posenc_orig(pts, NF) | embed | 0 pad] of the warpgroup's rows into the
// field's encoding slots (as level_fwd.cuh's encode_posenc). scales: null
// (the level), or a field alone's window row over the KP columns
// (window_feature).
template <int F, int NF>
__device__ __forceinline__ void encode_field(
    Ctx& c, const float* __restrict__ scales) {
  constexpr int kPairs = 3 * NF, KP = enc_cols(F), kRest = KP - 2 * kPairs;
  const float(*in)[12] = c.rows->in + c.group * kRows;
  auto put = [&c, scales](int r, int col, float v) {
    const uint32_t box = c.half(slot_of<F, kEnc, kFwd>(col >> 6));
    lf::sts16(lf::x_at(box, r, col & 63), window_feature(v, col, scales));
  };
#pragma unroll 4
  for (int e = c.tid; e < kRows * kPairs; e += 128) {
    const int r = e / kPairs, q = e % kPairs;
    float sn, cs;
    sincosf(in[r][q % 3] * lf::pow2(q / 3), &sn, &cs);
    put(r, 3 + q, sn);
    put(r, 3 + kPairs + q, cs);
  }
  for (int e = c.tid; e < kRows * kRest; e += 128) {
    const int r = e / kRest, f = e % kRest;
    const int col = f < 3 ? f : f + 2 * kPairs;
    put(r, col, f < 3 + kEmbed ? in[r][f] : 0.f);
  }
}

// The SE(3) / quaternion trunk's encoding (se3_trunk.cuh's math) into its
// slot.
__device__ __forceinline__ void encode_trunk(Ctx& c,
                                             const float* __restrict__ scales) {
  constexpr int kRest = kSe3EncP - 2 * kSe3Trig;
  const uint32_t box = c.half(slot_of<kSe3Warp, kEnc, kFwd>(0));
  const float(*in)[12] = c.rows->in + c.group * kRows;
#pragma unroll 4
  for (int e = c.tid; e < kRows * kSe3Trig; e += 128) {
    const int r = e / kSe3Trig, b = e % kSe3Trig;
    float sn, cs;
    sincosf(se3_band_arg(in[r], b), &sn, &cs);
    lf::sts16(lf::x_at(box, r, b), window_feature(sn, b, scales));
    lf::sts16(lf::x_at(box, r, kSe3Trig + b),
              window_feature(cs, kSe3Trig + b, scales));
  }
  for (int e = c.tid; e < kRows * kRest; e += 128) {
    const int r = e / kRest, f = e % kRest;
    const float v = f < kEmbed ? in[r][3 + f] : 0.f;
    lf::sts16(lf::x_at(box, r, 2 * kSe3Trig + f),
              window_feature(v, 2 * kSe3Trig + f, scales));
  }
}

// -- the walk-back -------------------------------------------------------------

// Wait for buffer b's reload if walk-back layer I reads it from there.
template <int F, int I, int kB>
__device__ __forceinline__ void await_reload(Ctx& c) {
  if constexpr (buf_plan(F, kB).after > I)
    mbar_wait_bounded(&c.reload[kB], c.it & 1);
}

// Reload buffer B from its spill slabs if the plan does so after walk-back
// layer I.
template <int F, int I, int B>
__device__ __forceinline__ void reload(Ctx& c) {
  constexpr BufPlan bp = buf_plan(F, B);
  if constexpr (bp.after == I) {
    constexpr int boxes = bp.reload[1] >= 0 ? 2 : 1;
    fence_async_global();
    mbar_expect(&c.reload[B], boxes * kSlabBytes);
#pragma unroll
    for (int box = 0; box < boxes; ++box)
      bulk_load(c.slab(box ? bp.reload[1] : bp.reload[0]),
                c.scratch + (bp.spill + box) * kSlabBytes, kSlabBytes,
                &c.reload[B]);
  }
}
template <int F, int I, int... B>
__device__ __forceinline__ void reloads(Ctx& c,
                                        std::integer_sequence<int, B...>) {
  (reload<F, I, B>(c), ...);
}

// kTransJac: encoding box 0 of d enc's layer-0 or skip part on the
// warpgroup's rows into rows.acc, fp32, as the sum of its two halves. A
// tangent row of channel k keeps channel k's 20 band columns, column c = 3 +
// 3 j + k (sin band j) or 33 + 3 j + k (cos band j) at acc[(c - 3) / 3]: no
// other column reaches d pts (the identity's and the embedding's are
// constant in the points; box 1 holds none). kAdd adds layer 0's part to the
// skip's; else it stores.
template <bool kAdd>
__device__ __forceinline__ void jac_enc_rows(const Ctx& c,
                                             const float (&d)[32]) {
  const int warp = c.tid >> 5, lane = c.tid & 31, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + (lane >> 2) + 8 * h;
    const int k = tan_stream(r) - 1;
    if (k < 0) continue;  // a primal row
    float* acc = c.rows->acc[c.group * kRows + r];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        if (col < 3 || col >= kWarpPts || col % 3 != k) continue;
        const float v = split_value(d[4 * j + 2 * h + e]);
        float& a = acc[(col - 3) / 3];
        a = kAdd ? a + v : v;
      }
  }
}

// Walk-back layer I of field F: dW, db, then the cotangent through it.
// kTan (tan_row's layout): db sums the primal rows alone, and a tangent row's
// cotangent is masked by its primal row's stored output.
// kTransJac (kTan; only the tangent rows carry a cotangent, which stays fp32
// as two bf16 halves, hi over the layer's output and lo in the lo row): every
// product that reads g reads both halves into one accumulator; no db (it is
// exactly zero); the new cotangent is split into hi and lo after its mask;
// d enc's parts (layer 0's, the skip's) go to rows.acc in fp32, hi + lo,
// only the band columns of the row's own channel (jac_enc_rows).
template <class T, int F, int I, bool kTan = false>
__device__ __forceinline__ void back_layer(Ctx& c, float* __restrict__ grad_w,
                                           float* __restrict__ grad_b) {
  constexpr int L = base<T, F>() + I;
  constexpr Shape sh = T::shape(L);
  constexpr int NO = sh.n / kBoxCols, NI = lf::k_boxes(sh), NU = NO * NI;
  constexpr int kG = out_buf(I);  // g_I overwrote the layer's output
  constexpr bool kJac = F == kTransJac;
  static_assert(!kJac || kTan, "the Jacobian's cotangent rides tan_row");
  const int warp = c.tid >> 5, lane = c.tid & 31, t = lane & 3;
  const bool leader = lane == 0;

  await_reload<F, I, in_buf(F, I, 0)>(c);
  if constexpr (I == 5) await_reload<F, I, kEnc>(c);
  c.mark(kCyBar);

  // dW: the 64 x 64 units u with u % 2 == (group + I) % 2.
  constexpr int kG0 = slot_at(F, kG, 0, I + 1);
  constexpr int kG1 = NO > 1 ? slot_at(F, kG, 1, I + 1) : kG0;
  constexpr int kH0 = slot_at(F, in_buf(F, I, 0), in_box(F, I, 0), I);
  constexpr int kH1 =
      NI > 1 ? slot_at(F, in_buf(F, I, 1), in_box(F, I, 1), I) : kH0;
  constexpr int kH2 =
      NI > 2 ? slot_at(F, in_buf(F, I, 2), in_box(F, I, 2), I) : kH0;
  constexpr int kH3 =
      NI > 3 ? slot_at(F, in_buf(F, I, 3), in_box(F, I, 3), I) : kH0;
  static_assert(NO <= 2 && NI <= 4, "at most 128 outputs, 256 inputs");
  constexpr int kD0 = dx_slot(F, I, 0, NI), kD1 = dx_slot(F, I, 1, NI);
  constexpr int kD2 = dx_slot(F, I, 2, NI), kD3 = dx_slot(F, I, 3, NI);
  auto g_slot = [](int ob) { return ob ? kG1 : kG0; };
  auto h_slot = [](int ib) {
    return ib == 0 ? kH0 : ib == 1 ? kH1 : ib == 2 ? kH2 : kH3;
  };
  // kTransJac: the low halves of g_I (read) and of g_(I-1) (written).
  constexpr int kL0 = lo_slot(F, I, 0), kL1 = lo_slot(F, I, 1);
  constexpr int kO0 = lo_slot(F, I > 0 ? I - 1 : 0, 0);
  constexpr int kO1 = lo_slot(F, I > 0 ? I - 1 : 0, 1);
  auto lo_in = [](int ob) { return ob ? kL1 : kL0; };
  const int p = (c.group + I) & 1;
  float dw[32];
  auto issue_unit = [&](int u, float(&d)[32]) {
    const uint32_t a = c.slab(g_slot(u / NI)), b = c.slab(h_slot(u % NI));
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kTileRows / 16; ++s)
      wgmma_m64n64k16<1, 1>(d, sw128_desc_at(a + s * 2048, 8192, kAtomBytes),
                            sw128_desc_at(b + s * 2048, 8192, kAtomBytes),
                            s > 0 ? 1 : 0);
    if constexpr (kJac) {
      const uint32_t al = c.slab(lo_in(u / NI));
#pragma unroll
      for (int s = 0; s < kTileRows / 16; ++s)
        wgmma_m64n64k16<1, 1>(d,
                              sw128_desc_at(al + s * 2048, 8192, kAtomBytes),
                              sw128_desc_at(b + s * 2048, 8192, kAtomBytes),
                              1);
    }
    wgmma_commit();
  };
  float* dw_l = grad_w + weight_offset<T>(L);
  const bool odd = t & 1;
  auto flush_unit = [&](int u, float(&d)[32]) {
    const int ob = u / NI, ib = u % NI;
    const int n = ob * kBoxCols + 16 * warp + (lane >> 2) + (odd ? 8 : 0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float s0 = odd ? d[4 * j] : d[4 * j + 2];
      const float s1 = odd ? d[4 * j + 1] : d[4 * j + 3];
      const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
      const float4 v = odd ? make_float4(r0, r1, d[4 * j + 2], d[4 * j + 3])
                           : make_float4(d[4 * j], d[4 * j + 1], r0, r1);
      const int k = ib * kBoxCols + 8 * j + 2 * (t & ~1);
      if (k < sh.k)
        atomicAdd(reinterpret_cast<float4*>(dw_l + (size_t)n * sh.k + k), v);
    }
    // db of the unit's 64 outputs: the rounded cotangent's column sums, a
    // pair of neighbouring lanes per column, each over half of the rows
    // (kTan: that half's 16 primal rows). kTransJac: none, db is zero.
    if (!kJac && ib == 0) {
      const uint32_t g = c.slab(g_slot(ob));
      const int f = c.tid >> 1, half = c.tid & 1;
      float s0 = 0.f, s1 = 0.f;
      if constexpr (kTan) {
#pragma unroll 8
        for (int q = 0; q < kTanPoints / 2; q += 2) {
          s0 += lds_bf(lf::x_at(g, half * 64 + tan_row(q, 0), f));
          s1 += lds_bf(lf::x_at(g, half * 64 + tan_row(q + 1, 0), f));
        }
      } else {
#pragma unroll 8
        for (int r = half * 64; r < half * 64 + 64; r += 2) {
          s0 += lds_bf(lf::x_at(g, r, f));
          s1 += lds_bf(lf::x_at(g, r + 1, f));
        }
      }
      s0 += s1;
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      if (!half) atomicAdd(grad_b + bias_offset<T>(L) + ob * kBoxCols + f, s0);
    }
  };
  // This warpgroup's Mp units, in an order rotated by the block so that
  // the blocks do not all add into the same lines at once.
  const int Mp = (NU - p + 1) / 2;
  const int rot = Mp > 0 ? (int)(blockIdx.x % Mp) : 0;
  auto unit = [&](int m) {
    const int q = m + rot;
    return 2 * (q >= Mp ? q - Mp : q) + p;
  };
  // One unit at a time: a second accumulator in flight made ptxas spill
  // (the other warpgroup's products overlap this one's adds).
  for (int m = 0; m < Mp; ++m) {
    if (jac_dead(F, I, unit(m) % NI)) continue;
    issue_unit(unit(m), dw);
    wgmma_wait<0>();
    fence_fragment(dw);
    c.mark(kCyMma);
    flush_unit(unit(m), dw);
    c.mark(kCyFlush);
  }

  // g W: one ring stage a box of the layer's K, read MN-major; box 0's
  // products go out before the barrier.
  float dx[2][32];
  int stage[NI];
  // A dead box's stage is released unread.
  auto skip_box = [&]() {
    mbar_wait_bounded(&c.ring.full[c.ring.s], c.ring.phase);
    if (leader) mbar_arrive(&c.ring.empty[c.ring.s]);
    c.ring.next();
  };
  auto issue_box = [&](int kb, float(&d)[32]) {
    c.mark(kCyMma);
    mbar_wait_bounded(&c.ring.full[c.ring.s], c.ring.phase);
    c.mark(kCyWait);
    const uint32_t b = smem_addr(c.ring.stage());
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < sh.n / 16; ++s)
      wgmma_m64n64k16<0, 1>(
          d,
          sw128_desc_at(c.half(g_slot(s >> 2)) + (s & 3) * 32, 16, kAtomBytes),
          sw128_desc_at(b + s * 2048, 8192, kAtomBytes), s > 0 ? 1 : 0);
    if constexpr (kJac)  // the low half, the same weight stage
#pragma unroll
      for (int s = 0; s < sh.n / 16; ++s)
        wgmma_m64n64k16<0, 1>(
            d,
            sw128_desc_at(c.half(lo_in(s >> 2)) + (s & 3) * 32, 16,
                          kAtomBytes),
            sw128_desc_at(b + s * 2048, 8192, kAtomBytes), 1);
    wgmma_commit();
    stage[kb] = c.ring.s;
    c.ring.next();
  };
  issue_box(0, dx[0]);
  c.mark(kCyMma);
  // Both warpgroups' dW have read the layer's input before it is written.
  c.block_sync();
  c.mark(kCyBar);
  static_assert(!jac_dead(F, I, 0), "box 0 is read");
#pragma unroll
  for (int kb = 0; kb < NI; ++kb) {
    if (jac_dead(F, I, kb)) continue;  // skipped when it was next
    if (kb + 1 < NI && jac_dead(F, I, kb + 1)) skip_box();
    if (kb + 1 < NI && !jac_dead(F, I, kb + 1)) {
      issue_box(kb + 1, dx[(kb + 1) & 1]);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    float(&d)[32] = dx[kb & 1];
    fence_fragment(d);
    if (leader) mbar_arrive(&c.ring.empty[stage[kb]]);
    c.mark(kCyMma);
    const uint32_t dst = c.half(kb == 0   ? kD0
                                : kb == 1 ? kD1
                                : kb == 2 ? kD2
                                          : kD3);
    const bool masked = dx_masked(F, I, kb);
    if (kJac && !masked) {  // d enc's part: fp32 rows
      jac_enc_rows<I == 0>(c, d);
      c.mark(kCyEpi);
      continue;
    }
    // Two n8 column groups of the warp's 16 rows a `stmatrix` (as
    // level_fwd.cuh's hidden()), the ReLU mask read at the same places with
    // `ldmatrix`, which returns it in the accumulator's fragment layout.
    const int i7 = lane & 7, jo = lane >> 4;
    const uint32_t row = dst + (16 * warp + i7 + (lane & 8)) * 128;
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const uint32_t addr = row + ((((j + jo) & 7) ^ i7) << 4);
      const float* e = d + 4 * j;
      uint32_t m[4] = {0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u};
      if (masked) {
        ldsm_x4(m, addr);
        if constexpr (kTan) {  // both rows take the primal row's (lane & 15)
          m[0] = m[1] = __shfl_sync(0xffffffffu, m[0], lane & 15);
          m[2] = m[3] = __shfl_sync(0xffffffffu, m[2], lane & 15);
        }
      }
      if constexpr (kJac) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mask_split(e[2 * q], e[2 * q + 1], m[q], hi[q], lo[q]);
        lf::stsm_x4(addr, hi[0], hi[1], hi[2], hi[3]);
        // g_(I-1)'s low half, at the same place of its own slot.
        lf::stsm_x4(addr - dst + c.half(kb ? kO1 : kO0), lo[0], lo[1], lo[2],
                    lo[3]);
      } else {
        lf::stsm_x4(addr, mask_pack(e[0], e[1], m[0]),
                    mask_pack(e[2], e[3], m[1]), mask_pack(e[4], e[5], m[2]),
                    mask_pack(e[6], e[7], m[3]));
      }
    }
    c.mark(kCyEpi);
  }
  fence_async_smem();
  c.block_sync();
  c.mark(kCyBar);
  // Reloads the plan issues after this layer (block thread 0).
  if (c.group == 0 && c.tid == 0)
    reloads<F, I>(c, std::make_integer_sequence<int, kBufs>());
}

// The head step of the translation warp (n_out 3) or the sheet (n_out 4),
// or the SE(3) trunk's w and v heads: dW / db of the head(s), then the
// cotangent of their input (the top hidden output, or the trunk logit),
// bf16, masked by that output's ReLU (not for the linear trunk logit),
// written over it. The heads' fp32 cotangents: rows.hg[:, 0:n] (and, SE(3),
// rows.se3[:, 8:11] for v). kTan (tan_row's layout): db sums the primal rows
// alone. kTransJac: the fp32 cotangent, unrounded, for dW and g W_head; no
// db (zero); a point's tangent rows masked by its primal row and split into
// hi (over h5) and lo, its primal row's cotangent zero.
template <class T, int F, bool kTan = false>
__device__ __forceinline__ void head_back(Ctx& c, const bf16* __restrict__ W,
                                          float* __restrict__ grad_w,
                                          float* __restrict__ grad_b) {
  constexpr bool kSe3 = F == kSe3Warp, kJac = F == kTransJac;
  constexpr int K = width(F), kIn = kSe3 ? kT : h_buf(5);
  constexpr int L0 = base<T, F>() + (kSe3 ? kSe3HeadW : 6);
  constexpr int n_out = F == kSheet ? kHypOut : 3;
  constexpr int kHeads = kSe3 ? 2 : 1;
  constexpr int kI = top(F) + 1;
  constexpr long long kW0 = weight_offset<T>(L0);
  constexpr long long kW1 = weight_offset<T>(L0 + kHeads - 1);
  constexpr int kB0 = bias_offset<T>(L0), kB1 = bias_offset<T>(L0 + kHeads - 1);
  Rows& rw = *c.rows;
  // Head h's fp32 cotangents: a row stride and a base.
  auto cot = [&](int h) { return h ? &rw.se3[0][8] : &rw.hg[0][0]; };
  const int t = c.group * 128 + c.tid;
  // dW: a thread per (head, input column, part of the 128 rows), its n_out
  // sums side by side; the parts > 0 leave theirs in rows.se3 (free here
  // unless there are two heads, which take every thread in one part), part
  // 0 adds them up after the barrier; then db, a thread per (head, output).
  constexpr int kCols = kHeads * K, kParts = 128 * kGroups / kCols;
  static_assert(kParts == 1 || !kSe3, "rows.se3 holds d v");
  static_assert((kParts - 1) * kCols * n_out <= kTileRows * 16,
                "the parts fit rows.se3");
  float* part_sums = &rw.se3[0][0];
  const int col = t % kCols, part = t / kCols;
  const int h = col / K, k_dw = col % K;
  float s[n_out];
  if (part < kParts) {
    const int stride = h ? 16 : 8;
    const uint32_t box = c.slab(slot_of<F, kIn, kI>(k_dw >> 6));
    const float* g = cot(h);
#pragma unroll
    for (int n = 0; n < n_out; ++n) s[n] = 0.f;
    constexpr int kPartRows = kTileRows / kParts;
#pragma unroll 4
    for (int r = part * kPartRows; r < (part + 1) * kPartRows; ++r) {
      const float x = lds_bf(lf::x_at(box, r, k_dw & 63));
#pragma unroll
      for (int n = 0; n < n_out; ++n)
        s[n] += (kJac ? g[r * stride + n] : round_bf(g[r * stride + n])) * x;
    }
    if (part > 0)
#pragma unroll
      for (int n = 0; n < n_out; ++n)
        part_sums[((part - 1) * kCols + col) * n_out + n] = s[n];
  }
  if (!kJac && t < kHeads * n_out) {
    const int hb = t / n_out, n = t % n_out, stride = hb ? 16 : 8;
    const float* g = cot(hb);
    float sb = 0.f;
    if constexpr (kTan) {
      for (int q = 0; q < kTanPoints; ++q) sb += g[tan_row(q, 0) * stride + n];
    } else {
      for (int r = 0; r < kTileRows; ++r) sb += g[r * stride + n];
    }
    atomicAdd(grad_b + (hb ? kB1 : kB0) + n, sb);
  }
  c.mark(kCyHead);
  c.block_sync();
  c.mark(kCyBar);
  if (part == 0)
#pragma unroll
    for (int n = 0; n < n_out; ++n) {
      float sum = s[n];
      for (int q = 1; q < kParts; ++q)
        sum += part_sums[((q - 1) * kCols + col) * n_out + n];
      atomicAdd(grad_w + (h ? kW1 : kW0) + n * K + k_dw, sum);
    }
  // The input's cotangent: a thread per pair of columns (its head weights
  // in registers) and every (128 / (K / 2))-th row of the warpgroup's.
  constexpr int kPairs = K / 2, kStep = 128 / kPairs;
  const int k = 2 * (c.tid % kPairs);
  float w[kHeads][n_out][2];
#pragma unroll
  for (int h = 0; h < kHeads; ++h)
#pragma unroll
    for (int n = 0; n < n_out; ++n)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        w[h][n][q] = __bfloat162float(W[(h ? kW1 : kW0) + n * K + k + q]);
  const uint32_t box = c.half(slot_of<F, kIn, kI>(k >> 6));
  if constexpr (kJac) {
    const uint32_t lo = c.half(lo_slot(F, 5, k >> 6));
    for (int q = c.tid / kPairs; q < kRows / 4; q += kStep) {
      const uint32_t at = lf::x_at(box, tan_row(q, 0), k & 63);
      const uint32_t m = lds32s(at);
      sts32(at, 0u);
      sts32(at - box + lo, 0u);
#pragma unroll
      for (int st = 1; st < 4; ++st) {
        const int r = tan_row(q, st);
        const float* g = rw.hg[c.group * kRows + r];
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = 0.f;
#pragma unroll
          for (int n = 0; n < n_out; ++n) v[e] += g[n] * w[0][n][e];
        }
        uint32_t hi, lh;
        mask_split(v[0], v[1], m, hi, lh);
        const uint32_t addr = lf::x_at(box, r, k & 63);
        sts32(addr, hi);
        sts32(addr - box + lo, lh);
      }
    }
  } else {
    for (int r = c.tid / kPairs; r < kRows; r += kStep) {
      const int R = c.group * kRows + r;
      float v[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        const float* g = cot(h) + R * (h ? 16 : 8);
        float gr[n_out];
#pragma unroll
        for (int n = 0; n < n_out; ++n) gr[n] = round_bf(g[n]);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float s = 0.f;
#pragma unroll
          for (int n = 0; n < n_out; ++n) s += gr[n] * w[h][n][q];
          v[q] += s;
        }
      }
      const uint32_t addr = lf::x_at(box, r, k & 63);
      if (!kSe3) {
        const uint32_t m = lds32s(addr);
        if (!(__uint_as_float(m << 16) > 0.f)) v[0] = 0.f;
        if (!(__uint_as_float(m & 0xffff0000u) > 0.f)) v[1] = 0.f;
      }
      sts32(addr, pack_bf(v[0], v[1]));
    }
  }
  fence_async_smem();
  c.mark(kCyHead);
  c.block_sync();
  c.mark(kCyBar);
}

// The SE(3) / quaternion trunk's w and v heads on the warpgroup's rows
// (fp32), then the retraction's VJP per row: d warped (rows.acc[:, 0:3]) ->
// d w (rows.hg), d v (rows.se3[:, 8:11]) and the part of d warped that
// reaches d pts directly (rows.acc[:, 0:3]). T: the level's table, whose
// first layers are the trunk's.
template <class T, int kWarp>
__device__ __forceinline__ void trunk_heads_and_retraction(
    Ctx& c, const bf16* __restrict__ W, const bf16* __restrict__ B) {
  static_assert(T::kWarp == Se3Table::kWarp, "the trunk leads the table");
  Rows& rw = *c.rows;
  const int r = c.tid & (kRows - 1), kh = c.tid >> 6;
  const int R = c.group * kRows + r;
  const uint32_t box = c.half(slot_of<kSe3Warp, kT, kFwd>(kh));
  const bf16* ww = W + weight_offset<T>(kSe3HeadW) + kh * 64;
  const bf16* wv = W + weight_offset<T>(kSe3HeadV) + kh * 64;
  float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int k = 0; k < 64; ++k) {
    const float x = lds_bf(lf::x_at(box, r, k));
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      s[n] += x * __bfloat162float(ww[n * kSe3W + k]);
      s[3 + n] += x * __bfloat162float(wv[n * kSe3W + k]);
    }
  }
  if (kh == 1)
#pragma unroll
    for (int n = 0; n < 6; ++n) rw.se3[R][8 + n] = s[n];
  c.sync();
  if (kh == 0) {
    const bf16* bw = B + bias_offset<T>(kSe3HeadW);
    const bf16* bv = B + bias_offset<T>(kSe3HeadV);
    float w[3], v[3];
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      w[n] = (s[n] + rw.se3[R][8 + n]) + __bfloat162float(bw[n]);
      v[n] = (s[3 + n] + rw.se3[R][11 + n]) + __bfloat162float(bv[n]);
    }
    const float g[3] = {rw.acc[R][0], rw.acc[R][1], rw.acc[R][2]};
    float dwv[3], dvv[3], dp[3];
    retract_bwd<kWarp == 2>(w, v, rw.in[R], g, dwv, dvv, dp);
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      rw.hg[R][n] = dwv[n];
      rw.se3[R][8 + n] = dvv[n];
      rw.acc[R][n] = dp[n];
    }
  }
  c.mark(kCyHead);
}

// d enc = layer 0's part + the skip part (both bf16, summed in fp32, times
// the window row), through the encoding's VJP: d[pts | embed] of the
// warpgroup's rows into dst[R * stride : R * stride + 11] (R the block
// row). A point channel's bands are split between a pair of neighbouring
// lanes, whose sums are added with a shuffle; then the embedding's
// channels pass through.
template <int F, int NF>
__device__ __forceinline__ void encoding_vjp(Ctx& c, float* dst, int stride,
                                             const float* __restrict__ scales) {
  constexpr bool kSe3 = F == kSe3Warp;
  constexpr int kPts = 3 * (1 + 2 * NF), kHalf = (NF + 1) / 2;
  // Where the trig bands and the embedding start in the encoding.
  constexpr int kSin = kSe3 ? 0 : 3, kCos = kSin + 3 * NF;
  constexpr int kEmb = kSe3 ? 2 * kSe3Trig : kPts;
  Rows& rw = *c.rows;
  const uint32_t enc0 = c.half(slot_of<F, kEnc, 0>(0));
  const uint32_t enc1 = c.half(slot_of<F, kEnc, 0>(1));
  const uint32_t skip0 = c.half(slot_of<F, kSkip, kFwd>(0));
  const uint32_t skip1 = c.half(slot_of<F, kSkip, kFwd>(1));
  auto gx = [&](int r, int f) {
    const float v =
        f < 64 ? lds_bf(lf::x_at(enc0, r, f)) + lds_bf(lf::x_at(skip0, r, f))
               : lds_bf(lf::x_at(enc1, r, f & 63)) +
                     lds_bf(lf::x_at(skip1, r, f & 63));
    return scales != nullptr ? v * scales[f] : v;
  };
  static_assert(kRows * 6 % 128 == 0, "every lane takes part in the sums");
  for (int e = c.tid; e < kRows * 6; e += 128) {
    const int part = e & 1, r = (e >> 1) / 3, ch = (e >> 1) % 3;
    const float x = rw.in[c.group * kRows + r][ch];
    float dx = 0.f;
    for (int k = part ? kHalf : 0; k < (part ? NF : kHalf); ++k) {
      float sn, cs;
      const float scale = lf::pow2((kSe3 ? kSe3MinDeg : 0) + k);
      sincosf(x * scale, &sn, &cs);
      const float flat =
          cs * gx(r, kSin + k * 3 + ch) - sn * gx(r, kCos + k * 3 + ch);
      dx += flat * scale;
    }
    dx += __shfl_xor_sync(0xffffffffu, dx, 1);
    if (part == 0)
      dst[(c.group * kRows + r) * stride + ch] = kSe3 ? dx : gx(r, ch) + dx;
  }
  for (int e = c.tid; e < kRows * kEmbed; e += 128) {
    const int r = e / kEmbed, ch = e % kEmbed;
    dst[(c.group * kRows + r) * stride + 3 + ch] = gx(r, kEmb + ch);
  }
  c.mark(kCyVjp);
}

// -- the kernel ----------------------------------------------------------------

// The block's shared memory: the slab pool at `base` (1024-byte aligned),
// the ring, the row scratch and one reload mbarrier per buffer; the ring's
// and the reloads' mbarriers are initialised, then the block synchronises.
__device__ __forceinline__ void lay_out(uint8_t*& base, Ring& ring,
                                        Rows*& rows, uint64_t*& reload) {
  extern __shared__ uint8_t smem_raw[];
  base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ring_base = base + kSlots * kSlabBytes;
  rows = reinterpret_cast<Rows*>(ring_base + kStages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(rows + 1);
  uint64_t* empty = full + kStages;
  reload = empty + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kArrivals);
    }
    for (int b = 0; b < kBufs; ++b) mbar_init(&reload[b], 1);
    fence_barrier_init();
  }
  __syncthreads();
  ring = Ring{ring_base, full, empty, 0, 0};
}

// kPlane: a plane level: no sheet; d hyper, dx_t[:, 3:11] of a (P, 16)
// dx_t, is the embedding's direct cotangent.
template <int kWarp, bool kPlane>
__global__ void __launch_bounds__(kThreads, 1)
    fields_bwd_kernel(const __grid_constant__
                      lf::Maps<LevelTable<kWarp, kPlane>> maps,
                      const float* __restrict__ zs,
                      const float* __restrict__ origins,
                      const float* __restrict__ dirs,
                      const float* __restrict__ embed,
                      const float* __restrict__ dx_t,
                      const float* __restrict__ warp_scales,
                      const bf16* __restrict__ W, const bf16* __restrict__ B,
                      float* __restrict__ d_z, float* __restrict__ d_ray,
                      float* __restrict__ grad_w, uint8_t* __restrict__ scratch,
                      long long n_points, int samples) {
  using T = LevelTable<kWarp, kPlane>;
  constexpr int FW = warp_field<kWarp>();
  constexpr long long kGradW = weight_offset<T>(T::kFields);
  uint8_t* base;
  Ring ring;
  Rows* rows;
  uint64_t* reload;
  lay_out(base, ring, rows, reload);
  const long long n_tiles = (n_points + kTileRows - 1) / kTileRows;
  const int group = threadIdx.x >> 7;

  if (group == kGroups) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kGroups)
      for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        produce_tile<kWarp, kPlane>(maps, ring);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  Ctx c{smem_addr(base), rows, ring, reload,
        scratch + (size_t)blockIdx.x * kSpillSlabs * kSlabBytes, group,
        (int)(threadIdx.x & 127), 0};
#ifdef HN_FIELDS_BWD_TRACE
  c.last = clock64();
#endif
  grad_w += (blockIdx.x % kGradCopies) *
            (kGradW + bias_offset<T>(T::kFields));
  float* grad_b = grad_w + kGradW;
  Rows& rw = *rows;
  for (long long tile = blockIdx.x; tile < n_tiles;
       tile += gridDim.x, ++c.it) {
    const long long row0 = tile * kTileRows;
    // Row inputs of the warpgroup's rows; cotangents are zero past P.
    {
      const int r = c.tid & (kRows - 1), R = group * kRows + r;
      const long long p = row0 + R;
      const bool valid = p < n_points;
      const long long ray = valid ? p / samples : 0;
      if (c.tid < kRows) {
        const float z = valid ? zs[p] : 0.f;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float d = valid ? dirs[3 * ray + ch] : 0.f;
          rw.in[R][ch] =
              valid ? __fadd_rn(origins[3 * ray + ch], __fmul_rn(z, d)) : 0.f;
          rw.zd[R][1 + ch] = d;
        }
        rw.zd[R][0] = z;
        rw.ray[R] = valid ? (int)ray : -1;
      } else {
#pragma unroll
        for (int ch = 0; ch < kEmbed; ++ch)
          rw.in[R][3 + ch] = valid ? embed[ray * kEmbed + ch] : 0.f;
        rw.in[R][11] = 0.f;
        float* acc = rw.acc[R];
        if constexpr (kPlane) {
          // d warped, then d hyper = d embed's direct part in the sheet's
          // d[pts | embed] columns, whose d pts part is zero.
          float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a, e = a;
          if (valid) {
            a = reinterpret_cast<const float4*>(dx_t)[4 * p];
            b = reinterpret_cast<const float4*>(dx_t)[4 * p + 1];
            e = reinterpret_cast<const float4*>(dx_t)[4 * p + 2];
          }
          acc[0] = a.x, acc[1] = a.y, acc[2] = a.z;
          acc[8] = acc[9] = acc[10] = 0.f;
          acc[11] = a.w, acc[12] = b.x, acc[13] = b.y, acc[14] = b.z;
          acc[15] = b.w, acc[16] = e.x, acc[17] = e.y, acc[18] = e.z;
        } else {
          float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
          if (valid) {
            a = reinterpret_cast<const float4*>(dx_t)[2 * p];
            b = reinterpret_cast<const float4*>(dx_t)[2 * p + 1];
          }
          acc[0] = a.x, acc[1] = a.y, acc[2] = a.z, acc[3] = a.w;
          acc[4] = b.x, acc[5] = b.y, acc[6] = b.z, acc[7] = 0.f;
          // The sheet's head first: d hyper.
          float* h = rw.hg[R];
          h[0] = a.w, h[1] = b.x, h[2] = b.y, h[3] = b.z;
          h[4] = h[5] = h[6] = h[7] = 0.f;
        }
      }
    }
    c.sync();
    c.mark(kCyRow);

    // The hyper sheet: recompute, walk back, its d[pts | embed] -> acc[8:19].
    if constexpr (!kPlane) {
      encode_field<kSheet, kHypF>(c, nullptr);
      fence_async_smem();
      c.sync();
      c.mark(kCyEnc);
      fwd_layer<T, kSheet, 0, true>(c, B);
      fwd_layer<T, kSheet, 1, true>(c, B);
      fwd_layer<T, kSheet, 2, true>(c, B);
      fwd_layer<T, kSheet, 3, true>(c, B);
      fwd_layer<T, kSheet, 4, true>(c, B);
      fwd_layer<T, kSheet, 5, true>(c, B);
      c.block_sync();
      c.mark(kCyBar);
      head_back<T, kSheet>(c, W, grad_w, grad_b);
      back_layer<T, kSheet, 5>(c, grad_w, grad_b);
      back_layer<T, kSheet, 4>(c, grad_w, grad_b);
      back_layer<T, kSheet, 3>(c, grad_w, grad_b);
      back_layer<T, kSheet, 2>(c, grad_w, grad_b);
      back_layer<T, kSheet, 1>(c, grad_w, grad_b);
      back_layer<T, kSheet, 0>(c, grad_w, grad_b);
      encoding_vjp<kSheet, kHypF>(c, &rw.acc[0][8], 20, nullptr);
    }
    c.sync();  // the warp's encoding goes over the sheet's d enc

    // The warp field.
    if constexpr (kWarp == 0) {
      if (c.tid >= kRows) {  // the warp's head cotangent: d warped
        const int R = group * kRows + c.tid - kRows;
        float* h = rw.hg[R];
        h[0] = rw.acc[R][0], h[1] = rw.acc[R][1], h[2] = rw.acc[R][2];
        h[3] = 0.f;
      }
      encode_field<kTransWarp, kWarpF>(c, nullptr);
      fence_async_smem();
      c.sync();
      spill_enc<kTransWarp>(c);
      c.mark(kCyEnc);
      fwd_layer<T, FW, 0, true>(c, B);
      fwd_layer<T, FW, 1, true>(c, B);
      fwd_layer<T, FW, 2, true>(c, B);
      fwd_layer<T, FW, 3, true>(c, B);
      fwd_layer<T, FW, 4, true>(c, B);
      fwd_layer<T, FW, 5, true>(c, B);
    } else {
      encode_trunk(c, warp_scales);
      fence_async_smem();
      c.sync();
      spill_enc<kSe3Warp>(c);
      c.mark(kCyEnc);
      fwd_layer<T, FW, 0, true>(c, B);
      fwd_layer<T, FW, 1, true>(c, B);
      fwd_layer<T, FW, 2, true>(c, B);
      fwd_layer<T, FW, 3, true>(c, B);
      fwd_layer<T, FW, 4, true>(c, B);
      fwd_layer<T, FW, 5, true>(c, B);
      fwd_layer<T, FW, 6, false>(c, B);  // the trunk logit: no ReLU
      trunk_heads_and_retraction<T, kWarp>(c, W, B);
    }
    // Every spill written before any reload reads it.
    if (c.tid == 0) {
      bulk_wait_all();
      fence_async_global();
    }
    c.block_sync();
    c.mark(kCyBar);
    head_back<T, FW>(c, W, grad_w, grad_b);
    if constexpr (kWarp != 0) back_layer<T, FW, 6>(c, grad_w, grad_b);
    back_layer<T, FW, 5>(c, grad_w, grad_b);
    back_layer<T, FW, 4>(c, grad_w, grad_b);
    back_layer<T, FW, 3>(c, grad_w, grad_b);
    back_layer<T, FW, 2>(c, grad_w, grad_b);
    back_layer<T, FW, 1>(c, grad_w, grad_b);
    back_layer<T, FW, 0>(c, grad_w, grad_b);
    if constexpr (kWarp == 0)
      encoding_vjp<kTransWarp, kWarpF>(c, &rw.se3[0][0], 16, nullptr);
    else
      encoding_vjp<kSe3Warp, kSe3F>(c, &rw.se3[0][0], 16, warp_scales);
    c.sync();

    // d pts = (d warped's direct part + the warp's part) + the sheet's part;
    // pts = o + z d, so d z = d pts . d, d o = sum_s d pts,
    // d d = sum_s z d pts; d embed = sum_s (warp's + sheet's).
    c.mark(kCyVjp);
    if (c.tid < kRows) {
      const int R = group * kRows + c.tid;
      float* a = rw.acc[R];
      const float* dw = rw.se3[R];
      float dp[3], de[kEmbed];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) dp[ch] = (a[ch] + dw[ch]) + a[8 + ch];
#pragma unroll
      for (int ch = 0; ch < kEmbed; ++ch) de[ch] = dw[3 + ch] + a[11 + ch];
      const float z = rw.zd[R][0];
      float dz = 0.f;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        dz += dp[ch] * rw.zd[R][1 + ch];
        a[ch] = dp[ch];
        a[3 + ch] = dp[ch] * z;
      }
#pragma unroll
      for (int ch = 0; ch < kEmbed; ++ch) a[6 + ch] = de[ch];
      if (row0 + R < n_points) d_z[row0 + R] = dz;
    }
    c.sync();
    // Per-ray sums over the warpgroup's rows in runs of kRun rows: rows of
    // a ray are consecutive; one add per run of equal rays.
    constexpr int kCh = 6 + kEmbed, kRun = 16;
    if (c.tid < kCh * (kRows / kRun)) {
      const int ch = c.tid % kCh, r0 = group * kRows + c.tid / kCh * kRun;
      float s = 0.f;
      int cur = rw.ray[r0];
      for (int r = r0; r < r0 + kRun; ++r) {
        const int ray = rw.ray[r];
        if (ray != cur) {
          if (cur >= 0) atomicAdd(d_ray + (size_t)cur * kCh + ch, s);
          s = 0.f;
          cur = ray;
        }
        s += rw.acc[r][ch];
      }
      if (cur >= 0) atomicAdd(d_ray + (size_t)cur * kCh + ch, s);
    }
    c.sync();
    c.mark(kCyRay);
  }
}

// -- host side ---------------------------------------------------------------

// The plan as the entry points report it: config[0:9] = rows of a block
// tile, consumer warpgroups, ring stages, bytes of a stage, dynamic shared
// memory, threads, slabs of the pool, spill slabs a block, copies of the
// gradient buffer.
inline void plan_config(int* config) {
  const int c[] = {kTileRows,   kGroups,   kStages,     kStageBytes,
                   kSmemBytes,  kThreads,  kSlots,      kSpillSlabs,
                   kGradCopies};
  for (int i = 0; i < 9; ++i) config[i] = c[i];
}

// Field f's buffer plan, six ints per buffer (enc, h0..h5, T, skip):
// forward slots (2), spill slab, the walk-back layer after which it is
// reloaded, reload slots (2).
inline void plan_table(int f, int* table) {
  for (int b = 0; b < kBufs; ++b) {
    const BufPlan p = buf_plan(f, b);
    const int row[6] = {p.fwd[0], p.fwd[1],    p.spill,
                        p.after,  p.reload[0], p.reload[1]};
    for (int i = 0; i < 6; ++i) table[6 * b + i] = row[i];
  }
}

// The weight loads of layers first .. first + count - 1 of T, forward, then
// backward, as (layer, 64-column box of K, box rows) at loads[3 n ...];
// returns the count of loads so far (written up to max_loads).
template <class T>
int plan_loads(int first, int count, int* loads, int n, int max_loads) {
  auto layer = [&](int l) {
    const Shape s = T::shape(l);
    for (int kb = 0; kb < lf::k_boxes(s); ++kb, ++n)
      if (n < max_loads) {
        loads[3 * n] = l;
        loads[3 * n + 1] = kb;
        loads[3 * n + 2] = lf::box_rows(s);
      }
  };
  for (int i = 0; i < count; ++i) layer(first + i);
  for (int i = count - 1; i >= 0; --i) layer(first + i);
  return n;
}

// Host side: the tensor maps of the field layers of the level's blob W
// (level_fwd.cuh's, cached; the template's layers, whose shapes depend on
// its layout, are never loaded here), the shared-memory attribute once per
// device, `blocks` persistent blocks.
template <int kWarp, bool kPlane = false>
int launch_fields_bwd(const void* z, const void* origins, const void* dirs,
                      const void* embed, const void* dx_t,
                      const void* warp_scales, const void* weights,
                      const void* biases, void* d_z, void* d_ray, void* grads,
                      void* scratch, long long n_points, int samples,
                      int blocks, void* stream) {
  using T = LevelTable<kWarp, kPlane>;
  static std::atomic<int> configured[kMaxDevices];
  int dev = 0, sms = 0;
  int status = current_device(&dev, &sms);
  if (status) return status;
  if (!configured[dev].load(std::memory_order_relaxed)) {
    const cudaError_t err = cudaFuncSetAttribute(
        fields_bwd_kernel<kWarp, kPlane>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured[dev].store(1, std::memory_order_relaxed);
  }
  if (n_points <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  lf::Maps<T> maps;
  static_assert(lf::whole_runs<T>(0, T::kFields), "the fields' maps");
  status = lf::make_maps<T>(&maps, static_cast<const bf16*>(weights), 0,
                            T::kFields);
  if (status) return status;
  fields_bwd_kernel<kWarp, kPlane><<<blocks, kThreads, kSmemBytes,
                                     (cudaStream_t)stream>>>(
      maps, static_cast<const float*>(z), static_cast<const float*>(origins),
      static_cast<const float*>(dirs), static_cast<const float*>(embed),
      static_cast<const float*>(dx_t), static_cast<const float*>(warp_scales),
      static_cast<const bf16*>(weights), static_cast<const bf16*>(biases),
      static_cast<float*>(d_z), static_cast<float*>(d_ray),
      static_cast<float*>(grads), static_cast<uint8_t*>(scratch), n_points,
      samples);
  return (int)cudaGetLastError();
}

}  // namespace fb
}  // namespace

// The six instantiations (fields_bwd_{trans,se3,quat,plane}.cu, and
// fields_bwd_plane_screw.cu's two).
#define HN_FIELDS_BWD_ARGS                                                  \
  const void *z, const void *origins, const void *dirs, const void *embed, \
      const void *dx_t, const void *warp_scales, const void *weights,       \
      const void *biases, void *d_z, void *d_ray, void *grads,              \
      void *scratch, long long n_points, int samples, int blocks,           \
      void *stream
// The arguments of HN_FIELDS_BWD_ARGS, passed on.
#define HN_FIELDS_BWD_PASS                                                 \
  z, origins, dirs, embed, dx_t, warp_scales, weights, biases, d_z, d_ray, \
      grads, scratch, n_points, samples, blocks, stream
extern "C" int hn_fields_bwd_trans(HN_FIELDS_BWD_ARGS);
extern "C" int hn_fields_bwd_se3(HN_FIELDS_BWD_ARGS);
extern "C" int hn_fields_bwd_quat(HN_FIELDS_BWD_ARGS);
extern "C" int hn_fields_bwd_plane(HN_FIELDS_BWD_ARGS);
extern "C" int hn_fields_bwd_plane_se3(HN_FIELDS_BWD_ARGS);
extern "C" int hn_fields_bwd_plane_quat(HN_FIELDS_BWD_ARGS);
