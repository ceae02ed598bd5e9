// The warp Jacobians' forwards for Hopper (sm_90a): the translation warp
// field and the SE(3) / quaternion trunk, each with its three point-tangent
// streams riding the network as extra rows, on the level forward's block
// (level_fwd.cuh), from the network's own blob.
//
// Replaces hypernerf_tpu/ops/pallas/fused_jacobian.py `_fused_fwd` (:269,
// the tile body `_jac_fwd_tile` :132-166 with the tangent encoding
// `_tangent_encode` :76-100) and hypernerf_tpu/ops/pallas/
// fused_se3_jacobian.py `_fused_fwd` (:286, the tile body `_jac_fwd_tile`
// :112-151 with `_tangent_encode` :59-80), for the flagship's widths.
//
// The translation warp's Jacobian (hn_fused_jacobian_fwd): the warp field,
// posenc_orig(pts, 10) ++ embed (71 -> 80) -> 6 x 128 (skip after layer 4)
// -> 3 (layers 0..6 of TransTable). In: x_raw (P, 11) fp32 rows [pts |
// embed]; the field's packed bf16 weights (out, in) and biases. Out: J (P,
// 9) fp32, J[p][3 i + k] = delta_ik + d translation_i / d p_k.
// The trunk's tangents (hn_fused_se3_jacobian_fwd): the Nerfies posenc(pts,
// degrees 0..8, no identity) ++ embed (56 -> 64) -> 6 x 128 (skip after
// layer 4) -> linear 128 -> 128, rounded -> the w and v heads, 128 -> 3 each
// (layers 0..8 of Se3Table). In: x_raw; an optional window row `scales` (64
// fp32); the trunk's own blobs. Out: (P, 24) fp32 [w | v | dw | dv],
// dw[3 i + k] = d w_i / d p_k (dv alike); the retraction and its
// point-Jacobian are the caller's.
// Tangent k of a point (d / d p_k) is a row of its own beside the point's
// primal row. Its encoding is [e_k (translation only) | cos(p_k 2^m) 2^m |
// -sin(p_k 2^m) 2^m on channel k's band columns | 0], times the window row
// in fp32 and rounded once; a hidden layer gives it no bias and its primal
// row's ReLU mask (from the primal fp32 pre-activation), then rounds; the
// trunk logit is linear, so its tangents pass unmasked; the heads are fp32,
// the bias on the primal rows alone. Rounding points are the TPU kernels'
// and the level kernel's (a primal feature is rounded, times the window row
// and rounded again).
//
// Bound: four rows a point, 100,480 (translation) or 113,408 (trunk)
// multiply-adds a row, against 44 + 36 or 44 + 96 bytes moved a point:
// operations bound both (262,144 points: 0.213 and 0.240 ms at the card's
// dense bf16 rate).
// Design: the level forward's block as the warp field alone and the trunk
// alone run it (modular_fwd.cu): a persistent grid of blocks of three
// consumer warpgroups, each with its 64-row activation tile resident in
// 128-byte-swizzled shared memory; the weights streamed by TMA through the
// six-stage ring from tensor maps over the network's own blob; `wgmma`
// products and the `cvt` / `stmatrix` epilogue in place. A tile holds 16
// points x 4 streams in tan_row's layout (level_fwd.cuh): the accumulator
// gives lane l of warp w two rows of one point, streams l / 16 and l / 16 +
// 2, so the primal row of a lane's columns sits on lane l & 15. The
// epilogue packs the primal lanes' mask bits (pre-activation > 0, one bit a
// column, 32 columns a word) and hands them to every lane with one shuffle.
// A point's sincos pairs are computed once and feed its four rows.

#include "level_fwd.cuh"

namespace {
namespace lf {

constexpr int kStreams = 4;                    // the primal row, d / d p_k
constexpr int kTilePoints = kRows / kStreams;  // 16 points a tile
constexpr int kIn = 3 + kEmbed;                // x_raw's columns

// The two networks with their tangents: the layers [0, kLast) of table T,
// run on the warp field's block of three 256-column tiles (the layers read
// and write the first 208 columns).
template <class T_, int kLast_>
struct Tangents {
  using T = T_;
  using Blk = Block<3, 256>;
  static constexpr int kFirst = 0, kLast = kLast_;
  static constexpr bool kSe3 = std::is_same<T_, Se3Table>::value;
};
using WarpTangents = Tangents<TransTable, TransTable::kWarp>;
using Se3Tangents = Tangents<Se3Table, kSe3HeadV + 1>;

// Hidden layer L (N <= 128) on the tile's streams, in place: a primal row
// bf16([relu](acc + b)) as `hidden`; a tangent row bf16(acc * mask), no
// bias, the mask its primal row's (acc + b > 0) for a ReLU layer and all
// ones for the linear trunk logit. Lanes 0..15 add the bias to their first
// accumulator row (the primal row) alone; every lane packs the sign bits
// of its first row's columns into a word (bit 2 j + e: column 8 j + 2 t +
// e), takes lane & 15's word with one shuffle (the primal row of the same
// point and columns) and rounds both rows through it: on the primal row
// that is the ReLU. The biases are read after the products (held through
// them they cost registers).
template <class T, int L, bool kRelu>
__device__ __forceinline__ void tangent_hidden(const Group& g, Ring& ring,
                                               const bf16* Bs) {
  constexpr int N = T::shape(L).n;
  using A = Acc<N>;
  constexpr int J = N / 8;  // n8 column groups
  static_assert(A::H == 1 && J <= 16, "a lane's mask in one word");
  A acc;
  product<T, L>(g, ring, acc);
  const int warp = g.tid >> 5, lane = g.tid & 31, t = lane & 3;
  const __nv_bfloat162* bias =
      reinterpret_cast<const __nv_bfloat162*>(Bs + bias_offset<T>(L)) + t;
  const float primal = lane < 16 ? 1.f : 0.f;  // the first row is stream 0
  float* d = acc.d[0];
  uint32_t on = 0xffffffffu;
  if constexpr (kRelu) on = 0u;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const __nv_bfloat162 b = bias[4 * j];
    d[4 * j] += primal * __low2float(b);
    d[4 * j + 1] += primal * __high2float(b);
    if constexpr (kRelu) {
      on |= (d[4 * j] > 0.f ? 1u : 0u) << (2 * j);
      on |= (d[4 * j + 1] > 0.f ? 1u : 0u) << (2 * j + 1);
    }
  }
  if constexpr (kRelu) on = __shfl_sync(0xffffffffu, on, lane & 15);
  const int i7 = lane & 7, jo = lane >> 4;
  const uint32_t row = g.xs + (16 * warp + i7 + (lane & 8)) * 128;
#pragma unroll
  for (int j = 0; j < J; j += 2) {
    const float* e = d + 4 * j;
    const int jj = j + jo;
    stsm_x4(row + (j >> 3) * kBoxBytes + (((jj & 7) ^ i7) << 4),
            masked_round(e[0], e[1], on, 2 * j),
            masked_round(e[2], e[3], on, 2 * j),
            masked_round(e[4], e[5], on, 2 * j + 2),
            masked_round(e[6], e[7], on, 2 * j + 2));
  }
  fence_async_smem();
  g.sync();
  LF_TRACE(g, L, 3);
}

// Head L (N = 8) on every row: dst[8 r + c] = fp32 acc (+ b on the primal
// rows when kBias) for c < 3.
template <class T, int L, bool kBias>
__device__ __forceinline__ void tangent_head(const Group& g, Ring& ring,
                                             const bf16* Bs, float* dst) {
  static_assert(T::shape(L).n == 8, "heads are 8 wide");
  Acc<8> acc;
  product<T, L>(g, ring, acc);
  const bf16* bias = Bs + bias_offset<T>(L);
  const int warp = g.tid >> 5, lane = g.tid & 31, q = lane >> 2, t = lane & 3;
  const int r = 16 * warp + q;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = 2 * t + (e & 1), rr = r + (e >= 2 ? 8 : 0);
    const bool biased = kBias && e < 2 && lane < 16;  // a primal row
    if (c < 3)
      dst[rr * 8 + c] =
          acc.d[0][e] + (biased ? __bfloat162float(bias[c]) : 0.f);
  }
  g.sync();
  LF_TRACE(g, L, 3);
}

// The x_raw rows [pts | embed] of the tile's points [p0, p0 + 16) into
// rows.in[0:16]; zeros past P. Every thread's loads go out before its
// stores.
__device__ __forceinline__ void point_rows(const Group& g, long long p0,
                                           long long n_points,
                                           const float* __restrict__ x_raw) {
  constexpr int kN = kTilePoints * kIn, kEach = (kN + 127) / 128;
  const float* src = x_raw + p0 * kIn;
  const long long valid = (n_points - p0) * kIn;
  float v[kEach];
#pragma unroll
  for (int i = 0; i < kEach; ++i) {
    const int e = g.tid + 128 * i;
    v[i] = e < kN && e < valid ? src[e] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kEach; ++i) {
    const int e = g.tid + 128 * i;
    if (e < kN) g.rows->in[e / kIn][e % kIn] = v[i];
  }
}

// Band b of point q, its sin / cos at features f_sin, f_cos of the
// encoding (tile columns 128 + f), computed once for the point's four
// rows: the primal row takes sin and cos (window_feature), tangent row 1 +
// b % 3 takes cos 2^m and -sin 2^m (tangent_feature), the other two
// tangent rows zeros.
__device__ __forceinline__ void band_streams(const Group& g, int q, int b,
                                             float arg, int m, int f_sin,
                                             int f_cos,
                                             const float* __restrict__ scales) {
  float sn, cs;
  sincosf(arg, &sn, &cs);
  const int c_sin = kWarpEnc + f_sin, c_cos = kWarpEnc + f_cos;
  sts16(x_at(g.xs, tan_row(q, 0), c_sin), window_feature(sn, f_sin, scales));
  sts16(x_at(g.xs, tan_row(q, 0), c_cos), window_feature(cs, f_cos, scales));
  const bf16 ts = tangent_feature(ldexpf(cs, m), f_sin, scales);
  const bf16 tc = tangent_feature(-ldexpf(sn, m), f_cos, scales);
  const bf16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int s = 1; s < kStreams; ++s) {
    const bool on = b % 3 == s - 1;
    sts16(x_at(g.xs, tan_row(q, s), c_sin), on ? ts : zero);
    sts16(x_at(g.xs, tan_row(q, s), c_cos), on ? tc : zero);
  }
}

// The trunk's encoding of the tile's streams into X[:, 128 : 192]: band b
// = 3 k + c at column b (sin) and 24 + b (cos), argument pts[c] 2^(m), m =
// kSe3MinDeg + k; then the primal rows' embedding and zeros.
__device__ __forceinline__ void encode_se3_streams(
    const Group& g, const float* __restrict__ scales) {
  constexpr int kRest = kSe3EncP - 2 * kSe3Trig;
  const float(*in)[12] = g.rows->in;
#pragma unroll 1
  for (int e = g.tid; e < kTilePoints * kSe3Trig; e += 128) {
    const int q = e / kSe3Trig, b = e % kSe3Trig;
    band_streams(g, q, b, se3_band_arg(in[q], b), kSe3MinDeg + b / 3, b,
                 kSe3Trig + b, scales);
  }
#pragma unroll 2
  for (int e = g.tid; e < kRows * kRest; e += 128) {
    const int r = e / kRest, f = e % kRest;
    const float v =
        tan_stream(r) == 0 && f < kEmbed ? in[tan_point(r)][3 + f] : 0.f;
    sts16(x_at(g.xs, r, kWarpEnc + 2 * kSe3Trig + f),
          window_feature(v, 2 * kSe3Trig + f, scales));
  }
}

// The warp field's encoding of the tile's streams into X[:, 128 : 208]:
// the primal rows [posenc_orig(pts, 10) | embed | 0], tangent k's [e_k |
// cos 2^j, -sin 2^j on channel k's bands | 0], each rounded once.
__device__ __forceinline__ void encode_warp_streams(const Group& g) {
  constexpr int kPairs = 3 * kWarpF, kRest = kWarpEncP - 2 * kPairs;
  const float(*in)[12] = g.rows->in;
#pragma unroll 1
  for (int e = g.tid; e < kTilePoints * kPairs; e += 128) {
    const int q = e / kPairs, b = e % kPairs;
    band_streams(g, q, b, in[q][b % 3] * pow2(b / 3), b / 3, 3 + b,
                 3 + kPairs + b, nullptr);
  }
#pragma unroll 2
  for (int e = g.tid; e < kRows * kRest; e += 128) {
    const int r = e / kRest, f = e % kRest, s = tan_stream(r);
    const float v = s == 0 ? (f < 3 + kEmbed ? in[tan_point(r)][f] : 0.f)
                           : (f == s - 1 ? 1.f : 0.f);
    sts16(x_at(g.xs, r, kWarpEnc + (f < 3 ? f : f + 2 * kPairs)),
          __float2bfloat16_rn(v));
  }
}

// The translation warp's Jacobian of the tile's points below P: J[p][3 i +
// k] = delta_ik + head[tangent row k of p][i], one float a thread, the
// tile's 144 floats in order.
__device__ __forceinline__ void write_jacobian(const Group& g, long long p0,
                                               long long n_points,
                                               float* __restrict__ jac) {
  const Rows& rw = *g.rows;
  for (int e = g.tid; e < kTilePoints * 9; e += 128) {
    const int q = e / 9, i = e % 9 / 3, k = e % 3;
    if (p0 + q < n_points)
      jac[p0 * 9 + e] = (i == k ? 1.f : 0.f) + rw.head[tan_row(q, 1 + k)][i];
  }
}

// [w | v | dw | dv] of the tile's points below P, six float4 a point, one
// a thread: w, v from the primal row's head[0:3], head[3:6]; dw[3 i + k],
// dv[3 i + k] from tangent row k's.
__device__ __forceinline__ void write_tangents(const Group& g, long long p0,
                                               long long n_points,
                                               float* __restrict__ out) {
  const Rows& rw = *g.rows;
  const int q = g.tid / 6, part = g.tid % 6;
  if (g.tid >= kTilePoints * 6 || p0 + q >= n_points) return;
  float v[4];
#pragma unroll
  for (int c4 = 0; c4 < 4; ++c4) {
    const int col = 4 * part + c4;
    if (col < 6) {
      v[c4] = rw.head[tan_row(q, 0)][col];
    } else {
      const int d = col < 15 ? col - 6 : col - 15, i = d / 3, k = d % 3;
      v[c4] = rw.head[tan_row(q, 1 + k)][(col < 15 ? 0 : 3) + i];
    }
  }
  reinterpret_cast<float4*>(out)[6 * (p0 + q) + part] =
      make_float4(v[0], v[1], v[2], v[3]);
}

// The network of S with its tangents on one tile: rows.head[r][0:3] (the
// trunk: w, and v at [3:6]) of every tile row r.
template <class S>
__device__ __forceinline__ void tangent_stage(
    const Group& g, Ring& ring, const bf16* Bs,
    const float* __restrict__ scales) {
  using T = typename S::T;
  if constexpr (S::kSe3)
    encode_se3_streams(g, scales);
  else
    encode_warp_streams(g);
  fence_async_smem();
  g.sync();
  tangent_hidden<T, 0, true>(g, ring, Bs);
  tangent_hidden<T, 1, true>(g, ring, Bs);
  tangent_hidden<T, 2, true>(g, ring, Bs);
  tangent_hidden<T, 3, true>(g, ring, Bs);
  tangent_hidden<T, 4, true>(g, ring, Bs);
  tangent_hidden<T, 5, true>(g, ring, Bs);
  float* head = &g.rows->head[0][0];
  if constexpr (S::kSe3) {
    tangent_hidden<T, kSe3Trunk, false>(g, ring, Bs);  // linear, rounded
    tangent_head<T, kSe3HeadW, true>(g, ring, Bs, head);
    tangent_head<T, kSe3HeadV, true>(g, ring, Bs, head + 3);
  } else {
    // The primal rows' head outputs are dropped: no bias.
    tangent_head<T, S::kLast - 1, false>(g, ring, Bs, head);
  }
}

template <class S>
__global__ void __launch_bounds__(S::Blk::kThreads, 1)
    tangents_fwd_kernel(const __grid_constant__ Maps<typename S::T> maps,
                        const float* __restrict__ x_raw,
                        const float* __restrict__ scales,
                        const bf16* __restrict__ B, float* __restrict__ out,
                        long long n_points) {
  using Blk = typename S::Blk;
  Group g;
  Ring ring;
  const bf16* Bs;
  const long long n_rows = kStreams * n_points;
  if (!enter_block<Blk, typename S::T, S::kFirst, S::kLast>(maps, B, n_rows,
                                                            g, ring, Bs))
    return;
  const long long n_steps = tile_steps<Blk>(n_rows);
  for (long long step = blockIdx.x; step < n_steps;
       step += gridDim.x, ++g.it) {
    const long long p0 = first_row<Blk>(g, step) / kStreams;
    point_rows(g, p0, n_points, x_raw);
    g.sync();
    tangent_stage<S>(g, ring, Bs, scales);  // ends in a barrier
    if constexpr (S::kSe3)
      write_tangents(g, p0, n_points, out);
    else
      write_jacobian(g, p0, n_points, out);
  }
}

template <class S>
int launch_tangents(const void* x_raw, const void* scales, const void* weights,
                    const void* biases, void* out, long long n_points,
                    void* stream) {
  using Blk = typename S::Blk;
  if (n_points <= 0) return (int)cudaErrorInvalidValue;
  static std::atomic<int> configured[kMaxDevices];
  unsigned grid = 0;
  int status = block_grid<Blk>(tangents_fwd_kernel<S>, configured,
                               kStreams * n_points, &grid);
  if (status) return status;
  Maps<typename S::T> maps;
  status = make_maps<typename S::T>(&maps, static_cast<const bf16*>(weights),
                                    S::kFirst, S::kLast);
  if (status) return status;
  tangents_fwd_kernel<S><<<grid, Blk::kThreads, Blk::kSmemBytes,
                           (cudaStream_t)stream>>>(
      maps, static_cast<const float*>(x_raw),
      static_cast<const float*>(scales), static_cast<const bf16*>(biases),
      static_cast<float*>(out), n_points);
  return (int)cudaGetLastError();
}

}  // namespace lf
}  // namespace

// weights / biases: the warp field's seven layers (TransTable's 0..6).
extern "C" int hn_fused_jacobian_fwd(const void* x_raw, const void* weights,
                                     const void* biases, void* jac,
                                     long long n_points, void* stream) {
  return lf::launch_tangents<lf::WarpTangents>(x_raw, nullptr, weights,
                                               biases, jac, n_points, stream);
}

// weights / biases: the trunk's nine layers alone (Se3Table's 0..8).
// scales: null, or 64 fp32 window weights.
extern "C" int hn_fused_se3_jacobian_fwd(const void* x_raw, const void* scales,
                                         const void* weights,
                                         const void* biases, void* out,
                                         long long n_points, void* stream) {
  return lf::launch_tangents<lf::Se3Tangents>(x_raw, scales, weights, biases,
                                              out, n_points, stream);
}

// The plan of kernel `which` (0 the translation warp's Jacobian, 1 the
// trunk's tangents): lf::forward_plan of its block over its layers in
// config[0:8], in_cols and the weight loads of one step of tiles, as
// hn_modular_fwd_plan reports a stage's; then config[8] = rows a point,
// config[9] = points a tile. Returns the number of loads (written up to
// max_loads), or -1 for an unknown kernel.
extern "C" int hn_tangents_fwd_plan(int which, int* config, int* in_cols,
                                    int* loads, int max_loads) {
  using namespace lf;
  int n;
  if (which == 0)
    n = forward_plan<WarpTangents::Blk, WarpTangents::T>(
        WarpTangents::kFirst, WarpTangents::kLast, config, in_cols, loads,
        max_loads);
  else if (which == 1)
    n = forward_plan<Se3Tangents::Blk, Se3Tangents::T>(
        Se3Tangents::kFirst, Se3Tangents::kLast, config, in_cols, loads,
        max_loads);
  else
    return -1;
  config[8] = kStreams;
  config[9] = kTilePoints;
  return n;
}

#ifdef HN_LEVEL_FWD_TRACE
// The clocks block 0 recorded (level_fwd.cuh), as [group][pair][layer][4].
extern "C" int hn_tangents_fwd_trace(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, lf::level_fwd_trace,
                                   sizeof(lf::level_fwd_trace));
}
#endif
