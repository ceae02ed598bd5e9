// One field MLP alone, backward, for Hopper (sm_90a): kernel B's block
// (fields_bwd.cuh) walking back one field from the field's own blobs. The
// kernel template and its launcher; fields_bwd_alone.cu instantiates it for
// the two fields of the translation table, se3_bwd_alone.cu for the SE(3) /
// quaternion trunk, se3_tangents_bwd.cu for the trunk with its three
// point-tangent streams and warp_tangents_bwd.cu for the translation warp
// field with its tangent streams, the Jacobian's backward (one nvcc process
// each).
//
// Fields: the translation warp (layers 0..6 of TransTable: posenc_orig(pts,
// 10) ++ embed -> 6 x 128 -> 3), the hyper sheet (layers 7..13:
// posenc_orig(pts, 7) ++ embed -> 6 x 64 -> 4), both with a skip after
// layer 4; the SE(3) / quaternion trunk (layers 0..8 of Se3Table, a prefix
// of the level's blob: the Nerfies encoding of the points, sin and cos of
// degrees 0..7, ++ embed -> 6 x 128 with a skip after layer 4 -> the linear
// trunk logit 128 -> 128 -> the w and the v head, 128 -> 3 each).
//
// In:  x_raw (P, 11) fp32 [pts | embed] per sample; an optional window row
//      `scales` over the padded encoding (fp32); g = d[output | 0], (P, 8)
//      fp32 (the trunk: d[w | v | 0 0]; with the tangents (P, 24) fp32 =
//      d[w | v | dw | dv], dw[p, i * 3 + k] = d w_i / d p_k); the field's
//      packed bf16 weights (out, in) and biases.
// Out: dx_raw (P, 11) fp32 per sample (the caller sums the embedding's part
//      per ray and adds the warp's residual); fp32 dW / db of the field's
//      layers in the packed layout, added into kGradCopies buffers (block b
//      into copy b % kGradCopies; the wrapper sums them).
// Rounding points are kernel B's and the JAX kernels': the encoding is
// rounded to bf16 (times the window row, rounded again); every product takes
// bf16 operands with fp32 sums; the cotangent is rounded to bf16 after each
// ReLU mask; a hidden layer's db sums the rounded cotangent, a head's the
// fp32 one; the trunk's two heads' parts of the logit's cotangent are summed
// in fp32 and rounded once, and no ReLU masks it; layer 0's and the skip's
// parts of d enc are summed in fp32 and times the window row before the
// encoding's VJP.
// The tangent streams (the JAX kernel's `_jac_bwd_tile`): the tangent
// encoding of coordinate k is [cos(p_k 2^m) 2^m | -sin(p_k 2^m) 2^m on
// channel k's band columns | 0], times the window row, rounded once; the
// recompute gives tangent rows no bias and each hidden layer masks them by
// the primal row's ReLU (the linear logit passes them unmasked, rounded);
// dW sums all rows, every db the primal rows alone; a tangent row's
// cotangent is masked by its primal row's; d pts is the primal encoding's
// pullback plus the three tangents' (the 4^m terms), d embed the primal
// pullback's alone. A block tile of 128 rows holds 32 points x 4 streams
// (fields_bwd.cuh's tan_row), so a tangent row's mask is a shuffle from the
// lane that holds its primal row.
// The translation warp's Jacobian (kTransJac, the JAX kernel's
// `_jac_bwd_tile`): only the tangent rows carry a cotangent, column k of dJ
// on tangent row k; the tangent encoding of coordinate k is [e_k | cos(p_k
// 2^j) 2^j | -sin(p_k 2^j) 2^j on channel k's band columns | 0], rounded
// once; the cotangent stays fp32, as the TPU kernel keeps it, held as two
// bf16 halves (fields_bwd.cuh's back_layer); the head's dW and g W_head take
// the fp32 g; db and d embed are exactly zero (they reach J only through
// the ReLU masks) and are not computed; d pts is the tangent encodings'
// pullback alone.
//
// Bound: three multiply-adds per weight and row (the recompute, g W and
// g^T h) against 120 bytes moved: operations bound it (16384 x 128 rows:
// 1.278 ms for the warp field, 0.350 for the sheet, 1.443 for the trunk;
// the trunk with its tangents at 262,144 points, 1 M rows: 0.721 ms, at the
// card's dense bf16 rate; the translation Jacobian's backward recomputes the
// four streams and runs both products on the three tangent streams: 0.533
// ms at 262,144 points).
//
// Design: kernel B's (fields_bwd.cuh): a persistent grid of block tiles of
// 128 rows on two consumer warpgroups and a producer warpgroup; the field
// recomputed with `wgmma` into the slab pool by the field's row of buf_plan
// (the sheet fits the pool; the warp field and the trunk spill their first
// outputs to a per-block scratch and reload them); the weights streamed by
// TMA through the ring (the field's hidden layers, and the trunk's logit,
// forward, then backward, from tensor maps over the field's own blob), read
// K-major by the recompute and MN-major by g W, so no transposed copy
// exists; dW as 64 x 64 `wgmma` units added once per block tile. What
// differs from kernel B: the rows come from x_raw and g, not from rays and
// dx_t; dx_raw is written per row (no ray sums, nothing passed through); the
// window row scales the encoding and its cotangent; the trunk's heads take
// their cotangents from g (no retraction).

#pragma once

#include <type_traits>

#include "fields_bwd.cuh"

namespace {
namespace fb {

// Field F (kTransWarp or kSheet of TransTable, kSe3Warp of Se3Table, or
// kTransJac, the translation warp field of TransTable for its Jacobian)
// alone: its layers [kFirst, kLast) of its table T, the layers streamed
// (the hidden ones and the trunk logit), its bands and outputs, and where
// its blobs sit in the level's.
template <int F>
struct Alone {
  using T = std::conditional_t<F == kSe3Warp, Se3Table, TransTable>;
  static constexpr int kFirst = base<T, F>();
  static constexpr int kStreamed = top(F) + 1;
  static constexpr int kLast = kFirst + kStreamed + (F == kSe3Warp ? 2 : 1);
  static constexpr int kBands = F == kSheet     ? kHypF
                               : F == kSe3Warp ? kSe3F
                                               : kWarpF;
  static constexpr int kOut = F == kSheet ? kHypOut : 3;
  static constexpr long long kW0 = weight_offset<T>(kFirst);
  static constexpr long long kNW = weight_offset<T>(kLast) - kW0;
  static constexpr int kB0 = bias_offset<T>(kFirst);
  static constexpr int kNB = bias_offset<T>(kLast) - kB0;
  static constexpr bool kSpills = buf_plan(F, h_buf(0)).spill >= 0;
  static_assert(lf::whole_runs<T>(kFirst, kLast), "the field's maps");
  static_assert((kNW + kNB) % 4 == 0, "each gradient copy starts 16-byte "
                "aligned for the float4 adds");
};

// A block tile's loads: the field's streamed layers forward, then backward.
template <int F>
__device__ __forceinline__ void produce_alone(
    const lf::Maps<typename Alone<F>::T>& maps, Ring& ring) {
  using A = Alone<F>;
  produce_run<typename A::T, A::kFirst, false>(
      maps, ring, std::make_integer_sequence<int, A::kStreamed>());
  produce_run<typename A::T, A::kFirst, true>(
      maps, ring, std::make_integer_sequence<int, A::kStreamed>());
}

constexpr int kIn = 3 + kEmbed;  // x_raw's and dx_raw's columns
constexpr int kTanG = 24;        // g's columns with the SE(3) tangents
constexpr int kJacG = 9;         // g's columns of the Jacobian: dJ

// Row inputs of the warpgroup's rows [row0, row0 + 64): x_raw into rows.in,
// g[:, 0:kOut] into rows.hg (the head's fp32 cotangent; the trunk: d w, and
// d v into rows.se3[:, 8:11]); zeros past P. The rows' x_raw is one run of
// 64 x 11 floats: every thread's loads go out before the first store.
template <int F>
__device__ __forceinline__ void alone_rows(const Ctx& c, long long row0,
                                           long long n_points,
                                           const float* __restrict__ x_raw,
                                           const float* __restrict__ g) {
  constexpr int kN = kRows * kIn, kEach = (kN + 127) / 128;
  constexpr int kOut = Alone<F>::kOut;
  Rows& rw = *c.rows;
  const int R0 = c.group * kRows;
  const float* src = x_raw + row0 * kIn;
  const long long valid = (n_points - row0) * kIn;
  float v[kEach];
#pragma unroll
  for (int i = 0; i < kEach; ++i) {
    const int e = c.tid + 128 * i;
    v[i] = e < kN && e < valid ? src[e] : 0.f;
  }
  // g: a row as two float4, a thread each.
  const int r = c.tid >> 1, h = c.tid & 1;
  const float4 gv = row0 + r < n_points
                        ? reinterpret_cast<const float4*>(g)[2 * (row0 + r) + h]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kEach; ++i) {
    const int e = c.tid + 128 * i;
    if (e < kN) rw.in[R0 + e / kIn][e % kIn] = v[i];
  }
  const float gg[4] = {gv.x, gv.y, gv.z, gv.w};
  if constexpr (F == kSe3Warp) {  // [w | v | 0 0]: hg[0:3] = d w, se3 d v
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 4 * h + q;
      if (col < 3) rw.hg[R0 + r][col] = gg[q];
      else if (col < 6) rw.se3[R0 + r][8 + col - 3] = gg[q];
    }
  } else {
    float* hg = rw.hg[R0 + r] + 4 * h;
#pragma unroll
    for (int q = 0; q < 4; ++q) hg[q] = 4 * h + q < kOut ? gg[q] : 0.f;
  }
}

// dx_raw of the warpgroup's rows from rows.acc[:, 0:11], rows below P.
__device__ __forceinline__ void alone_dx(const Ctx& c, long long row0,
                                         long long n_points,
                                         float* __restrict__ dx_raw) {
  constexpr int kN = kRows * kIn, kEach = (kN + 127) / 128;
  const Rows& rw = *c.rows;
  const int R0 = c.group * kRows;
  float* dst = dx_raw + row0 * kIn;
  const long long valid = (n_points - row0) * kIn;
#pragma unroll
  for (int i = 0; i < kEach; ++i) {
    const int e = c.tid + 128 * i;
    if (e < kN && e < valid) dst[e] = rw.acc[R0 + e / kIn][e % kIn];
  }
}

// -- the tangent streams ------------------------------------------------------

constexpr int kGroupPoints = kRows / 4;  // points of a warpgroup: 16

// Row inputs of the warpgroup's points [p0, p0 + 16) on its rows (tan_row):
// every stream row takes its point's x_raw; zeros past P. The trunk's
// (F = kSe3Warp): the heads' cotangents of stream 0 are d w, d v (g[:,
// 0:3], g[:, 3:6]), of stream 1 + k column k of d dw, d dv (g[:, 6 + 3 i +
// k], g[:, 15 + 3 i + k]), d w into rows.hg, d v into rows.se3[:, 8:11].
// The Jacobian's (kTransJac): g = dJ, g[:, 3 i + k] to rows.hg[:, i] of
// stream 1 + k; the primal rows' head cotangent is zero.
template <int F>
__device__ __forceinline__ void tangent_rows(const Ctx& c, long long p0,
                                             long long n_points,
                                             const float* __restrict__ x_raw,
                                             const float* __restrict__ g) {
  constexpr int kW = F == kSe3Warp ? kTanG : kJacG;
  constexpr int kX = kGroupPoints * kIn, kXEach = (kX + 127) / 128;
  constexpr int kG = kGroupPoints * kW, kGEach = (kG + 127) / 128;
  Rows& rw = *c.rows;
  const int R0 = c.group * kRows;
  const long long x_valid = (n_points - p0) * kIn;
  const long long g_valid = (n_points - p0) * kW;
  float xv[kXEach], gv[kGEach];
#pragma unroll
  for (int i = 0; i < kXEach; ++i) {
    const int e = c.tid + 128 * i;
    xv[i] = e < kX && e < x_valid ? x_raw[p0 * kIn + e] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kGEach; ++i) {
    const int e = c.tid + 128 * i;
    gv[i] = e < kG && e < g_valid ? g[p0 * kW + e] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kXEach; ++i) {
    const int e = c.tid + 128 * i;
    if (e < kX)
#pragma unroll
      for (int s = 0; s < 4; ++s)
        rw.in[R0 + tan_row(e / kIn, s)][e % kIn] = xv[i];
  }
  if constexpr (F == kTransJac) {
#pragma unroll
    for (int i = 0; i < kGEach; ++i) {
      const int e = c.tid + 128 * i;
      if (e < kG)
        rw.hg[R0 + tan_row(e / kW, 1 + e % kW % 3)][e % kW / 3] = gv[i];
    }
    if (c.tid < kGroupPoints * 3)
      rw.hg[R0 + tan_row(c.tid / 3, 0)][c.tid % 3] = 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < kGEach; ++i) {
      const int e = c.tid + 128 * i;
      const int q = e / kTanG, col = e % kTanG;
      // [w | v] of stream 0, then [dw | dv], column 3 i + k to stream 1 + k.
      const bool is_v = col < 6 ? col >= 3 : col >= 15;
      const int d = col < 6 ? col % 3 : (col - (is_v ? 15 : 6));
      const int s = col < 6 ? 0 : 1 + d % 3, out = col < 6 ? d : d / 3;
      const int R = R0 + tan_row(q, s);
      if (is_v)
        rw.se3[R][8 + out] = gv[i];
      else
        rw.hg[R][out] = gv[i];
    }
  }
}

// The trunk's encoding on the warpgroup's rows: the primal rows as
// encode_trunk; tangent k's [cos(p_k 2^m) 2^m | -sin(p_k 2^m) 2^m on
// channel k's band columns | 0] with m = kSe3MinDeg + band / 3.
__device__ __forceinline__ void encode_trunk_streams(
    Ctx& c, const float* __restrict__ scales) {
  constexpr int kRest = kSe3EncP - 2 * kSe3Trig;
  const uint32_t box = c.half(slot_of<kSe3Warp, kEnc, kFwd>(0));
  const float(*in)[12] = c.rows->in + c.group * kRows;
#pragma unroll 4
  for (int e = c.tid; e < kRows * kSe3Trig; e += 128) {
    const int r = e / kSe3Trig, b = e % kSe3Trig, s = tan_stream(r);
    const bool on = s == 0 || b % 3 == s - 1;
    float sn = 0.f, cs = 0.f;
    if (on) sincosf(se3_band_arg(in[r], b), &sn, &cs);
    bf16 vs, vc;
    if (s == 0) {
      vs = window_feature(sn, b, scales);
      vc = window_feature(cs, kSe3Trig + b, scales);
    } else {
      const int m = kSe3MinDeg + b / 3;
      vs = tangent_feature(ldexpf(cs, m), b, scales);
      vc = tangent_feature(-ldexpf(sn, m), kSe3Trig + b, scales);
    }
    lf::sts16(lf::x_at(box, r, b), vs);
    lf::sts16(lf::x_at(box, r, kSe3Trig + b), vc);
  }
  for (int e = c.tid; e < kRows * kRest; e += 128) {
    const int r = e / kRest, f = e % kRest;
    const float v = tan_stream(r) == 0 && f < kEmbed ? in[r][3 + f] : 0.f;
    lf::sts16(lf::x_at(box, r, 2 * kSe3Trig + f),
              window_feature(v, 2 * kSe3Trig + f, scales));
  }
}

// The translation warp field's encoding on the warpgroup's rows (kTransJac):
// the primal rows as encode_field's [posenc_orig(pts, 10) | embed | 0];
// tangent k's [e_k | cos(p_k 2^j) 2^j | -sin(p_k 2^j) 2^j on channel k's band
// columns | 0], each rounded once.
__device__ __forceinline__ void encode_warp_streams(Ctx& c) {
  constexpr int kPairs = 3 * kWarpF, kRest = kWarpEncP - 2 * kPairs;
  const float(*in)[12] = c.rows->in + c.group * kRows;
  auto put = [&c](int r, int col, float v) {
    const uint32_t box = c.half(slot_of<kTransJac, kEnc, kFwd>(col >> 6));
    lf::sts16(lf::x_at(box, r, col & 63), __float2bfloat16_rn(v));
  };
#pragma unroll 4
  for (int e = c.tid; e < kRows * kPairs; e += 128) {
    const int r = e / kPairs, q = e % kPairs, s = tan_stream(r);
    float sn = 0.f, cs = 0.f;
    if (s == 0 || q % 3 == s - 1)
      sincosf(in[r][q % 3] * lf::pow2(q / 3), &sn, &cs);
    const float f = s == 0 ? 1.f : lf::pow2(q / 3);
    put(r, 3 + q, s == 0 ? sn : cs * f);
    put(r, 3 + kPairs + q, s == 0 ? cs : -sn * f);
  }
  for (int e = c.tid; e < kRows * kRest; e += 128) {
    const int r = e / kRest, f = e % kRest, s = tan_stream(r);
    const float v = s == 0 ? (f < 3 + kEmbed ? in[r][f] : 0.f)
                           : (f == s - 1 ? 1.f : 0.f);
    put(r, f < 3 ? f : f + 2 * kPairs, v);
  }
}

// d pts of the warpgroup's 16 points (kTransJac) into their primal rows'
// rows.acc[0:3], and rows.acc[3:11] zero (d embed is exactly zero): the
// tangent encodings' pullback from tangent row c's band cotangents in
// rows.acc (jac_enc_rows), d/dp [cos(p 2^j) 2^j] = -sin(p 2^j) 4^j and d/dp
// [-sin(p 2^j) 2^j] = -cos(p 2^j) 4^j, a channel's bands split between a
// pair of neighbouring lanes.
__device__ __forceinline__ void jac_vjp(Ctx& c) {
  constexpr int kHalf = (kWarpF + 1) / 2;
  Rows& rw = *c.rows;
  const int R0 = c.group * kRows;
  static_assert(kGroupPoints * 6 % 32 == 0, "whole warps take the sums");
  for (int e = c.tid; e < kGroupPoints * 6; e += 128) {
    const int part = e & 1, q = (e >> 1) / 3, ch = (e >> 1) % 3;
    const int rp = tan_row(q, 0);
    const float x = rw.in[R0 + rp][ch];
    const float* g = rw.acc[R0 + tan_row(q, 1 + ch)];
    float dx = 0.f;
    for (int k = part ? kHalf : 0; k < (part ? kWarpF : kHalf); ++k) {
      float sn, cs;
      const float f = lf::pow2(k);
      sincosf(x * f, &sn, &cs);
      dx += (-sn * (g[k] * f) - cs * (g[kWarpF + k] * f)) * f;
    }
    dx += __shfl_xor_sync(0xffffffffu, dx, 1);
    if (part == 0) rw.acc[R0 + rp][ch] = dx;
  }
  for (int e = c.tid; e < kGroupPoints * kEmbed; e += 128)
    rw.acc[R0 + tan_row(e / kEmbed, 0)][3 + e % kEmbed] = 0.f;
  c.mark(kCyVjp);
}

// d[pts | embed] of the warpgroup's 16 points into rows.acc[primal row][0:11]:
// d enc = layer 0's part + the skip part (bf16, summed in fp32, times the
// window row) on each stream row; d p_c = the primal row's pullback plus
// tangent c's row's (d/dp [cos(p 2^m) 2^m] = -sin(p 2^m) 4^m, d/dp [-sin(p
// 2^m) 2^m] = -cos(p 2^m) 4^m), a point channel's bands split between a
// pair of neighbouring lanes; d embed from the primal row.
__device__ __forceinline__ void tangent_vjp(Ctx& c,
                                            const float* __restrict__ scales) {
  constexpr int kHalf = (kSe3F + 1) / 2;
  Rows& rw = *c.rows;
  const int R0 = c.group * kRows;
  const uint32_t enc = c.half(slot_of<kSe3Warp, kEnc, 0>(0));
  const uint32_t skip = c.half(slot_of<kSe3Warp, kSkip, kFwd>(0));
  auto gx = [&](int r, int f) {
    const float v = lds_bf(lf::x_at(enc, r, f)) + lds_bf(lf::x_at(skip, r, f));
    return scales != nullptr ? v * scales[f] : v;
  };
  static_assert(kGroupPoints * 6 % 32 == 0, "whole warps take the sums");
  for (int e = c.tid; e < kGroupPoints * 6; e += 128) {
    const int part = e & 1, q = (e >> 1) / 3, ch = (e >> 1) % 3;
    const int rp = tan_row(q, 0), rt = tan_row(q, 1 + ch);
    const float x = rw.in[R0 + rp][ch];
    float dx = 0.f;
    for (int k = part ? kHalf : 0; k < (part ? kSe3F : kHalf); ++k) {
      float sn, cs;
      const float scale = lf::pow2(kSe3MinDeg + k);
      sincosf(x * scale, &sn, &cs);
      const int fs = k * 3 + ch, fc = kSe3Trig + k * 3 + ch;
      dx += (cs * gx(rp, fs) - sn * gx(rp, fc)) * scale;
      dx += (-sn * gx(rt, fs) - cs * gx(rt, fc)) * scale * scale;
    }
    dx += __shfl_xor_sync(0xffffffffu, dx, 1);
    if (part == 0) rw.acc[R0 + rp][ch] = dx;
  }
  for (int e = c.tid; e < kGroupPoints * kEmbed; e += 128) {
    const int q = e / kEmbed, ch = e % kEmbed, rp = tan_row(q, 0);
    rw.acc[R0 + rp][3 + ch] = gx(rp, 2 * kSe3Trig + ch);
  }
  c.mark(kCyVjp);
}

// dx_raw of the warpgroup's points [p0, p0 + 16) from their primal rows'
// rows.acc[:, 0:11], points below P.
__device__ __forceinline__ void tangent_dx(const Ctx& c, long long p0,
                                           long long n_points,
                                           float* __restrict__ dx_raw) {
  constexpr int kN = kGroupPoints * kIn, kEach = (kN + 127) / 128;
  const Rows& rw = *c.rows;
  const long long valid = (n_points - p0) * kIn;
#pragma unroll
  for (int i = 0; i < kEach; ++i) {
    const int e = c.tid + 128 * i;
    if (e < kN && e < valid)
      dx_raw[p0 * kIn + e] =
          rw.acc[c.group * kRows + tan_row(e / kIn, 0)][e % kIn];
  }
}

// -- the kernel ----------------------------------------------------------------

// kTan: the SE(3) trunk (F = kSe3Warp) or the translation warp field (F =
// kTransJac, its Jacobian) with its tangent streams, n_points points on 4
// n_points rows.
template <int F, bool kTan>
__global__ void __launch_bounds__(kThreads, 1) field_bwd_kernel(
    const __grid_constant__ lf::Maps<typename Alone<F>::T> maps,
    const float* __restrict__ x_raw, const float* __restrict__ scales,
    const float* __restrict__ g_out, const bf16* __restrict__ W,
    const bf16* __restrict__ B, float* __restrict__ dx_raw,
    float* __restrict__ grads, uint8_t* __restrict__ scratch,
    long long n_points) {
  using A = Alone<F>;
  using T = typename A::T;
  static_assert((!kTan || F == kSe3Warp || F == kTransJac) &&
                    (kTan || F != kTransJac),
                "tangent streams: the trunk's, or the Jacobian's");
  uint8_t* base;
  Ring ring;
  Rows* rows;
  uint64_t* reload;
  lay_out(base, ring, rows, reload);
  const long long n_rows = kTan ? 4 * n_points : n_points;
  const long long n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const int group = threadIdx.x >> 7;

  if (group == kGroups) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kGroups)
      for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        produce_alone<F>(maps, ring);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  Ctx c{smem_addr(base), rows, ring, reload,
        scratch + (size_t)blockIdx.x * kSpillSlabs * kSlabBytes, group,
        (int)(threadIdx.x & 127), 0};
#ifdef HN_FIELDS_BWD_TRACE
  c.last = clock64();
#endif
  // The blobs and the gradient copies hold this field's layers alone; the
  // device functions index them by the level's layer table.
  const bf16* Wl = W - A::kW0;
  const bf16* Bl = B - A::kB0;
  float* copy = grads + (blockIdx.x % kGradCopies) * (A::kNW + A::kNB);
  float* grad_w = copy - A::kW0;
  float* grad_b = copy + A::kNW - A::kB0;
  Rows& rw = *rows;
  for (long long tile = blockIdx.x; tile < n_tiles;
       tile += gridDim.x, ++c.it) {
    // The warpgroup's first row, or with the tangents its first point.
    const long long first = kTan ? (tile * kTileRows + group * kRows) / 4
                                 : tile * kTileRows + group * kRows;
    if constexpr (kTan)
      tangent_rows<F>(c, first, n_points, x_raw, g_out);
    else
      alone_rows<F>(c, first, n_points, x_raw, g_out);
    c.sync();
    c.mark(kCyRow);
    if constexpr (F == kTransJac)
      encode_warp_streams(c);
    else if constexpr (kTan)
      encode_trunk_streams(c, scales);
    else if constexpr (F == kSe3Warp)
      encode_trunk(c, scales);
    else
      encode_field<F, A::kBands>(c, scales);
    fence_async_smem();
    c.sync();
    spill_enc<F>(c);
    c.mark(kCyEnc);
    fwd_layer<T, F, 0, true, kTan>(c, Bl);
    fwd_layer<T, F, 1, true, kTan>(c, Bl);
    fwd_layer<T, F, 2, true, kTan>(c, Bl);
    fwd_layer<T, F, 3, true, kTan>(c, Bl);
    fwd_layer<T, F, 4, true, kTan>(c, Bl);
    fwd_layer<T, F, 5, true, kTan>(c, Bl);
    // The trunk logit: no ReLU.
    if constexpr (F == kSe3Warp) fwd_layer<T, F, 6, false, kTan>(c, Bl);
    // Every spill written before any reload reads it.
    if (A::kSpills && c.tid == 0) {
      bulk_wait_all();
      fence_async_global();
    }
    c.block_sync();
    c.mark(kCyBar);
    head_back<T, F, kTan>(c, Wl, grad_w, grad_b);
    if constexpr (F == kSe3Warp) back_layer<T, F, 6, kTan>(c, grad_w, grad_b);
    back_layer<T, F, 5, kTan>(c, grad_w, grad_b);
    back_layer<T, F, 4, kTan>(c, grad_w, grad_b);
    back_layer<T, F, 3, kTan>(c, grad_w, grad_b);
    back_layer<T, F, 2, kTan>(c, grad_w, grad_b);
    back_layer<T, F, 1, kTan>(c, grad_w, grad_b);
    back_layer<T, F, 0, kTan>(c, grad_w, grad_b);
    if constexpr (F == kTransJac)
      jac_vjp(c);
    else if constexpr (kTan)
      tangent_vjp(c, scales);
    else
      encoding_vjp<F, A::kBands>(c, &rw.acc[0][0], 20, scales);
    c.sync();
    if constexpr (kTan)
      tangent_dx(c, first, n_points, dx_raw);
    else
      alone_dx(c, first, n_points, dx_raw);
    c.mark(kCyRay);
  }
}

// Host side: the tensor maps of the field's blob (level_fwd.cuh's,
// cached), the shared-memory attribute once per device, `blocks`
// persistent blocks.
template <int F, bool kTan>
int launch_field_bwd(const void* x_raw, const void* scales, const void* g,
                     const void* weights, const void* biases, void* dx_raw,
                     void* grads, void* scratch, long long n_points,
                     int blocks, void* stream) {
  using A = Alone<F>;
  if (n_points <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  static std::atomic<int> configured[kMaxDevices];
  int dev = 0, sms = 0;
  int status = current_device(&dev, &sms);
  if (status) return status;
  if (!configured[dev].load(std::memory_order_relaxed)) {
    const cudaError_t err = cudaFuncSetAttribute(
        field_bwd_kernel<F, kTan>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured[dev].store(1, std::memory_order_relaxed);
  }
  lf::Maps<typename A::T> maps;
  status = lf::make_maps<typename A::T>(
      &maps, static_cast<const bf16*>(weights), A::kFirst, A::kLast);
  if (status) return status;
  field_bwd_kernel<F, kTan>
      <<<blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
          maps, static_cast<const float*>(x_raw),
          static_cast<const float*>(scales), static_cast<const float*>(g),
          static_cast<const bf16*>(weights), static_cast<const bf16*>(biases),
          static_cast<float*>(dx_raw), static_cast<float*>(grads),
          static_cast<uint8_t*>(scratch), n_points);
  return (int)cudaGetLastError();
}

}  // namespace fb
}  // namespace

// The entry points' arguments (fields_bwd_alone.cu, se3_bwd_alone.cu,
// se3_tangents_bwd.cu, warp_tangents_bwd.cu): weights / biases the field's
// layers alone; scales null or the padded encoding width of fp32 window
// weights (the Jacobian's: null); grads [dW | db]
// of those layers in the packed layout, in fb::kGradCopies copies one after
// the other, zero on entry; scratch blocks x fb::kSpillSlabs x 16 KB of
// spill slabs where the field's plan spills (the warp field, the trunk),
// else unused; blocks hn_fused_fields_bwd_blocks(rows).
#define HN_FIELD_BWD_ARGS                                                    \
  const void *x_raw, const void *scales, const void *g, const void *weights, \
      const void *biases, void *dx_raw, void *grads, void *scratch,          \
      long long n_points, int blocks, void *stream
#define HN_FIELD_BWD_PASS                                              \
  x_raw, scales, g, weights, biases, dx_raw, grads, scratch, n_points, \
      blocks, stream

#ifdef HN_FIELDS_BWD_TRACE
// The cycles block 0 added up (fields_bwd.cuh), as [group][tile][kind];
// then zeroes them for the next launch.
extern "C" int hn_fields_bwd_trace(long long* out) {
  constexpr int kCount = fb::kGroups * fb::kTraceTiles * fb::kTraceKinds;
  static long long zero[kCount];
  int err = (int)cudaMemcpyFromSymbol(out, fb::fields_bwd_trace,
                                      sizeof(zero));
  if (err) return err;
  return (int)cudaMemcpyToSymbol(fb::fields_bwd_trace, zero, sizeof(zero));
}
#endif
