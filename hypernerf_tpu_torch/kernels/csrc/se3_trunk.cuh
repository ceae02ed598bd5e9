// The SE(3) / quaternion warp field's trunk on a tile, and its retraction.
// Shared by the trunk's backward alone (fused_se3_bwd.cu), the tangent
// kernels (jacobian.cuh) and the level kernels' screw-warp variants
// (level_fwd.cuh, whose trunk stage modular_fwd.cu also runs alone, and
// fields_bwd.cuh).
//
// The trunk is Se3Table's layers 0..8: the Nerfies encoding of the points
// (sin and cos of the degrees [kSe3MinDeg, kSe3MinDeg + 8), no identity
// block) ++ the embedding, 56 features padded to 64 -> 6 hidden layers of 128
// (skip input after layer 4) -> a linear 128 -> 128 trunk logit, rounded to
// bf16 WITHOUT a ReLU -> the w and the v head (128 -> 3 each, fp32), which
// both read the rounded trunk. The retraction maps (w, v, point) to the warped
// point in fp32, one thread per row: the screw exponential (SE(3)) or the
// rotation by exp(w) followed by the translation v (quaternion).
//
// The optional `scales` row (64 fp32 weights, the warp_alpha window)
// multiplies the rounded encoding, which is rounded again; the backward
// multiplies the encoding's fp32 cotangent by the same row.

#pragma once

#include "field_bwd.cuh"

namespace {

// Column plan (bf16 columns) of the trunk's backward tile:
// h0..h4 | enc | h5 | trunk logit | cotangent [g (W) | skip part (E)].
struct Se3Plan {
  static constexpr int W = kSe3W, E = kSe3EncP;
  static constexpr int enc = 5 * W, h5 = 5 * W + E, trunk = 6 * W + E;
  static constexpr int g = 7 * W + E, end = 8 * W + 2 * E;
  __host__ __device__ static constexpr int h(int i) {
    return i < 5 ? i * W : h5;
  }
  __host__ __device__ static constexpr int in(int i) {  // 6: the trunk logit
    return i == 0 ? enc : h(i - 1);
  }
};
constexpr int kLdS = Se3Plan::end + 8;  // 1160

using CS = Cfg<2, kLdS, 8>;

constexpr int kSe3Trunk = 6, kSe3HeadW = 7, kSe3HeadV = 8;  // layers

// The argument of band b (0..23) of the trunk encoding of one row
// in = [pts(3) | ...]: pts[b % 3] * 2^(kSe3MinDeg + b / 3) (exact).
__device__ __forceinline__ float se3_band_arg(const float* in, int b) {
  return ldexpf(in[b % 3], kSe3MinDeg + b / 3);
}

// Feature f of an encoding from its fp32 value: rounded, then times the
// window row and rounded again (no row: rounded once).
__device__ __forceinline__ bf16 window_feature(float v, int f,
                                            const float* __restrict__ scales) {
  bf16 b = __float2bfloat16_rn(v);
  if (scales != nullptr)
    b = __float2bfloat16_rn(__bfloat162float(b) * scales[f]);
  return b;
}

// Trunk encoding [sin bands | cos bands | embed | 0 pad] into
// X[:, col : col + 64] from rowin[r][12] = [pts(3) | embed(8) | pad]; band k
// of channel c at k * 3 + c, argument pts[c] * 2^(kSe3MinDeg + k) (exact).
// sinf / cosf, not the fast intrinsics: the top band multiplies x by 128.
template <class C>
__device__ __forceinline__ void encode_se3(bf16* X, int col,
                                           const float* rowin,
                                           const float* __restrict__ scales) {
  for (int e = threadIdx.x; e < C::ROWS * kSe3EncP; e += C::THREADS) {
    const int r = e / kSe3EncP, f = e % kSe3EncP;
    const float* in = rowin + r * 12;
    float v = 0.f;
    if (f < 2 * kSe3Trig) {
      const int b = f < kSe3Trig ? f : f - kSe3Trig;
      const float arg = se3_band_arg(in, b);
      v = f < kSe3Trig ? sinf(arg) : cosf(arg);
    } else if (f < 2 * kSe3Trig + kEmbed) {
      v = in[3 + f - 2 * kSe3Trig];
    }
    X[r * C::LD + col + f] = window_feature(v, f, scales);
  }
}

// Recompute of the trunk on Se3Plan's columns, every layer's output kept.
template <class C>
__device__ __forceinline__ void se3_recompute(bf16* X, const float* rowin,
                                              const bf16* W, const bf16* B,
                                              const float* __restrict__ scales) {
  using P = Se3Plan;
  using T = Se3Table;
  encode_se3<C>(X, P::enc, rowin, scales);
  __syncthreads();
  fwd_layer<C, 0, true, T>(X, P::in(0), P::h(0), W, B);
  fwd_layer<C, 1, true, T>(X, P::in(1), P::h(1), W, B);
  fwd_layer<C, 2, true, T>(X, P::in(2), P::h(2), W, B);
  fwd_layer<C, 3, true, T>(X, P::in(3), P::h(3), W, B);
  fwd_layer<C, 4, true, T>(X, P::in(4), P::h(4), W, B);
  fwd_layer<C, 5, true, T>(X, P::in(5), P::h(5), W, B);
  fwd_layer<C, kSe3Trunk, false, T>(X, P::h(5), P::trunk, W, B);
}

// Walk back through the recomputed trunk from the heads' fp32 cotangents
// hgw[ROWS][8] = [d w | 0] and hgv[ROWS][8] = [d v | 0]; writes d[pts | embed]
// into dacc[ROWS][12]. Rounding points: the heads' dW takes the rounded
// cotangent and their db the fp32 one; the trunk logit's cotangent
// (g_w W_w + g_v W_v, summed in fp32) is rounded once, its db sums that
// rounded cotangent and there is no ReLU mask on it; hidden layers as in
// field_bwd.
template <class C>
__device__ __forceinline__ void se3_walk_back(bf16* X, const float* rowin,
                                              const float* hgw,
                                              const float* hgv, float* dacc,
                                              const bf16* W, const bf16* Wt,
                                              float* grad_w, float* grad_b,
                                              const float* __restrict__ scales) {
  using P = Se3Plan;
  using T = Se3Table;
  const int tid = threadIdx.x;
  head_dw_db<C, kSe3HeadW, 0, T>(X, P::trunk, hgw, grad_w, grad_b);
  head_dw_db<C, kSe3HeadV, 0, T>(X, P::trunk, hgv, grad_w, grad_b);
  for (int e = tid; e < C::ROWS * kSe3W; e += C::THREADS) {
    const int r = e / kSe3W, k = e % kSe3W;
    const float v = head_dx<kSe3HeadW, T>(hgw + r * 8, W, k) +
                    head_dx<kSe3HeadV, T>(hgv + r * 8, W, k);
    X[r * C::LD + P::g + k] = __float2bfloat16_rn(v);
  }
  __syncthreads();
  // The trunk logit is linear: no mask on its own cotangent; the cotangent
  // it passes down is masked by hidden 5's ReLU.
  bwd_dw<C, kSe3Trunk, 0, T>(X, P::g, P::h(5), grad_w);
  bwd_db<C, kSe3Trunk, 0, T>(X, P::g, grad_b);
  bwd_dx<C, kSe3Trunk, T>(X, P::g, P::g, Wt, P::h(5), kSe3W);
  field_back<P, 0, 5, C, T>(X, Wt, grad_w, grad_b);  // writes the skip part
  field_back<P, 0, 4, C, T>(X, Wt, grad_w, grad_b);
  field_back<P, 0, 3, C, T>(X, Wt, grad_w, grad_b);
  field_back<P, 0, 2, C, T>(X, Wt, grad_w, grad_b);
  field_back<P, 0, 1, C, T>(X, Wt, grad_w, grad_b);
  field_back<P, 0, 0, C, T>(X, Wt, grad_w, grad_b);  // -> d enc in g[0:E]

  // d enc = layer 0's part + the skip part, in fp32, times the window row;
  // the encoding's VJP for the points (no identity term), the embedding
  // passes through.
  for (int e = tid; e < C::ROWS * 11; e += C::THREADS) {
    const int r = e / 11, c = e % 11;
    const bf16* gr = X + r * C::LD + P::g;
    auto gx = [&](int f) {
      const float v =
          __bfloat162float(gr[f]) + __bfloat162float(gr[kSe3W + f]);
      return scales != nullptr ? v * scales[f] : v;
    };
    float out;
    if (c < 3) {
      const float x = rowin[r * 12 + c];
      float dx = 0.f;
      for (int k = 0; k < kSe3F; ++k) {
        float sn, cs;
        sincosf(ldexpf(x, kSe3MinDeg + k), &sn, &cs);
        const float flat =
            cs * gx(k * 3 + c) - sn * gx(kSe3Trig + k * 3 + c);
        dx += ldexpf(flat, kSe3MinDeg + k);
      }
      out = dx;
    } else {
      out = gx(2 * kSe3Trig + c - 3);
    }
    dacc[r * 12 + c] = out;
  }
  __syncthreads();
}

// -- the retraction -----------------------------------------------------------

constexpr float kSmallAngleSq = 1e-12f;  // (1e-6)^2

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// warped = R p + G v (SE(3): the screw exponential, R = I + sin t A +
// (1 - cos t) A^2, G = I + b1 A + b2 A^2, b1 = (1 - cos t) / t,
// b2 = (t - sin t) / t, A = [a]_x, a = w / t, t = |w|), or R p + v
// (kQuat). |w|^2 is clamped before the root; at |w| <= 1e-6 the result is
// p + v.
template <bool kQuat>
__device__ __forceinline__ void retract(const float* w, const float* v,
                                        const float* p, float* out) {
  const float sq = dot3(w, w);
  if (sq <= kSmallAngleSq) {
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c] = p[c] + v[c];
    return;
  }
  const float safe = sqrtf(sq);
  const float a[3] = {w[0] / safe, w[1] / safe, w[2] / safe};
  float sn, cs;
  sincosf(safe, &sn, &cs);
  const float omc = 1.f - cs;
  const float ap = dot3(a, p);
  float axp[3];
  cross3(a, p, axp);
  if (kQuat) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[c] = (p[c] + sn * axp[c] + omc * (a[c] * ap - p[c])) + v[c];
    return;
  }
  const float av = dot3(a, v);
  float axv[3];
  cross3(a, v, axv);
  const float b1 = omc / safe, b2 = (safe - sn) / safe;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float rp = p[c] + sn * axp[c] + omc * (a[c] * ap - p[c]);
    const float gv = v[c] + b1 * axv[c] + b2 * (a[c] * av - v[c]);
    out[c] = rp + gv;
  }
}

// The hand-derived VJP of `retract`: g = d warped -> (d w, d v, d p).
// d p = R^T g, d v = G^T g (g for kQuat); the axis' and the angle's
// cotangents collect the R and G terms and pull back through a = w / t:
// d w = a d t + (d a - a <a, d a>) / t. At |w| <= 1e-6: d w = 0,
// d v = d p = g.
template <bool kQuat>
__device__ __forceinline__ void retract_bwd(const float* w, const float* v,
                                            const float* p, const float* g,
                                            float* dw, float* dv, float* dp) {
  const float sq = dot3(w, w);
  if (sq <= kSmallAngleSq) {
#pragma unroll
    for (int c = 0; c < 3; ++c) dw[c] = 0.f, dv[c] = g[c], dp[c] = g[c];
    return;
  }
  const float safe = sqrtf(sq);
  const float a[3] = {w[0] / safe, w[1] / safe, w[2] / safe};
  float sn, cs;
  sincosf(safe, &sn, &cs);
  const float omc = 1.f - cs;
  const float b1 = omc / safe, b2 = (safe - sn) / safe;
  const float ag = dot3(a, g), ap = dot3(a, p), pg = dot3(p, g);
  const float av = kQuat ? 0.f : dot3(a, v), vg = kQuat ? 0.f : dot3(v, g);
  float axg[3], axp[3], pxg[3], axv[3] = {0.f, 0.f, 0.f};
  float vxg[3] = {0.f, 0.f, 0.f};
  cross3(a, g, axg);
  cross3(a, p, axp);
  cross3(p, g, pxg);
  if (!kQuat) {
    cross3(a, v, axv);
    cross3(v, g, vxg);
  }
  float da[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float a_axg = a[c] * ag - g[c];
    dp[c] = g[c] - sn * axg[c] + omc * a_axg;
    dv[c] = kQuat ? g[c] : g[c] - b1 * axg[c] + b2 * a_axg;
    da[c] = sn * pxg[c] + omc * (p[c] * ag - 2.f * a[c] * pg + g[c] * ap);
    if (!kQuat)
      da[c] += b1 * vxg[c] + b2 * (v[c] * ag - 2.f * a[c] * vg + g[c] * av);
  }
  float dt = cs * dot3(axp, g) + sn * (ap * ag - pg);
  if (!kQuat) {
    const float b1p = sn / safe - omc / (safe * safe);
    const float b2p = (sn - safe * cs) / (safe * safe);
    dt += b1p * dot3(axv, g) + b2p * (av * ag - vg);
  }
  const float a_da = dot3(a, da);
#pragma unroll
  for (int c = 0; c < 3; ++c) dw[c] = a[c] * dt + (da[c] - a[c] * a_da) / safe;
}

}  // namespace
