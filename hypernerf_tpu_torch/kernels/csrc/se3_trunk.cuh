// The SE(3) / quaternion warp field's trunk: its constants, its encoding's
// features, and its retraction. Shared by the level kernels' screw-warp
// variants (level_fwd.cuh, whose trunk stage modular_fwd.cu also runs alone
// and tangents_fwd.cu with its tangent streams, and fields_bwd.cuh, whose
// block also runs the trunk alone backward, with and without its tangent
// streams: fields_bwd_alone.cuh).
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

#include "level_common.cuh"

namespace {

constexpr int kSe3Trunk = 6, kSe3HeadW = 7, kSe3HeadV = 8;  // layers

// The argument of band b (0..23) of the trunk encoding of one row
// in = [pts(3) | ...]: pts[b % 3] * 2^(kSe3MinDeg + b / 3) (exact).
__device__ __forceinline__ float se3_band_arg(const float* in, int b) {
  return ldexpf(in[b % 3], kSe3MinDeg + b / 3);
}

// Feature f of a tangent encoding from its fp32 value: times the window row,
// rounded once.
__device__ __forceinline__ bf16 tangent_feature(
    float v, int f, const float* __restrict__ scales) {
  return __float2bfloat16_rn(scales != nullptr ? v * scales[f] : v);
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
