// One field MLP (the warp field or the hyper sheet) on a tile: the encoding
// of raw rows [points | embedding] and the recompute-and-walk-back of its
// backward. Shared by the backward of a field alone (fused_field_bwd.cu)
// and, for the encoding, the forward of a field alone (fused_field.cu). (The
// level's fields backward, kernel B, is fields_bwd.cuh.)
//
// The optional `scales` row (one fp32 weight per padded encoded feature, the
// annealing window of the windowed encoding) multiplies the rounded encoding,
// which is rounded again; the backward multiplies the encoding's fp32
// cotangent by the same row. A null pointer means no window.

#pragma once

#include "level_bwd.cuh"

namespace {

// Column plan (bf16 columns) of a field of width W with padded encoding E:
// h0..h4 | enc | h5 | cotangent [g (W) | skip part (E)].
template <int W, int E>
struct Plan {
  static constexpr int enc = 5 * W, h5 = 5 * W + E, g = 6 * W + E;
  static constexpr int end = 7 * W + 2 * E;
  __host__ __device__ static constexpr int h(int i) {
    return i < 5 ? i * W : h5;
  }
  __host__ __device__ static constexpr int in(int i) {  // 6 is the head
    return i == 0 ? enc : h(i - 1);
  }
};
using WarpPlan = Plan<kWarpW, kWarpEncP>;
using HypPlan = Plan<kHypW, kHypEncP>;
constexpr int kLdF = WarpPlan::end + 8;  // 1064
static_assert(HypPlan::end <= WarpPlan::end, "the sheet fits the warp's tile");

using CF = Cfg<2, kLdF, 8>;

// Field encoding [posenc_orig(pts, F) | embed | 0 pad] into X[:, col:col+KP]
// from rowin[r][12] = [pts(3) | embed(8) | pad].
template <class C, int F, int KP>
__device__ __forceinline__ void encode_field(bf16* X, int col,
                                             const float* rowin,
                                             const float* __restrict__ scales) {
  constexpr int kPts = 3 * (1 + 2 * F);
  for (int e = threadIdx.x; e < C::ROWS * KP; e += C::THREADS) {
    const int r = e / KP, f = e % KP;
    const float* in = rowin + r * 12;
    float v = 0.f;
    if (f < kPts)
      v = posenc_at<3, F>(in, f);
    else if (f < kPts + kEmbed)
      v = in[3 + f - kPts];
    bf16 b = __float2bfloat16_rn(v);
    if (scales != nullptr)
      b = __float2bfloat16_rn(__bfloat162float(b) * scales[f]);
    X[r * C::LD + col + f] = b;
  }
}

// Hidden layer I of a field back: dW, db, then the cotangent through it. C is
// the tile's configuration and T the layer table (the level with the SE(3)
// warp keeps the sheet in a wider tile and at other rows of another table).
template <class P, int LB, int I, class C = CF, class T = TransTable>
__device__ __forceinline__ void field_back(bf16* X, const bf16* Wt,
                                           float* grad_w, float* grad_b) {
  constexpr int L = LB + I;
  bwd_dw<C, L, 0, T>(X, P::g, P::in(I), grad_w);
  bwd_db<C, L, 0, T>(X, P::g, grad_b);
  bwd_dx<C, L, T>(X, P::g, P::g, Wt, I > 0 ? P::h(I > 0 ? I - 1 : 0) : 0,
                  I > 0 ? layer_shape<T>(LB).n : 0);
}

// One field (layers LB .. LB + 6, width W, F bands) on the tile: recompute,
// walk back from the head cotangent hg, and write its d[pts | embed] into
// dacc[ROWS][12]. W, Wt, B, grad_w and grad_b are indexed by the level's
// layer table (layer 0 at offset 0).
template <class P, int LB, int F, class C = CF, class T = TransTable>
__device__ __forceinline__ void field_bwd(bf16* X, const float* rowin,
                                          const float* hg, float* dacc,
                                          const bf16* W, const bf16* Wt,
                                          const bf16* B, float* grad_w,
                                          float* grad_b,
                                          const float* __restrict__ scales) {
  constexpr int Wd = layer_shape<T>(LB).n;
  constexpr int kEncP = layer_shape<T>(LB).k;
  constexpr int kPts = 3 * (1 + 2 * F);
  const int tid = threadIdx.x;
  encode_field<C, F, kEncP>(X, P::enc, rowin, scales);
  __syncthreads();
  fwd_layer<C, LB + 0, true, T>(X, P::in(0), P::h(0), W, B);
  fwd_layer<C, LB + 1, true, T>(X, P::in(1), P::h(1), W, B);
  fwd_layer<C, LB + 2, true, T>(X, P::in(2), P::h(2), W, B);
  fwd_layer<C, LB + 3, true, T>(X, P::in(3), P::h(3), W, B);
  fwd_layer<C, LB + 4, true, T>(X, P::in(4), P::h(4), W, B);
  fwd_layer<C, LB + 5, true, T>(X, P::in(5), P::h(5), W, B);

  head_dw_db<C, LB + 6, 0, T>(X, P::h(5), hg, grad_w, grad_b);
  for (int e = tid; e < C::ROWS * Wd; e += C::THREADS) {
    const int r = e / Wd, k = e % Wd;
    const float v = head_dx<LB + 6, T>(hg + r * 8, W, k);
    const bool on = __bfloat162float(X[r * C::LD + P::h(5) + k]) > 0.f;
    X[r * C::LD + P::g + k] = __float2bfloat16_rn(on ? v : 0.f);
  }
  __syncthreads();
  field_back<P, LB, 5, C, T>(X, Wt, grad_w, grad_b);  // writes the skip part
  field_back<P, LB, 4, C, T>(X, Wt, grad_w, grad_b);
  field_back<P, LB, 3, C, T>(X, Wt, grad_w, grad_b);
  field_back<P, LB, 2, C, T>(X, Wt, grad_w, grad_b);
  field_back<P, LB, 1, C, T>(X, Wt, grad_w, grad_b);
  field_back<P, LB, 0, C, T>(X, Wt, grad_w, grad_b);  // -> d enc in g[0:E]

  // d enc = layer 0's part + the skip part, in fp32, times the window row;
  // posenc VJP for the points, the embedding passes through.
  for (int e = tid; e < C::ROWS * 11; e += C::THREADS) {
    const int r = e / 11, c = e % 11;
    const bf16* gr = X + r * C::LD + P::g;
    auto gx = [&](int f) {
      const float v =
          __bfloat162float(gr[f]) + __bfloat162float(gr[Wd + f]);
      return scales != nullptr ? v * scales[f] : v;
    };
    float out;
    if (c < 3) {
      const float x = rowin[r * 12 + c];
      float dx = 0.f;
      for (int k = 0; k < F; ++k) {
        const float scale = (float)(1 << k);
        float sn, cs;
        sincosf(x * scale, &sn, &cs);
        const float flat = cs * gx(3 + k * 3 + c) -
                           sn * gx(3 + 3 * F + k * 3 + c);
        dx += flat * scale;
      }
      out = gx(c) + dx;
    } else {
      out = gx(kPts + c - 3);
    }
    dacc[r * 12 + c] = out;
  }
  __syncthreads();
}

}  // namespace
