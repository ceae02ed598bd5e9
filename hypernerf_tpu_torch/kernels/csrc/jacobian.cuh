// The warp Jacobian kernels' forwards' shared device code (fused_jacobian.cu
// for the translation warp, fused_se3_jacobian.cu for the SE(3) /
// quaternion trunk; both backwards run on kernel B's block:
// warp_tangents_bwd.cu and se3_tangents_bwd.cu over fields_bwd_alone.cuh).
//
// Forward-mode tangents ride the MLP as extra rows. A tile holds R points as
// FOUR stream blocks of R rows each: the primal rows, then the tangent rows
// d/d p_k for k = 0, 1, 2 (row s * R + q is stream s of point q). Every layer
// is one product over all 4R rows, so a weight fragment fetched from L2 for a
// k-step feeds all four blocks. Primal rows get bias + ReLU; tangent rows get
// no bias and the primal row's ReLU mask (the ReLU's derivative), taken from
// the fp32 pre-activation; both are rounded to bf16 as the TPU kernels round
// them. Linear layers (the SE(3) trunk logit) pass the tangent unmasked.
//
// With R a multiple of 16, the mma.sync accumulator fragment a thread holds
// for one point and column holds it for all four streams (rows s * R + 8 u +
// g sit in m-tile (s * R / 8 + u) / 2, half (s * R / 8 + u) % 2), so the
// epilogue takes the mask from a register.

#pragma once

#include "se3_trunk.cuh"

namespace {

// A tile of four stream blocks of R points: Cfg with 4R rows.
template <int R_, int LD_>
struct JC : Cfg<R_ / 4, LD_, 8> {
  static constexpr int R = R_;
  static_assert(R_ % 16 == 0, "stream blocks of 16k rows");
};

__device__ __forceinline__ float bf2f(bf16 x) { return __bfloat162float(x); }

// Layer L over all 4R rows: X[:, out_col : out_col + N] from
// X[:, in_col : in_col + K]. Primal rows: bf16([relu](acc + b)); tangent
// rows: bf16(acc * mask) with mask = (primal acc + b > 0) for kRelu, no mask
// for a linear layer.
template <class C, int L, bool kRelu, class T>
__device__ __forceinline__ void jac_layer(bf16* X, int in_col, int out_col,
                                          const bf16* __restrict__ W,
                                          const bf16* __restrict__ B) {
  constexpr int N = layer_shape<T>(L).n, K = layer_shape<T>(L).k;
  constexpr int NT = tiles_per_warp<C, N>();
  constexpr int U = C::R / 8;
  float acc[C::MT][NT][4];
  gemm<C, N, K>(X, in_col, W + weight_offset<T>(L), acc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* bias = B + bias_offset<T>(L);
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int j = warp + C::NW * i;
    if (j * 8 >= N) continue;
    const int n = j * 8 + 2 * t;
    const float b0 = bf2f(bias[n]), b1 = bf2f(bias[n + 1]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pm = u / 2, ph = u % 2;  // the primal rows of slot u
      const float p0 = acc[pm][i][2 * ph] + b0;
      const float p1 = acc[pm][i][2 * ph + 1] + b1;
      const bool on0 = !kRelu || p0 > 0.f, on1 = !kRelu || p1 > 0.f;
      *reinterpret_cast<__nv_bfloat162*>(X + (8 * u + g) * C::LD + out_col +
                                         n) =
          kRelu ? __floats2bfloat162_rn(fmaxf(p0, 0.f), fmaxf(p1, 0.f))
                : __floats2bfloat162_rn(p0, p1);
#pragma unroll
      for (int s = 1; s < 4; ++s) {
        const int e8 = s * U + u, mt = e8 / 2, h = e8 % 2;
        const float v0 = on0 ? acc[mt][i][2 * h] : 0.f;
        const float v1 = on1 ? acc[mt][i][2 * h + 1] : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(X + (8 * e8 + g) * C::LD +
                                           out_col + n) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  __syncthreads();
}

// A linear head L (out <= 8 after padding) over all 4R rows, fp32:
// out[r][0:8] = X[r, in_col : in_col + K] @ W_L^T (+ b_L on primal rows).
template <class C, int L, class T>
__device__ __forceinline__ void jac_head(const bf16* X, int in_col,
                                         const bf16* __restrict__ W,
                                         const bf16* __restrict__ B,
                                         float* out) {
  constexpr int K = layer_shape<T>(L).k;
  static_assert(layer_shape<T>(L).n == 8, "heads are padded to 8");
  float acc[C::MT][1][4];
  gemm<C, 8, K>(X, in_col, W + weight_offset<T>(L), acc);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (threadIdx.x < 32) {
    const bf16* bias = B + bias_offset<T>(L);
    const float b0 = bf2f(bias[2 * t]), b1 = bf2f(bias[2 * t + 1]);
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        const bool primal = r < C::R;
        out[r * 8 + 2 * t] = acc[mt][0][2 * h] + (primal ? b0 : 0.f);
        out[r * 8 + 2 * t + 1] = acc[mt][0][2 * h + 1] + (primal ? b1 : 0.f);
      }
  }
  __syncthreads();
}

// The translation warp's encoding [posenc_orig(p, F) | embed | 0 pad] on the
// primal rows and its tangents on tangent row k:
// [e_k | cos(p_k 2^j) 2^j on channel k | -sin(p_k 2^j) 2^j on channel k | 0],
// each rounded to bf16 once, into X[:, col : col + KP] from
// rowin[q][12] = [pts(3) | embed(8) | pad].
template <class C, int F, int KP>
__device__ __forceinline__ void encode_trans_streams(bf16* X, int col,
                                                     const float* rowin) {
  constexpr int kPts = 3 * (1 + 2 * F);
  for (int e = threadIdx.x; e < C::ROWS * KP; e += C::THREADS) {
    const int r = e / KP, f = e % KP;
    const int s = r / C::R, q = r % C::R;
    const float* in = rowin + q * 12;
    float v = 0.f;
    if (s == 0) {
      if (f < kPts)
        v = posenc_at<3, F>(in, f);
      else if (f < kPts + kEmbed)
        v = in[3 + f - kPts];
    } else if (f < 3) {
      v = f == s - 1 ? 1.f : 0.f;
    } else if (f < kPts) {
      int b = f - 3;
      const bool is_cos = b >= 3 * F;
      if (is_cos) b -= 3 * F;
      if (b % 3 == s - 1) {
        const float scale = (float)(1 << (b / 3));
        const float arg = in[s - 1] * scale;  // exact scaling
        v = is_cos ? -sinf(arg) * scale : cosf(arg) * scale;
      }
    }
    X[r * C::LD + col + f] = __float2bfloat16_rn(v);
  }
}

// The SE(3) trunk's encoding on the primal rows and its tangents
// on tangent row k: [cos(p_k 2^m) 2^m | -sin(p_k 2^m) 2^m on channel k's
// band columns | 0], m = kSe3MinDeg + band. The window row multiplies the
// primal encoding after its rounding (rounded again) and the fp32 tangent
// before its one rounding.
template <class C>
__device__ __forceinline__ void encode_se3_streams(
    bf16* X, int col, const float* rowin, const float* __restrict__ scales) {
  for (int e = threadIdx.x; e < C::ROWS * kSe3EncP; e += C::THREADS) {
    const int r = e / kSe3EncP, f = e % kSe3EncP;
    const int s = r / C::R, q = r % C::R;
    const float* in = rowin + q * 12;
    bf16 out;
    if (s == 0) {
      float v = 0.f;
      if (f < 2 * kSe3Trig) {
        const int b = f < kSe3Trig ? f : f - kSe3Trig;
        const float arg = ldexpf(in[b % 3], kSe3MinDeg + b / 3);
        v = f < kSe3Trig ? sinf(arg) : cosf(arg);
      } else if (f < 2 * kSe3Trig + kEmbed) {
        v = in[3 + f - 2 * kSe3Trig];
      }
      out = __float2bfloat16_rn(v);
      if (scales != nullptr)
        out = __float2bfloat16_rn(bf2f(out) * scales[f]);
    } else {
      float v = 0.f;
      if (f < 2 * kSe3Trig) {
        const int b = f < kSe3Trig ? f : f - kSe3Trig;
        if (b % 3 == s - 1) {
          const int m = kSe3MinDeg + b / 3;
          const float arg = ldexpf(in[s - 1], m);
          v = f < kSe3Trig ? ldexpf(cosf(arg), m) : -ldexpf(sinf(arg), m);
        }
      }
      if (scales != nullptr) v *= scales[f];
      out = __float2bfloat16_rn(v);
    }
    X[r * C::LD + col + f] = out;
  }
}

}  // namespace
