// The warp Jacobian kernels' shared device code (fused_jacobian.cu,
// fused_jacobian_bwd.cu for the translation warp; fused_se3_jacobian.cu for
// the SE(3) / quaternion trunk's forward, whose backward runs on kernel B's
// block: se3_tangents_bwd.cu over fields_bwd_alone.cuh).
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
// With R = 8 or a multiple of 16, the mma.sync accumulator fragment a thread
// holds for one point and column holds it for all four streams (rows
// s * R + 8 u + g sit in m-tile (s * R / 8 + u) / 2, half (s * R / 8 + u) % 2),
// so the forward epilogue takes the mask from a register. The backward reads
// it from the primal row's stored activation.

#pragma once

#include "se3_trunk.cuh"

namespace {

// A tile of four stream blocks of R points: Cfg with 4R rows.
template <int R_, int LD_>
struct JC : Cfg<R_ / 4, LD_, 8> {
  static constexpr int R = R_;
  static_assert(R_ == 8 || R_ % 16 == 0, "stream blocks of 8 or 16k rows");
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

// d p_c of the tangent encoding's pullback for point q: its cotangent gx(r, f)
// on tangent row r = (1 + c) R + q; only channel c's band columns depend on p:
// d/dp [cos(p 2^m) 2^m] = -sin(p 2^m) 4^m, d/dp [-sin(p 2^m) 2^m] =
// -cos(p 2^m) 4^m, summed over the bands in fp32. sin_col / cos_col: the
// first sin / cos band column; NF bands from degree M0.
template <int NF, int M0, class G>
__device__ __forceinline__ float tangent_encode_dp(float x, int c, int sin_col,
                                                   int cos_col, G gx) {
  float dp = 0.f;
  for (int k = 0; k < NF; ++k) {
    const int m = M0 + k;
    float sn, cs;
    sincosf(ldexpf(x, m), &sn, &cs);
    const float a_sin = ldexpf(gx(sin_col + 3 * k + c), m);
    const float a_cos = ldexpf(gx(cos_col + 3 * k + c), m);
    dp += ldexpf(-sn * a_sin - cs * a_cos, m);
  }
  return dp;
}

// -- fp32 cotangents as two bf16 halves ------------------------------------
//
// The translation Jacobian's backward keeps its cotangent in fp32, as the TPU
// kernel does. It is stored as hi = bf16(g) and lo = bf16(g - hi), KLO
// columns apart, and every product takes both halves (two bf16 mma.sync with
// one weight fetch): hi + lo carries 16 of fp32's 24 mantissa bits, a
// relative error under 2^-16, where one bf16 rounding costs 2^-9.

__device__ __forceinline__ void split_bf(float v, bf16* hi, bf16* lo) {
  const bf16 h = __float2bfloat16_rn(v);
  *hi = h;
  *lo = __float2bfloat16_rn(v - bf2f(h));
}

// gemm with a split A: acc = (A_hi + A_lo) @ W^T, A_hi at a_col, A_lo at
// a_col + KLO.
template <class C, int N, int K, int KLO>
__device__ __forceinline__ void gemm_split(
    const bf16* X, int a_col, const bf16* __restrict__ W,
    float (&acc)[C::MT][tiles_per_warp<C, N>()][4]) {
  constexpr int T = tiles_per_warp<C, N>();
  static_assert(K % 16 == 0 && N % 8 == 0, "mma tile");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][i][c] = 0.f;
  if (warp * 8 >= N) return;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t b[T][2];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int j = warp + C::NW * i;
      if (j * 8 < N) {
        const bf16* w = W + (size_t)(j * 8 + g) * K + k0 + 2 * t;
        b[i][0] = ldg32(w);
        b[i][1] = ldg32(w + 8);
      } else {
        b[i][0] = b[i][1] = 0u;
      }
    }
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const bf16* x =
            X + (mt * 16 + g) * C::LD + a_col + half * KLO + k0 + 2 * t;
        const uint32_t a0 = lds32(x), a1 = lds32(x + 8 * C::LD);
        const uint32_t a2 = lds32(x + 8), a3 = lds32(x + 8 * C::LD + 8);
#pragma unroll
        for (int i = 0; i < T; ++i)
          if ((warp + C::NW * i) * 8 < N)
            mma_bf16(acc[mt][i], a0, a1, a2, a3, b[i][0], b[i][1]);
      }
    }
  }
}

// The cotangent through layer L over the four streams, split in and out:
// X[:, out_col (+KLO)] = split((X[:, g_col] + X[:, g_col + KLO]) @ W_L),
// zeroed for k < mask_w where the PRIMAL row of the same point stored
// X[q][mask_col + k] <= 0. Wt holds W_L^T, (K, N) row-major.
template <class C, int L, class T, int KLO>
__device__ __forceinline__ void jac_dx_split(bf16* X, int g_col, int out_col,
                                             const bf16* __restrict__ Wt,
                                             int mask_col, int mask_w) {
  constexpr int N = layer_shape<T>(L).n, K = layer_shape<T>(L).k;
  constexpr int NT = tiles_per_warp<C, K>();
  float acc[C::MT][NT][4];
  gemm_split<C, K, N, KLO>(X, g_col, Wt + weight_offset<T>(L), acc);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int j = warp + C::NW * i;
    if (j * 8 >= K) continue;
    const int k = j * 8 + 2 * t;
    const bool masked = k < mask_w;
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        float v[2] = {acc[mt][i][2 * h], acc[mt][i][2 * h + 1]};
        if (masked) {
          const bf16* m = X + (r % C::R) * C::LD + mask_col + k;
          if (!(bf2f(m[0]) > 0.f)) v[0] = 0.f;
          if (!(bf2f(m[1]) > 0.f)) v[1] = 0.f;
        }
        bf16* o = X + r * C::LD + out_col + k;
#pragma unroll
        for (int c = 0; c < 2; ++c) split_bf(v[c], o + c, o + KLO + c);
      }
    }
  }
  __syncthreads();
}

// dW_L[n][k] += sum_r (X[r][g_col + n] + X[r][g_col + KLO + n]) *
// X[r][h_col + k], added into the gradient buffer: a warp takes 16 x 16
// pieces of dW, the m16n8k16 product with M = out, N = in, K = rows, both
// operands read transposed with ldmatrix.trans.
template <class C, int L, class T, int KLO>
__device__ __forceinline__ void jac_dw_split(const bf16* X, int g_col,
                                             int h_col,
                                             float* __restrict__ grad_w) {
  constexpr int N = layer_shape<T>(L).n, K = layer_shape<T>(L).k;
  static_assert(N % 16 == 0 && K % 16 == 0, "16 x 16 pieces");
  float* dw = grad_w + weight_offset<T>(L);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q = lane >> 3, i8 = lane & 7;
  for (int unit = warp; unit < (N / 16) * (K / 16); unit += C::NW) {
    const int n0 = (unit / (K / 16)) * 16, k0 = (unit % (K / 16)) * 16;
    float c[2][4] = {};
#pragma unroll
    for (int rs = 0; rs < C::MT; ++rs) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, X + (rs * 16 + (q & 1) * 8 + i8) * C::LD + h_col +
                               k0 + (q >> 1) * 8);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, X + (rs * 16 + (q >> 1) * 8 + i8) * C::LD +
                                 g_col + half * KLO + n0 + (q & 1) * 8);
        mma_bf16(c[0], a[0], a[1], a[2], a[3], b[0], b[1]);
        mma_bf16(c[1], a[0], a[1], a[2], a[3], b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2* p = reinterpret_cast<float2*>(
            dw + (size_t)(n0 + g + 8 * h) * K + k0 + 8 * j + 2 * t);
        atomicAdd(p, make_float2(c[j][2 * h], c[j][2 * h + 1]));
      }
  }
}

}  // namespace
