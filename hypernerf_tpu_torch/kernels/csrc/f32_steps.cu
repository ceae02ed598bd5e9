// The float32 steps of kernels A and B for Hopper (sm_90a): a row product
// through a layer, a layer's dW / db over row ranges, their fixed-order
// sum, and the narrow steps (the encodings into the stash, the rgb
// condition per row, the posenc VJPs, the per-ray sums, the alpha
// condition's per-ray step).
//
// At `compute_dtype='float32'` they replace the TPU kernels
// hypernerf_tpu/ops/pallas/fused_mlp.py `_bwd_call` (:736, kernel A, the
// template backward, with 4 hyper coordinates or none, or the plane
// layouts' 8, in the posenc_orig or the windowed Nerfies layout, any rgb
// condition width up to 48, with or without the alpha condition) and
// hypernerf_tpu/ops/pallas/fused_level.py `_fields_bwd_call` (:846, kernel
// B, the warp field's and the sheet's backward), the two halves of the
// level backward (`_fused_bwd_pipelined` :1260, `_fused_bwd` :1397), and
// hypernerf_tpu/ops/pallas/fused_field.py `_fused_bwd` (:532, a field
// alone backward: kernel B's steps on one field from raw rows [points |
// embedding], encoded by the template's encoding step with 0 bands on the
// embedding, its VJP by the template's posenc VJP the same way, both with
// the field's window row where it has one). With the
// SE(3) / quaternion warp, kernel B walks the trunk back instead of the
// warp field (the trunk's encoding, the heads' forward, the retraction's
// VJP into the heads' cotangent and the point's direct term, se3_trunk.cuh
// `retract_bwd`, then the screw rows: the trunk's and the sheet's encoding
// VJPs per sample); in a plane table (no sheet) it walks back the warp
// field or the trunk alone and the plane rows add d hyper into each
// sample's d embed (the hyper coordinates are the embedding), and kernel
// A takes the plane layouts' 8 hyper coordinates through the same encoding
// steps. The trunk's steps on raw rows are the trunk alone
// backward (hypernerf_tpu/ops/pallas/fused_se3.py `_fused_bwd` :412). The
// host side that orders the steps over chunks of whole rays and owns the
// stash of each layer's fp32 output is kernels/f32.py; the bf16 kernels A
// and B are untouched. The Jacobians' backwards at float32 (rows 15 and 17,
// f32_tangents.cu) run rowprod, dw and reduce on a chunk's four streams:
// the mask's rows repeat, and a layer's db may sum its first rows alone.
//
// Bound: operations (the products) for rowprod and dw, bytes for the
// narrow steps. Design: rowprod and dw are f32_chain.cuh's register tiles
// (Step: 128 x 128 a block, 8 x 8 a thread) on operands staged through
// shared memory in chunks of 16 reduction columns (rowprod: 16 input
// columns of 128 rows and of 128 outputs; dw: 16 rows of 128 outputs and
// of 128 inputs),
// each chunk loaded into registers while the one before it is multiplied.
// dw writes each row range's partial sums into a slab of its own (as many
// ranges as fill the card twice, kernels/f32.py split_count), which
// hn_f32_reduce adds into the layer's [dW | db] in a fixed order: dW / db
// are deterministic.

#include "f32_chain.cuh"
#include "se3_trunk.cuh"  // retract_bwd: the retraction's VJP, fp32

namespace {
// Its own namespace: level_common.cuh (se3_trunk.cuh's) declares some of
// these names for the bf16 kernels.
namespace steps {

using namespace f32;

// A matrix of up to two column segments: element (r, k) is a0[r * ld0 + k]
// for k < k0, else a1[r * ld1 + k - k0].
struct Cols {
  const float* a0;
  long long ld0;
  int k0;
  const float* a1;
  long long ld1;
};

__device__ __forceinline__ float at(const Cols& m, long long r, int k) {
  return k < m.k0 ? m.a0[r * m.ld0 + k] : m.a1[r * m.ld1 + (k - m.k0)];
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

struct RowprodArgs {
  Cols a;
  int K;
  const float* w;  // B(k, n) = w[k * ldw + n] (f32_chain.cuh WChunk)
  long long ldw;
  int N;
  const float* bias;  // or null
  int relu;
  const float* mask;  // or null: out = mask > 0 ? out : 0
  long long ldm;
  long long mrows;  // the mask's rows: row r reads mask row r % mrows
  float* out;
  long long ldo;
  int accumulate;  // out += the product (no bias, ReLU or mask)
  long long M;
};

// out[r * ldo + n] = epi(sum_k A(r, k) B(k, n)) for r < M, n < N, with B
// the layer's weight (g W) or its transpose (x W^T), row-major [k][n]. The
// mask's rows repeat every mrows rows (the Jacobians' tangent rows read
// their point's primal row; mrows = M elsewhere).
using T = Step;  // 128 rows x 128 columns a block, 8 x 8 a thread

// The activation chunk's leading dimension: padded by 4 so that a quarter
// warp's float4 stores (8 columns of 8 rows) fall on distinct banks.
constexpr int kALd = T::kRows + 4;

__global__ void __launch_bounds__(kThreads) rowprod_f32(const RowprodArgs p) {
  __shared__ __align__(16) float as[2][kDepth * kALd];
  __shared__ __align__(16) float ws[2][T::kWTile];
  const int t = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * T::kRows;
  const int n0 = blockIdx.y * T::kCols;
  const int chunks = (p.K + kDepth - 1) / kDepth;
  // This thread's 8 activations of a chunk: column t % 16 of rows
  // 8 (t / 16) .. + 7 (a half warp reads 16 consecutive columns of a row).
  const int ak = t & 15, ar = (t >> 4) * 8;
  float av[8];
  WChunk<T> wc;
  auto load_a = [&](int k0) {
    const int k = k0 + ak;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long row = m0 + ar + i;
      av[i] = (row < p.M && k < p.K) ? at(p.a, row, k) : 0.f;
    }
  };
  auto store_a = [&](float* dst) {
    *reinterpret_cast<float4*>(dst + ak * kALd + ar) =
        make_float4(av[0], av[1], av[2], av[3]);
    *reinterpret_cast<float4*>(dst + ak * kALd + ar + 4) =
        make_float4(av[4], av[5], av[6], av[7]);
  };
  float acc[T::TR][T::TC];
  zero<T>(acc);
  load_a(0);
  wc.load(p.w, p.ldw, 0, p.K, n0, p.N);
  store_a(as[0]);
  wc.store(ws[0]);
  __syncthreads();
  for (int ch = 0; ch < chunks; ++ch) {
    const bool more = ch + 1 < chunks;
    if (more) {
      load_a((ch + 1) * kDepth);
      wc.load(p.w, p.ldw, (ch + 1) * kDepth, p.K, n0, p.N);
    }
    chunk_fma<T>(acc, as[ch & 1], kALd, ws[ch & 1]);
    if (more) {
      store_a(as[(ch + 1) & 1]);
      wc.store(ws[(ch + 1) & 1]);
    }
    __syncthreads();
  }
  // The epilogue, four columns (a run of col) at a time, as float4 (the
  // entry point checks the alignment).
  const int r0 = T::row();
#pragma unroll
  for (int i = 0; i < T::TR; ++i) {
    const long long r = m0 + r0 + i;
    if (r >= p.M) continue;
#pragma unroll
    for (int q = 0; q < T::TC / 4; ++q) {
      const int n = n0 + T::col(4 * q);
      if (n >= p.N) continue;  // N % 4 == 0: the run is whole
      float4* o = reinterpret_cast<float4*>(p.out + r * p.ldo + n);
      float4 y = make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                             acc[i][4 * q + 2], acc[i][4 * q + 3]);
      if (p.accumulate) {
        const float4 v = *o;
        y = make_float4(y.x + v.x, y.y + v.y, y.z + v.z, y.w + v.w);
      } else {
        if (p.bias != nullptr) {
          const float4 b = __ldg(reinterpret_cast<const float4*>(p.bias + n));
          y = make_float4(y.x + b.x, y.y + b.y, y.z + b.z, y.w + b.w);
        }
        if (p.relu)
          y = make_float4(fmaxf(y.x, 0.f), fmaxf(y.y, 0.f), fmaxf(y.z, 0.f),
                          fmaxf(y.w, 0.f));
        if (p.mask != nullptr) {
          const float4 m = *reinterpret_cast<const float4*>(
              p.mask + (r % p.mrows) * p.ldm + n);
          y = make_float4(m.x > 0.f ? y.x : 0.f, m.y > 0.f ? y.y : 0.f,
                          m.z > 0.f ? y.z : 0.f, m.w > 0.f ? y.w : 0.f);
        }
      }
      *o = y;
    }
  }
}

// sum += x with Kahan's compensation: `lost` carries the low part the
// running sum dropped (no multiply here, so nothing contracts into an FMA).
// A layer's db and a dW entry sum millions of rows a chunk, and a bias's
// sum can be small beside the rows' magnitudes (a random cotangent's
// column); the compensated sums keep the in-order slabs and their in-order
// reduction near the rounding of the total, not of every partial sum.
__device__ __forceinline__ void kahan_add(float& sum, float& lost, float x) {
  const float y = x - lost;
  const float t = sum + y;
  lost = (t - sum) - y;
  sum = t;
}

struct DwArgs {
  const float* g;  // (M, >= N) at ldg: the layer's output cotangent
  long long ldg;
  int N;
  Cols h;  // the layer's input, K columns
  int K;
  float* slab;  // (splits, lds)
  long long lds;
  long long w_off;  // dW (N_pad, ldc) at slab[z][w_off]
  int ldc;
  long long b_off;  // db at slab[z][b_off], or -1: none
  long long db_rows;  // db sums the rows r < db_rows (M: every row)
  long long M;
  int splits;
};

// slab[z][w_off + n * ldc + k] = sum over the rows of range z of G(r, n)
// H(r, k), and (blocks of the first column tile) slab[z][b_off + n] = sum
// of G(r, n) over its rows r < db_rows (the Jacobians' primal rows; M
// elsewhere), for n < N, k < K; zero for K <= k < ldc (a layer whose input
// is narrower than its packed columns: the static template's encoding).
// Grid (N tiles of 128, ldc tiles of 128, splits).
__global__ void __launch_bounds__(kThreads) dw_f32(const DwArgs p) {
  __shared__ __align__(16) float gs[2][kDepth * T::kRows];
  __shared__ __align__(16) float hs[2][T::kWTile];
  const int t = threadIdx.x;
  const int j0 = blockIdx.x * T::kRows, i0 = blockIdx.y * T::kCols;
  const int z = blockIdx.z;
  const long long r_begin = p.M * z / p.splits;
  const long long r_end = p.M * (z + 1) / p.splits;
  const long long n_rows = r_end - r_begin;
  const int chunks = (int)((n_rows + kDepth - 1) / kDepth);
  const bool with_db = p.b_off >= 0 && blockIdx.y == 0;
  // A chunk of 16 rows of G (128 outputs) and of H (128 inputs) is 512
  // float4 each: this thread's float4 f = t + 256 q (q < 2) of each is
  // row f / 32, columns 4 (f % 32) .. + 3, so a warp reads 512 contiguous
  // bytes of a row; G element by element where its columns are not
  // float4-aligned (a head's cotangent: 1 or 3 columns of a wider row).
  const bool g_vec = p.N % 4 == 0 && p.ldg % 4 == 0 && aligned16(p.g);
  float4 gv[2], hv[2];
  auto load = [&](int ch) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int f = t + q * kThreads;
      const long long r = r_begin + (long long)ch * kDepth + f / 32;
      const int c = (f % 32) * 4;
      const bool in = r < r_end;
      float gq[4], hq[4];
      const int n = j0 + c, k = i0 + c;
      if (g_vec && in && n < p.N) {
        const float4 v = *reinterpret_cast<const float4*>(p.g + r * p.ldg + n);
        gq[0] = v.x, gq[1] = v.y, gq[2] = v.z, gq[3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          gq[e] = (in && n + e < p.N) ? p.g[r * p.ldg + n + e] : 0.f;
      }
      if (in && k < p.K) {  // K, k0 % 4 == 0: the float4 is whole
        const float* src = k < p.h.k0 ? p.h.a0 + r * p.h.ld0 + k
                                      : p.h.a1 + r * p.h.ld1 + (k - p.h.k0);
        const float4 v = *reinterpret_cast<const float4*>(src);
        hq[0] = v.x, hq[1] = v.y, hq[2] = v.z, hq[3] = v.w;
      } else {
        hq[0] = hq[1] = hq[2] = hq[3] = 0.f;
      }
      gv[q] = make_float4(gq[0], gq[1], gq[2], gq[3]);
      hv[q] = make_float4(hq[0], hq[1], hq[2], hq[3]);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int f = t + q * kThreads;
      *reinterpret_cast<float4*>(&gs[buf][(f / 32) * T::kRows +
                                          (f % 32) * 4]) = gv[q];
      *reinterpret_cast<float4*>(&hs[buf][(f / 32) * T::kCols +
                                          (f % 32) * 4]) = hv[q];
    }
  };
  float acc[T::TR][T::TC];
  zero<T>(acc);
  float db = 0.f, db_lost = 0.f;  // compensated (kahan_add)
  if (chunks > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int ch = 0; ch < chunks; ++ch) {
    const bool more = ch + 1 < chunks;
    if (more) load(ch + 1);
    chunk_fma<T>(acc, gs[ch & 1], T::kRows, hs[ch & 1]);
    if (with_db && t < T::kRows)
      for (int k = 0; k < kDepth; ++k) {
        const long long r = r_begin + (long long)ch * kDepth + k;
        kahan_add(db, db_lost,
                  r < p.db_rows ? gs[ch & 1][k * T::kRows + t] : 0.f);
      }
    if (more) store((ch + 1) & 1);
    __syncthreads();
  }
  float* slab = p.slab + z * p.lds;
  const int r0 = T::row();
#pragma unroll
  for (int i = 0; i < T::TR; ++i) {
    const int n = j0 + r0 + i;
    if (n >= p.N) continue;
#pragma unroll
    for (int j = 0; j < T::TC; ++j) {
      const int k = i0 + T::col(j);
      // Past K the loads were zero, and so is the sum.
      if (k < p.ldc) slab[p.w_off + (long long)n * p.ldc + k] = acc[i][j];
    }
  }
  if (with_db && t < T::kRows && j0 + t < p.N) slab[p.b_off + j0 + t] = db;
}

// grads[i] += sum over z of slab[z * lds + i] for i < n, in order of z,
// compensated (kahan_add).
__global__ void reduce_f32(const float* slab, int splits, long long lds,
                           long long n, float* grads) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f, lost = 0.f;
  for (int z = 0; z < splits; ++z) kahan_add(s, lost, slab[z * lds + i]);
  grads[i] += s;
}

// out[r * ldo + f], f < pad: [posenc_orig(o + z d, F) | emb | 0] of row r
// (ray r / S). A thread per element.
__global__ void field_encode_f32(const float* z, const float* o,
                                 const float* d, const float* emb, int e,
                                 int samples, int F, float* out,
                                 long long ldo, int pad, long long M) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * pad) return;
  const long long r = i / pad;
  const int f = (int)(i % pad);
  const long long q = r / samples;
  float p[3];
  for (int c = 0; c < 3; ++c)
    p[c] = __fadd_rn(o[q * 3 + c], __fmul_rn(z[r], d[q * 3 + c]));
  const int n_pe = 3 * (1 + 2 * F);
  out[r * ldo + f] = f < n_pe ? posenc_feature(p, 1, 3, F, f)
                     : f < n_pe + e ? emb[q * e + f - n_pe]
                                    : 0.f;
}

// out[r * ldo + f], f < pad: [posenc_orig(raw[0:3], F0) |
// posenc_orig(raw[3:3 + ch1], F1) | 0] of row r (the second segment
// without its identity columns where !id1: the Nerfies posenc), each
// feature times the window row scales[f] where there is one. A thread per
// element.
__global__ void tmpl_encode_f32(const float* raw, long long ldr, int F0,
                                int ch1, int F1, float* out, long long ldo,
                                int pad, long long M, int id1,
                                const float* scales) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * pad) return;
  const long long r = i / pad;
  const int f = (int)(i % pad);
  const float* x = raw + r * ldr;
  const int n0 = 3 * (1 + 2 * F0), n1 = ch1 * ((id1 ? 1 : 0) + 2 * F1);
  const float v =
      f < n0        ? posenc_feature(x, 1, 3, F0, f)
      : f < n0 + n1 ? posenc_feature(x + 3, 1, ch1, F1, f - n0, id1 != 0)
                    : 0.f;
  out[r * ldo + f] = scales != nullptr ? v * scales[f] : v;
}

// out[r * ldo + c], c < pad: the condition of row r's ray, zero past C.
__global__ void cond_rows_f32(const float* cond, int C, int samples,
                              float* out, long long ldo, int pad,
                              long long M) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * pad) return;
  const long long r = i / pad;
  const int c = (int)(i % pad);
  out[r * ldo + c] = c < C ? cond[(r / samples) * C + c] : 0.f;
}

// dx[r * 8 + ...] = [the posenc VJP of raw[0:3] (F0 bands) | of
// raw[3:3 + ch1] (F1 bands; without identity columns where !id1) | 0] from
// the encoding's cotangent g (row r at g + r * ldg) times the window row
// where there is one (scales, aligned with g's columns). A thread per row.
__global__ void tmpl_posenc_bwd_f32(const float* raw, long long ldr, int F0,
                                    int ch1, int F1, const float* g,
                                    long long ldg, float* dx, long long ldx,
                                    long long M, int id1,
                                    const float* scales) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= M) return;
  const float* x = raw + r * ldr;
  const float* gr = g + r * ldg;
  float* out = dx + r * ldx;
  for (int c = 0; c < 3; ++c)
    out[c] = posenc_vjp(x[c], gr, 3, F0, c, true, scales);
  const int n0 = 3 * (1 + 2 * F0);
  const float* g1 = gr + n0;
  const float* w1 = scales != nullptr ? scales + n0 : nullptr;
  for (int c = 0; c < ch1; ++c)
    out[3 + c] = posenc_vjp(x[3 + c], g1, ch1, F1, c, id1 != 0, w1);
  for (int c = 3 + ch1; c < ldx; ++c) out[c] = 0.f;
}

// Kernel A's alpha condition (ca columns a ray): with gs the sum of the
// raw sigma's cotangent g over the S rows of ray q (row r at g[r * ldg]),
// d_alpha[q * ca + c] = gs alpha_w[c], and slab[z * lds + c] = the sum of
// gs alpha[q * ca + c] over the rays of range z (block z of `splits`,
// thread t's rays summed in order, then the threads' sums in order), which
// hn_f32_reduce adds in order of z: deterministic.
constexpr int kMaxAlpha = 8;
__global__ void __launch_bounds__(kThreads)
    alpha_cond_bwd_f32(const float* g, long long ldg, const float* alpha,
                       const float* alpha_w, int ca, int samples,
                       float* d_alpha, float* slab, long long lds,
                       long long rays, int splits) {
  __shared__ float part[kMaxAlpha][kThreads];
  const int t = threadIdx.x, z = blockIdx.x;
  const long long q0 = rays * z / splits, q1 = rays * (z + 1) / splits;
  float acc[kMaxAlpha];
  for (int c = 0; c < kMaxAlpha; ++c) acc[c] = 0.f;
  for (long long q = q0 + t; q < q1; q += kThreads) {
    float gs = 0.f;
    for (int k = 0; k < samples; ++k) gs += g[(q * samples + k) * ldg];
    for (int c = 0; c < ca; ++c) {
      d_alpha[q * ca + c] = gs * alpha_w[c];
      acc[c] = fmaf(gs, alpha[q * ca + c], acc[c]);
    }
  }
  for (int c = 0; c < kMaxAlpha; ++c) part[c][t] = acc[c];
  __syncthreads();
  if (t < ca) {
    float s = 0.f;
    for (int i = 0; i < kThreads; ++i) s += part[t][i];
    slab[z * lds + t] = s;
  }
}

// Kernel B's per-sample cotangents of row r (ray r / S): d p = dx_t[0:3] +
// the posenc VJPs of the warp field's (F0 bands) and the sheet's (F1)
// encoding cotangents, d embed = their embedding columns; d z[r] = d p .
// d, and rows[r * 14 + ...] = [d p | z d p | d embed], which
// hn_f32_ray_sum adds per ray. A thread per row.
__global__ void fields_rows_f32(const float* z, const float* o,
                                const float* d, int samples,
                                const float* dxt, long long ldx,
                                const float* gw, long long ldw, int F0,
                                const float* gs, long long ldgs, int F1,
                                int e, float* dz, float* rows, long long M) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= M) return;
  const long long q = r / samples;
  const float* g0 = gw + r * ldw;
  const float* g1 = gs + r * ldgs;
  float* out = rows + r * (6 + e);
  float dot = 0.f;
  for (int c = 0; c < 3; ++c) {
    const float p = __fadd_rn(o[q * 3 + c], __fmul_rn(z[r], d[q * 3 + c]));
    const float dp = (dxt[r * ldx + c] + posenc_vjp(p, g0, 3, F0, c))
                     + posenc_vjp(p, g1, 3, F1, c);
    dot += dp * d[q * 3 + c];
    out[c] = dp;
    out[3 + c] = dp * z[r];
  }
  dz[r] = dot;
  const int a0 = 3 * (1 + 2 * F0), a1 = 3 * (1 + 2 * F1);
  for (int c = 0; c < e; ++c) out[6 + c] = g0[a0 + c] + g1[a1 + c];
}

// out[q * C + c] = sum over the S rows of ray q of in[row * ldi + c]. A
// thread per (ray, column).
__global__ void ray_sum_f32(const float* in, long long ldi, int C,
                            int samples, float* out, long long rays) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rays * C) return;
  const long long q = i / C;
  const int c = (int)(i % C);
  float s = 0.f;
  for (int k = 0; k < samples; ++k) s += in[(q * samples + k) * ldi + c];
  out[i] = s;
}

// Where a step reads a sample's point and embedding: raw rows x (row r at
// x + r * ldx: [point | embedding]) or, with z, the rays' (o + z d of ray
// r / S, the embedding of that ray, e columns).
struct RowIn {
  const float* x;
  long long ldx;
  const float* z;
  const float* o;
  const float* d;
  const float* emb;
  int e;
  int samples;
};

__device__ __forceinline__ void row_point(const RowIn& in, long long r,
                                          float* p) {
  if (in.z == nullptr) {
    for (int c = 0; c < 3; ++c) p[c] = in.x[r * in.ldx + c];
    return;
  }
  const long long q = r / in.samples;
  for (int c = 0; c < 3; ++c)
    p[c] = __fadd_rn(in.o[q * 3 + c], __fmul_rn(in.z[r], in.d[q * 3 + c]));
}

__device__ __forceinline__ float row_embed(const RowIn& in, long long r,
                                           int c) {
  return in.z == nullptr ? in.x[r * in.ldx + 3 + c]
                         : in.emb[(r / in.samples) * in.e + c];
}

// The trunk's encoding cotangent g (kSe3EncP columns at stride 1) of one
// row times the window row (scales, or null), at feature f.
__device__ __forceinline__ float trunk_g(const float* g, const float* scales,
                                         int f) {
  return scales != nullptr ? g[f] * scales[f] : g[f];
}

// The VJP of the trunk's encoding for channel c of the point x: sum over
// the degrees k of 2^k (cos(x 2^k) g_sin - sin(x 2^k) g_cos), g the
// encoding's cotangent times the window row.
__device__ __forceinline__ float trunk_vjp(float x, const float* g,
                                           const float* scales, int c) {
  float acc = 0.f;
  for (int k = 0; k < kSe3F; ++k) {
    const float arg = ldexpf(x, kSe3MinDeg + k);
    const int fs = 3 * k + c;
    acc += ldexpf(1.f, kSe3MinDeg + k) *
           (cosf(arg) * trunk_g(g, scales, fs) -
            sinf(arg) * trunk_g(g, scales, kSe3Trig + fs));
  }
  return acc;
}

// out[r * ldo + f], f < kSe3EncP: the trunk's encoding of row r (f32_level.cu
// encode_trunk: [sin | cos of the point's bands | embedding | 0] times
// the window row). A thread per element.
__global__ void trunk_encode_f32(const RowIn in, const float* scales,
                                 float* out, long long ldo, long long M) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * kSe3EncP) return;
  const long long r = i / kSe3EncP;
  const int f = (int)(i % kSe3EncP);
  float v = 0.f;
  if (f < 2 * kSe3Trig) {
    const int b = f % kSe3Trig;
    float p[3];
    row_point(in, r, p);
    const float arg = ldexpf(p[b % 3], kSe3MinDeg + b / 3);
    v = f < kSe3Trig ? sinf(arg) : cosf(arg);
  } else if (f < 2 * kSe3Trig + in.e) {
    v = row_embed(in, r, f - 2 * kSe3Trig);
  }
  out[r * ldo + f] = scales != nullptr ? v * scales[f] : v;
}

// The trunk alone's dx[r * lddx + ...] = [the encoding's VJP for the point
// | the embedding's columns of the cotangent] from the encoding's cotangent
// g (row r at g + r * ldg) times the window row; x the raw rows. A thread
// per row.
__global__ void trunk_posenc_bwd_f32(const float* x, long long ldx,
                                     const float* scales, const float* g,
                                     long long ldg, float* dx, long long lddx,
                                     long long M) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= M) return;
  const float* gr = g + r * ldg;
  float* out = dx + r * lddx;
  for (int c = 0; c < 3; ++c) out[c] = trunk_vjp(x[r * ldx + c], gr, scales, c);
  for (int c = 0; c < kEmbed; ++c)
    out[3 + c] = trunk_g(gr, scales, 2 * kSe3Trig + c);
}

// Kernel B's retraction VJP of row r (ray r / S): from the heads' outputs
// (wv + r * ldwv: [w | 0 .. | v at kVCol ..]) and the cotangent of the
// warped point (dxt[0:3]), the heads' cotangent gwv[0:8] = [d w | d v |
// 0 0] and the point's direct term dp[0:3] = R^T g (SE(3), or quat the
// quaternion warp). A thread per row.
constexpr int kVCol = 8;  // the v head's first column in a row of wv
__global__ void retract_bwd_f32(int quat, const float* z, const float* o,
                                const float* d, int samples, const float* wv,
                                long long ldwv, const float* dxt,
                                long long ldxt, float* gwv, long long ldg,
                                float* dp, long long lddp, long long M) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= M) return;
  const long long q = r / samples;
  float p[3], w[3], v[3], g[3], dw[3], dv[3], dpp[3];
  for (int c = 0; c < 3; ++c) {
    p[c] = __fadd_rn(o[q * 3 + c], __fmul_rn(z[r], d[q * 3 + c]));
    w[c] = wv[r * ldwv + c];
    v[c] = wv[r * ldwv + kVCol + c];
    g[c] = dxt[r * ldxt + c];
  }
  if (quat)
    retract_bwd<true>(w, v, p, g, dw, dv, dpp);
  else
    retract_bwd<false>(w, v, p, g, dw, dv, dpp);
  float* gr = gwv + r * ldg;
  for (int c = 0; c < 3; ++c) {
    gr[c] = dw[c];
    gr[3 + c] = dv[c];
    dp[r * lddp + c] = dpp[c];
  }
  gr[6] = gr[7] = 0.f;
}

// Kernel B's per-sample cotangents of row r (ray r / S) with the screw
// warps: d p = (the retraction's direct term dpd[0:3] + the VJP of the
// trunk's encoding, cotangent gt times the window row) + the VJP of the
// sheet's posenc_orig (F1 bands, cotangent gs), d embed = the sum of
// their embedding columns; d z[r] = d p . d, and rows[r * (6 + e) + ...]
// = [d p | z d p | d embed], which hn_f32_ray_sum adds per ray. dpd may
// be rows itself (each thread reads its row's direct term first). A thread
// per row.
__global__ void screw_rows_f32(const float* z, const float* o,
                               const float* d, int samples, const float* dpd,
                               long long lddpd, const float* gt,
                               long long ldgt, const float* scales,
                               const float* gs, long long ldgs, int F1,
                               int e, float* dz, float* rows, long long M) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= M) return;
  const long long q = r / samples;
  const float* g0 = gt + r * ldgt;
  const float* g1 = gs + r * ldgs;
  float direct[3];
  for (int c = 0; c < 3; ++c) direct[c] = dpd[r * lddpd + c];
  float* out = rows + r * (6 + e);
  float dot = 0.f;
  for (int c = 0; c < 3; ++c) {
    const float p = __fadd_rn(o[q * 3 + c], __fmul_rn(z[r], d[q * 3 + c]));
    const float dp = (direct[c] + trunk_vjp(p, g0, scales, c)) +
                     posenc_vjp(p, g1, 3, F1, c);
    dot += dp * d[q * 3 + c];
    out[c] = dp;
    out[3 + c] = dp * z[r];
  }
  dz[r] = dot;
  const int a1 = 3 * (1 + 2 * F1);
  for (int c = 0; c < e; ++c)
    out[6 + c] = trunk_g(g0, scales, 2 * kSe3Trig + c) + g1[a1 + c];
}

// Kernel B's per-sample cotangents of row r (ray r / S) in a plane table
// (no sheet: the hyper coordinates are the ray's embedding): d p = the
// warp's direct term + the VJP of its encoding (cotangent g) — the
// translation warp's (screw 0): dxt[0:3] and the posenc_orig VJP (F0
// bands); the trunk's (screw 1): the retraction's dpd[0:3] and the trunk
// encoding's VJP, g times the window row —; d embed = the encoding's
// embedding columns of g (times the window row) + d hyper, dxt[3:3 + e];
// d z[r] = d p . d, and rows[r * (6 + e) + ...] = [d p | z d p | d embed],
// which hn_f32_ray_sum adds per ray. dpd may be rows itself (each thread
// reads its row's direct term first). A thread per row.
__global__ void plane_rows_f32(int screw, const float* z, const float* o,
                               const float* d, int samples, const float* dxt,
                               long long ldx, const float* dpd,
                               long long lddpd, const float* g,
                               long long ldg, int F0, const float* scales,
                               int e, float* dz, float* rows, long long M) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= M) return;
  const long long q = r / samples;
  const float* g0 = g + r * ldg;
  const float* dh = dxt + r * ldx + 3;
  float direct[3];
  for (int c = 0; c < 3; ++c)
    direct[c] = screw ? dpd[r * lddpd + c] : dxt[r * ldx + c];
  float* out = rows + r * (6 + e);
  float dot = 0.f;
  for (int c = 0; c < 3; ++c) {
    const float p = __fadd_rn(o[q * 3 + c], __fmul_rn(z[r], d[q * 3 + c]));
    const float dp = direct[c] + (screw ? trunk_vjp(p, g0, scales, c)
                                        : posenc_vjp(p, g0, 3, F0, c));
    dot += dp * d[q * 3 + c];
    out[c] = dp;
    out[3 + c] = dp * z[r];
  }
  dz[r] = dot;
  const int a0 = screw ? 2 * kSe3Trig : 3 * (1 + 2 * F0);
  for (int c = 0; c < e; ++c)
    out[6 + c] = (screw ? trunk_g(g0, scales, a0 + c) : g0[a0 + c]) + dh[c];
}

constexpr int kFlat = 256;  // threads a block of the elementwise steps

unsigned flat_blocks(long long n) {
  return (unsigned)((n + kFlat - 1) / kFlat);
}

}  // namespace steps
}  // namespace

using namespace steps;

// The C entry points: pointers and leading dimensions in floats; each
// returns a CUDA error code (1: arguments out of range).

// w: the layer's weight for g W, its transpose for x W^T: B(k, n) =
// w[k * ldw + n]; N, w, out, mask and bias 16-byte aligned with leading
// dimensions a multiple of 4 floats (float4 loads and stores); mrows the
// mask's rows (row r of out reads mask row r % mrows).
extern "C" int hn_f32_rowprod(const float* a0, long long ld0, int k0,
                              const float* a1, long long ld1, int K,
                              const float* w, long long ldw, int N,
                              const float* bias, int relu, const float* mask,
                              long long ldm, long long mrows, float* out,
                              long long ldo, int accumulate, long long M,
                              cudaStream_t stream) {
  if (K <= 0 || N <= 0 || k0 < 0 || k0 > K || N % 4 || ldw % 4 ||
      ldo % 4 || !aligned16(w) || !aligned16(out) ||
      (mask != nullptr && (ldm % 4 || !aligned16(mask) || mrows <= 0)) ||
      (bias != nullptr && !aligned16(bias)))
    return 1;
  if (M == 0) return 0;
  const RowprodArgs p{{a0, ld0, k0, a1, ld1}, K, w, ldw, N, bias,
                      relu, mask, ldm, mrows, out, ldo, accumulate, M};
  const dim3 grid((unsigned)((M + T::kRows - 1) / T::kRows),
                  (unsigned)((N + T::kCols - 1) / T::kCols));
  rowprod_f32<<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// db_rows: db sums G's rows r < db_rows (M: every row).
extern "C" int hn_f32_dw(const float* g, long long ldg, int N,
                         const float* h0, long long ld0, int k0,
                         const float* h1, long long ld1, int K, float* slab,
                         long long lds, long long w_off, int ldc,
                         long long b_off, long long db_rows, long long M,
                         int splits, cudaStream_t stream) {
  // H is read as float4: its segments 16-byte aligned, widths % 4 == 0.
  if (K <= 0 || N <= 0 || k0 < 0 || k0 > K || splits <= 0 || ldc < K ||
      K % 4 || k0 % 4 || ld0 % 4 || !aligned16(h0) ||
      (k0 < K && (ld1 % 4 || !aligned16(h1))))
    return 1;
  const DwArgs p{g, ldg, N, {h0, ld0, k0, h1, ld1}, K, slab, lds, w_off,
                 ldc, b_off, db_rows, M, splits};
  const dim3 grid((unsigned)((N + T::kRows - 1) / T::kRows),
                  (unsigned)((ldc + T::kCols - 1) / T::kCols),
                  (unsigned)splits);
  dw_f32<<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

extern "C" int hn_f32_reduce(const float* slab, int splits, long long lds,
                             long long n, float* grads,
                             cudaStream_t stream) {
  if (n > lds || splits <= 0) return 1;
  if (n == 0) return 0;
  reduce_f32<<<flat_blocks(n), kFlat, 0, stream>>>(slab, splits, lds, n,
                                                    grads);
  return cudaGetLastError();
}

extern "C" int hn_f32_field_encode(const float* z, const float* o,
                                   const float* d, const float* emb, int e,
                                   int samples, int F, float* out,
                                   long long ldo, int pad, long long M,
                                   cudaStream_t stream) {
  if (samples <= 0 || pad < 3 * (1 + 2 * F) + e) return 1;
  if (M == 0) return 0;
  field_encode_f32<<<flat_blocks(M * pad), kFlat, 0, stream>>>(
      z, o, d, emb, e, samples, F, out, ldo, pad, M);
  return cudaGetLastError();
}

// id1: whether the second segment has identity columns (posenc_orig) or
// not (the Nerfies posenc); scales: the window row (pad fp32) or null.
extern "C" int hn_f32_tmpl_encode(const float* raw, long long ldr, int F0,
                                  int ch1, int F1, float* out, long long ldo,
                                  int pad, long long M, int id1,
                                  const float* scales, cudaStream_t stream) {
  if (pad < 3 * (1 + 2 * F0) + ch1 * ((id1 ? 1 : 0) + 2 * F1) ||
      ldr < 3 + ch1)
    return 1;
  if (M == 0) return 0;
  tmpl_encode_f32<<<flat_blocks(M * pad), kFlat, 0, stream>>>(
      raw, ldr, F0, ch1, F1, out, ldo, pad, M, id1, scales);
  return cudaGetLastError();
}

extern "C" int hn_f32_cond_rows(const float* cond, int C, int samples,
                                float* out, long long ldo, int pad,
                                long long M, cudaStream_t stream) {
  if (samples <= 0 || C > pad) return 1;
  if (M == 0) return 0;
  cond_rows_f32<<<flat_blocks(M * pad), kFlat, 0, stream>>>(
      cond, C, samples, out, ldo, pad, M);
  return cudaGetLastError();
}

// id1, scales: as hn_f32_tmpl_encode took them.
extern "C" int hn_f32_tmpl_posenc_bwd(const float* raw, long long ldr,
                                      int F0, int ch1, int F1, const float* g,
                                      long long ldg, float* dx, long long ldx,
                                      long long M, int id1,
                                      const float* scales,
                                      cudaStream_t stream) {
  if (ldx < 3 + ch1 || ldr < 3 + ch1) return 1;
  if (M == 0) return 0;
  tmpl_posenc_bwd_f32<<<flat_blocks(M), kFlat, 0, stream>>>(
      raw, ldr, F0, ch1, F1, g, ldg, dx, ldx, M, id1, scales);
  return cudaGetLastError();
}

// g: the raw sigma's cotangent, row r at g[r * ldg] (rays x samples rows);
// alpha (rays, ca) fp32 and alpha_w (ca) fp32, ca <= 8; d_alpha (rays, ca)
// fp32; slab (splits, lds), lds >= ca: each ray range's part of the
// condition columns' dW, for hn_f32_reduce.
extern "C" int hn_f32_alpha_cond_bwd(const float* g, long long ldg,
                                     const float* alpha, const float* alpha_w,
                                     int ca, int samples, float* d_alpha,
                                     float* slab, long long lds,
                                     long long rays, int splits,
                                     cudaStream_t stream) {
  if (ca <= 0 || ca > kMaxAlpha || samples <= 0 || splits <= 0 || lds < ca)
    return 1;
  alpha_cond_bwd_f32<<<(unsigned)splits, kThreads, 0, stream>>>(
      g, ldg, alpha, alpha_w, ca, samples, d_alpha, slab, lds, rays, splits);
  return cudaGetLastError();
}

extern "C" int hn_f32_fields_rows(const float* z, const float* o,
                                  const float* d, int samples,
                                  const float* dxt, long long ldx,
                                  const float* gw, long long ldw, int F0,
                                  const float* gs, long long ldgs, int F1,
                                  int e, float* dz, float* rows, long long M,
                                  cudaStream_t stream) {
  if (samples <= 0 || ldx < 3) return 1;
  if (M == 0) return 0;
  fields_rows_f32<<<flat_blocks(M), kFlat, 0, stream>>>(
      z, o, d, samples, dxt, ldx, gw, ldw, F0, gs, ldgs, F1, e, dz, rows, M);
  return cudaGetLastError();
}

extern "C" int hn_f32_ray_sum(const float* in, long long ldi, int C,
                              int samples, float* out, long long rays,
                              cudaStream_t stream) {
  if (samples <= 0 || C < 0) return 1;
  if (rays * C == 0) return 0;
  ray_sum_f32<<<flat_blocks(rays * C), kFlat, 0, stream>>>(in, ldi, C,
                                                           samples, out,
                                                           rays);
  return cudaGetLastError();
}

// The trunk's encoding (kSe3EncP columns, times the window row scales or
// null) of M rows into out (row r at out + r * ldo): of raw rows x (row r
// at x + r * ldx, [point | embedding]) where z is null, else of the rays'
// points o + z d and embeddings emb (e columns) of ray r / samples.
extern "C" int hn_f32_trunk_encode(const float* x, long long ldx,
                                   const float* z, const float* o,
                                   const float* d, const float* emb, int e,
                                   int samples, const float* scales,
                                   float* out, long long ldo, long long M,
                                   cudaStream_t stream) {
  if (e < 0 || 2 * kSe3Trig + e > kSe3EncP || ldo < kSe3EncP ||
      (z == nullptr ? ldx < 3 + e : samples <= 0))
    return 1;
  if (M == 0) return 0;
  const RowIn in{x, ldx, z, o, d, emb, e, samples};
  trunk_encode_f32<<<flat_blocks(M * kSe3EncP), kFlat, 0, stream>>>(
      in, scales, out, ldo, M);
  return cudaGetLastError();
}

// The trunk alone's dx (M, >= 3 + kEmbed at lddx) from x (its raw rows)
// and the encoding's cotangent g.
extern "C" int hn_f32_trunk_posenc_bwd(const float* x, long long ldx,
                                       const float* scales, const float* g,
                                       long long ldg, float* dx,
                                       long long lddx, long long M,
                                       cudaStream_t stream) {
  if (ldx < 3 + kEmbed || lddx < 3 + kEmbed || ldg < kSe3EncP) return 1;
  if (M == 0) return 0;
  trunk_posenc_bwd_f32<<<flat_blocks(M), kFlat, 0, stream>>>(
      x, ldx, scales, g, ldg, dx, lddx, M);
  return cudaGetLastError();
}

// quat 0: the SE(3) retraction's VJP, 1: the quaternion warp's; wv (M, >=
// kVCol + 3 at ldwv) [w | .. | v ..]; dxt (M, >= 3 at ldxt); gwv (M, >= 8
// at ldg); dp (M, >= 3 at lddp).
extern "C" int hn_f32_retract_bwd(int quat, const float* z, const float* o,
                                  const float* d, int samples,
                                  const float* wv, long long ldwv,
                                  const float* dxt, long long ldxt,
                                  float* gwv, long long ldg, float* dp,
                                  long long lddp, long long M,
                                  cudaStream_t stream) {
  if ((quat != 0 && quat != 1) || samples <= 0 || ldwv < kVCol + 3 ||
      ldxt < 3 || ldg < 8 || lddp < 3)
    return 1;
  if (M == 0) return 0;
  retract_bwd_f32<<<flat_blocks(M), kFlat, 0, stream>>>(
      quat, z, o, d, samples, wv, ldwv, dxt, ldxt, gwv, ldg, dp, lddp, M);
  return cudaGetLastError();
}

extern "C" int hn_f32_screw_rows(const float* z, const float* o,
                                 const float* d, int samples,
                                 const float* dpd, long long lddpd,
                                 const float* gt, long long ldgt,
                                 const float* scales, const float* gs,
                                 long long ldgs, int F1, int e, float* dz,
                                 float* rows, long long M,
                                 cudaStream_t stream) {
  if (samples <= 0 || lddpd < 3 || ldgt < kSe3EncP || e < 0 ||
      2 * kSe3Trig + e > kSe3EncP)
    return 1;
  if (M == 0) return 0;
  screw_rows_f32<<<flat_blocks(M), kFlat, 0, stream>>>(
      z, o, d, samples, dpd, lddpd, gt, ldgt, scales, gs, ldgs, F1, e, dz,
      rows, M);
  return cudaGetLastError();
}

// screw 0: the translation warp (g its encoding's cotangent, F0 bands;
// no window row, no dpd); 1: the SE(3) / quaternion trunk (g at least
// kSe3EncP columns, scales its window row or null, dpd (M, >= 3 at lddpd)
// the retraction's direct term); dxt (M, >= 3 + e at ldx) [d warped | d
// hyper | ..]; rows (M, 6 + e).
extern "C" int hn_f32_plane_rows(int screw, const float* z, const float* o,
                                 const float* d, int samples,
                                 const float* dxt, long long ldx,
                                 const float* dpd, long long lddpd,
                                 const float* g, long long ldg, int F0,
                                 const float* scales, int e, float* dz,
                                 float* rows, long long M,
                                 cudaStream_t stream) {
  if ((screw != 0 && screw != 1) || samples <= 0 || e < 0 || ldx < 3 + e ||
      (screw ? dpd == nullptr || lddpd < 3 || ldg < kSe3EncP ||
                   2 * kSe3Trig + e > kSe3EncP
             : scales != nullptr || ldg < 3 * (1 + 2 * F0) + e))
    return 1;
  if (M == 0) return 0;
  plane_rows_f32<<<flat_blocks(M), kFlat, 0, stream>>>(
      screw, z, o, d, samples, dxt, ldx, dpd, lddpd, g, ldg, F0, scales, e,
      dz, rows, M);
  return cudaGetLastError();
}
