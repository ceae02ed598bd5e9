// Kernel A's narrow steps for Hopper (sm_90a): the encoding written into
// the stash, the rgb condition's per-ray term, the two heads' backward, the
// rgb and the alpha condition's cotangents summed per ray, the posenc VJP
// and the fixed-order sum of the dW / db slabs.
//
// Part of the template backward (kernel A), which replaces
// hypernerf_tpu/ops/pallas/fused_mlp.py `_bwd_call` (:736). The wide layers
// run as `wgmma` products (template_rowprod.cu, template_dw.cu); what is
// left here is under 1 % of the operations, a thread per element or, in the
// per-split steps, per column and row group, and bound by its bytes. The host side that orders the steps and
// owns the stash is kernels/fused_mlp.py `fused_template_bwd`.
//
// Rounding points are the TPU kernel's: a head's cotangent is rounded to
// bf16 for its products and its db sums the fp32 one; the bottleneck's two
// cotangents (rgb branch, alpha head) are summed in fp32, which is its db,
// then rounded; the encoding's two cotangents (layer 0, the skip) are
// summed in fp32 in the posenc VJP, which uses fp32 sin / cos of the same
// arguments as the recompute. The per-ray sums of d rgb_cond are written
// by one thread each (a chunk holds whole rays), so they are deterministic.
// The four template layouts (level_common.cuh TmplLayout) run here: the
// encoding's two steps take the layout from the raw rows' width, the window
// row and their buffers' widths: raw rows of 8 columns are OrigEnc's, or
// NerfEnc's where a window row is given (the stash holds the windowed
// features, and the VJP weights the fp32 cotangent by the row first, as the
// TPU kernel's `_encode_bwd`: a band of weight 0 passes no gradient, an
// identity column weighs 1); raw rows of 16 columns are PlaneEnc's, whose
// buffers' widths are its own (a stash of kPlaneStashLd columns, 192 of
// them the encoding's; the encoding's cotangent buffer of 2 x 256 columns),
// or NerfPlaneEnc's where a window row is given (NerfEnc's buffers); the rgb
// condition's two steps are compiled for each width a layout covers
// (kCondWidths: the view directions' encoding of either layout, with the
// nerf embedding after it, the embedding alone, none) and the steps that
// read the stash for both of its widths, and take the one they are given.
// The alpha condition (the kEmbed-column embedding, `alpha_cond_ch`,
// fused_mlp.py:481-485, 599-604) is the alpha head's input after the
// bottleneck: its share of the bottleneck's cotangent is unchanged, and its
// own step sums bf16(g_sigma) over a ray's rows once, which gives the ray's
// d alpha_cond (times the head's condition weights) and its part of the
// condition columns' dW (times the condition), written after the layers'
// [dW | db] in the slab.

#include "level_common.cuh"

namespace {

// The stash's and the cotangent buffers' leading dimensions and the
// condition's first column in rgb layer 0 are compiled in: with them passed
// at run time the condition's step took 3.2x as long on an H100 (its
// sample loop is latency-bound). The host owns the layout and passes it to
// every entry point, which refuses any other, so a change on the host side
// fails with cudaErrorInvalidValue instead of misindexing.
constexpr int kStashLd = 3072;  // bf16 columns of a stash row
constexpr int kGLd = 256;       // bf16 columns of a cotangent buffer row
// Layout L's stash: its encoding, the trunk's eight hidden outputs, its
// logit, the bottleneck and the rgb branch's four, one row per sample; and
// the columns of each of the encoding's two cotangents (layer 0's, the
// skip's) in their buffer, the encoding's rounded up to 128.
template <class L>
__host__ __device__ constexpr int stash_ld() {
  return L::kEncP + 9 * kTrunkW + kBneck + 4 * kRgbW;
}
template <class L>
__host__ __device__ constexpr int enc_half() {
  return (L::kEncP + 127) / 128 * 128;
}
constexpr int kPlaneStashLd = stash_ld<PlaneEnc>();  // 3136
static_assert(stash_ld<OrigEnc>() == kStashLd &&
                  stash_ld<NerfEnc>() == kStashLd &&
                  stash_ld<NerfPlaneEnc>() == kStashLd &&
                  2 * enc_half<OrigEnc>() == kGLd &&
                  2 * enc_half<NerfPlaneEnc>() == kGLd,
              "the 128-column layouts share the stash and the buffers");
constexpr int kCondCol = 128;   // first condition column of rgb layer 0
constexpr int kRowGroups = 8;   // threadIdx.y of the per-split kernels
constexpr int kRayGroups = 4;   // of the condition's (more registers)
constexpr int kAlphaThreads = 128;  // rays a block of the alpha condition's
                                    // step takes at a time
// The rgb condition widths the condition's steps are compiled for: each
// layout's view-direction encoding (39 posenc_orig, 27 Nerfies), with the
// nerf embedding after it (47, 35), the embedding alone (8) and none (0).
constexpr int kCondWidths[] = {kCond,          kNerfCond, kCond + kEmbed,
                               kNerfCond + kEmbed, kEmbed, 0};
static_assert(kCond + kEmbed <= kCondP, "every width fits the slots");

// Sum of v over the block's row groups (threadIdx.y), in their order, for
// column threadIdx.x; valid on threadIdx.y == 0. red: [blockDim.y][128].
__device__ __forceinline__ float sum_groups(float* red, float v) {
  __syncthreads();
  red[threadIdx.y * 128 + threadIdx.x] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.y == 0)
    for (int y = 0; y < blockDim.y; ++y) s += red[y * 128 + threadIdx.x];
  return s;
}

// Rows [r0, r1) of split z of n.
__device__ __forceinline__ void split_range(long long n, long long& r0,
                                            long long& r1) {
  r0 = n * blockIdx.x / gridDim.x;
  r1 = n * (blockIdx.x + 1) / gridDim.x;
}

// Layout L's encoding of raw rows of L::kRaw columns into the stash.
// scales: null, or the Nerfies layout's window row.
template <class L>
__global__ void tmpl_encode_kernel(const float* __restrict__ raw_t,
                                   const float* __restrict__ scales,
                                   bf16* __restrict__ stash, int enc_col,
                                   long long n_rows) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_rows * L::kEncP) return;
  const long long r = e / L::kEncP;
  const int f = (int)(e % L::kEncP);
  const float v = tmpl_feature<L>(raw_t + r * L::kRaw, f);
  stash[r * stash_ld<L>() + enc_col + f] = window_feature(v, f, scales);
}

// out[ray][n] = sum_c cond[ray][c] W[n][128 + c]: the condition's part of
// rgb layer 0, added per ray in the recompute's epilogue.
template <int kCondW>
__global__ void tmpl_ray_bias_kernel(const bf16* __restrict__ cond,
                                const bf16* __restrict__ w,
                                float* __restrict__ out, long long n_rays,
                                int w_ld) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_rays * kRgbW) return;
  const long long ray = e / kRgbW;
  const int n = (int)(e % kRgbW);
  float s = 0.f;
  for (int c = 0; c < kCondW; ++c)
    s += __bfloat162float(cond[ray * kCondW + c]) *
         __bfloat162float(w[n * w_ld + kCondCol + c]);
  out[e] = s;
}

// rgb logit (3 -> 8 padded, input r3): G[r][k] = bf16(mask(r3 > 0)
// sum_n bf16(g[r][n]) W[n][k]); dW[n][k] = sum_r bf16(g[r][n]) r3[r][k];
// db[n] = sum_r g[r][n]. One block per split, thread (k, y): column k of
// every kRowGroups-th row from y. kLd: the stash's leading dimension.
template <int kLd>
__global__ void __launch_bounds__(128 * kRowGroups)
    tmpl_rgb_head_kernel(const float* __restrict__ g4,
                                const bf16* __restrict__ stash, int r3_col,
                                const bf16* __restrict__ w,
                                bf16* __restrict__ gout,
                                float* __restrict__ slab, long long slab_len,
                                long long w_off, long long b_off,
                                long long n_rows) {
  __shared__ float red[kRowGroups * 128];
  const int k = threadIdx.x;
  float wk[3], dw[3] = {0.f, 0.f, 0.f}, db = 0.f;
  for (int n = 0; n < 3; ++n) wk[n] = __bfloat162float(w[n * kRgbW + k]);
  long long r0, r1;
  split_range(n_rows, r0, r1);
  for (long long r = r0 + threadIdx.y; r < r1; r += kRowGroups) {
    const float4 g = reinterpret_cast<const float4*>(g4)[r];
    const float gb[3] = {round_bf(g.x), round_bf(g.y), round_bf(g.z)};
    const float h = __bfloat162float(stash[r * kLd + r3_col + k]);
    float v = 0.f;
    for (int n = 0; n < 3; ++n) {
      v += gb[n] * wk[n];
      dw[n] += gb[n] * h;
    }
    gout[r * kGLd + k] = __float2bfloat16_rn(h > 0.f ? v : 0.f);
    if (k < 3) db += k == 0 ? g.x : (k == 1 ? g.y : g.z);
  }
  float* s = slab + blockIdx.x * slab_len;
  for (int n = 0; n < 3; ++n) dw[n] = sum_groups(red, dw[n]);
  db = sum_groups(red, db);
  if (threadIdx.y != 0) return;
  for (int n = 0; n < 8; ++n) s[w_off + n * kRgbW + k] = n < 3 ? dw[n] : 0.f;
  if (k < 8) s[b_off + k] = k < 3 ? db : 0.f;
}

// rgb layer 0's condition columns, per ray: d_cond[ray][c] = sum over the
// ray's rows of gin[r][128 + c] (bf16 values, fp32 sum); dW[n][128 + c] =
// sum_ray (sum over the ray's rows of gout[r][n]) cond[ray][c]. One block per
// split of the rays, thread (n, y): output feature n of every kRayGroups-th
// ray from y. kCondW condition columns; dW's pad columns up to kCondP are 0.
template <int kCondW>
__global__ void __launch_bounds__(128 * kRayGroups)
    tmpl_cond_bwd_kernel(const bf16* __restrict__ gout,
                                const bf16* __restrict__ gin,
                                const bf16* __restrict__ cond,
                                float* __restrict__ d_cond,
                                float* __restrict__ slab, long long slab_len,
                                long long w_off, int k_pad, long long n_rays,
                                int samples) {
  __shared__ float red[kRowGroups * 128];
  const int n = threadIdx.x;
  float acc[kCondP];
#pragma unroll
  for (int c = 0; c < kCondP; ++c) acc[c] = 0.f;
  long long q0, q1;
  split_range(n_rays, q0, q1);
  for (long long ray = q0 + threadIdx.y; ray < q1; ray += kRayGroups) {
    float gs = 0.f, dc = 0.f;
    for (int s = 0; s < samples; ++s) {
      const long long r = ray * samples + s;
      gs += __bfloat162float(gout[r * kGLd + n]);
      if (n < kCondW) dc += __bfloat162float(gin[r * kGLd + kCondCol + n]);
    }
    if (n < kCondW) d_cond[ray * kCondW + n] = dc;
#pragma unroll
    for (int c = 0; c < kCondW; ++c)
      acc[c] += gs * __bfloat162float(cond[ray * kCondW + c]);
  }
  float* s = slab + blockIdx.x * slab_len + w_off + (long long)n * k_pad +
             kCondCol;
#pragma unroll
  for (int c = 0; c < kCondP; ++c) {
    const float v = sum_groups(red, acc[c]);
    if (threadIdx.y == 0) s[c] = v;
  }
}

// The alpha head's condition columns (kEmbed, after the bottleneck), per
// ray: gs = sum over the ray's rows of bf16(g_sigma) in fp32; d_alpha[ray][c]
// = gs alpha_w[c]; the columns' dW, dW_alpha[0][128 + c] = sum over the
// split's rays of gs alpha[ray][c], to slab[tail_off + c]. One block per
// split of the rays, a thread per ray, kAlphaThreads at a time; the block
// sums its threads' dW in their order.
__global__ void __launch_bounds__(kAlphaThreads)
    tmpl_alpha_cond_bwd_kernel(const float* __restrict__ g4,
                               const bf16* __restrict__ alpha,
                               const bf16* __restrict__ w,
                               float* __restrict__ d_alpha,
                               float* __restrict__ slab, long long slab_len,
                               long long tail_off, long long n_rays,
                               int samples) {
  __shared__ float red[kEmbed][kAlphaThreads];
  float wk[kEmbed], acc[kEmbed];
#pragma unroll
  for (int c = 0; c < kEmbed; ++c) {
    wk[c] = __bfloat162float(w[c]);
    acc[c] = 0.f;
  }
  long long q0, q1;
  split_range(n_rays, q0, q1);
  for (long long ray = q0 + threadIdx.x; ray < q1; ray += kAlphaThreads) {
    float gs = 0.f;
    for (int s = 0; s < samples; ++s)
      gs += round_bf(g4[(ray * samples + s) * 4 + 3]);
#pragma unroll
    for (int c = 0; c < kEmbed; ++c) {
      d_alpha[ray * kEmbed + c] = gs * wk[c];
      acc[c] += gs * __bfloat162float(alpha[ray * kEmbed + c]);
    }
  }
#pragma unroll
  for (int c = 0; c < kEmbed; ++c) red[c][threadIdx.x] = acc[c];
  __syncthreads();
  if (threadIdx.x >= kEmbed) return;
  float v = 0.f;
  for (int t = 0; t < kAlphaThreads; ++t) v += red[threadIdx.x][t];
  slab[blockIdx.x * slab_len + tail_off + threadIdx.x] = v;
}

// The alpha head (1 -> 8 padded, input bneck) and the bottleneck's
// cotangent: g_b = gin[r][k] (the rgb branch's, bf16 values) + bf16(g_sigma)
// W_alpha[0][k] in fp32; gb[r][k] = bf16(g_b); db_bneck = sum g_b;
// dW_alpha[0][k] = sum bf16(g_sigma) bneck[r][k]; db_alpha = sum g_sigma.
// kLd: the stash's leading dimension.
template <int kLd>
__global__ void __launch_bounds__(128 * kRowGroups)
    tmpl_bneck_prep_kernel(const float* __restrict__ g4,
                                  const bf16* __restrict__ gin,
                                  const bf16* __restrict__ stash,
                                  int bneck_col, const bf16* __restrict__ w,
                                  bf16* __restrict__ gb,
                                  float* __restrict__ slab,
                                  long long slab_len, long long w_off,
                                  long long b_off, long long b9_off,
                                  long long n_rows) {
  __shared__ float red[kRowGroups * 128];
  const int k = threadIdx.x;
  const float wk = __bfloat162float(w[k]);
  float db9 = 0.f, dw = 0.f, db = 0.f;
  long long r0, r1;
  split_range(n_rows, r0, r1);
  for (long long r = r0 + threadIdx.y; r < r1; r += kRowGroups) {
    const float gs = g4[r * 4 + 3], gsb = round_bf(gs);
    const float v = __bfloat162float(gin[r * kGLd + k]) + gsb * wk;
    gb[r * kGLd + k] = __float2bfloat16_rn(v);
    db9 += v;
    dw += gsb * __bfloat162float(stash[r * kLd + bneck_col + k]);
    db += gs;
  }
  db9 = sum_groups(red, db9);
  dw = sum_groups(red, dw);
  db = sum_groups(red, db);
  if (threadIdx.y != 0) return;
  float* s = slab + blockIdx.x * slab_len;
  for (int n = 0; n < 8; ++n) s[w_off + n * kBneck + k] = n == 0 ? dw : 0.f;
  if (k < 8) s[b_off + k] = k == 0 ? db : 0.f;
  s[b9_off + k] = db9;
}

// dx_t[r][c] of layout L from the encoding's two cotangents e[r][0 : kEncP]
// (the skip's) and e[r][H : H + kEncP] (layer 0's), H = enc_half<L>(),
// summed in fp32 and, in the Nerfies layout, weighted by the window row.
template <class L>
__device__ __forceinline__ float posenc_vjp(const float* __restrict__ raw_t,
                                            const bf16* er,
                                            const float* __restrict__ scales,
                                            long long r, int c) {
  auto gx = [&](int f) {
    const float g = __bfloat162float(er[f]) +
                    __bfloat162float(er[enc_half<L>() + f]);
    return L::kNerfies ? g * scales[f] : g;
  };
  const bool xyz = c < 3;
  const int ch = xyz ? 3 : L::kHyp, nf = xyz ? kXyzF : L::kHypF;
  const int id = xyz ? 3 : L::kHypId;  // identity columns of the segment
  const int base = xyz ? 0 : kTmplXyz, cc = xyz ? c : c - 3;
  const float x = raw_t[r * L::kRaw + c];
  float dx = 0.f;
  for (int k = 0; k < nf; ++k) {
    const float scale = (float)(1 << k);
    float sn, cs;
    sincosf(x * scale, &sn, &cs);
    const float flat = cs * gx(base + id + k * ch + cc) -
                       sn * gx(base + id + nf * ch + k * ch + cc);
    dx += flat * scale;
  }
  return id ? gx(base + cc) + dx : dx;
}

// dx_t (n_rows, L::kRaw): columns 3 + L::kHyp on are zero.
template <class L>
__global__ void tmpl_posenc_bwd_kernel(const float* __restrict__ raw_t,
                                  const bf16* __restrict__ e,
                                  const float* __restrict__ scales,
                                  float* __restrict__ dx_t, long long n_rows) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows * L::kRaw) return;
  const long long r = i / L::kRaw;
  const int c = (int)(i % L::kRaw);
  const bf16* er = e + r * 2 * enc_half<L>();
  dx_t[i] = c < 3 + L::kHyp ? posenc_vjp<L>(raw_t, er, scales, r, c) : 0.f;
}

__global__ void tmpl_reduce_kernel(const float* __restrict__ slab, int splits,
                              long long len, float* __restrict__ grads) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += slab[z * len + i];
  grads[i] += s;
}

unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

namespace {

template <class L>
int launch_encode(const void* raw_t, void* stash, int enc_col,
                  long long n_rows, const void* scales, void* stream) {
  if (enc_col < 0 || enc_col + L::kEncP > stash_ld<L>())
    return (int)cudaErrorInvalidValue;
  tmpl_encode_kernel<L><<<blocks_for(n_rows * L::kEncP, 256), 256, 0,
                          (cudaStream_t)stream>>>(
      static_cast<const float*>(raw_t), static_cast<const float*>(scales),
      static_cast<bf16*>(stash), enc_col, n_rows);
  return (int)cudaGetLastError();
}

template <class L>
int launch_posenc_bwd(const void* raw_t, const void* e, void* dx_t,
                      long long n_rows, const void* scales, void* stream) {
  tmpl_posenc_bwd_kernel<L><<<blocks_for(n_rows * L::kRaw, 256), 256, 0,
                              (cudaStream_t)stream>>>(
      static_cast<const float*>(raw_t), static_cast<const bf16*>(e),
      static_cast<const float*>(scales), static_cast<float*>(dx_t), n_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// stash[r][enc_col : enc_col + kEncP] = bf16 encoding of raw_t[r] in the
// layout the raw rows' width raw_ld, the window row and the stash's width
// name: (P, 8) raw rows in posenc_orig where scales is null, else in the
// Nerfies layout times its window row scales (128 fp32), into a stash of
// kStashLd columns; (P, 16) raw rows in the plane layout, no window, into
// one of kPlaneStashLd columns, or in the Nerfies plane layout times its
// window row into one of kStashLd columns.
extern "C" int hn_tmpl_encode(const void* raw_t, long long raw_ld,
                              void* stash, long long stash_ld, int enc_col,
                              long long n_rows, const void* scales,
                              void* stream) {
  if (n_rows <= 0) return (int)cudaErrorInvalidValue;
  if (raw_ld == 16 && stash_ld == kPlaneStashLd && scales == nullptr)
    return launch_encode<PlaneEnc>(raw_t, stash, enc_col, n_rows, scales,
                                   stream);
  if (stash_ld != kStashLd) return (int)cudaErrorInvalidValue;
  if (raw_ld == 16 && scales)
    return launch_encode<NerfPlaneEnc>(raw_t, stash, enc_col, n_rows, scales,
                                       stream);
  if (raw_ld != 8) return (int)cudaErrorInvalidValue;
  if (scales)
    return launch_encode<NerfEnc>(raw_t, stash, enc_col, n_rows, scales,
                                  stream);
  return launch_encode<OrigEnc>(raw_t, stash, enc_col, n_rows, scales,
                                stream);
}

// The instantiation of each condition step for rgb condition width cond_ch,
// one of kCondWidths; null for any other width.
using RayBiasFn = decltype(&tmpl_ray_bias_kernel<0>);
using CondBwdFn = decltype(&tmpl_cond_bwd_kernel<0>);
RayBiasFn ray_bias_kernel(int cond_ch) {
  switch (cond_ch) {
    case kCondWidths[0]: return tmpl_ray_bias_kernel<kCondWidths[0]>;
    case kCondWidths[1]: return tmpl_ray_bias_kernel<kCondWidths[1]>;
    case kCondWidths[2]: return tmpl_ray_bias_kernel<kCondWidths[2]>;
    case kCondWidths[3]: return tmpl_ray_bias_kernel<kCondWidths[3]>;
    case kCondWidths[4]: return tmpl_ray_bias_kernel<kCondWidths[4]>;
    case kCondWidths[5]: return tmpl_ray_bias_kernel<kCondWidths[5]>;
  }
  return nullptr;
}
CondBwdFn cond_bwd_kernel(int cond_ch) {
  switch (cond_ch) {
    case kCondWidths[0]: return tmpl_cond_bwd_kernel<kCondWidths[0]>;
    case kCondWidths[1]: return tmpl_cond_bwd_kernel<kCondWidths[1]>;
    case kCondWidths[2]: return tmpl_cond_bwd_kernel<kCondWidths[2]>;
    case kCondWidths[3]: return tmpl_cond_bwd_kernel<kCondWidths[3]>;
    case kCondWidths[4]: return tmpl_cond_bwd_kernel<kCondWidths[4]>;
    case kCondWidths[5]: return tmpl_cond_bwd_kernel<kCondWidths[5]>;
  }
  return nullptr;
}

// out (n_rays, 128) fp32 = cond (n_rays, cond_ch) bf16 @ W[:, cond_col :
// cond_col + cond_ch]^T, W the (128, w_ld) bf16 weight of rgb layer 0;
// cond_ch is one of kCondWidths (0: out is zero).
extern "C" int hn_tmpl_ray_bias(const void* cond, const void* w, void* out,
                                long long n_rays, int w_ld, int cond_col,
                                int cond_ch, void* stream) {
  const RayBiasFn kernel = ray_bias_kernel(cond_ch);
  if (n_rays <= 0 || cond_col != kCondCol || cond_col + kCondP > w_ld ||
      kernel == nullptr)
    return (int)cudaErrorInvalidValue;
  kernel<<<blocks_for(n_rays * kRgbW, 256), 256, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(cond), static_cast<const bf16*>(w),
      static_cast<float*>(out), n_rays, w_ld);
  return (int)cudaGetLastError();
}

extern "C" int hn_tmpl_rgb_head(const void* g4, const void* stash,
                                long long stash_ld, int r3_col, const void* w,
                                void* gout, long long g_ld, void* slab,
                                long long slab_len, long long w_off,
                                long long b_off, long long n_rows, int splits,
                                void* stream) {
  if (n_rows <= 0 || splits <= 0 ||
      (stash_ld != kStashLd && stash_ld != kPlaneStashLd) || g_ld != kGLd ||
      r3_col < 0 || r3_col + kRgbW > stash_ld)
    return (int)cudaErrorInvalidValue;
  auto kernel = stash_ld == kStashLd ? tmpl_rgb_head_kernel<kStashLd>
                                     : tmpl_rgb_head_kernel<kPlaneStashLd>;
  kernel<<<splits, dim3(128, kRowGroups), 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(g4), static_cast<const bf16*>(stash), r3_col,
      static_cast<const bf16*>(w), static_cast<bf16*>(gout),
      static_cast<float*>(slab), slab_len, w_off, b_off, n_rows);
  return (int)cudaGetLastError();
}

// cond_ch: the condition's width, one of kCondWidths (d_cond is (n_rays,
// cond_ch)).
extern "C" int hn_tmpl_cond_bwd(const void* gout, long long gout_ld,
                                const void* gin, long long gin_ld,
                                int cond_col, const void* cond, void* d_cond,
                                void* slab, long long slab_len,
                                long long w_off, int k_pad, long long n_rays,
                                int samples, int splits, int cond_ch,
                                void* stream) {
  const CondBwdFn kernel = cond_bwd_kernel(cond_ch);
  if (n_rays <= 0 || samples <= 0 || splits <= 0 || gout_ld != kGLd ||
      gin_ld != kGLd || cond_col != kCondCol || cond_col + kCondP > k_pad ||
      kernel == nullptr)
    return (int)cudaErrorInvalidValue;
  kernel<<<splits, dim3(128, kRayGroups), 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(gout), static_cast<const bf16*>(gin),
      static_cast<const bf16*>(cond), static_cast<float*>(d_cond),
      static_cast<float*>(slab), slab_len, w_off, k_pad, n_rays, samples);
  return (int)cudaGetLastError();
}

// g4 (rows, 4) fp32, the chunk's cotangent (g_sigma in column 3), rows =
// n_rays x samples; alpha_cond (n_rays, alpha_ch) bf16; alpha_w (alpha_ch)
// bf16, the alpha head's condition columns; d_alpha (n_rays, alpha_ch) fp32;
// the columns' dW to slab[z][tail_off : tail_off + alpha_ch] of each split
// z. alpha_ch must be kEmbed.
extern "C" int hn_tmpl_alpha_cond_bwd(const void* g4, const void* alpha_cond,
                                      const void* alpha_w, void* d_alpha,
                                      void* slab, long long slab_len,
                                      long long tail_off, long long n_rays,
                                      int samples, int splits, int alpha_ch,
                                      void* stream) {
  if (n_rays <= 0 || samples <= 0 || splits <= 0 || alpha_ch != kEmbed ||
      tail_off < 0 || tail_off + kEmbed > slab_len)
    return (int)cudaErrorInvalidValue;
  tmpl_alpha_cond_bwd_kernel<<<splits, kAlphaThreads, 0,
                               (cudaStream_t)stream>>>(
      static_cast<const float*>(g4), static_cast<const bf16*>(alpha_cond),
      static_cast<const bf16*>(alpha_w), static_cast<float*>(d_alpha),
      static_cast<float*>(slab), slab_len, tail_off, n_rays, samples);
  return (int)cudaGetLastError();
}

extern "C" int hn_tmpl_bneck_prep(const void* g4, const void* gin,
                                  long long gin_ld, const void* stash,
                                  long long stash_ld, int bneck_col,
                                  const void* w, void* gb, long long gb_ld,
                                  void* slab, long long slab_len,
                                  long long w_off, long long b_off,
                                  long long b9_off, long long n_rows,
                                  int splits, void* stream) {
  if (n_rows <= 0 || splits <= 0 || gin_ld != kGLd || gb_ld != kGLd ||
      (stash_ld != kStashLd && stash_ld != kPlaneStashLd) || bneck_col < 0 ||
      bneck_col + kBneck > stash_ld)
    return (int)cudaErrorInvalidValue;
  auto kernel = stash_ld == kStashLd ? tmpl_bneck_prep_kernel<kStashLd>
                                     : tmpl_bneck_prep_kernel<kPlaneStashLd>;
  kernel<<<splits, dim3(128, kRowGroups), 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(g4), static_cast<const bf16*>(gin),
      static_cast<const bf16*>(stash), bneck_col, static_cast<const bf16*>(w),
      static_cast<bf16*>(gb), static_cast<float*>(slab), slab_len, w_off,
      b_off, b9_off, n_rows);
  return (int)cudaGetLastError();
}

// e: (n_rows, kGLd) bf16, the encoding's two cotangents in columns [0, 128)
// and [128, 256), with (P, raw_ld) raw rows and dx_t: raw_ld 8, scales null
// (posenc_orig) or the Nerfies layout's window row, as hn_tmpl_encode took
// it; raw_ld 16 and the window row, the Nerfies plane layout. The plane
// layout's: e (n_rows, 512), its two cotangents in columns [0, 192) and
// [256, 448), (P, 16) raw rows and dx_t, no window.
extern "C" int hn_tmpl_posenc_bwd(const void* raw_t, long long raw_ld,
                                  const void* e, long long e_ld, void* dx_t,
                                  long long n_rows, const void* scales,
                                  void* stream) {
  if (n_rows <= 0) return (int)cudaErrorInvalidValue;
  if (raw_ld == 16 && e_ld == 2 * enc_half<PlaneEnc>() && scales == nullptr)
    return launch_posenc_bwd<PlaneEnc>(raw_t, e, dx_t, n_rows, scales,
                                       stream);
  if (e_ld != kGLd) return (int)cudaErrorInvalidValue;
  if (raw_ld == 16 && scales)
    return launch_posenc_bwd<NerfPlaneEnc>(raw_t, e, dx_t, n_rows, scales,
                                           stream);
  if (raw_ld != 8) return (int)cudaErrorInvalidValue;
  if (scales)
    return launch_posenc_bwd<NerfEnc>(raw_t, e, dx_t, n_rows, scales,
                                      stream);
  return launch_posenc_bwd<OrigEnc>(raw_t, e, dx_t, n_rows, scales, stream);
}

// grads[i] += sum over z < splits of slab[z][i], in the order of z.
extern "C" int hn_tmpl_reduce(const void* slab, int splits, long long len,
                              void* grads, void* stream) {
  if (len <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  tmpl_reduce_kernel<<<blocks_for(len, 256), 256, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(slab), splits, len,
      static_cast<float*>(grads));
  return (int)cudaGetLastError();
}
