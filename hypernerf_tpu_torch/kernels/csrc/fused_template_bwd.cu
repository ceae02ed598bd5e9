// Template backward for Hopper (sm_90a): the first half of the level backward.
//
// Replaces hypernerf_tpu/ops/pallas/fused_mlp.py `_bwd_call` (:736, the tile
// body `_backward_tile_gen` :426-534), which is also the template half of the
// level backward's schedules (fused_level.py `_fused_bwd_split` :1435,
// `_fused_bwd_pipelined` :1260, `_fused_bwd` :1397), for the flagship spec.
//
// In:  raw_t (P, 8) fp32 [warped | hyper | 0] saved by the forward, the per-ray
//      rgb condition (R, 39) bf16, g (P, 4) fp32 = d[rgb logits | raw sigma],
//      the packed bf16 weights W (out, in), their transposes and the biases.
// Out: dx_t (P, 8) fp32 = d[warped | hyper | 0], d rgb_cond (R, 39) fp32 summed
//      per ray, and fp32 dW / db of the template's 16 layers in the packed
//      layout.
// Rounding points are the TPU kernel's: the cotangent is rounded to bf16
// before every product; ReLU masks come from the stored bf16 outputs; dW
// accumulates in fp32; db sums the fp32 cotangent at the three heads (rgb,
// alpha, bottleneck) and the bf16-rounded one at hidden layers; the skip and
// the bottleneck cotangents are summed in fp32; the posenc VJP uses fp32
// sin / cos of the same arguments as the recompute.
//
// Bound: per sample 696k MACs of recompute, as many for g W and as many for
// g^T h: 4.2 MFLOP, against 80 bytes read and written, so operations bound it
// (2.1 M samples: 8.8 TFLOP, 8.9 ms at the card's bf16 peak).
// Design (see level_bwd.cuh): a persistent grid, one block of 512 threads
// per SM; a tile of 32 rows keeps all 3296 bf16 columns of stored activations
// and cotangent (211 KB of the 227 KB a block may use); every block adds its
// dW straight into the one fp32 gradient buffer (2.8 MB, which stays in L2).
// What limits this version is the tile's height: every 32 rows read all
// 2.8 MB of W and W^T from L2 and add 2.8 MB of dW into it, four times the
// forward kernel's L2 traffic per sample. Taller tiles (activations in fewer
// bits, or two blocks of a cluster sharing one weight stream), or a layer at
// a time over stashed activations, is later work.

#include "level_bwd.cuh"

namespace {

constexpr int kL0 = kNumFieldLayers;  // first template layer (14)

// Column plan of the tile (bf16 columns).
constexpr int kColEnc = 5 * kTrunkW;            // 1280: right after h4
__host__ __device__ constexpr int trunk_col(int i) {  // h_i, i = 8 is hl
  return i < 5 ? i * kTrunkW : kColEnc + kTmplEncP + (i - 5) * kTrunkW;
}
constexpr int kColBn = trunk_col(8) + kTrunkW;  // 2432: [bneck | cond]
constexpr int kColCond = kColBn + kBneck;       // 2560
constexpr int kColRgb = kColCond + kCondP;      // 2608: r0..r3
constexpr int kColGr = kColRgb + 4 * kRgbW;     // 3120: rgb-phase cotangent
constexpr int kGrW = kBneck + kCondP;           // 176
// Trunk-phase cotangent [g (256) | skip part (128)] over the dead r0..r3.
constexpr int kColG = kColRgb;
constexpr int kLdT = kColGr + kGrW + 8;         // 3304
static_assert(kTrunkW + kTmplEncP <= 4 * kRgbW, "trunk cotangent fits");

using CT = Cfg<2, kLdT, 16>;

constexpr long long kGradW = weight_offset(kNumLayers) - weight_offset(kL0);
constexpr int kGradB = bias_offset(kNumLayers) - bias_offset(kL0);

// Input column of trunk layer i (0..7) and of the trunk logit (8).
__host__ __device__ constexpr int trunk_in_col(int i) {
  return i == 0 ? kColEnc : trunk_col(i - 1);
}

template <int I>
__device__ __forceinline__ void trunk_back(bf16* X, const bf16* Wt,
                                           float* grad_w, float* grad_b) {
  constexpr int L = kL0 + I;
  bwd_dw<CT, L, kL0>(X, kColG, trunk_in_col(I), grad_w);
  bwd_db<CT, L, kL0>(X, kColG, grad_b);
  bwd_dx<CT, L>(X, kColG, kColG, Wt, I > 0 ? trunk_col(I > 0 ? I - 1 : 0) : 0,
                I > 0 ? kTrunkW : 0);
}

template <int J>
__device__ __forceinline__ void rgb_back(bf16* X, const bf16* Wt, float* grad_w,
                                         float* grad_b) {
  constexpr int L = kL0 + 11 + J;  // rgb hidden J
  bwd_dw<CT, L, kL0>(X, kColGr, J == 0 ? kColBn : kColRgb + (J - 1) * kRgbW,
                     grad_w);
  bwd_db<CT, L, kL0>(X, kColGr, grad_b);
  bwd_dx<CT, L>(X, kColGr, kColGr, Wt, J > 0 ? kColRgb + (J - 1) * kRgbW : 0,
                J > 0 ? kRgbW : 0);
}

__global__ void __launch_bounds__(CT::THREADS, 1)
template_bwd_kernel(const float* __restrict__ raw_t,
                    const bf16* __restrict__ rgb_cond,
                    const float* __restrict__ g_out,
                    const bf16* __restrict__ W, const bf16* __restrict__ Wt,
                    const bf16* __restrict__ B, float* __restrict__ dx_t,
                    float* __restrict__ d_cond, float* __restrict__ grad_w,
                    long long n_points, int samples, long long n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);                      // [ROWS][LD]
  float* rawt = reinterpret_cast<float*>(X + CT::ROWS * CT::LD);  // [ROWS][8]
  float* gall = rawt + CT::ROWS * 8;  // [ROWS][4]: d rgb logits | d raw sigma
  float* hg = gall + CT::ROWS * 4;    // [ROWS][8]: a head's fp32 cotangent
  int* ray_of = reinterpret_cast<int*>(hg + CT::ROWS * 8);      // [ROWS]

  const int tid = threadIdx.x;
  float* grad_b = grad_w + kGradW;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * CT::ROWS;
    if (tid < CT::ROWS) {
      const long long p = row0 + tid;
      const bool valid = p < n_points;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a, gv = a;
      if (valid) {
        a = reinterpret_cast<const float4*>(raw_t)[2 * p];
        b = reinterpret_cast<const float4*>(raw_t)[2 * p + 1];
        gv = reinterpret_cast<const float4*>(g_out)[p];
      }
      float* rt = rawt + tid * 8;
      rt[0] = a.x, rt[1] = a.y, rt[2] = a.z, rt[3] = a.w;
      rt[4] = b.x, rt[5] = b.y, rt[6] = b.z, rt[7] = 0.f;
      float* ga = gall + tid * 4;  // zero on rows past the end: they add
      ga[0] = gv.x, ga[1] = gv.y, ga[2] = gv.z, ga[3] = gv.w;  // nothing
      ray_of[tid] = valid ? (int)(p / samples) : -1;
    }
    __syncthreads();

    // Recompute, keeping every layer's output.
    for (int e = tid; e < CT::ROWS * kTmplEncP; e += CT::THREADS) {
      const int r = e / kTmplEncP, f = e % kTmplEncP;
      const float* rt = rawt + r * 8;
      float v = 0.f;
      if (f < kTmplXyz)
        v = posenc_at<3, kXyzF>(rt, f);
      else if (f < kTmplEnc)
        v = posenc_at<kHypOut, kHypEncF>(rt + 3, f - kTmplXyz);
      X[r * CT::LD + kColEnc + f] = __float2bfloat16_rn(v);
    }
    for (int e = tid; e < CT::ROWS * kCondP; e += CT::THREADS) {
      const int r = e / kCondP, f = e % kCondP;
      X[r * CT::LD + kColCond + f] =
          (f < kCond && ray_of[r] >= 0)
              ? rgb_cond[(size_t)ray_of[r] * kCond + f]
              : __float2bfloat16_rn(0.f);
    }
    __syncthreads();
    fwd_layer<CT, kL0 + 0, true>(X, trunk_in_col(0), trunk_col(0), W, B);
    fwd_layer<CT, kL0 + 1, true>(X, trunk_in_col(1), trunk_col(1), W, B);
    fwd_layer<CT, kL0 + 2, true>(X, trunk_in_col(2), trunk_col(2), W, B);
    fwd_layer<CT, kL0 + 3, true>(X, trunk_in_col(3), trunk_col(3), W, B);
    fwd_layer<CT, kL0 + 4, true>(X, trunk_in_col(4), trunk_col(4), W, B);
    fwd_layer<CT, kL0 + 5, true>(X, trunk_in_col(5), trunk_col(5), W, B);
    fwd_layer<CT, kL0 + 6, true>(X, trunk_in_col(6), trunk_col(6), W, B);
    fwd_layer<CT, kL0 + 7, true>(X, trunk_in_col(7), trunk_col(7), W, B);
    fwd_layer<CT, kL0 + 8, true>(X, trunk_in_col(8), trunk_col(8), W, B);
    fwd_layer<CT, kL0 + 9, false>(X, trunk_col(8), kColBn, W, B);  // bneck
    fwd_layer<CT, kL0 + 11, true>(X, kColBn, kColRgb, W, B);
    fwd_layer<CT, kL0 + 12, true>(X, kColRgb, kColRgb + kRgbW, W, B);
    fwd_layer<CT, kL0 + 13, true>(X, kColRgb + kRgbW, kColRgb + 2 * kRgbW, W,
                                  B);
    fwd_layer<CT, kL0 + 14, true>(X, kColRgb + 2 * kRgbW, kColRgb + 3 * kRgbW,
                                  W, B);

    // rgb logit (layer 29): hg = d rgb logits.
    for (int e = tid; e < CT::ROWS * 8; e += CT::THREADS)
      hg[e] = (e % 8) < 3 ? gall[(e / 8) * 4 + e % 8] : 0.f;
    __syncthreads();
    head_dw_db<CT, kL0 + 15, kL0>(X, kColRgb + 3 * kRgbW, hg, grad_w, grad_b);
    for (int e = tid; e < CT::ROWS * kRgbW; e += CT::THREADS) {
      const int r = e / kRgbW, k = e % kRgbW;
      const float v = head_dx<kL0 + 15>(hg + r * 8, W, k);
      const bool on =
          __bfloat162float(X[r * CT::LD + kColRgb + 3 * kRgbW + k]) > 0.f;
      X[r * CT::LD + kColGr + k] = __float2bfloat16_rn(on ? v : 0.f);
    }
    __syncthreads();
    rgb_back<3>(X, Wt, grad_w, grad_b);
    rgb_back<2>(X, Wt, grad_w, grad_b);
    rgb_back<1>(X, Wt, grad_w, grad_b);
    rgb_back<0>(X, Wt, grad_w, grad_b);  // -> d[bneck | cond], 176 wide

    // d rgb_cond, summed per ray.
    ray_sums<CT>(ray_of, kCond, d_cond, kCond, [&](int r, int c) {
      return __bfloat162float(X[r * CT::LD + kColGr + kBneck + c]);
    });

    // alpha head (layer 24): hg = d raw sigma.
    __syncthreads();
    for (int e = tid; e < CT::ROWS * 8; e += CT::THREADS)
      hg[e] = (e % 8) == 0 ? gall[(e / 8) * 4 + 3] : 0.f;
    __syncthreads();
    head_dw_db<CT, kL0 + 10, kL0>(X, kColBn, hg, grad_w, grad_b);
    // Bottleneck cotangent g_b = d bneck (rgb branch) + d bneck (alpha), in
    // fp32; its fp32 sum is db of the bottleneck; rounded for the products.
    if (tid < kBneck) {
      float* db = grad_b + (bias_offset(kL0 + 9) - bias_offset(kL0));
      float s = 0.f;
      for (int r = 0; r < CT::ROWS; ++r) {
        bf16* gp = X + r * CT::LD + kColGr + tid;
        const float v = __bfloat162float(*gp) +
                        head_dx<kL0 + 10>(hg + r * 8, W, tid);
        s += v;
        *gp = __float2bfloat16_rn(v);
      }
      atomicAdd(db + tid, s);
    }
    __syncthreads();
    bwd_dw<CT, kL0 + 9, kL0>(X, kColGr, trunk_col(8), grad_w);
    bwd_dx<CT, kL0 + 9>(X, kColGr, kColG, Wt, trunk_col(8), kTrunkW);
    // Trunk logit (ReLU) and the trunk.
    trunk_back<8>(X, Wt, grad_w, grad_b);
    trunk_back<7>(X, Wt, grad_w, grad_b);
    trunk_back<6>(X, Wt, grad_w, grad_b);
    trunk_back<5>(X, Wt, grad_w, grad_b);  // writes the skip part too
    trunk_back<4>(X, Wt, grad_w, grad_b);
    trunk_back<3>(X, Wt, grad_w, grad_b);
    trunk_back<2>(X, Wt, grad_w, grad_b);
    trunk_back<1>(X, Wt, grad_w, grad_b);
    trunk_back<0>(X, Wt, grad_w, grad_b);  // -> d enc in G[:, 0:128]

    // posenc VJP: d enc = layer 0's part + the skip part, in fp32.
    for (int e = tid; e < CT::ROWS * 8; e += CT::THREADS) {
      const int r = e / 8, c = e % 8;
      if (row0 + r >= n_points) continue;
      const bf16* gr = X + r * CT::LD + kColG;
      auto gx = [&](int f) {
        return __bfloat162float(gr[f]) + __bfloat162float(gr[kTrunkW + f]);
      };
      float out = 0.f;
      if (c < 7) {
        const bool xyz = c < 3;
        const int ch = xyz ? 3 : kHypOut, nf = xyz ? kXyzF : kHypEncF;
        const int base = xyz ? 0 : kTmplXyz, cc = xyz ? c : c - 3;
        const float x = rawt[r * 8 + c];
        float dx = 0.f;
        for (int k = 0; k < nf; ++k) {
          const float scale = (float)(1 << k);
          float sn, cs;
          sincosf(x * scale, &sn, &cs);
          const float flat = cs * gx(base + ch + k * ch + cc) -
                             sn * gx(base + ch + nf * ch + k * ch + cc);
          dx += flat * scale;
        }
        out = gx(base + cc) + dx;
      }
      dx_t[(row0 + r) * 8 + c] = out;
    }
    __syncthreads();
  }
}

constexpr size_t kSmemT = sizeof(bf16) * CT::ROWS * CT::LD +
                          sizeof(float) * CT::ROWS * (8 + 4 + 8) +
                          sizeof(int) * CT::ROWS;

}  // namespace

// Blocks of the persistent grid for n_points samples: one per SM, never more
// than there are tiles.
extern "C" int hn_fused_template_bwd_blocks(long long n_points) {
  const long long tiles = (n_points + CT::ROWS - 1) / CT::ROWS;
  const long long sms = sm_count();
  return (int)(tiles < sms ? tiles : sms);
}

// weights, weights_t, biases: the template's 16 layers alone (layers 14..29
// of the table, which the kernel indexes them by). grads: kGradW + kGradB
// floats, [dW of layers 14..29 | db of layers 14..29], which every block adds
// into. grads and d_cond must be zero on entry.
extern "C" int hn_fused_template_bwd(
    const void* raw_t, const void* rgb_cond, const void* g, const void* weights,
    const void* weights_t, const void* biases, void* dx_t, void* d_cond,
    void* grads, long long n_points, int samples, int blocks, void* stream) {
  if (n_points <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      template_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemT);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n_points + CT::ROWS - 1) / CT::ROWS;
  template_bwd_kernel<<<blocks, CT::THREADS, kSmemT, (cudaStream_t)stream>>>(
      static_cast<const float*>(raw_t), static_cast<const bf16*>(rgb_cond),
      static_cast<const float*>(g),
      static_cast<const bf16*>(weights) - weight_offset(kL0),
      static_cast<const bf16*>(weights_t) - weight_offset(kL0),
      static_cast<const bf16*>(biases) - bias_offset(kL0),
      static_cast<float*>(dx_t), static_cast<float*>(d_cond),
      static_cast<float*>(grads), n_points, samples, tiles);
  return (int)cudaGetLastError();
}
