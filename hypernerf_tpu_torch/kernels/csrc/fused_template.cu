// The template MLP alone, forward, for Hopper (sm_90a).
//
// Replaces hypernerf_tpu/ops/pallas/fused_mlp.py `_fwd_call` (:656, the tile
// body `_forward_tile_gen` :319-379 with the in-kernel encoding of
// `enc_segments`) for the flagship template: posenc_orig(xyz, 10) ++
// posenc_orig(hyper (4), 6) -> trunk 8 x 256 (skip after 4, ReLU logit) ->
// bottleneck 128 -> alpha head; rgb branch 4 x 128 on [bottleneck | per-ray
// condition (39)] -> rgb logits.
//
// In:  x_raw (P, 8) fp32 rows [xyz | hyper | 0]; rgb_cond (P / S, 39) bf16, one
//      row per ray of S consecutive samples (S = 1: one row per sample); the
//      template's packed bf16 weights (out, in) and biases.
// Out: (P, 4) fp32 [rgb logits | raw sigma], as the level kernel packs it.
// A template without hyper coordinates (static NeRF: 63 encoded inputs) runs
// through the same kernel: the wrapper packs zero weight columns for the hyper
// bands, whose encoding of the zero input ([0 | sin 0 | cos 0]) then adds
// exactly nothing.
// Rounding points are the level kernel's (fused_level.cu).
//
// Bound: 686,976 multiply-adds per sample against 48 bytes moved, so
// operations bound it (8192 x 128 samples: 1.46 ms at the card's bf16 peak).
// Design: as fused_field.cu, a block of 256 threads keeps 64 rows in one
// shared-memory tile, 64 x 648 bf16 (83 KB, two blocks per SM); a layer reads
// one column range and writes another, as mma.sync m16n8k16 products with the
// weights from L2 (level_bwd.cuh):
//   h_a [0, 256) | enc [256, 384) | h_b [384, 640)
// with the bottleneck and the condition in h_b's range ([384, 512) and
// [512, 560)) and the rgb branch in h_a's two halves.

#include "level_bwd.cuh"

namespace {

constexpr int kL0 = kNumFieldLayers;  // first template layer (14)
constexpr int kColA = 0, kColEnc = kTrunkW, kColB = kTrunkW + kTmplEncP;
constexpr int kColCond = kColB + kBneck;
constexpr int kColR0 = 0, kColR1 = kRgbW;
static_assert(kColCond + kCondP <= kColB + kTrunkW, "condition fits h_b");
static_assert(2 * kRgbW <= kTrunkW, "rgb branch fits h_a");

using CT = Cfg<4, 2 * kTrunkW + kTmplEncP + 8, 8>;

__global__ void __launch_bounds__(CT::THREADS, 2)
template_fwd_kernel(const float* __restrict__ x_raw,
                    const bf16* __restrict__ rgb_cond,
                    const bf16* __restrict__ W, const bf16* __restrict__ B,
                    float* __restrict__ out, long long n_points,
                    int samples) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);                       // [ROWS][LD]
  float* rawt = reinterpret_cast<float*>(X + CT::ROWS * CT::LD);  // [ROWS][8]
  float* head = rawt + CT::ROWS * 8;                              // [ROWS][8]
  float* alpha = head + CT::ROWS * 8;                             // [ROWS]
  long long* ray_of = reinterpret_cast<long long*>(alpha + CT::ROWS);
  // The blobs hold the template's layers alone; the helpers index them by
  // the level's layer table.
  const bf16* Wl = W - weight_offset(kL0);
  const bf16* Bl = B - bias_offset(kL0);

  const long long row0 = (long long)blockIdx.x * CT::ROWS;
  const int tid = threadIdx.x;
  if (tid < CT::ROWS) {
    const long long p = row0 + tid;
    const bool valid = p < n_points;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (valid) {
      a = reinterpret_cast<const float4*>(x_raw)[2 * p];
      b = reinterpret_cast<const float4*>(x_raw)[2 * p + 1];
    }
    float* rt = rawt + tid * 8;
    rt[0] = a.x, rt[1] = a.y, rt[2] = a.z, rt[3] = a.w;
    rt[4] = b.x, rt[5] = b.y, rt[6] = b.z, rt[7] = 0.f;
    ray_of[tid] = valid ? p / samples : -1;
  }
  __syncthreads();

  // Encoding [posenc_orig(xyz, 10) | posenc_orig(hyper, 6) | 0 pad].
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
  __syncthreads();
  fwd_layer<CT, kL0 + 0, true>(X, kColEnc, kColA, Wl, Bl);
  fwd_layer<CT, kL0 + 1, true>(X, kColA, kColB, Wl, Bl);
  fwd_layer<CT, kL0 + 2, true>(X, kColB, kColA, Wl, Bl);
  fwd_layer<CT, kL0 + 3, true>(X, kColA, kColB, Wl, Bl);
  fwd_layer<CT, kL0 + 4, true>(X, kColB, kColA, Wl, Bl);
  fwd_layer<CT, kL0 + 5, true>(X, kColA, kColB, Wl, Bl);  // [h4 | enc]
  fwd_layer<CT, kL0 + 6, true>(X, kColB, kColA, Wl, Bl);
  fwd_layer<CT, kL0 + 7, true>(X, kColA, kColB, Wl, Bl);
  fwd_layer<CT, kL0 + 8, true>(X, kColB, kColA, Wl, Bl);   // trunk logit (ReLU)
  fwd_layer<CT, kL0 + 9, false>(X, kColA, kColB, Wl, Bl);  // bottleneck
  // The ray's condition after the bottleneck: [bneck | cond] is one K range.
  for (int e = tid; e < CT::ROWS * kCondP; e += CT::THREADS) {
    const int r = e / kCondP, f = e % kCondP;
    X[r * CT::LD + kColCond + f] =
        (f < kCond && ray_of[r] >= 0)
            ? rgb_cond[(size_t)ray_of[r] * kCond + f]
            : __float2bfloat16_rn(0.f);
  }
  head_fwd<CT, kL0 + 10>(X, kColB, Wl, Bl, head);  // alpha; ends in a barrier
  if (tid < CT::ROWS) alpha[tid] = head[tid * 8];
  fwd_layer<CT, kL0 + 11, true>(X, kColB, kColR0, Wl, Bl);
  fwd_layer<CT, kL0 + 12, true>(X, kColR0, kColR1, Wl, Bl);
  fwd_layer<CT, kL0 + 13, true>(X, kColR1, kColR0, Wl, Bl);
  fwd_layer<CT, kL0 + 14, true>(X, kColR0, kColR1, Wl, Bl);
  head_fwd<CT, kL0 + 15>(X, kColR1, Wl, Bl, head);  // rgb logits

  if (tid < CT::ROWS && row0 + tid < n_points) {
    const float* h = head + tid * 8;
    reinterpret_cast<float4*>(out)[row0 + tid] =
        make_float4(h[0], h[1], h[2], alpha[tid]);
  }
}

constexpr size_t kSmemTF = sizeof(bf16) * CT::ROWS * CT::LD +
                           sizeof(float) * CT::ROWS * (8 + 8 + 1) +
                           sizeof(long long) * CT::ROWS;

}  // namespace

// weights / biases: the template's 16 layers alone (layers 14..29 of the
// table). samples: consecutive rows that share one row of rgb_cond.
extern "C" int hn_fused_template_fwd(const void* x_raw, const void* rgb_cond,
                                     const void* weights, const void* biases,
                                     void* out, long long n_points,
                                     int samples, void* stream) {
  if (n_points <= 0 || samples <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      template_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemTF);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_points + CT::ROWS - 1) / CT::ROWS;
  template_fwd_kernel<<<(unsigned)blocks, CT::THREADS, kSmemTF,
                        (cudaStream_t)stream>>>(
      static_cast<const float*>(x_raw), static_cast<const bf16*>(rgb_cond),
      static_cast<const bf16*>(weights), static_cast<const bf16*>(biases),
      static_cast<float*>(out), n_points, samples);
  return (int)cudaGetLastError();
}
