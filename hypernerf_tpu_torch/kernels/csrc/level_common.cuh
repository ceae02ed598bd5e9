// Shared by the level kernels (fused_level.cu, fused_template_bwd.cu,
// fused_fields_bwd.cu): the flagship widths, the table of the 30 layers with
// their offsets into the packed weight and bias blobs, the bf16 tensor-core
// product and the posenc_orig feature map.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// Flagship widths (NerfConfig defaults).
constexpr int kEmbed = 8;
constexpr int kWarpW = 128, kWarpF = 10;
constexpr int kHypW = 64, kHypF = 7, kHypOut = 4;
constexpr int kXyzF = 10, kHypEncF = 6;
constexpr int kTrunkW = 256, kBneck = 128;
constexpr int kRgbW = 128, kCond = 39;

__host__ __device__ constexpr int pad16(int x) { return (x + 15) / 16 * 16; }

constexpr int kWarpPts = 3 * (1 + 2 * kWarpF);               // 63
constexpr int kHypPts = 3 * (1 + 2 * kHypF);                 // 45
constexpr int kTmplXyz = 3 * (1 + 2 * kXyzF);                // 63
constexpr int kTmplEnc = kTmplXyz + kHypOut * (1 + 2 * kHypEncF);  // 115
constexpr int kWarpEncP = pad16(kWarpPts + kEmbed);          // 80
constexpr int kHypEncP = pad16(kHypPts + kEmbed);            // 64
constexpr int kTmplEncP = pad16(kTmplEnc);                   // 128
constexpr int kCondP = pad16(kCond);                         // 48

struct Shape {
  int n, k;
};

// The 30 layers in kernel order, (out padded to 8, in padded per segment
// to 16). The Python wrapper packs weights to exactly these shapes and
// checks them against hn_fused_level_layout.
__host__ __device__ constexpr Shape layer_shape(int l) {
  constexpr Shape t[] = {
      // warp MLP: hidden 0..5 (skip input after 4), logit 3 -> 8
      {kWarpW, kWarpEncP}, {kWarpW, kWarpW}, {kWarpW, kWarpW},
      {kWarpW, kWarpW}, {kWarpW, kWarpW}, {kWarpW, kWarpW + kWarpEncP},
      {8, kWarpW},
      // hyper MLP: hidden 0..5, logit 4 -> 8
      {kHypW, kHypEncP}, {kHypW, kHypW}, {kHypW, kHypW}, {kHypW, kHypW},
      {kHypW, kHypW}, {kHypW, kHypW + kHypEncP}, {8, kHypW},
      // template trunk: hidden 0..7, ReLU logit
      {kTrunkW, kTmplEncP}, {kTrunkW, kTrunkW}, {kTrunkW, kTrunkW},
      {kTrunkW, kTrunkW}, {kTrunkW, kTrunkW}, {kTrunkW, kTrunkW + kTmplEncP},
      {kTrunkW, kTrunkW}, {kTrunkW, kTrunkW}, {kTrunkW, kTrunkW},
      // bottleneck, alpha head 1 -> 8
      {kBneck, kTrunkW}, {8, kBneck},
      // rgb branch: hidden 0..3, logit 3 -> 8
      {kRgbW, kBneck + kCondP}, {kRgbW, kRgbW}, {kRgbW, kRgbW},
      {kRgbW, kRgbW}, {8, kRgbW},
  };
  return t[l];
}
constexpr int kNumLayers = 30;
constexpr int kNumFieldLayers = 14;  // warp 7 + hyper 7, then the template

__host__ __device__ constexpr long long weight_offset(int l) {
  long long o = 0;
  for (int i = 0; i < l; ++i)
    o += (long long)layer_shape(i).n * layer_shape(i).k;
  return o;
}

__host__ __device__ constexpr int bias_offset(int l) {
  int o = 0;
  for (int i = 0; i < l; ++i) o += layer_shape(i).n;
  return o;
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Feature f of posenc_orig over CH channels and F bands, block layout
// [x | sin(x * 2^k) | cos(x * 2^k)] with band k of channel c at k * CH + c.
template <int CH, int F>
__device__ __forceinline__ float posenc_at(const float* x, int f) {
  if (f < CH) return x[f];
  f -= CH;
  const bool is_cos = f >= CH * F;
  if (is_cos) f -= CH * F;
  const float arg = x[f % CH] * (float)(1 << (f / CH));  // exact scaling
  return is_cos ? cosf(arg) : sinf(arg);
}

}  // namespace
