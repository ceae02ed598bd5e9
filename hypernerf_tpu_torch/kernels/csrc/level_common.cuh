// Shared by the level kernels (level_fwd.cuh, fields_bwd.cuh, kernel
// A's template_*.cu): the flagship widths, the two tables of the level's
// layers (30 with the translation warp, 32 with the SE(3) / quaternion warp)
// with their offsets into the packed weight and bias blobs, the bf16
// tensor-core product and the posenc_orig feature map. A function that reads
// a table takes it as a template parameter, TransTable by default.

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
// The SE(3) / quaternion warp's trunk: Nerfies encoding of the points over
// the degrees [kSe3MinDeg, kSe3MinDeg + kSe3F), [sin | cos | embed].
constexpr int kSe3W = 128, kSe3F = 8, kSe3MinDeg = 0;
constexpr int kSe3Trig = 3 * kSe3F;                          // 24
constexpr int kSe3EncP = pad16(2 * kSe3Trig + kEmbed);       // 64

struct Shape {
  int n, k;
};

// The 30 layers of the level with the translation warp, in kernel order,
// (out padded to 8, in padded per segment to 16). The Python wrapper packs
// weights to exactly these shapes and checks them against
// hn_fused_level_layout.
struct TransTable {
  static constexpr int kNum = 30;
  static constexpr int kWarp = 7;     // warp layers, then the sheet
  static constexpr int kFields = 14;  // warp 7 + hyper 7, then the template
  __host__ __device__ static constexpr Shape shape(int l) {
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
        {kTrunkW, kTrunkW}, {kTrunkW, kTrunkW},
        {kTrunkW, kTrunkW + kTmplEncP}, {kTrunkW, kTrunkW},
        {kTrunkW, kTrunkW}, {kTrunkW, kTrunkW},
        // bottleneck, alpha head 1 -> 8
        {kBneck, kTrunkW}, {8, kBneck},
        // rgb branch: hidden 0..3, logit 3 -> 8
        {kRgbW, kBneck + kCondP}, {kRgbW, kRgbW}, {kRgbW, kRgbW},
        {kRgbW, kRgbW}, {8, kRgbW},
    };
    return t[l];
  }
};

// The 32 layers of the level with the SE(3) or the quaternion warp: the
// warp is a trunk of 6 hidden layers on the Nerfies encoding (no identity
// block), a linear 128 -> 128 trunk logit and the w and v heads (3 -> 8
// each); the sheet and the template are TransTable's.
struct Se3Table {
  static constexpr int kNum = 32;
  static constexpr int kWarp = 9;
  static constexpr int kFields = 16;
  __host__ __device__ static constexpr Shape shape(int l) {
    constexpr Shape t[] = {
        {kSe3W, kSe3EncP}, {kSe3W, kSe3W}, {kSe3W, kSe3W}, {kSe3W, kSe3W},
        {kSe3W, kSe3W}, {kSe3W, kSe3W + kSe3EncP},
        {kSe3W, kSe3W}, {8, kSe3W}, {8, kSe3W},
    };
    return l < kWarp ? t[l]
                     : TransTable::shape(l - kWarp + TransTable::kWarp);
  }
};

template <class T = TransTable>
__host__ __device__ constexpr Shape layer_shape(int l) {
  return T::shape(l);
}
constexpr int kNumLayers = TransTable::kNum;
constexpr int kNumFieldLayers = TransTable::kFields;

template <class T = TransTable>
__host__ __device__ constexpr long long weight_offset(int l) {
  long long o = 0;
  for (int i = 0; i < l; ++i) o += (long long)T::shape(i).n * T::shape(i).k;
  return o;
}

template <class T = TransTable>
__host__ __device__ constexpr int bias_offset(int l) {
  int o = 0;
  for (int i = 0; i < l; ++i) o += T::shape(i).n;
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
