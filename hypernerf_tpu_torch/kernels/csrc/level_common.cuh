// Shared by the level kernels (level_fwd.cuh, fields_bwd.cuh, kernel
// A's template_*.cu): the flagship widths, the template's four encoding
// layouts, the tables of the level's layers, keyed by warp x slicing (30
// with the translation warp, 32 with the SE(3) / quaternion warp; without a
// sheet, axis_aligned_plane slicing, 23 and 25, over the template layout's
// encoding width) with their offsets into the packed weight and bias blobs,
// the bf16 rounding and the posenc_orig feature map.
// A function that reads a table takes it as a template parameter,
// TransTable by default.

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
constexpr int kPlaneEncP = 192;  // the plane layout's 167 columns, 3 boxes
constexpr int kCondP = pad16(kCond);                         // 48
// The SE(3) / quaternion warp's trunk: Nerfies encoding of the points over
// the degrees [kSe3MinDeg, kSe3MinDeg + kSe3F), [sin | cos | embed].
constexpr int kSe3W = 128, kSe3F = 8, kSe3MinDeg = 0;
constexpr int kSe3Trig = 3 * kSe3F;                          // 24
constexpr int kSe3EncP = pad16(2 * kSe3Trig + kEmbed);       // 64

// The template's encoding layouts (TmplLayout below), each the first trunk
// layer's input, kEncP columns, and the rgb branch's kCondP condition
// columns:
//  - OrigEnc, the flagship's posenc_orig: the xyz at kXyzF bands and the
//    kHypOut hyper coordinates at kHypEncF, identity columns on both; a
//    kCond-column condition, posenc_orig(viewdirs, 6);
//  - NerfEnc, the Nerfies encoding of use_original_embed=False, the anneal
//    configuration: posenc from degree 0, [x | sin | cos] with band k of
//    channel c at k * C + c, the xyz over kXyzF bands with its identity, the
//    hyper coordinates over kNerfHypF bands without; a kNerfCond-column
//    condition, posenc(viewdirs, 0, 4, identity). Every column is weighted by
//    a window row, a tensor input of every call (the annealing alphas move
//    every step), and a kernel takes that layout wherever it is given the
//    row: one branch, uniform over the call;
//  - PlaneEnc, axis_aligned_plane slicing, the plane configuration:
//    posenc_orig with the kEmbed coordinates of the ray's GLO embedding as
//    the hyper coordinates (no sheet computes them), 167 columns in
//    kPlaneEncP slots; the flagship's condition;
//  - NerfPlaneEnc, axis_aligned_plane slicing with the Nerfies encoding
//    (the plane_anneal configurations): NerfEnc's xyz, then the kEmbed
//    plane coordinates over kNerfHypF bands without identity, 63 + 64 = 127
//    columns in kTmplEncP slots, NerfEnc's condition and window row.
// A layout's kCond is its view directions' width; the rgb condition a call
// takes is any width up to kCondP (the use_nerf_embed settings append the
// kEmbed-column embedding, or give it alone, or no condition at all), and
// the alpha condition is the embedding or none (level_fwd.cuh Cond).
// kRaw: the columns of a raw row [xyz | hyper | 0] (raw_t, x_raw).
constexpr int kNerfHypF = 4, kNerfCond = 27;
template <int H, int HF, bool kNerfies_, int EncP, int Cond>
struct TmplLayout {
  static constexpr int kHyp = H, kHypF = HF, kEncP = EncP, kCond = Cond;
  static constexpr bool kNerfies = kNerfies_;
  static constexpr bool kPlane = H == kEmbed;  // the hyper coords: the embed
  static constexpr int kHypId = kNerfies ? 0 : H;  // identity columns
  static constexpr int kEnc = kTmplXyz + kHypId + 2 * H * HF;
  static constexpr int kRaw = 3 + H <= 8 ? 8 : 16;
  static_assert(kEnc <= kEncP && kEncP % 64 == 0, "the encoding's slots");
};
using OrigEnc = TmplLayout<kHypOut, kHypEncF, false, kTmplEncP, kCond>;
using NerfEnc = TmplLayout<kHypOut, kNerfHypF, true, kTmplEncP, kNerfCond>;
using PlaneEnc = TmplLayout<kEmbed, kHypEncF, false, kPlaneEncP, kCond>;
using NerfPlaneEnc =
    TmplLayout<kEmbed, kNerfHypF, true, kTmplEncP, kNerfCond>;
static_assert(OrigEnc::kEnc == kTmplEnc && NerfEnc::kEnc <= kTmplEncP &&
                  PlaneEnc::kEnc == 167 && PlaneEnc::kEnc <= kPlaneEncP &&
                  NerfPlaneEnc::kEnc == 127 && NerfPlaneEnc::kRaw == 16 &&
                  kNerfCond <= kCondP,
              "each layout fills its slots");

struct Shape {
  int n, k;
};

// The template's 16 layers in kernel order, with its encoding in EncP
// columns: the trunk's hidden 0..7 (the skip input after 4), its ReLU logit,
// the bottleneck, the alpha head 1 -> 8 (its bottleneck columns; an alpha
// condition's come apart), the rgb branch's hidden 0..3 on [bottleneck |
// condition], its logit 3 -> 8.
__host__ __device__ constexpr Shape tmpl_shape(int i, int enc_p) {
  return i == 0   ? Shape{kTrunkW, enc_p}
         : i == 5 ? Shape{kTrunkW, kTrunkW + enc_p}
         : i < 9  ? Shape{kTrunkW, kTrunkW}
         : i == 9 ? Shape{kBneck, kTrunkW}
         : i == 10 ? Shape{8, kBneck}
         : i == 11 ? Shape{kRgbW, kBneck + kCondP}
         : i < 15 ? Shape{kRgbW, kRgbW}
                  : Shape{8, kRgbW};
}

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
    };
    return l < kFields ? t[l] : tmpl_shape(l - kFields, kTmplEncP);
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

// The levels without a sheet (axis_aligned_plane: kWarp == kFields, the
// hyper coordinates are the embedding), over the template layout L: the 23
// layers of the translation warp's (PlaneTable: the plane configuration's,
// PlaneEnc's 192-column encoding; with NerfPlaneEnc, 128) and the 25 of the
// SE(3) / quaternion warp's (Se3PlaneTable), the warp's layers then the
// template's on L::kEncP encoding columns.
template <class L>
struct PlaneTableOf {
  static constexpr int kNum = 23;
  static constexpr int kWarp = 7;
  static constexpr int kFields = 7;
  __host__ __device__ static constexpr Shape shape(int l) {
    return l < kFields ? TransTable::shape(l)
                       : tmpl_shape(l - kFields, L::kEncP);
  }
};
template <class L>
struct Se3PlaneTableOf {
  static constexpr int kNum = 25;
  static constexpr int kWarp = 9;
  static constexpr int kFields = 9;
  __host__ __device__ static constexpr Shape shape(int l) {
    return l < kFields ? Se3Table::shape(l)
                       : tmpl_shape(l - kFields, L::kEncP);
  }
};
using PlaneTable = PlaneTableOf<PlaneEnc>;
using Se3PlaneTable = Se3PlaneTableOf<PlaneEnc>;

template <class T = TransTable>
__host__ __device__ constexpr Shape layer_shape(int l) {
  return T::shape(l);
}

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

__device__ __forceinline__ float round_bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Feature f of an encoding from its fp32 value: rounded, then times the
// window row and rounded again (no row: rounded once).
__device__ __forceinline__ bf16 window_feature(float v, int f,
                                            const float* __restrict__ scales) {
  bf16 b = __float2bfloat16_rn(v);
  if (scales != nullptr)
    b = __float2bfloat16_rn(__bfloat162float(b) * scales[f]);
  return b;
}

// Feature f of posenc_orig over CH channels and F bands, block layout
// [x | sin(x * 2^k) | cos(x * 2^k)] with band k of channel c at k * CH + c
// (without the identity block when !kId: the Nerfies posenc from degree 0).
template <int CH, int F, bool kId = true>
__device__ __forceinline__ float posenc_at(const float* x, int f) {
  if (kId) {
    if (f < CH) return x[f];
    f -= CH;
  }
  const bool is_cos = f >= CH * F;
  if (is_cos) f -= CH * F;
  const float arg = x[f % CH] * (float)(1 << (f / CH));  // exact scaling
  return is_cos ? cosf(arg) : sinf(arg);
}

// Feature f < L::kEncP of the template's encoding in layout L of a raw
// row rt = [xyz | hyper], before its window (0 past kEnc).
template <class L>
__device__ __forceinline__ float tmpl_feature(const float* rt, int f) {
  if (f < kTmplXyz) return posenc_at<3, kXyzF>(rt, f);
  if (f >= L::kEnc) return 0.f;
  return posenc_at<L::kHyp, L::kHypF, !L::kNerfies>(rt + 3, f - kTmplXyz);
}

}  // namespace
