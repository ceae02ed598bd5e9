// The float32 level forward for Hopper (sm_90a): warp field, hyper sheet
// and template for every sample of a tile, in shared memory from the ray
// inputs to the packed output. It replaces the TPU kernel
// hypernerf_tpu/ops/pallas/fused_level.py `_fused` (:1322) and its
// pipelined schedule `_fwd_call_pipelined` (:1019) at
// `compute_dtype='float32'`, for the flagship table: the translation warp
// (6 x 128 on posenc 10 of the point and the 8-column embedding), the
// bendy sheet (6 x 64, 4 outputs, posenc 7), the posenc_orig template (8 x
// 256 with a skip after layer 4, bottleneck 128, the alpha head on the
// bottleneck, the rgb branch 4 x 128 on [bottleneck | rgb condition]).
// The bf16 level forward is level_fwd.cuh's, untouched.
//
// Bound: operations (1.7 MFLOP a sample; f32_chain.cuh). Design: a block of
// 256 threads owns a tile of 64 samples; the sheet runs first (its
// encoding, six hidden layers and head), then the warp field, then the
// template on [warped | hyper]; every layer is f32::tile_layer on
// activations kept feature-major in three shared buffers (X: an encoding,
// 128 features; H0, H1: hidden layers, 256 each, ping-ponged; a 256-wide
// layer in one pass of f32_chain.cuh's Wide tile), so nothing
// but the ray inputs, the weights (3.3 MB, read from L2 once per tile) and
// the output (and raw_t) touches device memory. The rgb condition fills
// H1's features 128.. after the bottleneck, zero-padded to kCondPad.

#include "f32_chain.cuh"

namespace {

using namespace f32;

// The flagship table (the bf16 table's shapes, level_common.cuh
// TransTable): warp 0..6, sheet 7..13, template 14..29; (n_pad, k_pad)
// of each packed layer, as kernels/common.py `_pack_layer` pads them.
constexpr int kLayers = 30;
constexpr int kShapeN[kLayers] = {128, 128, 128, 128, 128, 128, 8,
                                  64,  64,  64,  64,  64,  64,  8,
                                  256, 256, 256, 256, 256, 256, 256, 256,
                                  256, 128, 8,   128, 128, 128, 128, 8};
constexpr int kShapeK[kLayers] = {80,  128, 128, 128, 128, 208, 128,
                                  64,  64,  64,  64,  64,  128, 64,
                                  128, 256, 256, 256, 256, 384, 256, 256,
                                  256, 256, 128, 176, 128, 128, 128, 128};
constexpr int kEmbed = 8;
constexpr int kWarpFreq = 10, kSheetFreq = 7, kSheetOut = 4;
constexpr int kXyzFreq = 10, kHyperFreq = 6;
constexpr int kWarpEnc = 80, kSheetEnc = 64, kTmplEnc = 128;
constexpr int kBneck = 128, kCondPad = 48;

// Shared memory, in floats: X, H0, H1, the weight tile, and per-row
// scratch: the point (3), [warped | hyper] (8), a head's 8 outputs, sigma,
// and the row's ray index.
constexpr int kX = kTmplEnc * kRows;
constexpr int kH = 256 * kRows;
constexpr int kSmemFloats =
    kX + 2 * kH + 2 * Wide::kWTile + (3 + 8 + 8 + 1) * kRows + kRows;
constexpr int kSmemBytes = 4 * kSmemFloats;
static_assert(kSmemBytes <= 232448, "shared memory of an sm_90 block");

// Each layer's weight and bias offsets in the blobs and its (n_pad,
// k_pad), kernel arguments (the tables above are host data).
struct Offsets {
  long long w[kLayers];
  int b[kLayers];
  int n[kLayers];
  int k[kLayers];
};

struct Args {
  const float* z;     // (R, S)
  const float* o;     // (R, 3)
  const float* d;     // (R, 3)
  const float* emb;   // (R, 8)
  const float* cond;  // (R, cond_w)
  int cond_w;
  const float* w;  // every layer's transposed weight (k_pad, n_pad), fp32
  const float* b;  // the packed biases, fp32
  float* out;      // (P, 4) [rgb logits | raw sigma]
  float* raw_t;    // (P, 8) [warped | hyper | 0] or null
  long long rays;
  int samples;
  Offsets off;
};

__device__ __forceinline__ const float* W(const Args& a, int l) {
  return a.w + a.off.w[l];
}
__device__ __forceinline__ const float* B(const Args& a, int l) {
  return a.b + a.off.b[l];
}

// Layer l of the table on one or two shared segments.
__device__ __forceinline__ void layer1(const Args& a, int l, const float* x,
                                       float* out, bool relu, float* ws) {
  const int k = a.off.k[l], n = a.off.n[l];
  const Seg segs[1] = {{x, k}};
  tile_layer(segs, W(a, l), n, n, B(a, l), relu, out, ws);
}
__device__ __forceinline__ void layer2(const Args& a, int l, const float* x0,
                                       int k0, const float* x1, float* out,
                                       float* ws) {
  const int k = a.off.k[l], n = a.off.n[l];
  const Seg segs[2] = {{x0, k0}, {x1, k - k0}};
  tile_layer(segs, W(a, l), n, n, B(a, l), true, out, ws);
}

// A field (the warp field from layer `first`, or the sheet): the encoding
// in X, six hidden layers ping-ponged through H0 / H1 with the skip after
// the fifth, the head into `head`.
__device__ __forceinline__ void field(const Args& a, int first, int width,
                                      float* X, float* H0, float* H1,
                                      float* head, float* ws) {
  layer1(a, first, X, H0, true, ws);
  layer1(a, first + 1, H0, H1, true, ws);
  layer1(a, first + 2, H1, H0, true, ws);
  layer1(a, first + 3, H0, H1, true, ws);
  layer1(a, first + 4, H1, H0, true, ws);
  layer2(a, first + 5, H0, width, X, H1, ws);
  layer1(a, first + 6, H1, head, false, ws);
}

__global__ void __launch_bounds__(kThreads)
    level_fwd_f32(const Args a) {
  extern __shared__ float4 hn_f32_smem[];
  float* X = reinterpret_cast<float*>(hn_f32_smem);
  float* H0 = X + kX;
  float* H1 = H0 + kH;
  float* ws = H1 + kH;
  float* pts = ws + 2 * Wide::kWTile;  // 3 x kRows
  float* raw = pts + 3 * kRows;  // 8 x kRows: warped | hyper
  float* head = raw + 8 * kRows;
  float* sigma = head + 8 * kRows;
  int* ray = reinterpret_cast<int*>(sigma + kRows);
  const int t = threadIdx.x;
  const long long n_pts = a.rays * a.samples;
  const long long p0 = (long long)blockIdx.x * kRows;

  // The rows' points o + z d (rows past the end: the origin).
  if (t < kRows) {
    const long long p = p0 + t;
    const bool valid = p < n_pts;
    const long long q = valid ? p / a.samples : 0;
    ray[t] = (int)q;
    const float z = valid ? a.z[p] : 0.f;
    for (int c = 0; c < 3; ++c)
      pts[c * kRows + t] =
          valid ? __fadd_rn(a.o[q * 3 + c], __fmul_rn(z, a.d[q * 3 + c]))
                : 0.f;
  }
  __syncthreads();

  // The sheet: [posenc_orig(p, 7) | embedding | 0] -> 4 hyper coordinates.
  for (int i = t; i < kSheetEnc * kRows; i += kThreads) {
    const int f = i / kRows, r = i % kRows;
    const int n_pe = 3 * (1 + 2 * kSheetFreq);
    X[i] = f < n_pe ? posenc_feature(pts + r, kRows, 3, kSheetFreq, f)
           : f < n_pe + kEmbed ? a.emb[(long long)ray[r] * kEmbed + f - n_pe]
                               : 0.f;
  }
  __syncthreads();
  field(a, 7, 64, X, H0, H1, head, ws);
  if (t < kRows)
    for (int c = 0; c < kSheetOut; ++c)
      raw[(3 + c) * kRows + t] = head[c * kRows + t];

  // The warp field: [posenc_orig(p, 10) | embedding | 0] -> the offset.
  for (int i = t; i < kWarpEnc * kRows; i += kThreads) {
    const int f = i / kRows, r = i % kRows;
    const int n_pe = 3 * (1 + 2 * kWarpFreq);
    X[i] = f < n_pe ? posenc_feature(pts + r, kRows, 3, kWarpFreq, f)
           : f < n_pe + kEmbed ? a.emb[(long long)ray[r] * kEmbed + f - n_pe]
                               : 0.f;
  }
  __syncthreads();
  field(a, 0, 128, X, H0, H1, head, ws);
  if (t < kRows)
    for (int c = 0; c < 3; ++c)
      raw[c * kRows + t] = __fadd_rn(pts[c * kRows + t], head[c * kRows + t]);
  __syncthreads();

  // The template: [posenc_orig(warped, 10) | posenc_orig(hyper, 6) | 0].
  for (int i = t; i < kTmplEnc * kRows; i += kThreads) {
    const int f = i / kRows, r = i % kRows;
    const int n_xyz = 3 * (1 + 2 * kXyzFreq);
    const int n_hyp = kSheetOut * (1 + 2 * kHyperFreq);
    X[i] = f < n_xyz ? posenc_feature(raw + r, kRows, 3, kXyzFreq, f)
           : f < n_xyz + n_hyp
               ? posenc_feature(raw + 3 * kRows + r, kRows, kSheetOut,
                                kHyperFreq, f - n_xyz)
               : 0.f;
  }
  __syncthreads();
  layer1(a, 14, X, H0, true, ws);
  layer1(a, 15, H0, H1, true, ws);
  layer1(a, 16, H1, H0, true, ws);
  layer1(a, 17, H0, H1, true, ws);
  layer1(a, 18, H1, H0, true, ws);
  layer2(a, 19, H0, 256, X, H1, ws);
  layer1(a, 20, H1, H0, true, ws);
  layer1(a, 21, H0, H1, true, ws);
  layer1(a, 22, H1, H0, true, ws);  // the trunk's ReLU logit
  // The rgb branch's input: [bottleneck (H1 0..127) | condition | 0].
  for (int i = t; i < kCondPad * kRows; i += kThreads) {
    const int c = i / kRows, r = i % kRows;
    H1[(kBneck + c) * kRows + r] =
        c < a.cond_w ? a.cond[(long long)ray[r] * a.cond_w + c] : 0.f;
  }
  layer1(a, 23, H0, H1, false, ws);  // the bottleneck, linear
  layer1(a, 24, H1, head, false, ws);  // the alpha head
  if (t < kRows) sigma[t] = head[t];
  layer1(a, 25, H1, H0, true, ws);
  layer1(a, 26, H0, H1, true, ws);
  layer1(a, 27, H1, H0, true, ws);
  layer1(a, 28, H0, H1, true, ws);
  layer1(a, 29, H1, head, false, ws);  // the rgb head

  if (t < kRows) {
    const long long p = p0 + t;
    if (p < n_pts) {
      for (int c = 0; c < 3; ++c) a.out[p * 4 + c] = head[c * kRows + t];
      a.out[p * 4 + 3] = sigma[t];
      if (a.raw_t != nullptr) {
        for (int c = 0; c < 7; ++c) a.raw_t[p * 8 + c] = raw[c * kRows + t];
        a.raw_t[p * 8 + 7] = 0.f;
      }
    }
  }
}

}  // namespace

// The float32 table's (n_pad, k_pad) of each layer (written up to
// max_layers); returns the number of layers.
extern "C" int hn_f32_level_layout(int* n, int* k, int max_layers) {
  for (int l = 0; l < kLayers && l < max_layers; ++l) {
    n[l] = kShapeN[l];
    k[l] = kShapeK[l];
  }
  return kLayers;
}

// z (R, S), o / d (R, 3), emb (R, 8), cond (R, cond_w) fp32, cond_w <= 48;
// w the packed fp32 weights of the flagship table transposed layer by layer
// (common.py's blob, each layer (k_pad, n_pad) row-major), b its biases;
// out (R * S, 4) fp32 and, if
// not null, raw_t (R * S, 8) fp32. Returns a CUDA error code.
extern "C" int hn_f32_level_fwd(const float* z, const float* o,
                                const float* d, const float* emb,
                                const float* cond, int cond_w,
                                const float* w, const float* b, float* out,
                                float* raw_t, long long rays, int samples,
                                cudaStream_t stream) {
  if (cond_w < 0 || cond_w > kCondPad || samples <= 0) return 1;
  const long long n_pts = rays * samples;
  if (n_pts == 0) return 0;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        level_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  Args a{z, o, d, emb, cond, cond_w, w, b, out, raw_t, rays, samples, {}};
  long long at_w = 0;
  int at_b = 0;
  for (int l = 0; l < kLayers; ++l) {
    a.off.w[l] = at_w;
    a.off.b[l] = at_b;
    a.off.n[l] = kShapeN[l];
    a.off.k[l] = kShapeK[l];
    at_w += (long long)kShapeN[l] * kShapeK[l];
    at_b += kShapeN[l];
  }
  const long long blocks = (n_pts + kRows - 1) / kRows;
  level_fwd_f32<<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}
