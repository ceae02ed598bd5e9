// The float32 level forward for Hopper (sm_90a): warp field, hyper sheet
// and template for every sample of a tile, in shared memory from the ray
// inputs to the packed output. It replaces the TPU kernel
// hypernerf_tpu/ops/pallas/fused_level.py `_fused` (:1322) and its
// pipelined schedule `_fwd_call_pipelined` (:1019) at
// `compute_dtype='float32'`, for the flagship tables: the translation warp
// (6 x 128 on posenc 10 of the point and the 8-column embedding) or the
// SE(3) / quaternion warp (table codes 1 and 2: the trunk, 6 x 128 on the
// Nerfies encoding of the point over degrees 0..7 and the embedding, a
// linear 128 -> 128 trunk logit, the w and v heads, then the retraction in
// fp32, se3_trunk.cuh `retract`; the optional window row multiplies the
// trunk's encoding), the bendy sheet (6 x 64, 4 outputs, posenc 7), the
// template (8 x 256 with a skip after layer 4, bottleneck 128, the alpha
// head on the bottleneck, the rgb branch 4 x 128 on [bottleneck | rgb
// condition of 0 to 48 columns]) in either layout of the sheet tables: the
// posenc_orig encoding, or with the template's window row the Nerfies one
// (the xyz as posenc_orig has it, the 4 hyper coordinates over degrees
// 0..3 without identity, 95 columns in the same 128, each times its
// window weight). An alpha condition (8 columns a ray, or none) is dotted
// with the alpha head's condition weights and added to its output. The
// plane tables (table codes 3 to 8, axis_aligned_plane slicing) run the
// same stages without the sheet: the hyper coordinates are the ray's 8 GLO
// coordinates, encoded posenc_orig at 6 bands (codes 3 to 5: 167 columns
// in a 192-column X, the template's first layer at K = 192 and its skip
// at 448) or, with the template's window row, the Nerfies way at 4 bands
// (codes 6 to 8: 127 columns in the flagship's 128), after the warp of
// code % 3. Layout, table code, window row, condition widths and the alpha
// condition are run-time arguments of one kernel. The bf16 level forward
// is level_fwd.cuh's, untouched.
//
// Its stages also run alone, on raw rows, for the per-module path at
// float32: the template alone (hn_f32_template_fwd, replacing
// hypernerf_tpu/ops/pallas/fused_mlp.py `_fwd_call` :656; 4 hyper
// coordinates, 8 in the plane layouts or, for a template without them, 0,
// a run-time argument; any rows per condition row, 1 included; the
// level's layouts and conditions), a field alone (hn_f32_field_fwd, the
// warp field or the sheet, with or without a window row, replacing
// hypernerf_tpu/ops/pallas/fused_field.py `_fused` :495) and the SE(3)
// trunk alone (hn_f32_trunk_fwd, [w | v] of raw rows, replacing
// hypernerf_tpu/ops/pallas/fused_se3.py `_fused` :374).
//
// Bound: operations (1.7 MFLOP a sample; f32_chain.cuh). Design: a block of
// 256 threads owns a tile of 64 samples; the sheet runs first (its
// encoding, six hidden layers and head), then the warp field (or the trunk
// and the retraction), then the template on [warped | hyper] (a plane
// table: the warp, then the template on [warped | embedding]); every layer
// is f32::tile_layer on activations kept feature-major in three shared
// buffers (X: an encoding, 128 features, or a plane table's 192; H0, H1:
// hidden layers, 256 each, ping-ponged; a 256-wide layer in one pass of
// f32_chain.cuh's Wide tile), so nothing but the ray inputs, the weights
// (3.3 MB, read from L2 once per tile) and the output (and raw_t) touches
// device memory. The rgb condition fills H1's features 128.. after the
// bottleneck, zero-padded to kCondPad. The trunk writes its w head into H1
// (free after the trunk logit) and its v head into the per-row head
// scratch. The sheet tables carve 201,984 bytes; a plane table carves X of
// its encoding's slots and 16 raw rows of scratch ([warped 3 | hyper 8]:
// 220,416 bytes with the 192-column X, 204,032 with 128), still one block
// an SM, with a launch's own carve. A field alone carves less shared
// memory (X of 80 features, H of 128, the Narrow tile's weight chunks:
// 107,776 bytes), so that two blocks fit an SM, and the trunk alone less
// again (X of 64 features: 103,680 bytes).

#include "f32_chain.cuh"
#include "se3_trunk.cuh"  // retract: the screw warps' retraction, fp32

namespace {
// Its own namespace: level_common.cuh (se3_trunk.cuh's) declares some of
// these names for the bf16 kernels.
namespace lvl {

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
// The screw warps' trunk (level_common.cuh Se3Table's layers 0..8): hidden
// 0..5 (the skip input after 4), the linear trunk logit, the w and v heads.
// Its rows sit in the slots kTrunk0.. of a kernel's offsets, after the
// flagship table's, so that a screw level keeps the sheet's and the
// template's slots; its blob holds the trunk's rows first.
constexpr int kTrunkLayers = 9, kTrunk0 = kLayers;
constexpr int kTrunkN[kTrunkLayers] = {128, 128, 128, 128, 128,
                                       128, 128, 8,   8};
constexpr int kTrunkK[kTrunkLayers] = {64,  128, 128, 128, 128,
                                       192, 128, 128, 128};
constexpr int kSlots = kLayers + kTrunkLayers;
static_assert(kTrunkK[0] == kSe3EncP && kTrunkN[0] == kSe3W &&
                  kTrunkK[5] == kSe3W + kSe3EncP,
              "the trunk's widths: level_common.cuh Se3Table");
constexpr int kEmbed = 8;
constexpr int kWarpFreq = 10, kSheetFreq = 7, kSheetOut = 4;
constexpr int kXyzFreq = 10, kHyperFreq = 6;
constexpr int kNerfHyperFreq = 4;  // the Nerfies layout's hyper bands
constexpr int kAlphaCond = kEmbed;  // an alpha condition's columns
constexpr int kWarpEnc = 80, kSheetEnc = 64, kTmplEnc = 128;
constexpr int kBneck = 128, kCondPad = 48;
// The plane tables (codes 3..8, kPlaneCodes and up): no sheet; the
// posenc_orig plane layout's encoding slots (167 columns: the xyz at 10
// bands, the 8 GLO coordinates at 6) and the raw rows a tile holds [warped
// | 8 hyper | 0] in, where the sheet tables hold [warped | 4 hyper | 0] in
// kRaw.
constexpr int kPlaneCodes = 3, kCodes = 9;
constexpr int kPlaneEnc = 192, kRaw = 8, kPlaneRaw = 16;

// The shared buffers of a tile, carved in this order: X (an encoding, xf
// features), H0 and H1 (hidden layers, hf features each), the double
// weight tile (2 x wtile), and per-row scratch: the point (3), [warped |
// hyper | 0] (raw rows), a head's 8 outputs, sigma, and the row's ray
// index (the row a row's embedding and condition are read from).
constexpr int smem_floats(int xf, int hf, int wtile, int raw = kRaw) {
  return xf * kRows + 2 * hf * kRows + 2 * wtile + (3 + raw + 8 + 1) * kRows +
         kRows;
}

struct Tiles {
  float *X, *H0, *H1, *ws, *pts, *raw, *head, *sigma;
  int* ray;
  __device__ Tiles(float* s, int xf, int hf, int wtile, int raw_rows = kRaw) {
    X = s;
    H0 = X + xf * kRows;
    H1 = H0 + hf * kRows;
    ws = H1 + hf * kRows;
    pts = ws + 2 * wtile;  // 3 x kRows
    raw = pts + 3 * kRows;  // raw_rows x kRows: warped | hyper | 0
    head = raw + raw_rows * kRows;
    sigma = head + 8 * kRows;
    ray = reinterpret_cast<int*>(sigma + kRows);
  }
};

// The template's carve in the level forward and the template alone, by its
// hyper coordinates and layout: X of its encoding's slots (kTmplEnc, or
// kPlaneEnc for the posenc_orig plane layout) and its raw rows (kRaw, or
// kPlaneRaw with the plane tables' 8 hyper coordinates); a launch takes
// its own carve's bytes.
struct Carve {
  int xf, raw;
};
__host__ __device__ constexpr Carve carve_of(int hyper, bool nerfies) {
  return hyper == kEmbed ? Carve{nerfies ? kTmplEnc : kPlaneEnc, kPlaneRaw}
                         : Carve{kTmplEnc, kRaw};
}
constexpr int carve_bytes(Carve c) {
  return 4 * smem_floats(c.xf, 256, Wide::kWTile, c.raw);
}

// The level forward and the template alone: X of the template's encoding,
// H of its 256-wide layers, the Wide tile's weight chunks: the sheet
// tables' carve (kSmemBytes), and the most a plane table carves
// (kPlaneSmemBytes, the posenc_orig plane layout's).
constexpr int kSmemBytes = 4 * smem_floats(kTmplEnc, 256, Wide::kWTile);
static_assert(kSmemBytes <= 232448, "shared memory of an sm_90 block");
constexpr int kPlaneSmemBytes =
    4 * smem_floats(kPlaneEnc, 256, Wide::kWTile, kPlaneRaw);
static_assert(kPlaneSmemBytes <= 232448, "shared memory of an sm_90 block");
static_assert(carve_bytes(carve_of(4, false)) == kSmemBytes &&
                  carve_bytes(carve_of(kEmbed, false)) == kPlaneSmemBytes &&
                  carve_bytes(carve_of(kEmbed, true)) < kPlaneSmemBytes,
              "the carves: the sheet tables', the plane layouts'");
// A field alone: X of the warp field's encoding (the wider), H of 128
// features, the Narrow tile's weight chunks (no layer of a field is wider).
constexpr int kFieldSmemBytes =
    4 * smem_floats(kWarpEnc, 128, Narrow::kWTile);
static_assert(kFieldSmemBytes <= 232448, "shared memory of an sm_90 block");
// The SE(3) trunk alone: X of its encoding, H of 128 features, the Narrow
// tile's weight chunks.
constexpr int kTrunkSmemBytes =
    4 * smem_floats(kSe3EncP, kSe3W, Narrow::kWTile);
static_assert(kTrunkSmemBytes <= 232448, "shared memory of an sm_90 block");

// Each layer's weight and bias offsets in the blobs and its (n_pad,
// k_pad), kernel arguments (the tables above are host data). A kernel of a
// stage alone fills the stage's rows of the table, with offsets into the
// stage's own blobs.
struct Offsets {
  long long w[kSlots];
  int b[kSlots];
  int n[kSlots];
  int k[kSlots];
};

// A network's blobs: every layer's transposed weight (k_pad, n_pad) and
// the packed biases, fp32, and where each layer of the table lies in them.
struct Net {
  const float* w;
  const float* b;
  Offsets off;
};

__device__ __forceinline__ const float* W(const Net& a, int l) {
  return a.w + a.off.w[l];
}
__device__ __forceinline__ const float* B(const Net& a, int l) {
  return a.b + a.off.b[l];
}

// Layer l of the table on one or two shared segments.
__device__ __forceinline__ void layer1(const Net& a, int l, const float* x,
                                       float* out, bool relu, float* ws) {
  const int k = a.off.k[l], n = a.off.n[l];
  const Seg segs[1] = {{x, k}};
  tile_layer(segs, W(a, l), n, n, B(a, l), relu, out, ws);
}
__device__ __forceinline__ void layer2(const Net& a, int l, const float* x0,
                                       int k0, const float* x1, float* out,
                                       float* ws) {
  const int k = a.off.k[l], n = a.off.n[l];
  const Seg segs[2] = {{x0, k0}, {x1, k - k0}};
  tile_layer(segs, W(a, l), n, n, B(a, l), true, out, ws);
}

// A field's encoding into X, `enc` features: [posenc_orig(p, F) |
// embedding | 0], the embedding of tile row r at emb[rows[r] * emb_ld],
// each feature times the window row where there is one (`scales`, enc
// fp32, or null).
__device__ __forceinline__ void encode_field(float* X, const float* pts,
                                             int F, int enc,
                                             const float* emb, int emb_ld,
                                             const int* rows,
                                             const float* scales = nullptr) {
  for (int i = threadIdx.x; i < enc * kRows; i += kThreads) {
    const int f = i / kRows, r = i % kRows;
    const int n_pe = 3 * (1 + 2 * F);
    const float v =
        f < n_pe            ? posenc_feature(pts + r, kRows, 3, F, f)
        : f < n_pe + kEmbed ? emb[(long long)rows[r] * emb_ld + f - n_pe]
                            : 0.f;
    X[i] = scales != nullptr ? v * scales[f] : v;
  }
}

// A field (the warp field from layer `first`, or the sheet): the encoding
// in X, six hidden layers ping-ponged through H0 / H1 with the skip after
// the fifth, the head into `head`.
__device__ __forceinline__ void field(const Net& a, int first, int width,
                                      const Tiles& s) {
  layer1(a, first, s.X, s.H0, true, s.ws);
  layer1(a, first + 1, s.H0, s.H1, true, s.ws);
  layer1(a, first + 2, s.H1, s.H0, true, s.ws);
  layer1(a, first + 3, s.H0, s.H1, true, s.ws);
  layer1(a, first + 4, s.H1, s.H0, true, s.ws);
  layer2(a, first + 5, s.H0, width, s.X, s.H1, s.ws);
  layer1(a, first + 6, s.H1, s.head, false, s.ws);
}

// The screw warps' trunk encoding into X, kSe3EncP features: [sin | cos
// of the bands of the point over the degrees kSe3MinDeg.. (band b of
// channel c at 3 b + c) | embedding | 0], each feature times the window
// row where there is one (`scales`, kSe3EncP fp32, or null); the embedding
// of tile row r at emb[rows[r] * emb_ld].
__device__ __forceinline__ void encode_trunk(float* X, const float* pts,
                                             const float* emb, int emb_ld,
                                             const int* rows,
                                             const float* scales) {
  for (int i = threadIdx.x; i < kSe3EncP * kRows; i += kThreads) {
    const int f = i / kRows, r = i % kRows;
    float v = 0.f;
    if (f < 2 * kSe3Trig) {
      const int b = f % kSe3Trig;
      const float arg = ldexpf(pts[(b % 3) * kRows + r], kSe3MinDeg + b / 3);
      v = f < kSe3Trig ? sinf(arg) : cosf(arg);
    } else if (f < 2 * kSe3Trig + kEmbed) {
      v = emb[(long long)rows[r] * emb_ld + f - 2 * kSe3Trig];
    }
    X[i] = scales != nullptr ? v * scales[f] : v;
  }
}

// The trunk (slots kTrunk0..kTrunk0 + 8) on its encoding in X: six hidden
// layers ping-ponged through H0 / H1 with the skip after the fifth, the
// linear trunk logit into H0 (no ReLU), then the w head into H1's rows
// 0..7 and the v head into `head`.
__device__ __forceinline__ void trunk(const Net& a, const Tiles& s) {
  layer1(a, kTrunk0, s.X, s.H0, true, s.ws);
  layer1(a, kTrunk0 + 1, s.H0, s.H1, true, s.ws);
  layer1(a, kTrunk0 + 2, s.H1, s.H0, true, s.ws);
  layer1(a, kTrunk0 + 3, s.H0, s.H1, true, s.ws);
  layer1(a, kTrunk0 + 4, s.H1, s.H0, true, s.ws);
  layer2(a, kTrunk0 + 5, s.H0, kSe3W, s.X, s.H1, s.ws);
  layer1(a, kTrunk0 + 6, s.H1, s.H0, false, s.ws);
  layer1(a, kTrunk0 + 7, s.H0, s.H1, false, s.ws);
  layer1(a, kTrunk0 + 8, s.H0, s.head, false, s.ws);
}

// Tile row t's warped point into s.raw's rows 0..2: the retraction of the
// trunk's (w, v) (H1, head) and the point, SE(3) or (quat) quaternion.
__device__ __forceinline__ void retract_row(const Tiles& s, int t,
                                            bool quat) {
  float w[3], v[3], p[3], out[3];
  for (int c = 0; c < 3; ++c) {
    w[c] = s.H1[c * kRows + t];
    v[c] = s.head[c * kRows + t];
    p[c] = s.pts[c * kRows + t];
  }
  if (quat)
    retract<true>(w, v, p, out);
  else
    retract<false>(w, v, p, out);
  for (int c = 0; c < 3; ++c) s.raw[c * kRows + t] = out[c];
}

// The template's encoding of [warped | hyper] (s.raw, `hyper` hyper
// coordinates: 4, the plane tables' 8, or 0 for a template without them)
// into X's `enc` features (its carve's xf): without a window row
// [posenc_orig(warped, 10) | posenc_orig(hyper, 6) | 0]; with one
// (`scales`, enc fp32: the Nerfies layouts) [posenc_orig(warped, 10) | sin
// | cos of hyper over degrees 0..3 | 0], each feature times its window
// weight.
__device__ __forceinline__ void encode_template(const Tiles& s, int hyper,
                                                const float* scales,
                                                int enc) {
  const bool nerfies = scales != nullptr;
  const int hf = nerfies ? kNerfHyperFreq : kHyperFreq;
  const int n_xyz = 3 * (1 + 2 * kXyzFreq);
  const int n_hyp = hyper * ((nerfies ? 0 : 1) + 2 * hf);
  for (int i = threadIdx.x; i < enc * kRows; i += kThreads) {
    const int f = i / kRows, r = i % kRows;
    const float v =
        f < n_xyz ? posenc_feature(s.raw + r, kRows, 3, kXyzFreq, f)
        : f < n_xyz + n_hyp
            ? posenc_feature(s.raw + 3 * kRows + r, kRows, hyper, hf,
                             f - n_xyz, !nerfies)
            : 0.f;
    s.X[i] = nerfies ? v * scales[f] : v;
  }
}

// The template (layers 14..29) on its encoding in X: the rgb logits into
// s.head's rows 0..2, the raw sigma into s.sigma. The rgb branch's input
// is [bottleneck (H1 0..127) | condition | 0], the condition of tile row r
// at cond[s.ray[r] * cond_w]; the alpha condition of tile row r (alpha,
// kAlphaCond columns a ray, or null) dotted with the alpha head's condition
// weights (alpha_w, kAlphaCond fp32) is added to its raw sigma.
__device__ __forceinline__ void template_stage(const Net& a, const Tiles& s,
                                               const float* cond, int cond_w,
                                               const float* alpha,
                                               const float* alpha_w) {
  layer1(a, 14, s.X, s.H0, true, s.ws);
  layer1(a, 15, s.H0, s.H1, true, s.ws);
  layer1(a, 16, s.H1, s.H0, true, s.ws);
  layer1(a, 17, s.H0, s.H1, true, s.ws);
  layer1(a, 18, s.H1, s.H0, true, s.ws);
  layer2(a, 19, s.H0, 256, s.X, s.H1, s.ws);
  layer1(a, 20, s.H1, s.H0, true, s.ws);
  layer1(a, 21, s.H0, s.H1, true, s.ws);
  layer1(a, 22, s.H1, s.H0, true, s.ws);  // the trunk's ReLU logit
  for (int i = threadIdx.x; i < kCondPad * kRows; i += kThreads) {
    const int c = i / kRows, r = i % kRows;
    s.H1[(kBneck + c) * kRows + r] =
        c < cond_w ? cond[(long long)s.ray[r] * cond_w + c] : 0.f;
  }
  layer1(a, 23, s.H0, s.H1, false, s.ws);  // the bottleneck, linear
  layer1(a, 24, s.H1, s.head, false, s.ws);  // the alpha head
  if (threadIdx.x < kRows) {
    const int t = threadIdx.x;
    float sigma = s.head[t];
    if (alpha != nullptr) {
      const float* ar = alpha + (long long)s.ray[t] * kAlphaCond;
      float dot = 0.f;
      for (int c = 0; c < kAlphaCond; ++c) dot = fmaf(ar[c], alpha_w[c], dot);
      sigma += dot;
    }
    s.sigma[t] = sigma;
  }
  layer1(a, 25, s.H1, s.H0, true, s.ws);
  layer1(a, 26, s.H0, s.H1, true, s.ws);
  layer1(a, 27, s.H1, s.H0, true, s.ws);
  layer1(a, 28, s.H0, s.H1, true, s.ws);
  layer1(a, 29, s.H1, s.head, false, s.ws);  // the rgb head
}

// Tile row t's [rgb logits | raw sigma] into out (row p).
__device__ __forceinline__ void write_packed(const Tiles& s, float* out,
                                             long long p, int t) {
  for (int c = 0; c < 3; ++c) out[p * 4 + c] = s.head[c * kRows + t];
  out[p * 4 + 3] = s.sigma[t];
}

struct Args {
  const float* z;     // (R, S)
  const float* o;     // (R, 3)
  const float* d;     // (R, 3)
  const float* emb;   // (R, 8)
  const float* cond;  // (R, cond_w)
  int cond_w;
  float* out;      // (P, 4) [rgb logits | raw sigma]
  float* raw_t;    // (P, carve raw) [warped | hyper | 0] or null
  long long rays;
  int samples;
  int code;  // the warp: 0 translation, 1 SE(3), 2 quaternion
  int plane;  // no sheet: the hyper coordinates are the embedding
  const float* scales;  // the trunk's window row (kSe3EncP fp32) or null
  const float* tmpl_scales;  // the template's window row (enc fp32) or null
  const float* alpha;    // (R, kAlphaCond) the alpha condition, or null
  const float* alpha_w;  // (kAlphaCond) its weights in the alpha head
  Net net;  // the table's layers (table_slots) in their slots
};

__global__ void __launch_bounds__(kThreads)
    level_fwd_f32(const Args a) {
  extern __shared__ float4 hn_f32_smem[];
  const int hyper = a.plane ? kEmbed : kSheetOut;
  const Carve c = carve_of(hyper, a.tmpl_scales != nullptr);
  const Tiles s(reinterpret_cast<float*>(hn_f32_smem), c.xf, 256,
                Wide::kWTile, c.raw);
  const int t = threadIdx.x;
  const long long n_pts = a.rays * a.samples;
  const long long p0 = (long long)blockIdx.x * kRows;

  // The rows' points o + z d (rows past the end: the origin).
  if (t < kRows) {
    const long long p = p0 + t;
    const bool valid = p < n_pts;
    const long long q = valid ? p / a.samples : 0;
    s.ray[t] = (int)q;
    const float z = valid ? a.z[p] : 0.f;
    for (int c = 0; c < 3; ++c)
      s.pts[c * kRows + t] =
          valid ? __fadd_rn(a.o[q * 3 + c], __fmul_rn(z, a.d[q * 3 + c]))
                : 0.f;
  }
  __syncthreads();

  if (!a.plane) {
    // The sheet: [posenc_orig(p, 7) | embedding | 0] -> 4 hyper
    // coordinates.
    encode_field(s.X, s.pts, kSheetFreq, kSheetEnc, a.emb, kEmbed, s.ray);
    __syncthreads();
    field(a.net, 7, 64, s);
    if (t < kRows)
      for (int c = 0; c < kSheetOut; ++c)
        s.raw[(3 + c) * kRows + t] = s.head[c * kRows + t];
  } else if (t < kRows) {
    // No sheet: the hyper coordinates are the ray's embedding.
    for (int c = 0; c < kEmbed; ++c)
      s.raw[(3 + c) * kRows + t] = a.emb[(long long)s.ray[t] * kEmbed + c];
  }

  if (a.code == 0) {
    // The warp field: [posenc_orig(p, 10) | embedding | 0] -> the offset.
    encode_field(s.X, s.pts, kWarpFreq, kWarpEnc, a.emb, kEmbed, s.ray);
    __syncthreads();
    field(a.net, 0, 128, s);
    if (t < kRows)
      for (int c = 0; c < 3; ++c)
        s.raw[c * kRows + t] =
            __fadd_rn(s.pts[c * kRows + t], s.head[c * kRows + t]);
  } else {
    // The trunk on its encoding -> (w, v), then the retraction.
    encode_trunk(s.X, s.pts, a.emb, kEmbed, s.ray, a.scales);
    __syncthreads();
    trunk(a.net, s);
    if (t < kRows) retract_row(s, t, a.code == 2);
  }
  __syncthreads();

  // The template on [warped | hyper], in the layout of its window row.
  encode_template(s, hyper, a.tmpl_scales, c.xf);
  __syncthreads();
  template_stage(a.net, s, a.cond, a.cond_w, a.alpha, a.alpha_w);

  if (t < kRows) {
    const long long p = p0 + t;
    if (p < n_pts) {
      write_packed(s, a.out, p, t);
      if (a.raw_t != nullptr)
        for (int j = 0; j < c.raw; ++j)
          a.raw_t[p * c.raw + j] = j < 3 + hyper ? s.raw[j * kRows + t] : 0.f;
    }
  }
}

struct TemplateArgs {
  const float* x;  // (P, ldx) raw rows [xyz | hyper | 0]
  long long ldx;
  int hyper;  // hyper coordinates: 4, or 0 (static); the plane layouts' 8
  const float* cond;  // (P / S, cond_w)
  int cond_w;
  const float* scales;   // the window row (carve xf fp32: Nerfies) or null
  const float* alpha;    // (P / S, kAlphaCond) the alpha condition, or null
  const float* alpha_w;  // (kAlphaCond) its weights in the alpha head
  float* out;  // (P, 4) [rgb logits | raw sigma]
  long long rows;
  int samples;
  Net net;  // the template's blobs, at the table's rows 14..29
};

// The template alone: the level forward's template stage on raw rows, the
// condition of row p the condition row p / S.
__global__ void __launch_bounds__(kThreads)
    template_fwd_f32(const TemplateArgs a) {
  extern __shared__ float4 hn_f32_smem[];
  const Carve c = carve_of(a.hyper, a.scales != nullptr);
  const Tiles s(reinterpret_cast<float*>(hn_f32_smem), c.xf, 256,
                Wide::kWTile, c.raw);
  const int t = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * kRows;
  if (t < kRows) {
    const long long p = p0 + t;
    const bool valid = p < a.rows;
    s.ray[t] = valid ? (int)(p / a.samples) : 0;
    for (int j = 0; j < 3 + a.hyper; ++j)
      s.raw[j * kRows + t] = valid ? a.x[p * a.ldx + j] : 0.f;
  }
  __syncthreads();
  encode_template(s, a.hyper, a.scales, c.xf);
  __syncthreads();
  template_stage(a.net, s, a.cond, a.cond_w, a.alpha, a.alpha_w);
  if (t < kRows && p0 + t < a.rows) write_packed(s, a.out, p0 + t, t);
}

struct TrunkArgs {
  const float* x;       // (P, 3 + kEmbed) raw rows [points | embedding]
  const float* scales;  // the window row (kSe3EncP fp32) or null
  float* out;           // (P, 8) [w | v | 0 0]
  long long rows;
  Net net;  // the trunk's blobs, at the slots kTrunk0..
};

// The SE(3) trunk alone: the level forward's trunk stage on raw rows.
__global__ void __launch_bounds__(kThreads) trunk_fwd_f32(const TrunkArgs a) {
  extern __shared__ float4 hn_f32_smem[];
  const Tiles s(reinterpret_cast<float*>(hn_f32_smem), kSe3EncP, kSe3W,
                Narrow::kWTile);
  constexpr int kRaw = 3 + kEmbed;
  const int t = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * kRows;
  if (t < kRows) {
    const long long p = p0 + t;
    const bool valid = p < a.rows;
    s.ray[t] = valid ? (int)p : 0;
    for (int c = 0; c < 3; ++c)
      s.pts[c * kRows + t] = valid ? a.x[p * kRaw + c] : 0.f;
  }
  __syncthreads();
  encode_trunk(s.X, s.pts, a.x + 3, kRaw, s.ray, a.scales);
  __syncthreads();
  trunk(a.net, s);
  if (t < kRows && p0 + t < a.rows)
    for (int c = 0; c < 8; ++c)
      a.out[(p0 + t) * 8 + c] = c < 3   ? s.H1[c * kRows + t]
                                : c < 6 ? s.head[(c - 3) * kRows + t]
                                        : 0.f;
}

struct FieldArgs {
  const float* x;       // (P, 3 + kEmbed) raw rows [points | embedding]
  const float* scales;  // the window row (enc fp32) or null
  float* out;           // (P, 8) [the head's outputs | 0]
  long long rows;
  int first, width, freq, enc;  // the field: its table rows, encoding
  Net net;  // the field's blobs, at its rows of the table
};

// A field alone: the level forward's field stage on raw rows.
__global__ void __launch_bounds__(kThreads) field_fwd_f32(const FieldArgs a) {
  extern __shared__ float4 hn_f32_smem[];
  const Tiles s(reinterpret_cast<float*>(hn_f32_smem), kWarpEnc, 128,
                Narrow::kWTile);
  constexpr int kRaw = 3 + kEmbed;
  const int t = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * kRows;
  if (t < kRows) {
    const long long p = p0 + t;
    const bool valid = p < a.rows;
    s.ray[t] = valid ? (int)p : 0;
    for (int c = 0; c < 3; ++c)
      s.pts[c * kRows + t] = valid ? a.x[p * kRaw + c] : 0.f;
  }
  __syncthreads();
  encode_field(s.X, s.pts, a.freq, a.enc, a.x + 3, kRaw, s.ray, a.scales);
  __syncthreads();
  field(a.net, a.first, a.width, s);
  if (t < kRows && p0 + t < a.rows)
    for (int c = 0; c < 8; ++c)
      a.out[(p0 + t) * 8 + c] = s.head[c * kRows + t];
}

// A slot's (n_pad, k_pad): the trunk's rows, or the flagship table's with
// the template's first layer (14) and skip (19) on `enc` encoding columns.
void slot_shape(int slot, int enc, int& n, int& k) {
  if (slot >= kTrunk0) {
    n = kTrunkN[slot - kTrunk0];
    k = kTrunkK[slot - kTrunk0];
    return;
  }
  n = kShapeN[slot];
  k = slot == 14 || slot == 19 ? kShapeK[slot] - kTmplEnc + enc
                               : kShapeK[slot];
}

// The layers of table code `code`, as slots in the order of its blob: the
// warp's (the translation warp's rows 0..6, or the trunk's nine in the
// slots kTrunk0..), the sheet's 7..13 (the sheet tables, codes below
// kPlaneCodes), the template's 14..29. Returns their number.
int table_slots(int code, int* slots) {
  int n = 0;
  if (code % 3)
    for (int l = 0; l < kTrunkLayers; ++l) slots[n++] = kTrunk0 + l;
  else
    for (int l = 0; l < 7; ++l) slots[n++] = l;
  for (int l = code < kPlaneCodes ? 7 : 14; l < kLayers; ++l) slots[n++] = l;
  return n;
}

// The `count` slots laid out in a blob of their own, in order, the
// template's encoding `enc` columns wide.
Offsets place(const int* slots, int count, int enc = kTmplEnc) {
  Offsets off{};
  long long at_w = 0;
  int at_b = 0;
  for (int i = 0; i < count; ++i) {
    const int slot = slots[i];
    slot_shape(slot, enc, off.n[slot], off.k[slot]);
    off.w[slot] = at_w;
    off.b[slot] = at_b;
    at_w += (long long)off.n[slot] * off.k[slot];
    at_b += off.n[slot];
  }
  return off;
}

// Rows [first, last) of the flagship table laid out in a blob of their
// own, in order, after the trunk's nine where `trunk` (a stage alone: the
// template, a field, the trunk).
Offsets table_offsets(int first, int last, bool trunk = false,
                      int enc = kTmplEnc) {
  int slots[kSlots], n = 0;
  if (trunk)
    for (int l = 0; l < kTrunkLayers; ++l) slots[n++] = kTrunk0 + l;
  for (int l = first; l < last; ++l) slots[n++] = l;
  return place(slots, n, enc);
}

// Raise a kernel's dynamic shared memory limit to `bytes`, once.
template <class K>
cudaError_t allow_smem(K kernel, int bytes, bool& ready) {
  if (ready) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) ready = true;
  return e;
}

unsigned tiles_of(long long rows) {
  return (unsigned)((rows + kRows - 1) / kRows);
}

}  // namespace lvl
}  // namespace

using namespace lvl;

// The float32 table of table code `code` (0..8: kernels/common.py
// TABLE_CODES): each layer's (n_pad, k_pad) in the order of its blob
// (written up to max_layers); returns the number of layers, or -1 for a
// code out of range. The sheet tables' are the flagship table (code 0) or
// the trunk's rows, then its 7..29; a plane table's the warp's, then the
// template's at its layout's encoding (K = 192 and 448: the posenc_orig
// plane layout, codes 3 to 5; 128 and 384: the Nerfies one, 6 to 8).
extern "C" int hn_f32_table_layout(int code, int* n, int* k,
                                   int max_layers) {
  if (code < 0 || code >= kCodes) return -1;
  int slots[kSlots];
  const int count = table_slots(code, slots);
  const int enc = code >= kPlaneCodes && code < 2 * kPlaneCodes
                      ? kPlaneEnc
                      : lvl::kTmplEnc;
  for (int i = 0; i < count && i < max_layers; ++i)
    slot_shape(slots[i], enc, n[i], k[i]);
  return count;
}

// z (R, S), o / d (R, 3), emb (R, 8), cond (R, cond_w) fp32, cond_w <= 48;
// w the packed fp32 weights of the level's table transposed layer by layer
// (common.py's blob, each layer (k_pad, n_pad) row-major), b its biases;
// code the table (hn_f32_table_layout's: 0 translation, the flagship
// table; 1 SE(3), 2 quaternion: the trunk's rows, then the flagship
// table's 7..29; 3 to 8 the plane tables, no sheet, the warp of code % 3:
// 3 to 5 the posenc_orig plane layout, 6 to 8 the Nerfies one, which takes
// a window row); scales the trunk's window row (kSe3EncP fp32) or null (no
// window; always with the translation warp); tmpl_scales the template's
// window row (its encoding's slots of fp32: the Nerfies layouts) or null
// (posenc_orig); alpha_cond (R, 8) fp32 and alpha_w (8) fp32, the alpha
// condition and its weights in the alpha head, both or neither; out (R *
// S, 4) fp32 and, if not null, raw_t (R * S, 8) fp32 ((R * S, 16), [warped
// | embedding | 0], in a plane table). Returns a CUDA error code.
extern "C" int hn_f32_level_fwd(const float* z, const float* o,
                                const float* d, const float* emb,
                                const float* cond, int cond_w,
                                const float* w, const float* b, int code,
                                const float* scales, const float* tmpl_scales,
                                const float* alpha_cond, const float* alpha_w,
                                float* out, float* raw_t, long long rays,
                                int samples, cudaStream_t stream) {
  const bool plane = code >= kPlaneCodes;
  if (cond_w < 0 || cond_w > kCondPad || samples <= 0 || code < 0 ||
      code >= kCodes || (code % 3 == 0 && scales != nullptr) ||
      (plane && (code >= 2 * kPlaneCodes) != (tmpl_scales != nullptr)) ||
      (alpha_cond == nullptr) != (alpha_w == nullptr))
    return 1;
  const long long n_pts = rays * samples;
  if (n_pts == 0) return 0;
  static bool ready = false;
  const cudaError_t e = allow_smem(level_fwd_f32, kPlaneSmemBytes, ready);
  if (e != cudaSuccess) return e;
  const Carve c =
      carve_of(plane ? lvl::kEmbed : kSheetOut, tmpl_scales != nullptr);
  int slots[kSlots];
  const int count = table_slots(code, slots);
  const Args a{z,       o,           d,          emb,
               cond,    cond_w,      out,        raw_t,
               rays,    samples,     code % 3,   plane,
               scales,  tmpl_scales, alpha_cond, alpha_w,
               {w, b, place(slots, count, c.xf)}};
  level_fwd_f32<<<tiles_of(n_pts), kThreads, carve_bytes(c), stream>>>(a);
  return cudaGetLastError();
}

// The template alone (the level's template stage): x (rows, ldx) fp32 raw
// rows [xyz | hyper | 0] with `hyper` hyper coordinates (4; 8, the plane
// layouts'; or 0 for a template without them, whose encoding's hyper bands
// are then zero); cond (rows / samples, cond_w) fp32, cond_w <= 48,
// condition row q for rows q S .. q S + S - 1 (S = 1 included); scales the
// window row (the encoding's slots of fp32: the Nerfies layouts) or null
// (posenc_orig); alpha_cond (rows / samples, 8) fp32 and alpha_w (8) fp32,
// both or neither; w, b the template's own fp32 blobs (w transposed layer
// by layer, the float32 table's rows 14..29 at the layout's encoding: its
// first layer's K 192 in the posenc_orig plane layout, else 128); out
// (rows, 4) fp32 [rgb logits | raw sigma].
extern "C" int hn_f32_template_fwd(const float* x, long long ldx, int hyper,
                                   const float* cond, int cond_w,
                                   const float* scales,
                                   const float* alpha_cond,
                                   const float* alpha_w, const float* w,
                                   const float* b, float* out, long long rows,
                                   int samples, cudaStream_t stream) {
  if ((hyper != 0 && hyper != kSheetOut && hyper != lvl::kEmbed) ||
      ldx < 3 + hyper || cond_w < 0 || cond_w > kCondPad || samples <= 0 ||
      rows % samples || rows / samples > 0x7fffffffLL ||
      (alpha_cond == nullptr) != (alpha_w == nullptr))
    return 1;
  if (rows == 0) return 0;
  static bool ready = false;
  const cudaError_t e = allow_smem(template_fwd_f32, kPlaneSmemBytes, ready);
  if (e != cudaSuccess) return e;
  const Carve c = carve_of(hyper, scales != nullptr);
  const TemplateArgs a{x,       ldx,        hyper,   cond, cond_w,
                       scales,  alpha_cond, alpha_w, out,  rows,
                       samples, {w, b, table_offsets(14, kLayers, false,
                                                     c.xf)}};
  template_fwd_f32<<<tiles_of(rows), kThreads, carve_bytes(c), stream>>>(a);
  return cudaGetLastError();
}

// The SE(3) trunk alone (the level's trunk stage): x (rows, 11) fp32 raw
// rows [points | embedding]; scales its window row (kSe3EncP fp32) or
// null; w, b the trunk's own fp32 blobs (w transposed layer by layer); out
// (rows, 8) fp32 [w | v | 0 0].
extern "C" int hn_f32_trunk_fwd(const float* x, const float* scales,
                                const float* w, const float* b, float* out,
                                long long rows, cudaStream_t stream) {
  if (rows > 0x7fffffffLL) return 1;
  if (rows == 0) return 0;
  static bool ready = false;
  const cudaError_t e = allow_smem(trunk_fwd_f32, kTrunkSmemBytes, ready);
  if (e != cudaSuccess) return e;
  const TrunkArgs a{x, scales, out, rows, {w, b, table_offsets(0, 0, true)}};
  trunk_fwd_f32<<<tiles_of(rows), kThreads, kTrunkSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

// A field alone (the level's field stage): which 0 the warp field (the
// table's rows 0..6), 1 the sheet (7..13); x (rows, 11) fp32 raw rows
// [points | embedding]; scales the window row (the field's packed encoding
// columns, 80 or 64 fp32) or null; w, b the field's own fp32 blobs (w
// transposed layer by layer); out (rows, 8) fp32 [the head's outputs | 0].
extern "C" int hn_f32_field_fwd(int which, const float* x,
                                const float* scales, const float* w,
                                const float* b, float* out, long long rows,
                                cudaStream_t stream) {
  if ((which != 0 && which != 1) || rows > 0x7fffffffLL) return 1;
  if (rows == 0) return 0;
  static bool ready = false;
  const cudaError_t e = allow_smem(field_fwd_f32, kFieldSmemBytes, ready);
  if (e != cudaSuccess) return e;
  const int first = which ? 7 : 0;
  const FieldArgs a{x,
                    scales,
                    out,
                    rows,
                    first,
                    which ? 64 : 128,
                    which ? kSheetFreq : kWarpFreq,
                    which ? kSheetEnc : kWarpEnc,
                    {w, b, table_offsets(first, first + 7)}};
  field_fwd_f32<<<tiles_of(rows), kThreads, kFieldSmemBytes, stream>>>(a);
  return cudaGetLastError();
}
