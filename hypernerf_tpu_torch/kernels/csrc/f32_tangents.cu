// The float32 Jacobians for Hopper (sm_90a): the forwards of the warp's
// point-Jacobian, one kernel each, and the narrow steps of their backwards.
// At `compute_dtype='float32'` they replace the TPU kernels
// hypernerf_tpu/ops/pallas/fused_jacobian.py `_fused_fwd` (:269, row 14:
// the translation warp's field with its three point-tangent streams -> J)
// and `_fused_bwd` (:302, row 15), and
// hypernerf_tpu/ops/pallas/fused_se3_jacobian.py `_fused_fwd` (:286, row
// 16: the SE(3) / quaternion trunk's (w, v) and their point-tangents, with
// or without the window row) and `_fused_bwd` (:331, row 17). The bf16 rows
// 14 to 17 are tangents_fwd.cu, warp_tangents_bwd.cu and se3_tangents_bwd.cu.
//
// A point has four streams: its primal row and its tangent rows along p_0,
// p_1 and p_2. The tangent encoding along p_k is the primal encoding's
// derivative: [e_k | cos(p_k 2^j) 2^j and -sin(p_k 2^j) 2^j on channel k's
// band columns | 0] (the translation warp's posenc_orig of 10 bands,
// identity first; the trunk's bands have no identity and run from degree
// kSe3MinDeg, each feature times the window row where there is one). A
// hidden layer maps a tangent row t to (t W) * [its point's primal
// pre-activation > 0]: no bias, the primal row's ReLU mask. A linear layer
// (the trunk logit, a head) passes it unmasked. The skip concatenates the
// tangent encoding.
//
// Forward (rows 14 and 16), bound: operations (f32_chain.cuh). A block of
// 256 threads owns 16 points, a tile of 64 rows: tile row s * 16 + q is
// stream s of point q, so a thread's 8 rows (f32_chain.cuh Tile) lie in one
// stream. The stages of a field alone and the trunk alone (f32_level.cu:
// X, H0 and H1 feature-major, the Narrow tile's weight chunks, two blocks
// an SM) run on the 64 rows with a stream-aware epilogue (stream_layer):
// the primal rows take the bias and the ReLU and are written first; after a
// barrier each tangent row reads its point's primal output as its mask
// (ReLU(y) > 0 iff y > 0).
//
// Backward (rows 15 and 17): sequences of f32_steps.cu's steps over chunks
// of points (kernels/f32.py jacobian_bwd_steps, either Jacobian). A
// chunk's n points are 4 n stash rows, stream s of point q at row s n + q;
// rowprod takes the tangent rows' masks from the n primal rows (the mask's
// rows repeat) and dw sums a layer's db over the primal rows alone (its
// db_rows). The steps here: the streams' encoding (hn_f32_stream_encode),
// the output's cotangent as rows of the streams (hn_f32_stream_cot), and
// the encoding's cotangent pulled back to the points
// (hn_f32_stream_enc_bwd). Bound: bytes.

#include <type_traits>

#include "f32_chain.cuh"
#include "se3_trunk.cuh"  // the trunk's widths (level_common.cuh)

namespace {
// Its own namespace: level_common.cuh declares the widths it reads.
namespace jac {

using namespace f32;

constexpr int kStreams = 4;                // the primal row, three tangents
constexpr int kPoints = kRows / kStreams;  // 16 points a tile
constexpr int kRaw = 3 + kEmbed;           // a raw row [point | embedding]
constexpr int kW = kWarpW;                 // both networks' hidden width
static_assert(kSe3W == kW && kW <= Narrow::kCols, "one Narrow pass a layer");
static_assert(kPoints % Narrow::TR == 0, "a thread's rows in one stream");
constexpr int kEncMax = kWarpEncP;  // X's features: the wider encoding
static_assert(kSe3EncP <= kEncMax, "X holds the trunk's encoding");
constexpr int kJac = 9, kWv = 24;  // output columns a point

// A network's encoding: the translation warp field's posenc_orig (identity
// columns, kWarpF bands from degree 0) or the trunk's (no identity, kSe3F
// bands from kSe3MinDeg), then the embedding, `cols` features in all.
struct Enc {
  bool ident;
  int F, min_deg, cols;
};
__host__ __device__ constexpr Enc enc_of(bool trunk) {
  return trunk ? Enc{false, kSe3F, kSe3MinDeg, kSe3EncP}
               : Enc{true, kWarpF, 0, kWarpEncP};
}

// Feature f of stream s's encoding of a point p (3 floats) whose embedding
// is emb (kEmbed floats, read for the primal stream alone): stream 0 the
// encoding [p | sin bands | cos bands | embedding | 0] (band j of channel c
// at 3 j + c, degree e.min_deg + j; no p without e.ident), stream k + 1 its
// derivative along p_k. Band arguments p 2^deg are exact; sin / cos are
// the accurate ones (no fast math).
__device__ __forceinline__ float stream_feature(const float* p,
                                                const float* emb, int s,
                                                int f, Enc e) {
  const int at = e.ident ? 3 : 0, nb = 3 * e.F;
  if (f < at) return s == 0 ? p[f] : (f == s - 1 ? 1.f : 0.f);
  f -= at;
  if (f < 2 * nb) {
    const bool is_cos = f >= nb;
    const int b = is_cos ? f - nb : f, c = b % 3, deg = e.min_deg + b / 3;
    if (s != 0 && c != s - 1) return 0.f;
    const float arg = ldexpf(p[c], deg);
    if (s == 0) return is_cos ? cosf(arg) : sinf(arg);
    const float scale = ldexpf(1.f, deg);
    return is_cos ? -sinf(arg) * scale : cosf(arg) * scale;
  }
  f -= 2 * nb;
  return s == 0 && f < kEmbed ? emb[f] : 0.f;
}

// A layer on the tile's kPoints points x kStreams streams (f32_chain.cuh
// tile_passes with a stream-aware epilogue, Narrow passes): out[n * kRows +
// r] = the product of row r and the layer's transposed weight w (k, N);
// the primal rows add the bias and, where `relu`, take the ReLU; a tangent
// row adds no bias and, where `relu`, is zero unless its point's primal
// pre-activation is positive, read from the primal row's output once the
// primal rows are written. Every thread calls it; it ends with a barrier.
template <int NSeg>
__device__ void stream_layer(const Seg (&segs)[NSeg], const float* w, int N,
                             const float* bias, bool relu, float* out,
                             float* ws) {
  using T = Narrow;
  const int K = seg_width(segs);
  const int r = T::row();
  const bool primal = r < kPoints;
  for (int n0 = 0; n0 < N; n0 += T::kCols) {
    float acc[T::TR][T::TC];
    pass_product<T>(acc, segs, w, N, K, n0, N, ws);
    auto write = [&](bool primal_rows) {
#pragma unroll
      for (int j = 0; j < T::TC; ++j) {
        const int n = n0 + T::col(j);
        if (n >= N) continue;
        const float b = primal_rows ? __ldg(bias + n) : 0.f;
#pragma unroll
        for (int q = 0; q < T::TR / 4; ++q) {
          const int row = r + 4 * q;
          float4 m = make_float4(1.f, 1.f, 1.f, 1.f);
          if (relu && !primal_rows)
            m = *reinterpret_cast<const float4*>(out + n * kRows +
                                                 row % kPoints);
          const float mk[4] = {m.x, m.y, m.z, m.w};
          float y[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            y[i] = acc[4 * q + i][j] + b;
            if (relu)
              y[i] = primal_rows ? fmaxf(y[i], 0.f)
                                 : (mk[i] > 0.f ? y[i] : 0.f);
          }
          *reinterpret_cast<float4*>(out + n * kRows + row) =
              make_float4(y[0], y[1], y[2], y[3]);
        }
      }
    };
    if (primal) write(true);
    __syncthreads();
    if (!primal) write(false);
  }
  __syncthreads();
}

struct FwdArgs {
  const float* x;       // (P, kRaw) raw rows [points | embedding]
  const float* scales;  // the trunk's window row (kSe3EncP fp32) or null
  const float* w;       // the network's weights, transposed layer by layer
  const float* b;       // its biases
  float* out;           // (P, kJac) J, or (P, kWv) [w | v | dw | dv]
  long long points;
};

// Layer L of the network (level_common.cuh's table Table: the translation
// warp field's layers 0..6 of TransTable, the trunk's 0..8 of Se3Table;
// its blob holds those layers alone, in order) on x, or on [x | x1] (the
// skip: kW features, then the encoding).
template <class Table, int L>
__device__ __forceinline__ void net_layer(const FwdArgs& a, const float* x,
                                          float* out, bool relu, float* ws,
                                          const float* x1 = nullptr) {
  constexpr Shape sh = Table::shape(L);
  const float* w = a.w + weight_offset<Table>(L);
  const float* b = a.b + bias_offset<Table>(L);
  if (x1 == nullptr) {
    const Seg segs[1] = {{x, sh.k}};
    stream_layer(segs, w, sh.n, b, relu, out, ws);
  } else {
    const Seg segs[2] = {{x, kW}, {x1, sh.k - kW}};
    stream_layer(segs, w, sh.n, b, relu, out, ws);
  }
}

// Shared memory: X (kEncMax features), H0 and H1 (kW), the Narrow tile's
// weight chunks, a head's 8 outputs, the tile's 16 points.
constexpr int kSmemBytes =
    4 * (kEncMax * kRows + 2 * kW * kRows + 2 * Narrow::kWTile + 8 * kRows +
         3 * kPoints);
static_assert(2 * (kSmemBytes + 1024) <= 233472, "two blocks an SM");

// Row 14 (kTrunk false): the warp field on a tile's streams, the head into
// `head`; J[i * 3 + k] = delta_ik + the head's column i on tangent k's row.
// Row 16 (kTrunk): the trunk, the linear trunk logit into H0, the w head
// into H1 and the v head into `head`; [w | v] of the primal row, dw[i * 3 +
// k] and dv[i * 3 + k] of tangent k's row.
template <bool kTrunk>
__global__ void __launch_bounds__(kThreads)
    tangents_fwd_f32(const FwdArgs a) {
  using Table = std::conditional_t<kTrunk, Se3Table, TransTable>;
  extern __shared__ float4 hn_f32_smem[];
  float* X = reinterpret_cast<float*>(hn_f32_smem);
  float* H0 = X + kEncMax * kRows;
  float* H1 = H0 + kW * kRows;
  float* ws = H1 + kW * kRows;
  float* head = ws + 2 * Narrow::kWTile;
  float* pts = head + 8 * kRows;  // channel c of point q at c * kPoints + q
  const int t = threadIdx.x;
  const long long q0 = (long long)blockIdx.x * kPoints;
  if (t < kPoints) {
    const long long q = q0 + t;
    for (int c = 0; c < 3; ++c)
      pts[c * kPoints + t] = q < a.points ? a.x[q * kRaw + c] : 0.f;
  }
  __syncthreads();
  constexpr Enc e = enc_of(kTrunk);
  for (int i = t; i < e.cols * kRows; i += kThreads) {
    const int f = i / kRows, r = i % kRows, s = r / kPoints, q = r % kPoints;
    const float p[3] = {pts[q], pts[kPoints + q], pts[2 * kPoints + q]};
    const long long row = q0 + q < a.points ? q0 + q : 0;
    const float v = stream_feature(p, a.x + row * kRaw + 3, s, f, e);
    X[i] = a.scales != nullptr ? v * a.scales[f] : v;
  }
  __syncthreads();
  net_layer<Table, 0>(a, X, H0, true, ws);
  net_layer<Table, 1>(a, H0, H1, true, ws);
  net_layer<Table, 2>(a, H1, H0, true, ws);
  net_layer<Table, 3>(a, H0, H1, true, ws);
  net_layer<Table, 4>(a, H1, H0, true, ws);
  net_layer<Table, 5>(a, H0, H1, true, ws, X);  // the skip: [h4 | encoding]
  if constexpr (kTrunk) {
    net_layer<Table, 6>(a, H1, H0, false, ws);    // the trunk logit, linear
    net_layer<Table, 7>(a, H0, H1, false, ws);    // the w head
    net_layer<Table, 8>(a, H0, head, false, ws);  // the v head
    for (int i = t; i < kPoints * kWv; i += kThreads) {
      const int q = i / kWv, j = i % kWv;
      const long long p = q0 + q;
      if (p >= a.points) continue;
      // [w | v]: the primal row; [dw | dv]: column i of tangent k's row.
      const int m = j < 6 ? j : (j - 6) % 9;
      const bool v_head = j < 6 ? j >= 3 : j >= 15;
      const int col = j < 6 ? j % 3 : m / 3, s = j < 6 ? 0 : 1 + m % 3;
      a.out[p * kWv + j] = (v_head ? head : H1)[col * kRows + s * kPoints + q];
    }
  } else {
    net_layer<Table, 6>(a, H1, head, false, ws);  // the head, linear
    for (int i = t; i < kPoints * kJac; i += kThreads) {
      const int q = i / kJac, j = i % kJac, c = j / 3, k = j % 3;
      const long long p = q0 + q;
      if (p >= a.points) continue;
      a.out[p * kJac + j] =
          head[c * kRows + (k + 1) * kPoints + q] + (c == k ? 1.f : 0.f);
    }
  }
}

template <bool kTrunk>
int launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        tangents_fwd_f32<kTrunk>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const unsigned blocks = (unsigned)((a.points + kPoints - 1) / kPoints);
  tangents_fwd_f32<kTrunk><<<blocks, kThreads, kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

// out[(s n + q) * ldo + f], f < pad: stream s's encoding of raw row q (x +
// q * ldx: [point | embedding]) for the warp field (trunk 0) or the trunk
// (1), times the window row where there is one (pad fp32). A thread per
// element.
__global__ void stream_encode_f32(int trunk, const float* x, long long ldx,
                                  const float* scales, float* out,
                                  long long ldo, int pad, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kStreams * n * pad) return;
  const long long row = i / pad;
  const int f = (int)(i % pad), s = (int)(row / n);
  const float* xr = x + (row % n) * ldx;
  const float v = stream_feature(xr, xr + 3, s, f, enc_of(trunk));
  out[row * ldo + f] = scales != nullptr ? v * scales[f] : v;
}

// The output's cotangent g (row q at g + q * ldg) as the rows of the
// streams, out[row * ldo + c], zero past the heads' columns: J's (trunk 0,
// g (n, 9) in J's [i * 3 + k] order) on the tangent rows alone, tangent k's
// row k n + q [g[3 i + k] (i = 0..2) | 0]; [w | v | dw | dv]'s (trunk 1, g
// (n, 24)) on all four streams, the primal row q [g[0..5] | 0] and tangent
// k's row (k + 1) n + q [g[6 + 3 i + k] | g[15 + 3 i + k] | 0]. A thread
// per element.
__global__ void stream_cot_f32(int trunk, const float* g, long long ldg,
                               float* out, long long ldo, long long n) {
  const int streams = trunk ? kStreams : kStreams - 1;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= streams * n * ldo) return;
  const long long row = i / ldo, q = row % n;
  const int c = (int)(i % ldo), s = (int)(row / n) + (trunk ? 0 : 1);
  const float* gq = g + q * ldg;
  float v = 0.f;
  if (trunk && c < 6)
    v = s == 0 ? gq[c] : gq[6 + 9 * (c / 3) + 3 * (c % 3) + s - 1];
  else if (!trunk && c < 3)
    v = gq[3 * c + s - 1];
  out[row * ldo + c] = v;
}

// dx[q * lddx + ...] of raw row q (x + q * ldx) from the encoding's
// cotangent g of the streams (row s n + q at ldg: the trunk's four, trunk
// 1; the warp field's three tangent streams, trunk 0), each column first
// times the window row where there is one: d p_c = the primal encoding's
// VJP (trunk: sum over the bands of 2^d (cos(p_c 2^d) g_sin - sin(p_c 2^d)
// g_cos)) + tangent c's (the derivative of its band columns: of cos(p_c
// 2^d) 2^d, -sin(p_c 2^d) 4^d; of -sin(p_c 2^d) 2^d, -cos(p_c 2^d) 4^d);
// d embed = the primal row's embedding columns (the translation warp's:
// 0, J reaches no embedding). A thread per point.
__global__ void stream_enc_bwd_f32(int trunk, const float* x, long long ldx,
                                   const float* scales, const float* g,
                                   long long ldg, float* dx, long long lddx,
                                   long long n) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  const Enc e = enc_of(trunk);
  const int at = e.ident ? 3 : 0, nb = 3 * e.F;
  const float* gp = trunk ? g + q * ldg : nullptr;  // the primal row
  auto wt = [&](int f) { return scales != nullptr ? scales[f] : 1.f; };
  float* out = dx + q * lddx;
  for (int c = 0; c < 3; ++c) {
    const float xc = x[q * ldx + c];
    const float* gt = g + (((trunk ? 1 : 0) + c) * n + q) * ldg;
    float primal = 0.f, tangent = 0.f;
    for (int j = 0; j < e.F; ++j) {
      const int deg = e.min_deg + j;
      const float arg = ldexpf(xc, deg), scale = ldexpf(1.f, deg);
      const float sn = sinf(arg), cs = cosf(arg);
      const int fs = at + 3 * j + c, fc = at + nb + 3 * j + c;
      if (gp != nullptr)
        primal += scale * (cs * (gp[fs] * wt(fs)) - sn * (gp[fc] * wt(fc)));
      tangent += (-sn * (gt[fs] * wt(fs)) - cs * (gt[fc] * wt(fc))) * scale *
                 scale;
    }
    out[c] = primal + tangent;
  }
  for (int c = 0; c < kEmbed; ++c) {
    const int f = at + 2 * nb + c;
    out[3 + c] = gp != nullptr ? gp[f] * wt(f) : 0.f;
  }
}

constexpr int kFlat = 256;  // threads a block of the elementwise steps

unsigned flat_blocks(long long n) {
  return (unsigned)((n + kFlat - 1) / kFlat);
}

}  // namespace jac
}  // namespace

using namespace jac;

// Row 14: x (points, 11) fp32 raw rows [points | embedding]; w, b the warp
// field's own fp32 blobs (w transposed layer by layer, TransTable's layers
// 0..6); out (points, 9) fp32 J[i * 3 + k] = d warped_i / d p_k.
extern "C" int hn_f32_jacobian_fwd(const float* x, const float* w,
                                   const float* b, float* out,
                                   long long points, cudaStream_t stream) {
  if (points < 0) return 1;
  if (points == 0) return 0;
  return launch_fwd<false>(FwdArgs{x, nullptr, w, b, out, points}, stream);
}

// Row 16: x as row 14's; scales the trunk's window row (kSe3EncP fp32) or
// null; w, b the trunk's own fp32 blobs (w transposed layer by layer,
// Se3Table's layers 0..8); out (points, 24) fp32 [w | v | dw | dv].
extern "C" int hn_f32_se3_jacobian_fwd(const float* x, const float* scales,
                                       const float* w, const float* b,
                                       float* out, long long points,
                                       cudaStream_t stream) {
  if (points < 0) return 1;
  if (points == 0) return 0;
  return launch_fwd<true>(FwdArgs{x, scales, w, b, out, points}, stream);
}

// The four streams' encoding of n raw rows x (n, >= 11 at ldx) into out (4
// n rows at ldo, pad columns: at least the network's encoding; scales pad
// fp32 or null). trunk 0: the translation warp field's, 1: the trunk's.
extern "C" int hn_f32_stream_encode(int trunk, const float* x, long long ldx,
                                    const float* scales, float* out,
                                    long long ldo, int pad, long long n,
                                    cudaStream_t stream) {
  if ((trunk != 0 && trunk != 1) || ldx < kRaw ||
      pad < enc_of(trunk).cols || ldo < pad)
    return 1;
  if (n == 0) return 0;
  stream_encode_f32<<<flat_blocks(kStreams * n * pad), kFlat, 0, stream>>>(
      trunk, x, ldx, scales, out, ldo, pad, n);
  return cudaGetLastError();
}

// g (n, >= 9 or 24 at ldg) -> out (3 n or 4 n rows, ldo >= 3 or 6).
extern "C" int hn_f32_stream_cot(int trunk, const float* g, long long ldg,
                                 float* out, long long ldo, long long n,
                                 cudaStream_t stream) {
  if ((trunk != 0 && trunk != 1) || ldg < (trunk ? kWv : kJac) ||
      ldo < (trunk ? 6 : 3))
    return 1;
  if (n == 0) return 0;
  const int streams = trunk ? kStreams : kStreams - 1;
  stream_cot_f32<<<flat_blocks(streams * n * ldo), kFlat, 0, stream>>>(
      trunk, g, ldg, out, ldo, n);
  return cudaGetLastError();
}

// x (n, >= 11 at ldx); g (4 n or 3 n rows at ldg, at least the network's
// encoding); scales its window row or null; dx (n, >= 11 at lddx).
extern "C" int hn_f32_stream_enc_bwd(int trunk, const float* x,
                                     long long ldx, const float* scales,
                                     const float* g, long long ldg,
                                     float* dx, long long lddx, long long n,
                                     cudaStream_t stream) {
  if ((trunk != 0 && trunk != 1) || ldx < kRaw || lddx < kRaw ||
      ldg < enc_of(trunk).cols)
    return 1;
  if (n == 0) return 0;
  stream_enc_bwd_f32<<<flat_blocks(n), kFlat, 0, stream>>>(
      trunk, x, ldx, scales, g, ldg, dx, lddx, n);
  return cudaGetLastError();
}
