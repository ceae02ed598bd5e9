// Compositing backward for Hopper (sm_90a).
//
// Replaces hypernerf_tpu/ops/pallas/fused_composite.py `_fused_bwd` (:477,
// the tile body `_backward_tile` :325-378): the analytic VJP of sigmoid /
// softplus and volume rendering.
//
// In:  packed (P, 4) [rgb logits | raw sigma], z (R, S), directions (R, 3),
//      optional noise (R, S), d_outs (R, 6) = d[rgb (3) | depth | med_depth |
//      acc], d_weights (R, S).
// Out: d packed (P, 4) (its fourth column is also d noise), d z (R, S),
//      d dnorm (R, 1) for the directions' norm (the wrapper's autograd turns
//      it into d directions, as the TPU kernel leaves it to XLA).
//
// Bound: bytes: each ray reads 16 S + 4 S (+ 4 S noise) + 4 S + 36 bytes and
// writes 20 S + 4; at 16384 rays x 128 samples that is 105 MB, 31 us at the
// card's memory rate. The earlier design, a thread per ray walking its
// samples in series, read a warp's samples S floats apart and ran at 15 % of
// that bound. Design: a warp per ray (kWarps rays a block), its lanes over
// the samples in chunks of 32, every load and store coalesced (the packed
// rows as one float4 a lane). A forward pass recomputes the compositing
// forward exactly as csrc/fused_composite.cu computes it: the transmittance
// as a product scan of 1 - alpha + 1e-5 with a carry from one chunk to the
// next, the cumulative weight as a sum scan with its carry, the median
// sample as the first lane of a ballot on cum >= 0.5. It leaves each
// sample's packed row (noise added), depth and transmittance in the warp's
// shared memory. The backward pass then walks the chunks from the last: the
// strict tail sum_{t > s} g_w_t w_t, which d u = tail / u needs, is a
// reverse shuffle scan plus the carry of the later chunks; d z[s] takes its
// neighbour term d dist[s - 1] from lane s - 1 by a shuffle, and at a
// chunk's first lane from the next chunk down, so that write waits for the
// carry; d |d| is a warp sum. Sums run in another order than a sequential
// walk's, so the outputs move in their last bits.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // rays a block
constexpr float kEps = 1e-5f;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float softplus(float x) {
  // jax.nn.softplus: log1p(exp(-|x|)) + max(x, 0).
  return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.f);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Inclusive scans over the warp's lanes: a product and a sum from lane 0
// up, a sum from lane 31 down.
__device__ __forceinline__ float scan_prod(float v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(kAll, v, d);
    if (lane >= d) v = __fmul_rn(o, v);
  }
  return v;
}
__device__ __forceinline__ float scan_add(float v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(kAll, v, d);
    if (lane >= d) v = o + v;
  }
  return v;
}
__device__ __forceinline__ float scan_add_down(float v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_down_sync(kAll, v, d);
    if (lane + d < 32) v = v + o;
  }
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kAll, v, d);
  return v;
}

__global__ void __launch_bounds__(32 * kWarps)
composite_bwd_kernel(const float4* __restrict__ packed,
                     const float* __restrict__ z,
                     const float* __restrict__ dirs,
                     const float* __restrict__ noise,
                     const float* __restrict__ d_outs,
                     const float* __restrict__ d_weights,
                     float4* __restrict__ d_packed, float* __restrict__ d_z,
                     float* __restrict__ d_dnorm, long long n_rays, int S,
                     int white_bkgd, int sample_at_infinity) {
  // A warp's shared memory: the packed rows with the noise added (S
  // float4), then its depths (S) and transmittances (S) after all the
  // warps' rows.
  extern __shared__ float4 sh[];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * kWarps + wid;
  if (r >= n_rays) return;  // the whole warp
  float4* pks = sh + wid * S;
  float* zs = reinterpret_cast<float*>(sh + kWarps * S) + wid * 2 * S;
  float* trs = zs + S;

  const float* zr = z + r * S;
  const float4* pk = packed + r * S;
  const float* nr = noise != nullptr ? noise + r * S : nullptr;
  const float* dwr = d_weights + r * S;
  float4* dpk = d_packed + r * S;
  float* dzr = d_z + r * S;
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);
  const float last = sample_at_infinity ? 1e7f : 1e-7f;
  const float* go = d_outs + r * 6;
  const float d_r = go[0], d_g = go[1], d_b = go[2];
  const float d_depth = go[3], d_med = go[4], d_acc = go[5];
  const float white = white_bkgd ? d_r + d_g + d_b : 0.f;

  // Forward: the transmittance before each sample and the median sample,
  // as the forward kernel computes them.
  float carry_t = 1.f, carry_w = 0.f;
  int med = -1;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const bool in = s < S, has_next = s + 1 < S;
    const float zc = in ? zr[s] : 0.f;
    const float zn = has_next ? zr[s + 1] : 0.f;
    float4 p = in ? pk[s] : make_float4(0.f, 0.f, 0.f, 0.f);
    if (nr != nullptr && in) p.w += nr[s];
    const float dist = __fmul_rn(has_next ? zn - zc : last, dnorm);
    const float alpha =
        in ? 1.f - expf(-__fmul_rn(softplus(p.w), dist)) : 0.f;
    const float incl = scan_prod(in ? 1.f - alpha + kEps : 1.f, lane);
    float excl = __shfl_up_sync(kAll, incl, 1);
    if (lane == 0) excl = 1.f;
    const float tr = __fmul_rn(carry_t, excl);
    const float w = __fmul_rn(alpha, tr);
    carry_t = __fmul_rn(carry_t, __shfl_sync(kAll, incl, 31));
    const float cum = carry_w + scan_add(w, lane);
    carry_w = __shfl_sync(kAll, cum, 31);
    const unsigned hit = __ballot_sync(kAll, in && cum >= 0.5f);
    if (med < 0 && hit) med = s0 + __ffs(hit) - 1;
    if (in) {
      pks[s] = p;
      zs[s] = zc;
      trs[s] = tr;
    }
  }
  __syncwarp();

  // Backward, from the last chunk down.
  float tail = 0.f;     // sum of g_w w over the chunks already walked
  float pending = 0.f;  // d z of the first sample of the chunk above, less
                        // its neighbour term d dist of this chunk's last
  float dn = 0.f;
  for (int s0 = (S - 1) / 32 * 32; s0 >= 0; s0 -= 32) {
    const int s = s0 + lane;
    const bool in = s < S, has_next = s + 1 < S;
    const float4 p = in ? pks[s] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float sigma = softplus(p.w);
    const float zc = in ? zs[s] : 0.f;
    const float dist_raw = has_next ? zs[s + 1] - zc : last;
    const float dist = __fmul_rn(dist_raw, dnorm);
    const float e = expf(-__fmul_rn(sigma, dist));  // 1 - alpha
    const float alpha = 1.f - e;
    const float u = 1.f - alpha + kEps;
    const float tr = in ? trs[s] : 0.f;
    const float w = __fmul_rn(alpha, tr);
    const float cr = sigmoid(p.x), cg = sigmoid(p.y), cb = sigmoid(p.z);

    float g_w = (in ? dwr[s] : 0.f) + zc * d_depth;
    g_w += cr * d_r;
    g_w += cg * d_g;
    g_w += cb * d_b;
    g_w -= white;
    if (!sample_at_infinity || has_next) g_w += d_acc;
    const float gw_w = in ? g_w * w : 0.f;

    // The strict tail: the later lanes' sum, then the later chunks'.
    const float incl = scan_add_down(gw_w, lane);
    float later = __shfl_down_sync(kAll, incl, 1);
    if (lane == 31) later = 0.f;
    const float d_u = (tail + later) / u;
    tail += __shfl_sync(kAll, incl, 0);
    const float d_alpha = g_w * tr - d_u;
    const float exp_term = 1.f - alpha;
    const float d_sigma = d_alpha * dist * exp_term;
    const float d_dist = d_alpha * sigma * exp_term;
    const float d_raw = d_sigma * sigmoid(p.w);
    if (in)
      dpk[s] = make_float4(w * d_r * cr * (1.f - cr),
                           w * d_g * cg * (1.f - cg),
                           w * d_b * cb * (1.f - cb), d_raw);

    if (in) dn += d_dist * dist_raw;
    const float d_draw = has_next ? d_dist * dnorm : 0.f;
    // d z[s] = w d_depth + [s == med] d_med - d_draw[s] + d_draw[s - 1].
    const float own = w * d_depth + (s == med ? d_med : 0.f) - d_draw;
    const float below = __shfl_up_sync(kAll, d_draw, 1);
    if (in && lane > 0) dzr[s] = own + below;
    // The chunk above's first sample takes this chunk's last d_draw.
    if (lane == 31 && s0 + 32 < S) dzr[s0 + 32] = pending + d_draw;
    pending = __shfl_sync(kAll, own, 0);
  }
  if (lane == 0) dzr[0] = pending;
  dn = warp_sum(dn);
  if (lane == 0) d_dnorm[r] = dn;
}

}  // namespace

// Shared memory of a block: 24 bytes a sample of each of its kWarps rays.
extern "C" int hn_fused_composite_bwd(
    const void* packed, const void* z, const void* dirs, const void* noise,
    const void* d_outs, const void* d_weights, void* d_packed, void* d_z,
    void* d_dnorm, long long n_rays, int samples, int white_bkgd,
    int sample_at_infinity, void* stream) {
  const long long blocks = (n_rays + kWarps - 1) / kWarps;
  if (blocks <= 0) return (int)cudaGetLastError();
  if (samples <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (sizeof(float4) + 2 * sizeof(float)) * kWarps *
                      (size_t)samples;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  composite_bwd_kernel<<<(unsigned)blocks, 32 * kWarps, smem,
                         (cudaStream_t)stream>>>(
      static_cast<const float4*>(packed), static_cast<const float*>(z),
      static_cast<const float*>(dirs), static_cast<const float*>(noise),
      static_cast<const float*>(d_outs),
      static_cast<const float*>(d_weights), static_cast<float4*>(d_packed),
      static_cast<float*>(d_z), static_cast<float*>(d_dnorm), n_rays,
      samples, white_bkgd, sample_at_infinity);
  return (int)cudaGetLastError();
}
