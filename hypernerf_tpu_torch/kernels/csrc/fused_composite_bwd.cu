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
// Per ray: a forward scan recomputes the transmittance of every sample (kept
// in the d z output as scratch) and finds the median sample; a backward scan
// carries the reverse cumulative sum of g_w * w (as its strict tail, which
// is what d u = (rc - g_w w) / u needs) and one pending neighbour term of
// d z, and writes d packed and d z as it goes.
//
// Bound: bytes: each ray reads 16 S + 4 S (+ 4 S noise) + 4 S + 36 bytes and
// writes 20 S + 4; at 16384 rays x 128 samples that is 105 MB, 31 us at the
// card's memory rate. Design: one thread per ray, as the forward; the scans
// are sequential per ray and the accesses of a warp are S floats apart, so
// this first version is far from that bound (a warp per ray with shuffles
// for the two scans would coalesce).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float softplus(float x) {
  return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.f);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(kThreads)
composite_bwd_kernel(const float4* __restrict__ packed,
                     const float* __restrict__ z,
                     const float* __restrict__ dirs,
                     const float* __restrict__ noise,
                     const float* __restrict__ d_outs,
                     const float* __restrict__ d_weights,
                     float4* __restrict__ d_packed, float* __restrict__ d_z,
                     float* __restrict__ d_dnorm, long long n_rays, int S,
                     int white_bkgd, int sample_at_infinity) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
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

  // Forward scan: the transmittance before each sample, and the median one.
  float trans = 1.f, cum = 0.f;
  int med = -1;
  for (int s = 0; s < S; ++s) {
    const float raw = nr != nullptr ? pk[s].w + nr[s] : pk[s].w;
    const float dist =
        __fmul_rn(s + 1 < S ? zr[s + 1] - zr[s] : last, dnorm);
    const float alpha = 1.f - expf(-__fmul_rn(softplus(raw), dist));
    dzr[s] = trans;
    cum += __fmul_rn(alpha, trans);
    if (med < 0 && cum >= 0.5f) med = s;
    trans = __fmul_rn(trans, 1.f - alpha + kEps);
  }

  // Backward scan.
  float tail = 0.f;     // sum over t > s of g_w_t * w_t
  float pending = 0.f;  // d z[s + 1] without the term from sample s
  float dn = 0.f;
  for (int s = S - 1; s >= 0; --s) {
    const float4 p = pk[s];
    const float raw = nr != nullptr ? p.w + nr[s] : p.w;
    const float sigma = softplus(raw);
    const bool has_next = s + 1 < S;
    const float zs = zr[s];
    const float dist_raw = has_next ? zr[s + 1] - zs : last;
    const float dist = __fmul_rn(dist_raw, dnorm);
    const float e = expf(-__fmul_rn(sigma, dist));  // 1 - alpha
    const float alpha = 1.f - e;
    const float u = 1.f - alpha + kEps;
    const float tr = dzr[s];
    const float w = __fmul_rn(alpha, tr);
    const float cr = sigmoid(p.x), cg = sigmoid(p.y), cb = sigmoid(p.z);

    float g_w = dwr[s] + zs * d_depth;
    g_w += cr * d_r;
    g_w += cg * d_g;
    g_w += cb * d_b;
    g_w -= white;
    if (!sample_at_infinity || has_next) g_w += d_acc;

    const float d_u = tail / u;
    tail += g_w * w;
    const float d_alpha = g_w * tr - d_u;
    const float exp_term = 1.f - alpha;
    const float d_sigma = d_alpha * dist * exp_term;
    const float d_dist = d_alpha * sigma * exp_term;
    const float d_raw = d_sigma * sigmoid(raw);
    dpk[s] = make_float4(w * d_r * cr * (1.f - cr), w * d_g * cg * (1.f - cg),
                         w * d_b * cb * (1.f - cb), d_raw);

    dn += d_dist * dist_raw;
    const float d_draw = has_next ? d_dist * dnorm : 0.f;
    if (has_next) dzr[s + 1] = pending + d_draw;
    pending = w * d_depth + (s == med ? d_med : 0.f) - d_draw;
  }
  dzr[0] = pending;
  d_dnorm[r] = dn;
}

}  // namespace

extern "C" int hn_fused_composite_bwd(
    const void* packed, const void* z, const void* dirs, const void* noise,
    const void* d_outs, const void* d_weights, void* d_packed, void* d_z,
    void* d_dnorm, long long n_rays, int samples, int white_bkgd,
    int sample_at_infinity, void* stream) {
  const int blocks = (int)((n_rays + kThreads - 1) / kThreads);
  if (blocks > 0) {
    composite_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const float4*>(packed), static_cast<const float*>(z),
        static_cast<const float*>(dirs), static_cast<const float*>(noise),
        static_cast<const float*>(d_outs),
        static_cast<const float*>(d_weights),
        static_cast<float4*>(d_packed), static_cast<float*>(d_z),
        static_cast<float*>(d_dnorm), n_rays, samples, white_bkgd,
        sample_at_infinity);
  }
  return (int)cudaGetLastError();
}
