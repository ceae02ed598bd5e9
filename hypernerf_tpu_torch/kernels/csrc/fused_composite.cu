// Compositing forward with the in-kernel hierarchical draw, for Hopper.
//
// Replaces hypernerf_tpu/ops/pallas/fused_composite.py `_fused` (forward,
// fused_composite.py:437) with its fine draw `_fine_z_tile` (:187-246).
//
// Per ray: sigmoid / softplus of the level kernel's packed (S, 4) row block,
// deltas scaled by |d| with a last delta of 1e7 (or 1e-7), the exclusive
// transmittance product of (1 - alpha + 1e-5), the weights, and rgb, depth,
// median depth (first sample whose cumulative weight reaches 0.5) and acc
// (without the last sample when it sits at infinity). With N > 0 it also
// inverts the CDF of weights[1:-1] + 1e-5 over the depth midpoints at the
// ascending u (with the JAX package's bracket clamps and its
// `denom < eps -> 1` rule) and merges those depths with the ascending
// coarse z into z_union (S + N): the inverse CDF is monotone in u, so the
// draws come out sorted and a two-pointer merge replaces the TPU's padded
// bitonic network.
//
// Bound: the work is a short sequential scan per ray (about 3 S + 2 N
// transcendentals and the same number of adds), tiny next to the level
// kernel; at 8192 rays it is latency-bound, not bandwidth-bound (8192 x 64
// x 16 B of input is 8 MB). Design: one thread per ray, sequential
// cumulative product and sum (no log-depth scan), a two-pointer scan of u
// against the CDF, and the CDF kept in shared memory laid out
// sample-major so the threads of a warp hit distinct banks.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float softplus(float x) {
  // jax.nn.softplus: log1p(exp(-|x|)) + max(x, 0).
  return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.f);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(kThreads)
composite_fwd_kernel(const float4* __restrict__ packed,
                     const float* __restrict__ z,
                     const float* __restrict__ dirs,
                     const float* __restrict__ u,
                     float* __restrict__ out,
                     float* __restrict__ weights,
                     float* __restrict__ z_union,
                     long long n_rays, int S, int N, int white_bkgd,
                     int sample_at_infinity) {
  extern __shared__ float cdf_sh[];  // [S][kThreads]; only when N > 0
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  float* cdf = cdf_sh + threadIdx.x;  // cdf[k * kThreads]

  const float* zr = z + r * S;
  const float4* pk = packed + r * S;
  float* wr = weights + r * S;
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);
  const float last = sample_at_infinity ? 1e7f : 1e-7f;

  float trans = 1.f, cr = 0.f, cg = 0.f, cb = 0.f, depth = 0.f;
  float acc_all = 0.f, acc_inner = 0.f, cum = 0.f, med = 0.f, wsum = 0.f;
  bool found = false;
  float z_cur = zr[0];
  for (int s = 0; s < S; ++s) {
    const float4 p = pk[s];
    const bool has_next = s + 1 < S;
    const float z_next = has_next ? zr[s + 1] : 0.f;
    const float dist = __fmul_rn(has_next ? z_next - z_cur : last, dnorm);
    const float alpha = 1.f - expf(-__fmul_rn(softplus(p.w), dist));
    const float w = __fmul_rn(alpha, trans);
    wr[s] = w;
    cr += __fmul_rn(w, sigmoid(p.x));
    cg += __fmul_rn(w, sigmoid(p.y));
    cb += __fmul_rn(w, sigmoid(p.z));
    depth += __fmul_rn(w, z_cur);
    acc_all += w;
    if (has_next) acc_inner += w;
    cum += w;
    if (!found && cum >= 0.5f) {
      med = z_cur;
      found = true;
    }
    if (N > 0 && s >= 1 && has_next) {
      cdf[s * kThreads] = w + kEps;  // weights[1:-1] + eps, CDF'd below
      wsum += w + kEps;
    }
    trans = __fmul_rn(trans, 1.f - alpha + kEps);
    z_cur = z_next;
  }
  const float white = white_bkgd ? 1.f - acc_all : 0.f;
  float* o = out + r * 6;
  o[0] = cr + white;
  o[1] = cg + white;
  o[2] = cb + white;
  o[3] = depth;
  o[4] = med;
  o[5] = sample_at_infinity ? acc_inner : acc_all;
  if (N == 0) return;

  // CDF over the S - 1 midpoint bins: cdf_0 = 0, cdf_k = sum_{j<=k} pdf_j.
  float c = 0.f;
  cdf[0] = 0.f;
  for (int k = 1; k <= S - 2; ++k) {
    c += cdf[k * kThreads] / wsum;
    cdf[k * kThreads] = c;
  }
  const float* ur = u + r * N;
  float* zu = z_union + r * (S + N);
  int idx = 0;  // #{k in [0, S-2] : cdf_k <= u_j}, non-decreasing in j
  int zi = 0, n_out = 0;
  for (int j = 0; j < N; ++j) {
    const float uj = ur[j];
    while (idx <= S - 2 && cdf[idx * kThreads] <= uj) ++idx;
    const int i0 = min(max(idx - 1, 0), S - 3);
    const int i1 = max(min(idx, S - 2), 1);
    const float c0 = cdf[i0 * kThreads], c1 = cdf[i1 * kThreads];
    const float b0 = 0.5f * (zr[i0] + zr[i0 + 1]);
    const float b1 = 0.5f * (zr[i1] + zr[i1 + 1]);
    float denom = c1 - c0;
    if (denom < kEps) denom = 1.f;
    const float f = b0 + __fmul_rn((uj - c0) / denom, b1 - b0);
    while (zi < S && zr[zi] <= f) zu[n_out++] = zr[zi++];
    zu[n_out++] = f;
  }
  while (zi < S) zu[n_out++] = zr[zi++];
}

}  // namespace

extern "C" int hn_fused_composite_fwd(const void* packed, const void* z,
                                      const void* dirs, const void* u,
                                      void* out, void* weights, void* z_union,
                                      long long n_rays, int samples, int fine,
                                      int white_bkgd, int sample_at_infinity,
                                      void* stream) {
  const int blocks = (int)((n_rays + kThreads - 1) / kThreads);
  const size_t smem = fine > 0 ? sizeof(float) * samples * kThreads : 0;
  if (blocks > 0) {
    composite_fwd_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const float4*>(packed), static_cast<const float*>(z),
        static_cast<const float*>(dirs), static_cast<const float*>(u),
        static_cast<float*>(out), static_cast<float*>(weights),
        static_cast<float*>(z_union), n_rays, samples, fine, white_bkgd,
        sample_at_infinity);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* hn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
