// Compositing forward with the in-kernel hierarchical draw, for Hopper.
//
// Replaces hypernerf_tpu/ops/pallas/fused_composite.py `_fused` (forward,
// fused_composite.py:437: `_forward_tile` :249-275, `_outputs_tile`
// :277-300) with its fine draw `_fine_z_tile` (:187-246).
//
// Per ray: sigmoid / softplus of the level kernel's packed (S, 4) row block
// (with the optional (R, S) noise added to raw sigma before the softplus, the
// TPU kernel's `has_noise`, fused_composite.py:249-258), deltas scaled by |d|
// with a last delta of 1e7 (or 1e-7), the exclusive
// transmittance product of (1 - alpha + 1e-5), the weights, and rgb, depth,
// median depth (first sample whose cumulative weight reaches 0.5) and acc
// (without the last sample when it sits at infinity). With N > 0 it also
// inverts the CDF of weights[1:-1] + 1e-5 over the depth midpoints at the
// ascending u (with the JAX package's bracket clamps and its
// `denom < eps -> 1` rule) and merges those depths with the ascending
// coarse z into z_union (S + N).
//
// Bound: a few transcendentals and adds a sample; at R = 8192, S = 64, N =
// 64 the inputs and outputs are 19 MB, 5.7 us at the card's memory rate. The
// work a ray does is a chain of scans, so the old design, a thread per ray
// walking its samples in series, was bound by that chain's latency with two
// warps an SM at R = 8192. Design: a warp per ray (kWarps rays a block), so
// 8192 rays are 8192 warps; its lanes take 32 samples at a time, loads and
// stores coalesced (the packed rows as float4). The transmittance's
// exclusive product and the cumulative weight are shuffle scans with a
// carry from one chunk of 32 samples to the next (the JAX kernel scans in
// log depth too, `_shift_scan`); rgb, depth and acc are warp sums; the
// median is a ballot on the cumulative weight reaching 0.5. The fine draw
// keeps the ray's z, CDF, draws and z_union in the warp's shared memory: the
// CDF a shuffle scan, made monotone by a running max (a no-op where the sums
// come out monotone), each lane's u_j inverted by binary search (the count
// #{k : cdf_k <= u_j}, as the two-pointer scan of the earlier design found
// it), the draws made non-decreasing by a running max (a no-op where they
// are), and z_union by ranks: draw f_j to j + #{i : z_i <= f_j}, coarse z_i
// to i + #{j : f_j < z_i} (a coarse depth equal to a draw first), then
// copied out coalesced. Sums run in another order than a sequential walk's,
// so the outputs move in their last bits.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // rays a block
constexpr float kEps = 1e-5f;
constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned kNegInf = 0xff800000u;  // -inf's bits

__device__ __forceinline__ float softplus(float x) {
  // jax.nn.softplus: log1p(exp(-|x|)) + max(x, 0).
  return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.f);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Inclusive scans over the warp's lanes.
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
__device__ __forceinline__ float scan_max(float v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(kAll, v, d);
    if (lane >= d) v = fmaxf(o, v);
  }
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kAll, v, d);
  return v;
}

// #{k in [0, n) : a[k] <= v} (kUpper) or #{k : a[k] < v} for ascending a.
template <bool kUpper>
__device__ __forceinline__ int count_below(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (kUpper ? a[mid] <= v : a[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(32 * kWarps)
composite_fwd_kernel(const float4* __restrict__ packed,
                     const float* __restrict__ z,
                     const float* __restrict__ dirs,
                     const float* __restrict__ noise,
                     const float* __restrict__ u,
                     float* __restrict__ out,
                     float* __restrict__ weights,
                     float* __restrict__ z_union,
                     long long n_rays, int S, int N, int white_bkgd,
                     int sample_at_infinity) {
  // A warp's shared memory (N > 0): z (S) | draws (N) | the CDF (S - 1),
  // then z_union (S + N) over it.
  extern __shared__ float sh[];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * kWarps + wid;
  if (r >= n_rays) return;  // the whole warp
  float* zs = sh + wid * (2 * S + 2 * N);
  float* fs = zs + S;
  float* buf = fs + N;

  const float* zr = z + r * S;
  const float4* pk = packed + r * S;
  const float* nr = noise != nullptr ? noise + r * S : nullptr;
  float* wr = weights + r * S;
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);
  const float last = sample_at_infinity ? 1e7f : 1e-7f;

  float carry_t = 1.f, carry_w = 0.f;  // the chunks before: trans, cum
  float cr = 0.f, cg = 0.f, cb = 0.f, depth = 0.f, acc_all = 0.f;
  float acc_inner = 0.f, wsum = 0.f, med = 0.f;
  bool found = false;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const bool in = s < S, has_next = s + 1 < S;
    const float zc = in ? zr[s] : 0.f;
    const float zn = has_next ? zr[s + 1] : 0.f;
    const float4 p = in ? pk[s] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float raw = nr != nullptr && in ? p.w + nr[s] : p.w;
    const float dist = __fmul_rn(has_next ? zn - zc : last, dnorm);
    const float alpha =
        in ? 1.f - expf(-__fmul_rn(softplus(raw), dist)) : 0.f;
    // trans_s = prod_{j < s} (1 - alpha_j + eps): the chunk's exclusive
    // product times the chunks' before.
    const float incl = scan_prod(in ? 1.f - alpha + kEps : 1.f, lane);
    float excl = __shfl_up_sync(kAll, incl, 1);
    if (lane == 0) excl = 1.f;
    const float w = __fmul_rn(alpha, __fmul_rn(carry_t, excl));
    carry_t = __fmul_rn(carry_t, __shfl_sync(kAll, incl, 31));
    if (in) wr[s] = w;
    cr += __fmul_rn(w, sigmoid(p.x));
    cg += __fmul_rn(w, sigmoid(p.y));
    cb += __fmul_rn(w, sigmoid(p.z));
    depth += __fmul_rn(w, zc);
    acc_all += w;
    if (has_next) acc_inner += w;
    // The median: the first sample whose cumulative weight reaches 0.5.
    const float cum = carry_w + scan_add(w, lane);
    carry_w = __shfl_sync(kAll, cum, 31);
    const unsigned hit = __ballot_sync(kAll, in && cum >= 0.5f);
    if (!found && hit) {
      med = __shfl_sync(kAll, zc, __ffs(hit) - 1);
      found = true;
    }
    if (N > 0) {  // weights[1:-1] + eps, CDF'd below
      const bool bin = s >= 1 && has_next;
      if (in) zs[s] = zc;
      if (bin) buf[s] = w + kEps;
      wsum += bin ? w + kEps : 0.f;
    }
  }
  cr = warp_sum(cr);
  cg = warp_sum(cg);
  cb = warp_sum(cb);
  depth = warp_sum(depth);
  acc_all = warp_sum(acc_all);
  acc_inner = warp_sum(acc_inner);
  if (lane < 6) {
    const float white = white_bkgd ? 1.f - acc_all : 0.f;
    const float o = lane == 0   ? cr + white
                    : lane == 1 ? cg + white
                    : lane == 2 ? cb + white
                    : lane == 3 ? depth
                    : lane == 4 ? med
                                : (sample_at_infinity ? acc_inner : acc_all);
    out[r * 6 + lane] = o;
  }
  if (N == 0) return;

  // The CDF over the S - 1 midpoint edges: cdf_0 = 0, cdf_k = sum_{1 <= j
  // <= k} pdf_j / wsum, a running max over it.
  wsum = warp_sum(wsum);
  __syncwarp();
  float carry_c = 0.f, carry_m = 0.f;
  for (int k0 = 0; k0 < S - 1; k0 += 32) {
    const int k = k0 + lane;
    const float v = k >= 1 && k <= S - 2 ? buf[k] / wsum : 0.f;
    const float c = carry_c + scan_add(v, lane);
    carry_c = __shfl_sync(kAll, c, 31);
    const float m = fmaxf(carry_m, scan_max(c, lane));
    carry_m = __shfl_sync(kAll, m, 31);
    if (k <= S - 2) buf[k] = m;
  }
  __syncwarp();

  // The draws: u_j's bracket [idx - 1, idx] with idx = #{k : cdf_k <= u_j},
  // clamped into [0, S - 3] x [1, S - 2]; then a running max over j.
  const float* ur = u + r * N;
  float carry_f = __uint_as_float(kNegInf);
  for (int j0 = 0; j0 < N; j0 += 32) {
    const int j = j0 + lane;
    float f = __uint_as_float(kNegInf);
    if (j < N) {
      const float uj = ur[j];
      const int idx = count_below<true>(buf, S - 1, uj);
      const int i0 = min(max(idx - 1, 0), S - 3);
      const int i1 = max(min(idx, S - 2), 1);
      const float c0 = buf[i0], c1 = buf[i1];
      const float b0 = 0.5f * (zs[i0] + zs[i0 + 1]);
      const float b1 = 0.5f * (zs[i1] + zs[i1 + 1]);
      float denom = c1 - c0;
      if (denom < kEps) denom = 1.f;
      f = b0 + __fmul_rn((uj - c0) / denom, b1 - b0);
    }
    f = fmaxf(carry_f, scan_max(f, lane));
    carry_f = __shfl_sync(kAll, f, 31);
    if (j < N) fs[j] = f;
  }
  __syncwarp();

  // z_union by ranks into the CDF's place, then out.
  for (int i = lane; i < S; i += 32)
    buf[i + count_below<false>(fs, N, zs[i])] = zs[i];
  for (int j = lane; j < N; j += 32)
    buf[j + count_below<true>(zs, S, fs[j])] = fs[j];
  __syncwarp();
  float* zu = z_union + r * (S + N);
  for (int i = lane; i < S + N; i += 32) zu[i] = buf[i];
}

}  // namespace

extern "C" int hn_fused_composite_fwd(const void* packed, const void* z,
                                      const void* dirs, const void* noise,
                                      const void* u, void* out, void* weights,
                                      void* z_union, long long n_rays,
                                      int samples, int fine, int white_bkgd,
                                      int sample_at_infinity, void* stream) {
  const long long blocks = (n_rays + kWarps - 1) / kWarps;
  const size_t smem =
      fine > 0 ? sizeof(float) * kWarps * (2 * samples + 2 * fine) : 0;
  if (blocks <= 0) return (int)cudaGetLastError();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        composite_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  composite_fwd_kernel<<<(unsigned)blocks, 32 * kWarps, smem,
                         (cudaStream_t)stream>>>(
      static_cast<const float4*>(packed), static_cast<const float*>(z),
      static_cast<const float*>(dirs), static_cast<const float*>(noise),
      static_cast<const float*>(u), static_cast<float*>(out),
      static_cast<float*>(weights), static_cast<float*>(z_union), n_rays,
      samples, fine, white_bkgd, sample_at_infinity);
  return (int)cudaGetLastError();
}

extern "C" const char* hn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
