// Fields backward for Hopper (sm_90a): the second half of the level backward.
//
// Replaces hypernerf_tpu/ops/pallas/fused_level.py `_fields_bwd_call` (:846,
// the tile body `_fields_bwd_core_gen` :409-450 over fused_field.py
// `_backward_tile_gen` :379-418 and the ray-mode writes `_write_ray_grads`
// :250-269), which is also the fields half of `_fused_bwd_pipelined` (:1260)
// and `_fused_bwd` (:1397), for the flagship spec with each of its three warp
// types: translation, SE(3) and quaternion (`_warp_bwd_tile_gen` :545-584).
//
// In:  z (R, S), origins / directions (R, 3), embed (R, 8) fp32, and
//      dx_t (P, 8) fp32 = d[warped | hyper | 0] from the template backward.
// Out: d z (R, S); per ray [d origins | d directions | d embed] (R, 14),
//      summed over the ray's samples; fp32 dW / db of the 7 warp and 7 hyper
//      layers in the packed layout.
// Per tile: pts = o + z d and [posenc | embed] are rebuilt, the hyper sheet
// is recomputed and walked back from dx_t[:, 3:7], then the warp field from
// dx_t[:, 0:3] (whose residual also passes dx_t[:, 0:3] straight to d pts);
// d pts and d embed are the sums of both. Rounding points as in
// fused_template_bwd.cu. The TPU kernel shares the warp's sin / cos with the
// sheet; here each encoding computes its own (the same values).
// With the SE(3) or the quaternion warp the warp stage is the trunk of
// se3_trunk.cuh instead: recompute the trunk and (w, v), take the retraction's
// hand-derived VJP from d warped to (d w, d v, d pts direct) in fp32, one
// thread per row, walk the trunk back from [d w | d v], and
// d pts = d pts direct + the trunk's part: there is no residual path. The
// optional window row scales the trunk's encoding and its cotangent.
//
// Bound: per sample 133k MACs of recompute, as many for g W and for g^T h:
// 0.8 MFLOP against 48 bytes moved, so operations bound it (2.1 M samples:
// 1.7 TFLOP, 1.7 ms at the card's bf16 peak).
// Design (see level_bwd.cuh; one field's pass is field_bwd.cuh, shared with
// fused_field_bwd.cu): a persistent grid, two blocks of 256 threads
// per SM, tiles of 32 rows, one shared-memory tile reused by the sheet and
// then the warp (68 KB; 85 KB with the SE(3) trunk, which keeps one more
// layer), dW added straight into the one fp32 gradient buffer (0.53 MB, which
// stays in L2). As in the template backward the tile's
// height, 32 rows per pass over the weights, is what limits it.

#include <type_traits>

#include "se3_trunk.cuh"

namespace {

// What depends on the warp type kWarp (0 translation, 1 SE(3), 2 quaternion):
// the layer table, the tile (the SE(3) trunk keeps one more layer's output,
// so its tile is wider; the sheet then runs in that tile too) and the extra
// per-row fp32 scratch of the retraction ([w | v] and [d v | 0]).
template <int kWarp>
struct Variant {
  using T = typename std::conditional<kWarp == 0, TransTable, Se3Table>::type;
  using C = typename std::conditional<kWarp == 0, CF, CS>::type;
  static constexpr int kExtra = kWarp == 0 ? 0 : 2 * 8;
  static constexpr long long kGradW = weight_offset<T>(T::kFields);
  static constexpr size_t smem =
      sizeof(bf16) * C::ROWS * C::LD +
      sizeof(float) * C::ROWS * (12 + 4 + 8 + 4 + 12 + 12 + 14 + kExtra) +
      sizeof(int) * C::ROWS;
};

template <int kWarp>
__global__ void __launch_bounds__(CF::THREADS, 2)
fields_bwd_kernel(const float* __restrict__ zs,
                  const float* __restrict__ origins,
                  const float* __restrict__ dirs,
                  const float* __restrict__ embed,
                  const float* __restrict__ dx_t,
                  const float* __restrict__ warp_scales,
                  const bf16* __restrict__ W, const bf16* __restrict__ Wt,
                  const bf16* __restrict__ B, float* __restrict__ d_z,
                  float* __restrict__ d_ray, float* __restrict__ grad_w,
                  long long n_points, int samples, long long n_tiles) {
  using V = Variant<kWarp>;
  using T = typename V::T;
  using C = typename V::C;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);                     // [ROWS][LD]
  float* rowin = reinterpret_cast<float*>(X + C::ROWS * C::LD);  // [ROWS][12]
  float* zd = rowin + C::ROWS * 12;  // [ROWS][4]: z | direction
  float* hg = zd + C::ROWS * 4;      // [ROWS][8]: a head's fp32 cotangent
  // [ROWS][4]: d warped, then what of it reaches d pts directly
  float* dwarp = hg + C::ROWS * 8;
  float* dacc_h = dwarp + C::ROWS * 4;    // [ROWS][12]: the sheet's d[pts|emb]
  float* dacc_w = dacc_h + C::ROWS * 12;  // [ROWS][12]: the warp's
  float* rayv = dacc_w + C::ROWS * 12;    // [ROWS][14]: d o | d d | d embed
  float* wv = rayv + C::ROWS * 14;        // [ROWS][8]: w | v (kWarp != 0)
  float* hgv = wv + C::ROWS * 8;          // [ROWS][8]: d v | 0 (kWarp != 0)
  int* ray_of = reinterpret_cast<int*>(rayv + C::ROWS * (14 + V::kExtra));

  const int tid = threadIdx.x;
  float* grad_b = grad_w + V::kGradW;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * C::ROWS;
    if (tid < C::ROWS) {
      const long long p = row0 + tid;
      const bool valid = p < n_points;
      const long long ray = valid ? p / samples : 0;
      const float z = valid ? zs[p] : 0.f;
      float* in = rowin + tid * 12;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float d = dirs[3 * ray + c];
        in[c] = __fadd_rn(origins[3 * ray + c], __fmul_rn(z, d));
        zd[tid * 4 + 1 + c] = d;
      }
      zd[tid * 4] = z;
#pragma unroll
      for (int c = 0; c < kEmbed; ++c) in[3 + c] = embed[ray * kEmbed + c];
      in[11] = 0.f;
      // Cotangents are zero on rows past the end: they add nothing.
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (valid) {
        a = reinterpret_cast<const float4*>(dx_t)[2 * p];
        b = reinterpret_cast<const float4*>(dx_t)[2 * p + 1];
      }
      float* dw = dwarp + tid * 4;
      dw[0] = a.x, dw[1] = a.y, dw[2] = a.z, dw[3] = 0.f;
      float* h = hg + tid * 8;  // the sheet's head first: d hyper
      h[0] = a.w, h[1] = b.x, h[2] = b.y, h[3] = b.z;
      h[4] = h[5] = h[6] = h[7] = 0.f;
      ray_of[tid] = valid ? (int)ray : -1;
    }
    __syncthreads();

    // The sheet encodes the raw points, whatever the warp.
    field_bwd<HypPlan, T::kWarp, kHypF, C, T>(X, rowin, hg, dacc_h, W, Wt, B,
                                              grad_w, grad_b, nullptr);
    if constexpr (kWarp == 0) {
      if (tid < C::ROWS) {  // the warp's head: d warped
        float* h = hg + tid * 8;
        const float* dw = dwarp + tid * 4;
        h[0] = dw[0], h[1] = dw[1], h[2] = dw[2], h[3] = 0.f;
      }
      __syncthreads();
      // warped = pts + delta: d warped also reaches d pts as it is.
      field_bwd<WarpPlan, 0, kWarpF>(X, rowin, hg, dacc_w, W, Wt, B, grad_w,
                                     grad_b, nullptr);
    } else {
      // warped = retraction(w, v, pts): recompute the trunk and (w, v), take
      // the retraction's VJP from d warped to (d w, d v, d pts direct), then
      // walk the trunk back from [d w | d v]. There is no residual path.
      se3_recompute<C>(X, rowin, W, B, warp_scales);
      se3_heads_fwd<C>(X, Se3Plan::trunk, W, B, wv);
      if (tid < C::ROWS) {
        float* dw = dwarp + tid * 4;
        const float g[3] = {dw[0], dw[1], dw[2]};
        float* gw = hg + tid * 8;
        float* gv = hgv + tid * 8;
        retract_bwd<kWarp == 2>(wv + tid * 8, wv + tid * 8 + 3,
                                rowin + tid * 12, g, gw, gv, dw);
#pragma unroll
        for (int c = 3; c < 8; ++c) gw[c] = gv[c] = 0.f;
      }
      __syncthreads();
      se3_walk_back<C>(X, rowin, hg, hgv, dacc_w, W, Wt, grad_w, grad_b,
                       warp_scales);
    }

    // d pts = (d warped's direct part + the warp's part) + the sheet's part;
    // pts = o + z d, so d z = d pts . d, d o = sum_s d pts,
    // d d = sum_s z d pts; d embed = sum_s (warp's + sheet's).
    if (tid < C::ROWS) {
      const float* zr = zd + tid * 4;
      float* rv = rayv + tid * 14;
      float dz = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float dp = (dwarp[tid * 4 + c] + dacc_w[tid * 12 + c]) +
                         dacc_h[tid * 12 + c];
        dz += dp * zr[1 + c];
        rv[c] = dp;
        rv[3 + c] = dp * zr[0];
      }
#pragma unroll
      for (int c = 0; c < kEmbed; ++c)
        rv[6 + c] = dacc_w[tid * 12 + 3 + c] + dacc_h[tid * 12 + 3 + c];
      if (row0 + tid < n_points) d_z[row0 + tid] = dz;
    }
    __syncthreads();
    ray_sums<C>(ray_of, 14, d_ray, 14,
                [&](int r, int c) { return rayv[r * 14 + c]; });
    __syncthreads();
  }
}

template <int kWarp>
int launch_fields_bwd(const void* z, const void* origins, const void* dirs,
                      const void* embed, const void* dx_t,
                      const void* warp_scales, const void* weights,
                      const void* weights_t, const void* biases, void* d_z,
                      void* d_ray, void* grads, long long n_points,
                      int samples, int blocks, void* stream) {
  using V = Variant<kWarp>;
  cudaError_t err = cudaFuncSetAttribute(
      fields_bwd_kernel<kWarp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)V::smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n_points + V::C::ROWS - 1) / V::C::ROWS;
  fields_bwd_kernel<kWarp>
      <<<blocks, V::C::THREADS, V::smem, (cudaStream_t)stream>>>(
          static_cast<const float*>(z), static_cast<const float*>(origins),
          static_cast<const float*>(dirs), static_cast<const float*>(embed),
          static_cast<const float*>(dx_t),
          static_cast<const float*>(warp_scales),
          static_cast<const bf16*>(weights),
          static_cast<const bf16*>(weights_t),
          static_cast<const bf16*>(biases), static_cast<float*>(d_z),
          static_cast<float*>(d_ray), static_cast<float*>(grads), n_points,
          samples, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of the persistent grid for n_points samples: two per SM, never more
// than there are tiles.
extern "C" int hn_fused_fields_bwd_blocks(long long n_points) {
  const long long tiles = (n_points + CF::ROWS - 1) / CF::ROWS;
  const long long most = 2LL * sm_count();
  return (int)(tiles < most ? tiles : most);
}

// warp_type: 0 translation, 1 SE(3), 2 quaternion; weights, weights_t and
// biases in that type's table. warp_scales: null, or the 64 fp32 window
// weights of the SE(3) / quaternion trunk's encoding. grads: [dW of the field
// layers | db of the field layers] (14 layers, or 16), which every block adds
// into. grads and d_ray (R, 14) must be zero on entry.
extern "C" int hn_fused_fields_bwd(
    int warp_type, const void* z, const void* origins, const void* dirs,
    const void* embed, const void* dx_t, const void* warp_scales,
    const void* weights, const void* weights_t, const void* biases, void* d_z,
    void* d_ray, void* grads, long long n_rays, int samples, int blocks,
    void* stream) {
  const long long n_points = n_rays * samples;
  if (n_points <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  switch (warp_type) {
    case 0:
      return launch_fields_bwd<0>(z, origins, dirs, embed, dx_t, warp_scales,
                                  weights, weights_t, biases, d_z, d_ray,
                                  grads, n_points, samples, blocks, stream);
    case 1:
      return launch_fields_bwd<1>(z, origins, dirs, embed, dx_t, warp_scales,
                                  weights, weights_t, biases, d_z, d_ray,
                                  grads, n_points, samples, blocks, stream);
    case 2:
      return launch_fields_bwd<2>(z, origins, dirs, embed, dx_t, warp_scales,
                                  weights, weights_t, biases, d_z, d_ray,
                                  grads, n_points, samples, blocks, stream);
  }
  return (int)cudaErrorInvalidValue;
}
