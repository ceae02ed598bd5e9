// The SE(3) / quaternion trunk's primal (w, v) and point-tangents, backward,
// for Hopper (sm_90a).
//
// Replaces hypernerf_tpu/ops/pallas/fused_se3_jacobian.py `_fused_bwd` (:331,
// the tile body `_jac_bwd_tile` :154-212 with the tangent encoding's pullback
// `_tangent_encode_bwd` :83-109) for the trunk fused_se3_jacobian.cu computes.
//
// In:  x_raw (P, 11) fp32 [pts | embed] per sample, the optional window row,
//      g (P, 24) fp32 = d[w | v | dw | dv] in the forward's layout, the trunk's
//      packed bf16 weights, their transposes and the biases.
// Out: dx_raw (P, 11) fp32 per sample = [d pts | d embed], and fp32 dW / db of
//      the nine layers in the packed layout, added into one zeroed buffer.
// Both streams carry cotangents (the retraction reads the primal w and v), so
// the backward walks all four row blocks at once, as the TPU kernel stacks
// them: the blocks couple only through the ReLU masks, whose derivative is
// zero, so every dW sums the primal and the tangent rows' products; db sums
// the primal rows alone (biases do not reach the tangents); the tangent rows
// are masked by their primal row's activation. d embed comes from the primal
// encoding's pullback; d pts adds that pullback and the tangent encoding's
// (the 4^m diagonal terms). Rounding points are kernel 13's (fused_se3_bwd.cu)
// and the TPU kernel's: the heads' cotangents rounded to bf16 for the
// products while their db sums the fp32 values; the trunk logit's cotangent
// g_w W_w + g_v W_v summed in fp32 and rounded once; hidden layers' cotangents
// rounded after every product; the encoding's cotangent summed in fp32 and
// times the window row.
//
// Bound: the recompute and both products on all four blocks, three
// multiply-adds per weight, sample and block: 1.36 M multiply-adds per sample
// against 44 + 96 + 44 bytes, so operations bound it (262,144 samples:
// 0.72 ms at the card's bf16 peak).
// Design (as fused_se3_bwd.cu): a persistent grid, two blocks of 256 threads
// per SM, tiles of 8 points (32 rows: the four blocks) in one shared-memory
// tile (74 KB) on se3_trunk.cuh's column plan, dW added with atomics straight
// into the one fp32 gradient buffer, which stays in L2; its last bits change
// from run to run.

#include "jacobian.cuh"

namespace {

using C17 = JC<8, kLdS>;
constexpr long long kGradW17 = weight_offset<Se3Table>(Se3Table::kWarp);
constexpr size_t kSmem17 =
    sizeof(bf16) * C17::ROWS * C17::LD +
    sizeof(float) * (C17::R * 12 + 2 * C17::ROWS * 8 + C17::R * 12);

// Layer I of the trunk back over the four blocks: dW (all rows), db (primal
// rows), then the cotangent through it, masked by the primal rows' ReLU of
// the layer below.
template <int I>
__device__ __forceinline__ void jac_back17(bf16* X, const bf16* Wt,
                                           float* grad_w, float* grad_b) {
  using P = Se3Plan;
  using T = Se3Table;
  bwd_dw<C17, I, 0, T>(X, P::g, P::in(I), grad_w);
  jac_db<C17, I, T>(X, P::g, grad_b);
  jac_dx<C17, I, T>(X, P::g, P::g, Wt, I > 0 ? P::h(I > 0 ? I - 1 : 0) : 0,
                    I > 0 ? kSe3W : 0);
}

__global__ void __launch_bounds__(C17::THREADS, 2)
se3_jacobian_bwd_kernel(const float* __restrict__ x_raw,
                        const float* __restrict__ scales,
                        const float* __restrict__ g_out,
                        const bf16* __restrict__ W,
                        const bf16* __restrict__ Wt,
                        const bf16* __restrict__ B,
                        float* __restrict__ dx_raw, float* __restrict__ grads,
                        long long n_points, long long n_tiles) {
  using C = C17;
  using P = Se3Plan;
  using T = Se3Table;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);                      // [ROWS][LD]
  float* rowin = reinterpret_cast<float*>(X + C::ROWS * C::LD);  // [R][12]
  float* hgw = rowin + C::R * 12;    // [ROWS][8]: [d w | 0] per row
  float* hgv = hgw + C::ROWS * 8;    // [ROWS][8]: [d v | 0] per row
  float* dacc = hgv + C::ROWS * 8;   // [R][12]: d[pts | embed]
  float* grad_b = grads + kGradW17;
  const int tid = threadIdx.x;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long p0 = tile * C::R;
    for (int e = tid; e < C::R * 12; e += C::THREADS) {
      const int q = e / 12, c = e % 12;
      const long long p = p0 + q;
      rowin[e] = (c < 3 + kEmbed && p < n_points)
                     ? x_raw[p * (3 + kEmbed) + c]
                     : 0.f;
    }
    // The primal row of point q takes d w, d v; its tangent row k takes
    // column k of d dw, d dv. Points past the end: zero.
    for (int e = tid; e < C::ROWS * 8; e += C::THREADS) {
      const int r = e / 8, i = e % 8;
      const int s = r / C::R, q = r % C::R;
      const long long p = p0 + q;
      float gw = 0.f, gv = 0.f;
      if (i < 3 && p < n_points) {
        const float* gp = g_out + p * 24;
        gw = s == 0 ? gp[i] : gp[6 + i * 3 + s - 1];
        gv = s == 0 ? gp[3 + i] : gp[15 + i * 3 + s - 1];
      }
      hgw[e] = gw;
      hgv[e] = gv;
    }
    __syncthreads();
    encode_se3_streams<C>(X, P::enc, rowin, scales);
    __syncthreads();
    jac_layer<C, 0, true, T>(X, P::in(0), P::h(0), W, B);
    jac_layer<C, 1, true, T>(X, P::in(1), P::h(1), W, B);
    jac_layer<C, 2, true, T>(X, P::in(2), P::h(2), W, B);
    jac_layer<C, 3, true, T>(X, P::in(3), P::h(3), W, B);
    jac_layer<C, 4, true, T>(X, P::in(4), P::h(4), W, B);
    jac_layer<C, 5, true, T>(X, P::in(5), P::h(5), W, B);
    jac_layer<C, kSe3Trunk, false, T>(X, P::h(5), P::trunk, W, B);

    jac_head_dw_db<C, kSe3HeadW, T>(X, P::trunk, hgw, grads, grad_b);
    jac_head_dw_db<C, kSe3HeadV, T>(X, P::trunk, hgv, grads, grad_b);
    for (int e = tid; e < C::ROWS * kSe3W; e += C::THREADS) {
      const int r = e / kSe3W, k = e % kSe3W;
      const float v = head_dx<kSe3HeadW, T>(hgw + r * 8, W, k) +
                      head_dx<kSe3HeadV, T>(hgv + r * 8, W, k);
      X[r * C::LD + P::g + k] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    // The trunk logit is linear: no mask on its own cotangent; the cotangent
    // it passes down is masked by hidden 5's ReLU.
    bwd_dw<C, kSe3Trunk, 0, T>(X, P::g, P::h(5), grads);
    jac_db<C, kSe3Trunk, T>(X, P::g, grad_b);
    jac_dx<C, kSe3Trunk, T>(X, P::g, P::g, Wt, P::h(5), kSe3W);
    jac_back17<5>(X, Wt, grads, grad_b);  // writes the skip part
    jac_back17<4>(X, Wt, grads, grad_b);
    jac_back17<3>(X, Wt, grads, grad_b);
    jac_back17<2>(X, Wt, grads, grad_b);
    jac_back17<1>(X, Wt, grads, grad_b);
    jac_back17<0>(X, Wt, grads, grad_b);  // -> d enc in g[0:64]

    // The encoding's cotangent of row r: layer 0's part + the skip part, in
    // fp32, times the window row.
    for (int e = tid; e < C::R * 11; e += C::THREADS) {
      const int q = e / 11, c = e % 11;
      auto gx_row = [&](int r) {
        const bf16* gr = X + r * C::LD + P::g;
        return [=](int f) {
          const float v = bf2f(gr[f]) + bf2f(gr[kSe3W + f]);
          return scales != nullptr ? v * scales[f] : v;
        };
      };
      const auto gp = gx_row(q);
      float out;
      if (c < 3) {
        // The primal encoding's pullback (no identity term) ...
        const float x = rowin[q * 12 + c];
        float dx = 0.f;
        for (int k = 0; k < kSe3F; ++k) {
          float sn, cs;
          sincosf(ldexpf(x, kSe3MinDeg + k), &sn, &cs);
          const float flat = cs * gp(k * 3 + c) - sn * gp(kSe3Trig + k * 3 + c);
          dx += ldexpf(flat, kSe3MinDeg + k);
        }
        // ... plus the tangent encoding's, from tangent row c.
        out = dx + tangent_encode_dp<kSe3F, kSe3MinDeg>(
                       x, c, 0, kSe3Trig, gx_row((1 + c) * C::R + q));
      } else {
        out = gp(2 * kSe3Trig + c - 3);
      }
      dacc[q * 12 + c] = out;
    }
    __syncthreads();
    for (int e = tid; e < C::R * (3 + kEmbed); e += C::THREADS) {
      const int q = e / (3 + kEmbed), c = e % (3 + kEmbed);
      if (p0 + q < n_points)
        dx_raw[(p0 + q) * (3 + kEmbed) + c] = dacc[q * 12 + c];
    }
    __syncthreads();
  }
}

}  // namespace

// Blocks of the persistent grid for n_points samples: two per SM, never more
// than there are tiles.
extern "C" int hn_fused_se3_jacobian_bwd_blocks(long long n_points) {
  const long long tiles = (n_points + C17::R - 1) / C17::R;
  const long long most = 2LL * sm_count();
  return (int)(tiles < most ? tiles : most);
}

// weights, weights_t, biases: the trunk's nine layers alone. grads: [dW | db]
// of those layers in the packed layout, which every block adds into; it must
// be zero on entry.
extern "C" int hn_fused_se3_jacobian_bwd(const void* x_raw, const void* scales,
                                         const void* g, const void* weights,
                                         const void* weights_t,
                                         const void* biases, void* dx_raw,
                                         void* grads, long long n_points,
                                         int blocks, void* stream) {
  if (n_points <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      se3_jacobian_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem17);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n_points + C17::R - 1) / C17::R;
  se3_jacobian_bwd_kernel<<<blocks, C17::THREADS, kSmem17,
                            (cudaStream_t)stream>>>(
      static_cast<const float*>(x_raw), static_cast<const float*>(scales),
      static_cast<const float*>(g), static_cast<const bf16*>(weights),
      static_cast<const bf16*>(weights_t), static_cast<const bf16*>(biases),
      static_cast<float*>(dx_raw), static_cast<float*>(grads), n_points,
      tiles);
  return (int)cudaGetLastError();
}
