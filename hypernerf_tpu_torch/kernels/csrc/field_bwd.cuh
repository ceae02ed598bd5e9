// A field MLP's column plan on a backward tile and the walk-back through
// one of its hidden layers. Borrowed by the SE(3) trunk's backward
// (se3_trunk.cuh) and the translation Jacobian's (fused_jacobian_bwd.cu).
// (A field alone forward is a stage of the level forward, modular_fwd.cu;
// a field alone backward runs on kernel B's block, fields_bwd_alone.cu over
// fields_bwd.cuh.)

#pragma once

#include "level_bwd.cuh"

namespace {

// Column plan (bf16 columns) of a field of width W with padded encoding E:
// h0..h4 | enc | h5 | cotangent [g (W) | skip part (E)].
template <int W, int E>
struct Plan {
  static constexpr int enc = 5 * W, h5 = 5 * W + E, g = 6 * W + E;
  static constexpr int end = 7 * W + 2 * E;
  __host__ __device__ static constexpr int h(int i) {
    return i < 5 ? i * W : h5;
  }
  __host__ __device__ static constexpr int in(int i) {  // 6 is the head
    return i == 0 ? enc : h(i - 1);
  }
};
using WarpPlan = Plan<kWarpW, kWarpEncP>;

// Hidden layer I of a field back: dW, db, then the cotangent through it. C is
// the tile's configuration and T the layer table.
template <class P, int LB, int I, class C, class T>
__device__ __forceinline__ void field_back(bf16* X, const bf16* Wt,
                                           float* grad_w, float* grad_b) {
  constexpr int L = LB + I;
  bwd_dw<C, L, 0, T>(X, P::g, P::in(I), grad_w);
  bwd_db<C, L, 0, T>(X, P::g, grad_b);
  bwd_dx<C, L, T>(X, P::g, P::g, Wt, I > 0 ? P::h(I > 0 ? I - 1 : 0) : 0,
                  I > 0 ? layer_shape<T>(LB).n : 0);
}

}  // namespace
