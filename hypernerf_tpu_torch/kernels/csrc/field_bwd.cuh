// A field MLP's column plan on a mma.sync backward tile: the translation
// Jacobian's backward (fused_jacobian_bwd.cu) keeps the warp field's stored
// outputs and its cotangent on these columns. (A field alone forward is a
// stage of the level forward, modular_fwd.cu; a field alone backward, the
// SE(3) trunk's and the trunk's tangents' run on kernel B's block,
// fields_bwd_alone.cuh over fields_bwd.cuh.)

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

}  // namespace
