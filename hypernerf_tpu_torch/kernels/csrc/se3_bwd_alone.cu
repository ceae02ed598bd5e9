// The SE(3) / quaternion warp field's trunk alone, backward, for Hopper
// (sm_90a): fields_bwd_alone.cuh's kernel (kernel B's block) on the trunk,
// layers 0..8 of Se3Table, from the trunk's own blob.
//
// Replaces hypernerf_tpu/ops/pallas/fused_se3.py `_fused_bwd` (:412, the tile
// body `_backward_tile_gen` :234-282 with the encoding's VJP `_encode_bwd_gen`
// :126-151) for the trunk that modular_fwd.cu's trunk stage computes.
//
// In:  x_raw (P, 11), the optional window row, g (P, 8) fp32 = d[w | v |
//      0 0]. Out: dx_raw (P, 11) and dW / db of the nine layers, as
//      fields_bwd_alone.cuh says. Per block tile: the trunk encoding with the
//      window row, layers 0..5 with ReLU and the linear logit recomputed; no
//      retraction: the heads' fp32 cotangents come from g (d w into
//      rows.hg, d v into rows.se3[:, 8:11]) into kernel B's head step for
//      the SE(3) trunk; the logit and the hidden layers walked back; the
//      encoding's VJP with the window row (no identity term). Rounding
//      points are the JAX kernel's: g_w and g_v rounded to bf16 for the
//      products while the heads' db sums the fp32 values; the logit's
//      cotangent g_w W_w + g_v W_v rounded once, its db summing the rounded
//      value, no mask on it; the skip part of d enc added in fp32.
// Bound: 3 x 116,736 multiply-adds a row: operations (16384 x 128 rows:
// 1.443 ms at the card's dense bf16 rate).

#include "fields_bwd_alone.cuh"

extern "C" int hn_fused_se3_bwd(HN_FIELD_BWD_ARGS) {
  return fb::launch_field_bwd<fb::kSe3Warp, false>(HN_FIELD_BWD_PASS);
}
