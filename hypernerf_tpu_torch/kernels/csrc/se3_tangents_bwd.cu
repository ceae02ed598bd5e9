// The SE(3) / quaternion trunk's primal (w, v) and point-tangents, backward,
// for Hopper (sm_90a): fields_bwd_alone.cuh's kernel (kernel B's block) on
// the trunk with its three tangent streams, from the trunk's own blob.
//
// Replaces hypernerf_tpu/ops/pallas/fused_se3_jacobian.py `_fused_bwd`
// (:331, the tile body `_jac_bwd_tile` :154-212 with the tangent encoding's
// pullback `_tangent_encode_bwd` :83-109 and the forward stash of
// `_jac_fwd_tile` :112-152) for the trunk tangents_fwd.cu computes.
//
// In:  x_raw (P, 11), the optional window row, g (P, 24) fp32 = d[w | v |
//      dw | dv] in the forward's layout. Out: dx_raw (P, 11) = [d pts | d
//      embed] and dW / db of the nine layers, as fields_bwd_alone.cuh says.
// A block tile is 32 points x 4 streams (the primal row, then d / d p_k),
// fields_bwd.cuh's tan_row: both streams carry cotangents (the retraction
// reads the primal w and v), and they couple only through the ReLU masks,
// whose derivative is zero, so every dW sums the primal and the tangent
// rows' products; db sums the primal rows alone (biases do not reach the
// tangents); a tangent row is masked by its primal row, whose lane
// (lane & 15 of the same warp) hands its mask over with a shuffle. d embed
// comes from the primal encoding's pullback; d pts adds that pullback and
// the tangent encodings' (the 4^m terms). Rounding points are the trunk
// backward's (se3_bwd_alone.cu) and the TPU kernel's.
// Bound: the recompute and both products on all four streams, three
// multiply-adds per weight, row and stream: operations (262,144 points:
// 0.721 ms at the card's dense bf16 rate).

#include "fields_bwd_alone.cuh"

// n_points points (4 n_points rows): blocks hn_fused_fields_bwd_blocks(4
// n_points); g (P, 24) fp32; the rest as hn_fused_se3_bwd's.
extern "C" int hn_fused_se3_jacobian_bwd(HN_FIELD_BWD_ARGS) {
  return fb::launch_field_bwd<fb::kSe3Warp, true>(HN_FIELD_BWD_PASS);
}
