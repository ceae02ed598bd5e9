// The translation warp's Jacobian J = d warped / d points, backward, for
// Hopper (sm_90a): fields_bwd_alone.cuh's kernel (kernel B's block) on the
// warp field with its three point-tangent streams, from the field's own
// blob (layers 0..6 of TransTable).
//
// Replaces hypernerf_tpu/ops/pallas/fused_jacobian.py `_fused_bwd` (:302, the
// tile body `_jac_bwd_tile` :168-208 with the recompute `_jac_fwd_tile`
// :132-166 and the tangent encoding's pullback `_tangent_encode_bwd`
// :103-129) for the field tangents_fwd.cu computes.
//
// In:  x_raw (P, 11) fp32 [pts | embed], g (P, 9) fp32 = dJ in J's layout
//      (g[p, 3 i + k] = d loss / d J[i, k]), the field's packed bf16 weights
//      and biases; no window row. Out: dx_raw (P, 11) = [d pts | 0] and dW of
//      the seven layers, as fields_bwd_alone.cuh says; db stays zero.
// A block tile is 32 points x 4 streams (fields_bwd.cuh's tan_row): the
// primal rows are recomputed for their ReLU masks and carry no cotangent
// (zero rows in every walk-back product); tangent row k takes column k of
// dJ. The cotangent stays fp32 as the TPU kernel keeps it: the head's dW and
// g W_head take the fp32 g, and every stored cotangent is held as two bf16
// halves hi + lo (16 of fp32's 24 mantissa bits), both read by each product
// into one accumulator; the walk-back's low halves alternate between two
// pairs of slots (the plan's lo row), d enc's two parts go to fp32 rows.
// Rounding points are the plain version's (`fused_jacobian_bwd_plain`,
// `split_cotangent`).
// Bound: the recompute on four streams and both products on three: 1.0 M
// multiply-adds a point: operations (262,144 points: 0.533 ms at the card's
// dense bf16 rate; the halves' second products are not counted).

#include "fields_bwd_alone.cuh"

// n_points points (4 n_points rows): blocks hn_fused_fields_bwd_blocks(4
// n_points); scales null; g (P, 9) fp32; scratch blocks x fb::kSpillSlabs x
// 16 KB; the rest as hn_fused_field_bwd's.
extern "C" int hn_fused_jacobian_bwd(HN_FIELD_BWD_ARGS) {
  if (scales != nullptr) return (int)cudaErrorInvalidValue;
  return fb::launch_field_bwd<fb::kTransJac, true>(HN_FIELD_BWD_PASS);
}
