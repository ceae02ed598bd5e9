// One field MLP alone, backward, for the two fields of the translation
// table: fields_bwd_alone.cuh's kernel for the warp field and the hyper
// sheet, and the plan entry point of every field alone backward (these two,
// se3_bwd_alone.cu's trunk, se3_tangents_bwd.cu's trunk with its tangents
// and warp_tangents_bwd.cu's warp field with its tangents).
//
// Replaces hypernerf_tpu/ops/pallas/fused_field.py `_fused_bwd` (:532, the
// tile body `_backward_tile_gen` :379-417 with the posenc VJP
// `_encode_bwd_gen` :233-266) for the two fields modular_fwd.cu computes.
// Design, bound and rounding points: fields_bwd_alone.cuh.

#include "fields_bwd_alone.cuh"

// which: 0 the warp field (layers 0..6 of the table), 1 the hyper sheet
// (layers 7..13). g: (P, 8) fp32. The rest: HN_FIELD_BWD_ARGS.
extern "C" int hn_fused_field_bwd(int which, HN_FIELD_BWD_ARGS) {
  if (which == 0)
    return fb::launch_field_bwd<fb::kTransWarp, false>(HN_FIELD_BWD_PASS);
  if (which == 1)
    return fb::launch_field_bwd<fb::kSheet, false>(HN_FIELD_BWD_PASS);
  return (int)cudaErrorInvalidValue;
}

// The plan of field `which` alone (0 the warp field, 1 the sheet, 2 the
// SE(3) trunk, with or without its tangent streams, which change the rows
// of a point and nothing of the plan, 3 the warp field with its tangent
// streams, the Jacobian's, whose cotangent in two halves has a plan of its
// own): config[0:9] as hn_fused_fields_bwd_plan's (kernel B's block);
// table[0:60] the field's buffer plan, six ints per buffer (enc, h0..h5, T,
// skip, lo), kernel B's row of that field; loads[3 i : 3 i + 3] = (layer of
// the table, 64-column box of K, box rows) of the i-th weight load of one block
// tile: the field's streamed layers (six hidden, and the trunk logit)
// forward, then backward. Returns the number of loads (written up to
// max_loads), or -1 for another field.
extern "C" int hn_fused_field_bwd_plan(int which, int* config, int* table,
                                       int* loads, int max_loads) {
  using namespace fb;
  if (which < 0 || which > 3) return -1;
  plan_config(config);
  if (which == 0) {
    plan_table(kTransWarp, table);
    return plan_loads<TransTable>(Alone<kTransWarp>::kFirst,
                                  Alone<kTransWarp>::kStreamed, loads, 0,
                                  max_loads);
  }
  if (which == 1) {
    plan_table(kSheet, table);
    return plan_loads<TransTable>(Alone<kSheet>::kFirst,
                                  Alone<kSheet>::kStreamed, loads, 0,
                                  max_loads);
  }
  if (which == 3) {
    plan_table(kTransJac, table);
    return plan_loads<TransTable>(Alone<kTransJac>::kFirst,
                                  Alone<kTransJac>::kStreamed, loads, 0,
                                  max_loads);
  }
  plan_table(kSe3Warp, table);
  return plan_loads<Se3Table>(Alone<kSe3Warp>::kFirst,
                              Alone<kSe3Warp>::kStreamed, loads, 0,
                              max_loads);
}
