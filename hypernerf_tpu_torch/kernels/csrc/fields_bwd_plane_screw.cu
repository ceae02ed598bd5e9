// The fields backward (kernel B) of the levels with the SE(3) or the
// quaternion warp and no sheet (axis_aligned_plane: the plane_se3,
// plane_quaternion and plane_anneal_* configurations): fields_bwd.cuh's
// kernel for warp types 1 and 2 without the sheet (the trunk, the
// retraction's VJP and d embed = the trunk's + dx_t[:, 3:11]), compiled on
// its own so that it builds in parallel with the other instantiations and
// adds no code to them.

#include "fields_bwd.cuh"

extern "C" int hn_fields_bwd_plane_se3(HN_FIELDS_BWD_ARGS) {
  return fb::launch_fields_bwd<1, true>(HN_FIELDS_BWD_PASS);
}

extern "C" int hn_fields_bwd_plane_quat(HN_FIELDS_BWD_ARGS) {
  return fb::launch_fields_bwd<2, true>(HN_FIELDS_BWD_PASS);
}
