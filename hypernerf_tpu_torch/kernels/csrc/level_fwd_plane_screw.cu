// The level forward with the SE(3) and with the quaternion warp and
// axis_aligned_plane slicing (the plane_se3 and plane_quaternion
// configurations): level_fwd.cuh's kernel for warp types 1 and 2 with the
// template's PlaneEnc layout on Se3PlaneTable (the trunk, no sheet, the
// template on its 192-column encoding; PlaneBlock's two 448-column tiles and
// ring of 5 stages), compiled on its own so that it builds in parallel with
// the other instantiations and adds no code to them.

#include "level_fwd.cuh"

extern "C" int hn_level_fwd_plane_se3(HN_LEVEL_FWD_ARGS) {
  return lf::launch_level_fwd<1, PlaneEnc>(HN_LEVEL_FWD_PASS);
}

extern "C" int hn_level_fwd_plane_quat(HN_LEVEL_FWD_ARGS) {
  return lf::launch_level_fwd<2, PlaneEnc>(HN_LEVEL_FWD_PASS);
}
