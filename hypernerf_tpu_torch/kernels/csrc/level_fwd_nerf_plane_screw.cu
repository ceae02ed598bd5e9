// The level forward with the SE(3) and with the quaternion warp and the
// template's Nerfies plane layout (the plane_anneal_se3 configuration, the
// HyperNeRF paper's axis-aligned plane model, and plane_anneal_quaternion):
// level_fwd.cuh's kernel for warp types 1 and 2 with NerfPlaneEnc on
// Se3PlaneTableOf<NerfPlaneEnc> (the trunk, no sheet, the template on its
// 128-column encoding; the level's block), both window rows in one call,
// compiled on its own so that it builds in parallel with the other
// instantiations and adds no code to them.

#include "level_fwd.cuh"

extern "C" int hn_level_fwd_nerf_plane_se3(HN_LEVEL_FWD_ARGS) {
  return lf::launch_level_fwd<1, NerfPlaneEnc>(HN_LEVEL_FWD_PASS);
}

extern "C" int hn_level_fwd_nerf_plane_quat(HN_LEVEL_FWD_ARGS) {
  return lf::launch_level_fwd<2, NerfPlaneEnc>(HN_LEVEL_FWD_PASS);
}
