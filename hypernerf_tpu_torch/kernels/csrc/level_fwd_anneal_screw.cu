// The level forward with the SE(3) and with the quaternion warp and the
// template's Nerfies layout (the anneal_se3 and anneal_quaternion
// configurations: the trunk's window row and the template's in one call):
// level_fwd.cuh's kernel for warp types 1 and 2 with NerfEnc, compiled on
// its own so that it builds in parallel with the other instantiations and
// adds no code to them.

#include "level_fwd.cuh"

extern "C" int hn_level_fwd_anneal_se3(HN_LEVEL_FWD_ARGS) {
  return lf::launch_level_fwd<1, NerfEnc>(HN_LEVEL_FWD_PASS);
}

extern "C" int hn_level_fwd_anneal_quat(HN_LEVEL_FWD_ARGS) {
  return lf::launch_level_fwd<2, NerfEnc>(HN_LEVEL_FWD_PASS);
}
