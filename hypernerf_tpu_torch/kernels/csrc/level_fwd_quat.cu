// The level forward with the quaternion warp: level_fwd.cuh's kernel for
// warp type 2, compiled on its own so that the three instantiations build
// in parallel.

#include "level_fwd.cuh"

extern "C" int hn_level_fwd_quat(HN_LEVEL_FWD_ARGS) {
  return lf::launch_level_fwd<2, OrigEnc>(HN_LEVEL_FWD_PASS);
}
