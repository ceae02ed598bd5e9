// The level forward with the SE(3) warp: level_fwd.cuh's kernel for
// warp type 1, compiled on its own so that the three instantiations build
// in parallel.

#include "level_fwd.cuh"

extern "C" int hn_level_fwd_se3(HN_LEVEL_FWD_ARGS) {
  return lf::launch_level_fwd<1, OrigEnc>(HN_LEVEL_FWD_PASS);
}
