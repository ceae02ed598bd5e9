// The level forward with the translation warp and the template's Nerfies
// layout (the anneal configuration): level_fwd.cuh's kernel for warp type 0
// with NerfEnc, compiled on its own so that it builds in parallel
// with the other instantiations and adds no code to them.

#include "level_fwd.cuh"

extern "C" int hn_level_fwd_anneal(HN_LEVEL_FWD_ARGS) {
  return lf::launch_level_fwd<0, NerfEnc>(HN_LEVEL_FWD_PASS);
}
