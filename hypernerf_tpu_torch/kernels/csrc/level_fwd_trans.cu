// The level forward with the translation warp: level_fwd.cuh's kernel for
// warp type 0, compiled on its own so that the three instantiations build
// in parallel.

#include "level_fwd.cuh"

extern "C" int hn_level_fwd_trans(HN_LEVEL_FWD_ARGS) {
  return lf::launch_level_fwd<0, OrigEnc>(HN_LEVEL_FWD_PASS);
}

#ifdef HN_LEVEL_FWD_TRACE
// The clocks block 0 recorded (level_fwd.cuh), as [group][pair][layer][4].
extern "C" int hn_level_fwd_trace(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, lf::level_fwd_trace,
                                   sizeof(lf::level_fwd_trace));
}
#endif
