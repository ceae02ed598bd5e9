// The level forward of the plane configuration (axis_aligned_plane
// slicing): level_fwd.cuh's kernel for the translation warp with the
// template's PlaneEnc layout (no sheet; the hyper coordinates are the ray's
// embedding; a 448-column tile and a ring of 5 stages, PlaneBlock), compiled
// on its own so that it builds in parallel with the other instantiations
// and adds no code to them.

#include "level_fwd.cuh"

extern "C" int hn_level_fwd_plane(HN_LEVEL_FWD_ARGS) {
  return lf::launch_level_fwd<0, PlaneEnc>(HN_LEVEL_FWD_PASS);
}

#ifdef HN_LEVEL_FWD_TRACE
// The clocks block 0 recorded (level_fwd.cuh), as [group][pair][layer][4].
extern "C" int hn_level_fwd_plane_trace(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, lf::level_fwd_trace,
                                   sizeof(lf::level_fwd_trace));
}
#endif
