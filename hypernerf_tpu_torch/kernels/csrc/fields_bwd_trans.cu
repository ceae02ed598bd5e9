// The fields backward (kernel B) with the translation warp: fields_bwd.cuh's
// kernel for warp type 0, compiled on its own so that the three
// instantiations build in parallel.

#include "fields_bwd.cuh"

extern "C" int hn_fields_bwd_trans(HN_FIELDS_BWD_ARGS) {
  return fb::launch_fields_bwd<0>(z, origins, dirs, embed, dx_t,
                                  warp_scales, weights, biases, d_z, d_ray,
                                  grads, scratch, n_points, samples, blocks,
                                  stream);
}

#ifdef HN_FIELDS_BWD_TRACE
// The cycles block 0 added up (fields_bwd.cuh), as [group][tile][kind];
// then zeroes them for the next launch.
extern "C" int hn_fields_bwd_trace(long long* out) {
  constexpr int kCount = fb::kGroups * fb::kTraceTiles * fb::kTraceKinds;
  static long long zero[kCount];
  int err = (int)cudaMemcpyFromSymbol(out, fb::fields_bwd_trace,
                                      sizeof(zero));
  if (err) return err;
  return (int)cudaMemcpyToSymbol(fb::fields_bwd_trace, zero, sizeof(zero));
}
#endif
