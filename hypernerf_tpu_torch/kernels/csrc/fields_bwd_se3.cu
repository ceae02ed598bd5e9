// The fields backward (kernel B) with the SE(3) warp: fields_bwd.cuh's
// kernel for warp type 1, compiled on its own so that the three
// instantiations build in parallel.

#include "fields_bwd.cuh"

extern "C" int hn_fields_bwd_se3(HN_FIELDS_BWD_ARGS) {
  return fb::launch_fields_bwd<1>(z, origins, dirs, embed, dx_t,
                                  warp_scales, weights, biases, d_z, d_ray,
                                  grads, scratch, n_points, samples, blocks,
                                  stream);
}
