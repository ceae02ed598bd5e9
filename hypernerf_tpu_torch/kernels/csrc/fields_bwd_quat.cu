// The fields backward (kernel B) with the quaternion warp: fields_bwd.cuh's
// kernel for warp type 2, compiled on its own so that the three
// instantiations build in parallel.

#include "fields_bwd.cuh"

extern "C" int hn_fields_bwd_quat(HN_FIELDS_BWD_ARGS) {
  return fb::launch_fields_bwd<2>(z, origins, dirs, embed, dx_t,
                                  warp_scales, weights, biases, d_z, d_ray,
                                  grads, scratch, n_points, samples, blocks,
                                  stream);
}
