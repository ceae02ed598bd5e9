// The fields backward (kernel B) of the levels with the translation warp and
// no sheet (the plane and plane_anneal configurations): the translation
// warp field alone (fields_bwd.cuh's kernel for warp type 0
// without the sheet), d embed = the warp's + dx_t[:, 3:11], compiled on its
// own so that it builds in parallel with the other instantiations and adds
// no code to them.

#include "fields_bwd.cuh"

extern "C" int hn_fields_bwd_plane(HN_FIELDS_BWD_ARGS) {
  return fb::launch_fields_bwd<0, true>(z, origins, dirs, embed, dx_t,
                                        warp_scales, weights, biases, d_z,
                                        d_ray, grads, scratch, n_points,
                                        samples, blocks, stream);
}
