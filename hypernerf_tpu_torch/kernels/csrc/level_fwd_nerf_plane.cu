// The level forward with the translation warp and the template's Nerfies
// plane layout (the plane_anneal configuration: axis_aligned_plane slicing
// with use_original_embed=False), and the template alone in that layout:
// level_fwd.cuh's kernel for warp type 0 and template_fwd.cuh's, each with
// NerfPlaneEnc (127 encoding columns in 128, raw rows of 16 columns, the
// window row; the level's block of two 384-column tiles), compiled on their
// own so that they build in parallel with the other instantiations and add
// no code to them.
//
// The template alone: x_raw (P, 16) fp32 rows [xyz | hyper (8) | 0]; the
// conditions as hn_fused_template_fwd takes them; weights / biases: the
// template's 16 layers alone (layers 7..22 of PlaneTableOf<NerfPlaneEnc>,
// the shapes of TransTable's 14..29); scales: the window row (128 fp32).

#include "template_fwd.cuh"

extern "C" int hn_level_fwd_nerf_plane(HN_LEVEL_FWD_ARGS) {
  return lf::launch_level_fwd<0, NerfPlaneEnc>(HN_LEVEL_FWD_PASS);
}

extern "C" int hn_template_fwd_nerf_plane(HN_TEMPLATE_FWD_ARGS) {
  return lf::launch_template<NerfPlaneEnc>(HN_TEMPLATE_FWD_PASS);
}
