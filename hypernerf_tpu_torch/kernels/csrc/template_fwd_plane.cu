// The template alone in the plane layout (the plane configuration's
// template: posenc_orig of the warped point and of the 8 hyper coordinates,
// 167 columns in 192): template_fwd.cuh's kernel with PlaneEnc on
// PlaneBlock, compiled on its own so that it builds in parallel with
// modular_fwd.cu and adds no code to it; and the entry point of the
// template alone of every plane level.
//
// x_raw: (P, 16) fp32 rows [xyz | hyper (8) | 0]; the conditions as
// hn_fused_template_fwd takes them; weights / biases: the template's 16
// layers alone (layers 7..22 of its plane table); out (P, 4) fp32 [rgb
// logits | raw sigma]; scales: null for the plane layout, which has no
// window, or the Nerfies plane layout's window row (128 fp32), which
// selects that layout (level_fwd_nerf_plane.cu).

#include "template_fwd.cuh"

extern "C" int hn_fused_template_fwd_plane(HN_TEMPLATE_FWD_ARGS) {
  if (n_points <= 0 || samples <= 0 ||
      lf::bad_conditions(rgb_cond, alpha_cond, alpha_w, cond_w))
    return (int)cudaErrorInvalidValue;
  if (scales) return hn_template_fwd_nerf_plane(HN_TEMPLATE_FWD_PASS);
  return lf::launch_template<PlaneEnc>(HN_TEMPLATE_FWD_PASS);
}

#ifdef HN_LEVEL_FWD_TRACE
// The clocks block 0 of the plane template recorded (level_fwd.cuh), as
// [group][pair][layer][4].
extern "C" int hn_template_fwd_plane_trace(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, lf::level_fwd_trace,
                                   sizeof(lf::level_fwd_trace));
}
#endif
