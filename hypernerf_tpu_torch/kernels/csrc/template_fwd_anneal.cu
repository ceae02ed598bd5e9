// The template alone in the Nerfies layout (the anneal configuration):
// template_fwd.cuh's kernel with NerfEnc, compiled on its own so that it
// builds in parallel with modular_fwd.cu and adds no code to it.

#include "template_fwd.cuh"

extern "C" int hn_template_fwd_anneal(HN_TEMPLATE_FWD_ARGS) {
  return lf::launch_template<NerfEnc>(HN_TEMPLATE_FWD_PASS);
}

#ifdef HN_LEVEL_FWD_TRACE
// The clocks block 0 of the Nerfies template recorded (level_fwd.cuh), as
// [group][pair][layer][4].
extern "C" int hn_template_fwd_anneal_trace(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, lf::level_fwd_trace,
                                   sizeof(lf::level_fwd_trace));
}
#endif
