// The template alone on the level forward's block (level_fwd.cuh's
// template stage run by itself, modular_fwd.cu's header comment), a kernel
// template over the encoding's layout: modular_fwd.cu instantiates the
// posenc_orig layout and template_fwd_anneal.cu the Nerfies one, each in
// its own nvcc process.

#pragma once

#include "level_fwd.cuh"

namespace {
namespace lf {

using MT = TransTable;  // the per-module kernels' layer table

// The template's row inputs: x_raw rows [xyz | hyper | 0] into rows.raw
// (threads 0..63 the first four columns, 64..127 the last four) and the
// condition row of each, p / S; zeros and row 0 past P.
__device__ __forceinline__ void template_rows(
    const Group& g, long long row0, long long n_points, int samples,
    const float* __restrict__ x_raw) {
  const int r = g.tid & (kRows - 1), h = g.tid >> 6;
  const long long p = row0 + r;
  const bool valid = p < n_points;
  const float4 v = valid ? reinterpret_cast<const float4*>(x_raw)[2 * p + h]
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  float* raw = g.rows->raw[r] + 4 * h;
  raw[0] = v.x, raw[1] = v.y, raw[2] = v.z, raw[3] = h ? 0.f : v.w;
  if (h == 0) g.rows->ray[r] = valid ? (int)(p / samples) : 0;
}

// The template alone in layout TmplEnc<kNerfies> (template_stage).
template <bool kNerfies>
__global__ void __launch_bounds__(LevelBlock::kThreads, 1)
    template_fwd_kernel(const __grid_constant__ Maps<MT> maps,
                        const float* __restrict__ x_raw,
                        const bf16* __restrict__ rgb_cond,
                        const float* __restrict__ scales,
                        const bf16* __restrict__ B, float* __restrict__ out,
                        long long n_points, int samples) {
  Group g;
  Ring ring;
  const bf16* Bs;
  if (!enter_block<LevelBlock, MT, MT::kFields, MT::kNum>(maps, B, n_points,
                                                          g, ring, Bs))
    return;
  const long long n_pairs = tile_steps<LevelBlock>(n_points);
  for (long long pair = blockIdx.x; pair < n_pairs;
       pair += gridDim.x, ++g.it) {
    const long long row0 = first_row<LevelBlock>(g, pair);
    template_rows(g, row0, n_points, samples, x_raw);
    g.sync();
    template_stage<MT, kNerfies>(g, ring, Bs, rgb_cond, scales, out, row0,
                                 n_points);
  }
}

// Host side of template_fwd_kernel<kNerfies>: the tensor maps of the
// template's blob, the shared-memory attribute once per device, a
// persistent grid.
template <bool kNerfies>
int launch_template(const void* x_raw, const void* rgb_cond,
                    const void* scales, const void* weights,
                    const void* biases, void* out, long long n_points,
                    int samples, void* stream) {
  static std::atomic<int> configured[kMaxDevices];
  unsigned grid = 0;
  int status = block_grid<LevelBlock>(template_fwd_kernel<kNerfies>,
                                      configured, n_points, &grid);
  if (status) return status;
  Maps<MT> maps;
  status = make_maps<MT>(&maps, static_cast<const bf16*>(weights),
                         MT::kFields, MT::kNum);
  if (status) return status;
  template_fwd_kernel<kNerfies><<<grid, LevelBlock::kThreads,
                                  LevelBlock::kSmemBytes,
                                  (cudaStream_t)stream>>>(
      maps, static_cast<const float*>(x_raw),
      static_cast<const bf16*>(rgb_cond), static_cast<const float*>(scales),
      static_cast<const bf16*>(biases), static_cast<float*>(out), n_points,
      samples);
  return (int)cudaGetLastError();
}

}  // namespace lf
}  // namespace

// The template alone in the Nerfies layout (template_fwd_anneal.cu), with
// hn_fused_template_fwd's arguments.
extern "C" int hn_template_fwd_anneal(const void* x_raw, const void* rgb_cond,
                                      const void* scales, const void* weights,
                                      const void* biases, void* out,
                                      long long n_points, int samples,
                                      void* stream);
