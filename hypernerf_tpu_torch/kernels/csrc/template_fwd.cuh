// The template alone on the level forward's block (level_fwd.cuh's
// template stage run by itself, modular_fwd.cu's header comment), a kernel
// template over the encoding's layout: modular_fwd.cu instantiates the
// posenc_orig layout, template_fwd_anneal.cu the Nerfies one,
// template_fwd_plane.cu the plane one (its own table's layers 7..22 on
// PlaneBlock) and level_fwd_nerf_plane.cu the Nerfies plane one (layers
// 7..22 of its table, on the level's block), each in its own nvcc process.

#pragma once

#include "level_fwd.cuh"

namespace {
namespace lf {

using MT = TransTable;  // the per-module kernels' layer table

// The template's row inputs: x_raw rows [xyz | hyper | 0] of L::kRaw
// columns into rows.raw (threads 0..63 the first four columns, 64..127 the
// next four) or, plane (16 columns, two float4 a thread), the xyz into
// rows.raw and the 8 hyper coordinates into rows.in[:, 3:11], where the
// level keeps the embedding (encode_template); and the condition row of
// each, p / S; zeros and row 0 past P.
template <class L>
__device__ __forceinline__ void template_rows(
    const Group& g, long long row0, long long n_points, int samples,
    const float* __restrict__ x_raw) {
  const int r = g.tid & (kRows - 1), h = g.tid >> 6;
  const long long p = row0 + r;
  const bool valid = p < n_points;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* src = reinterpret_cast<const float4*>(x_raw);
  if constexpr (L::kPlane) {
    const float4 a = valid ? src[4 * p + 2 * h] : zero;
    const float4 b = valid ? src[4 * p + 2 * h + 1] : zero;
    float* in = g.rows->in[r];
    if (h == 0) {  // [x y z e0 | e1 e2 e3 e4]
      float* raw = g.rows->raw[r];
      raw[0] = a.x, raw[1] = a.y, raw[2] = a.z;
      in[3] = a.w, in[4] = b.x, in[5] = b.y, in[6] = b.z, in[7] = b.w;
    } else {  // [e5 e6 e7 0 | 0 0 0 0]
      in[8] = a.x, in[9] = a.y, in[10] = a.z;
    }
  } else {
    const float4 v = valid ? src[2 * p + h] : zero;
    float* raw = g.rows->raw[r] + 4 * h;
    raw[0] = v.x, raw[1] = v.y, raw[2] = v.z, raw[3] = h ? 0.f : v.w;
  }
  if (h == 0) g.rows->ray[r] = valid ? (int)(p / samples) : 0;
}

// The template alone in layout L (template_stage): the template's layers
// of the level table of L, from the template's own blob.
template <class L>
__global__ void __launch_bounds__(TmplBlock<L>::kThreads, 1)
    template_fwd_kernel(const __grid_constant__ Maps<LevelTable<0, L>> maps,
                        const float* __restrict__ x_raw, const Cond cond,
                        const float* __restrict__ scales,
                        const bf16* __restrict__ B, float* __restrict__ out,
                        long long n_points, int samples) {
  using T = LevelTable<0, L>;
  using Blk = TmplBlock<L>;
  Group g;
  typename Blk::Ring ring;
  const bf16* Bs;
  if (!enter_block<Blk, T, T::kFields, T::kNum>(maps, B, n_points, g, ring,
                                                Bs))
    return;
  const long long n_pairs = tile_steps<Blk>(n_points);
  for (long long pair = blockIdx.x; pair < n_pairs;
       pair += gridDim.x, ++g.it) {
    const long long row0 = first_row<Blk>(g, pair);
    template_rows<L>(g, row0, n_points, samples, x_raw);
    g.sync();
    template_stage<T, L>(g, ring, Bs, cond, scales, out, row0, n_points);
  }
}

// Host side of template_fwd_kernel<L>: the tensor maps of the template's
// blob, the shared-memory attribute once per device, a persistent grid.
template <class L>
int launch_template(const void* x_raw, const void* rgb_cond,
                    const void* alpha_cond, const void* alpha_w,
                    const void* scales, const void* weights,
                    const void* biases, void* out, long long n_points,
                    int samples, int cond_w, void* stream) {
  using T = LevelTable<0, L>;
  using Blk = TmplBlock<L>;
  static std::atomic<int> configured[kMaxDevices];
  unsigned grid = 0;
  int status = block_grid<Blk>(template_fwd_kernel<L>, configured, n_points,
                               &grid);
  if (status) return status;
  Maps<T> maps;
  status = make_maps<T>(&maps, static_cast<const bf16*>(weights),
                        T::kFields, T::kNum);
  if (status) return status;
  template_fwd_kernel<L><<<grid, Blk::kThreads, Blk::kSmemBytes,
                           (cudaStream_t)stream>>>(
      maps, static_cast<const float*>(x_raw),
      Cond{static_cast<const bf16*>(rgb_cond),
           static_cast<const bf16*>(alpha_cond),
           static_cast<const bf16*>(alpha_w), cond_w},
      static_cast<const float*>(scales),
      static_cast<const bf16*>(biases), static_cast<float*>(out), n_points,
      samples);
  return (int)cudaGetLastError();
}

}  // namespace lf
}  // namespace

// The template alone's arguments (hn_fused_template_fwd), and passed on.
#define HN_TEMPLATE_FWD_ARGS                                                \
  const void *x_raw, const void *rgb_cond, const void *alpha_cond,          \
      const void *alpha_w, const void *scales, const void *weights,         \
      const void *biases, void *out, long long n_points, int samples,       \
      int cond_w, void *stream
#define HN_TEMPLATE_FWD_PASS                                               \
  x_raw, rgb_cond, alpha_cond, alpha_w, scales, weights, biases, out,      \
      n_points, samples, cond_w, stream

// The template alone in the Nerfies layout (template_fwd_anneal.cu) and in
// the Nerfies plane layout (level_fwd_nerf_plane.cu), with
// hn_fused_template_fwd's arguments.
extern "C" int hn_template_fwd_anneal(HN_TEMPLATE_FWD_ARGS);
extern "C" int hn_template_fwd_nerf_plane(HN_TEMPLATE_FWD_ARGS);
