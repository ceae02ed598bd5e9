// The level forward's entry points: the compiled layer tables, the forward's
// plan (tile, ring, column plan and weight-load schedule) and the launch,
// which dispatches to the kernel of the warp type (level_fwd.cuh, compiled
// per warp type in level_fwd_trans.cu, level_fwd_se3.cu, level_fwd_quat.cu).

#include "level_fwd.cuh"

// The compiled layer table of the level with warp `warp_type` (0 translation,
// 1 SE(3), 2 quaternion: the last two share one table).
extern "C" int hn_fused_level_layout(int warp_type, int* n, int* k,
                                     int max_layers) {
  const int count = warp_type == 0 ? TransTable::kNum : Se3Table::kNum;
  for (int l = 0; l < count && l < max_layers; ++l) {
    const Shape s = warp_type == 0 ? TransTable::shape(l) : Se3Table::shape(l);
    n[l] = s.n;
    k[l] = s.k;
  }
  return count;
}

namespace {

template <class T>
int level_fwd_plan(int* config, int* in_cols, int* loads, int max_loads) {
  const int c[] = {lf::kRows,       lf::kGroups,     lf::kStages,
                   lf::kStageBytes, lf::kSmemBytes,  lf::kThreads,
                   lf::kCols,       lf::map_count<T>()};
  for (int i = 0; i < 8; ++i) config[i] = c[i];
  int n = 0;
  for (int l = 0; l < T::kNum; ++l) {
    in_cols[l] = lf::in_col<T>(l);
    const Shape s = T::shape(l);
    for (int kb = 0; kb < lf::k_boxes(s); ++kb)
      for (int nb = 0; nb < lf::n_halves(s); ++nb, ++n)
        if (n < max_loads) {
          loads[4 * n] = l;
          loads[4 * n + 1] = kb;
          loads[4 * n + 2] = nb;
          loads[4 * n + 3] = lf::box_rows(s);
        }
  }
  return n;
}

}  // namespace

// The forward's plan for warp type `warp_type`: config[0:8] = rows of a
// warpgroup's tile, consumer warpgroups, ring stages, bytes of a stage,
// dynamic shared memory, threads, tile columns, tensor maps; in_cols[l] =
// the first tile column of layer l's input; loads[4 i : 4 i + 4] = (layer,
// 64-column box of K, 128-row half of N, box rows) of the i-th weight load
// of one pair of row tiles, in the order the producer issues and the
// consumers take them. Returns the number of loads (written up to
// max_loads).
extern "C" int hn_fused_level_fwd_plan(int warp_type, int* config,
                                       int* in_cols, int* loads,
                                       int max_loads) {
  return warp_type == 0
             ? level_fwd_plan<TransTable>(config, in_cols, loads, max_loads)
             : level_fwd_plan<Se3Table>(config, in_cols, loads, max_loads);
}

// warp_type: 0 translation, 1 SE(3), 2 quaternion; weights / biases in that
// type's table (pack_level's blobs). warp_scales: null, or the 64 fp32
// window weights of the SE(3) / quaternion trunk's encoding (unused by the
// translation warp).
extern "C" int hn_fused_level_fwd(int warp_type, const void* z,
                                  const void* origins, const void* dirs,
                                  const void* embed, const void* rgb_cond,
                                  const void* warp_scales, const void* weights,
                                  const void* biases, void* out, void* raw_t,
                                  long long n_rays, int samples,
                                  void* stream) {
  const long long n_points = n_rays * samples;
  switch (warp_type) {
    case 0:
      return hn_level_fwd_trans(z, origins, dirs, embed, rgb_cond, warp_scales,
                                weights, biases, out, raw_t, n_points, samples,
                                stream);
    case 1:
      return hn_level_fwd_se3(z, origins, dirs, embed, rgb_cond, warp_scales,
                              weights, biases, out, raw_t, n_points, samples,
                              stream);
    case 2:
      return hn_level_fwd_quat(z, origins, dirs, embed, rgb_cond, warp_scales,
                               weights, biases, out, raw_t, n_points, samples,
                               stream);
  }
  return (int)cudaErrorInvalidValue;
}
