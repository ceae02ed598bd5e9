// The level kernels' entry points: the compiled layer tables; the forward's
// plan (tile, ring, column plan and weight-load schedule) and launch, which
// dispatches to the kernel of the warp type (level_fwd.cuh, compiled per
// warp type in level_fwd_trans.cu, level_fwd_se3.cu, level_fwd_quat.cu); the
// fields backward's (kernel B) plan, grid and launch (fields_bwd.cuh, in
// fields_bwd_trans.cu, fields_bwd_se3.cu, fields_bwd_quat.cu).

#include "fields_bwd.cuh"

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

namespace {

void fields_bwd_plan_of(int field, int* table) {
  for (int b = 0; b < fb::kBufs; ++b) {
    const fb::BufPlan p = fb::buf_plan(field, b);
    const int row[6] = {p.fwd[0], p.fwd[1],    p.spill,
                        p.after,  p.reload[0], p.reload[1]};
    for (int i = 0; i < 6; ++i) table[6 * b + i] = row[i];
  }
}

template <class T>
int fields_bwd_loads(int warp_field, int* loads, int max_loads) {
  int n = 0;
  auto layer = [&](int l) {
    const Shape s = T::shape(l);
    for (int kb = 0; kb < lf::k_boxes(s); ++kb, ++n)
      if (n < max_loads) {
        loads[3 * n] = l;
        loads[3 * n + 1] = kb;
        loads[3 * n + 2] = lf::box_rows(s);
      }
  };
  const int nw = fb::top(warp_field) + 1;
  for (int i = 0; i < 6; ++i) layer(T::kWarp + i);
  for (int i = 5; i >= 0; --i) layer(T::kWarp + i);
  for (int i = 0; i < nw; ++i) layer(i);
  for (int i = nw - 1; i >= 0; --i) layer(i);
  return n;
}

}  // namespace

// The fields backward's plan for warp type `warp_type`: config[0:9] = rows
// of a block tile, consumer warpgroups, ring stages, bytes of a stage,
// dynamic shared memory, threads, slabs of the pool, spill slabs a block,
// copies of the gradient buffer;
// table[0:54] the sheet's buffer plan and table[54:108] the warp field's,
// six ints per buffer (enc, h0..h5, T, skip): forward slots (2), spill slab,
// the walk-back layer after which it is reloaded, reload slots (2);
// loads[3 i : 3 i + 3] = (layer, 64-column box of K, box rows) of the i-th
// weight load of one block tile. Returns the number of loads (written up to
// max_loads).
extern "C" int hn_fused_fields_bwd_plan(int warp_type, int* config,
                                        int* table, int* loads,
                                        int max_loads) {
  const int c[] = {fb::kTileRows,  fb::kGroups,      fb::kStages,
                   fb::kStageBytes, fb::kSmemBytes,    fb::kThreads,
                   fb::kSlots,      fb::kSpillSlabs, fb::kGradCopies};
  for (int i = 0; i < 9; ++i) config[i] = c[i];
  const int wf = warp_type == 0 ? fb::kTransWarp : fb::kSe3Warp;
  fields_bwd_plan_of(fb::kSheet, table);
  fields_bwd_plan_of(wf, table + 6 * fb::kBufs);
  return warp_type == 0
             ? fields_bwd_loads<TransTable>(wf, loads, max_loads)
             : fields_bwd_loads<Se3Table>(wf, loads, max_loads);
}

// Blocks of the fields backward's persistent grid for n_points samples:
// one per SM, never more than there are block tiles.
extern "C" int hn_fused_fields_bwd_blocks(long long n_points) {
  int dev = 0, sms = 0;
  if (current_device(&dev, &sms)) return 0;
  const long long tiles = (n_points + fb::kTileRows - 1) / fb::kTileRows;
  return (int)(tiles < sms ? tiles : sms);
}

// warp_type: 0 translation, 1 SE(3), 2 quaternion; weights / biases in that
// type's table (pack_level's blobs). warp_scales: null, or the 64 fp32
// window weights of the SE(3) / quaternion trunk's encoding. grads: [dW of
// the field layers | db of the field layers] (14 layers, or 16), in
// fb::kGradCopies copies one after the other (block b adds into copy b %
// fb::kGradCopies); grads and d_ray (R, 14) must be zero on entry. scratch:
// blocks x fb::kSpillSlabs x 16 KB of spill slabs.
extern "C" int hn_fused_fields_bwd(int warp_type, const void* z,
                                   const void* origins, const void* dirs,
                                   const void* embed, const void* dx_t,
                                   const void* warp_scales,
                                   const void* weights, const void* biases,
                                   void* d_z, void* d_ray, void* grads,
                                   void* scratch, long long n_rays,
                                   int samples, int blocks, void* stream) {
  const long long n_points = n_rays * samples;
  switch (warp_type) {
    case 0:
      return hn_fields_bwd_trans(z, origins, dirs, embed, dx_t, warp_scales,
                                 weights, biases, d_z, d_ray, grads, scratch,
                                 n_points, samples, blocks, stream);
    case 1:
      return hn_fields_bwd_se3(z, origins, dirs, embed, dx_t, warp_scales,
                               weights, biases, d_z, d_ray, grads, scratch,
                               n_points, samples, blocks, stream);
    case 2:
      return hn_fields_bwd_quat(z, origins, dirs, embed, dx_t, warp_scales,
                                weights, biases, d_z, d_ray, grads, scratch,
                                n_points, samples, blocks, stream);
  }
  return (int)cudaErrorInvalidValue;
}
