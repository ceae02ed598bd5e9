// The level kernels' entry points: the compiled layer tables; the forward's
// plan (tile, ring, column plan and weight-load schedule) and launch, which
// dispatches to the kernel of the table (level_fwd.cuh, compiled per warp
// type in level_fwd_trans.cu, level_fwd_se3.cu, level_fwd_quat.cu, for the
// plane configuration in level_fwd_plane.cu); the fields backward's (kernel
// B) plan, grid and launch (fields_bwd.cuh, in fields_bwd_trans.cu,
// fields_bwd_se3.cu, fields_bwd_quat.cu, fields_bwd_plane.cu).
// A table code: 0, 1 and 2 the levels with the translation, the SE(3) and
// the quaternion warp (a warp type), 3 the plane configuration's level (the
// translation warp, no sheet: PlaneTable).

#include "fields_bwd.cuh"

// The compiled layer table of table code `warp_type` (0 translation, 1
// SE(3), 2 quaternion: the last two share one table; 3 plane).
extern "C" int hn_fused_level_layout(int warp_type, int* n, int* k,
                                     int max_layers) {
  const int count = warp_type == 0   ? TransTable::kNum
                    : warp_type == 3 ? PlaneTable::kNum
                                     : Se3Table::kNum;
  for (int l = 0; l < count && l < max_layers; ++l) {
    const Shape s = warp_type == 0   ? TransTable::shape(l)
                    : warp_type == 3 ? PlaneTable::shape(l)
                                     : Se3Table::shape(l);
    n[l] = s.n;
    k[l] = s.k;
  }
  return count;
}

// The forward's plan for table code `warp_type` (lf::forward_plan over
// all the level's layers): config[0:8], in_cols[l] for every layer l, and
// the weight loads of one pair of row tiles. Returns the number of loads
// (written up to max_loads).
extern "C" int hn_fused_level_fwd_plan(int warp_type, int* config,
                                       int* in_cols, int* loads,
                                       int max_loads) {
  if (warp_type == 3)
    return lf::forward_plan<lf::PlaneBlock, PlaneTable>(
        0, PlaneTable::kNum, config, in_cols, loads, max_loads);
  return warp_type == 0
             ? lf::forward_plan<lf::LevelBlock, TransTable>(
                   0, TransTable::kNum, config, in_cols, loads, max_loads)
             : lf::forward_plan<lf::LevelBlock, Se3Table>(
                   0, Se3Table::kNum, config, in_cols, loads, max_loads);
}

// warp_type: a table code, 0 translation, 1 SE(3), 2 quaternion, 3 plane;
// weights / biases in that table (pack_level's blobs). warp_scales: null,
// or the 64 fp32 window weights of the SE(3) / quaternion trunk's encoding
// (unused by the translation warp). tmpl_scales: null for the template's
// posenc_orig layout; the Nerfies layout's 128 fp32 window weights otherwise
// (level_common.cuh TmplLayout), with the translation warp alone
// (level_fwd_anneal.cu). The conditions (level_fwd.cuh Cond): rgb_cond (R,
// cond_w) bf16, cond_w 0..48; alpha_cond (R, 8) bf16 and alpha_w (8) bf16,
// or both null. The plane level (level_fwd_plane.cu) takes no window row
// and writes raw_t as (P, 16).
extern "C" int hn_fused_level_fwd(int warp_type, const void* z,
                                  const void* origins, const void* dirs,
                                  const void* embed, const void* rgb_cond,
                                  const void* alpha_cond, const void* alpha_w,
                                  const void* warp_scales,
                                  const void* tmpl_scales, const void* weights,
                                  const void* biases, void* out, void* raw_t,
                                  long long n_rays, int samples, int cond_w,
                                  void* stream) {
  const long long n_points = n_rays * samples;
  if (lf::bad_conditions(rgb_cond, alpha_cond, alpha_w, cond_w))
    return (int)cudaErrorInvalidValue;
  if (warp_type == 0)
    return (tmpl_scales ? hn_level_fwd_anneal
                        : hn_level_fwd_trans)(HN_LEVEL_FWD_PASS);
  if (tmpl_scales) return (int)cudaErrorInvalidValue;
  switch (warp_type) {
    case 3:
      return hn_level_fwd_plane(HN_LEVEL_FWD_PASS);
    case 1:
      return hn_level_fwd_se3(HN_LEVEL_FWD_PASS);
    case 2:
      return hn_level_fwd_quat(HN_LEVEL_FWD_PASS);
  }
  return (int)cudaErrorInvalidValue;
}

// The fields backward's plan for table code `warp_type`: config[0:9] = rows
// of a block tile, consumer warpgroups, ring stages, bytes of a stage,
// dynamic shared memory, threads, slabs of the pool, spill slabs a block,
// copies of the gradient buffer;
// table[0:60] the sheet's buffer plan and table[60:120] the warp field's
// (the plane level, which has no sheet: table[0:60] the warp field's), six
// ints per buffer (enc, h0..h5, T, skip, lo): forward slots (2), spill slab,
// the walk-back layer after which it is reloaded, reload slots (2);
// loads[3 i : 3 i + 3] = (layer, 64-column box of K, box rows) of the i-th
// weight load of one block tile. Returns the number of loads (written up to
// max_loads).
extern "C" int hn_fused_fields_bwd_plan(int warp_type, int* config,
                                        int* table, int* loads,
                                        int max_loads) {
  fb::plan_config(config);
  if (warp_type == 3) {  // the translation warp's layers alone
    fb::plan_table(fb::kTransWarp, table);
    return fb::plan_loads<PlaneTable>(0, fb::top(fb::kTransWarp) + 1, loads,
                                      0, max_loads);
  }
  const int wf = warp_type == 0 ? fb::kTransWarp : fb::kSe3Warp;
  fb::plan_table(fb::kSheet, table);
  fb::plan_table(wf, table + 6 * fb::kBufs);
  const int nw = fb::top(wf) + 1;
  // The sheet's six hidden layers, then the warp's (the SE(3) trunk's seven).
  if (warp_type == 0) {
    const int n =
        fb::plan_loads<TransTable>(TransTable::kWarp, 6, loads, 0, max_loads);
    return fb::plan_loads<TransTable>(0, nw, loads, n, max_loads);
  }
  const int n =
      fb::plan_loads<Se3Table>(Se3Table::kWarp, 6, loads, 0, max_loads);
  return fb::plan_loads<Se3Table>(0, nw, loads, n, max_loads);
}

// Blocks of the fields backward's persistent grid for n_points samples (a
// field alone's too, fields_bwd_alone.cu): one per SM, never more than
// there are block tiles.
extern "C" int hn_fused_fields_bwd_blocks(long long n_points) {
  int dev = 0, sms = 0;
  if (current_device(&dev, &sms)) return 0;
  const long long tiles = (n_points + fb::kTileRows - 1) / fb::kTileRows;
  return (int)(tiles < sms ? tiles : sms);
}

// warp_type: a table code, 0 translation, 1 SE(3), 2 quaternion, 3 plane;
// weights / biases in that table (pack_level's blobs). warp_scales: null,
// or the 64 fp32 window weights of the SE(3) / quaternion trunk's encoding.
// dx_t: (P, 8), or (P, 16) for the plane level. grads: [dW of the field
// layers | db of the field layers] (14 layers, 16, or the plane's 7), in
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
    case 3:
      return hn_fields_bwd_plane(z, origins, dirs, embed, dx_t, warp_scales,
                                 weights, biases, d_z, d_ray, grads, scratch,
                                 n_points, samples, blocks, stream);
  }
  return (int)cudaErrorInvalidValue;
}
