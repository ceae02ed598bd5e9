// The level kernels' entry points: the compiled layer tables; the forward's
// plan (tile, ring, column plan and weight-load schedule) and launch, which
// dispatches to the kernel of the table and the template's layout
// (level_fwd.cuh, compiled per warp type and layout in level_fwd_*.cu); the
// fields backward's (kernel B) plan, grid and launch (fields_bwd.cuh, in
// fields_bwd_trans.cu, fields_bwd_se3.cu, fields_bwd_quat.cu,
// fields_bwd_plane.cu, fields_bwd_plane_screw.cu).
// A table code names a table of the level's layers and the warp type: 0, 1
// and 2 the levels with the sheet and the translation, the SE(3) and the
// quaternion warp (a warp type; the template posenc_orig or Nerfies, as the
// window row says), 3, 4 and 5 the same warps without a sheet with the
// template's plane layout (PlaneTable, Se3PlaneTable), 6, 7 and 8 without a
// sheet with the Nerfies plane layout (the tables over NerfPlaneEnc). The
// warp type of code c is c % 3.

#include "fields_bwd.cuh"

namespace {

template <class T_, class L_>
struct TableTag {
  using T = T_;  // the layer table
  using L = L_;  // the template's layout (its block)
};

// f(TableTag<table, layout>{}) for table code `code`; -1 for another code.
template <class F>
int with_table(int code, F f) {
  switch (code) {
    case 0: return f(TableTag<TransTable, OrigEnc>{});
    case 1:
    case 2: return f(TableTag<Se3Table, OrigEnc>{});
    case 3: return f(TableTag<PlaneTable, PlaneEnc>{});
    case 4:
    case 5: return f(TableTag<Se3PlaneTable, PlaneEnc>{});
    case 6: return f(TableTag<PlaneTableOf<NerfPlaneEnc>, NerfPlaneEnc>{});
    case 7:
    case 8:
      return f(TableTag<Se3PlaneTableOf<NerfPlaneEnc>, NerfPlaneEnc>{});
  }
  return -1;
}

}  // namespace

// The compiled layer table of table code `warp_type`: its layer count
// (n[l], k[l] written up to max_layers), or -1 for an unknown code.
extern "C" int hn_fused_level_layout(int warp_type, int* n, int* k,
                                     int max_layers) {
  return with_table(warp_type, [&](auto tag) {
    using T = typename decltype(tag)::T;
    for (int l = 0; l < T::kNum && l < max_layers; ++l) {
      n[l] = T::shape(l).n;
      k[l] = T::shape(l).k;
    }
    return T::kNum;
  });
}

// The forward's plan for table code `warp_type` (lf::forward_plan of its
// block over all the level's layers): config[0:8], in_cols[l] for every
// layer l, and the weight loads of one pair of row tiles. Returns the
// number of loads (written up to max_loads), or -1 for an unknown code.
extern "C" int hn_fused_level_fwd_plan(int warp_type, int* config,
                                       int* in_cols, int* loads,
                                       int max_loads) {
  return with_table(warp_type, [&](auto tag) {
    using T = typename decltype(tag)::T;
    return lf::forward_plan<lf::TmplBlock<typename decltype(tag)::L>, T>(
        0, T::kNum, config, in_cols, loads, max_loads);
  });
}

// warp_type: a table code; weights / biases in that table (pack_level's
// blobs). warp_scales: null, or the 64 fp32 window weights of the SE(3) /
// quaternion trunk's encoding (unused by the translation warp).
// tmpl_scales: the template's window row (128 fp32), which codes 0..2 take
// for the Nerfies layout (null: posenc_orig) and codes 6..8 require; codes
// 3..5 take none. The conditions (level_fwd.cuh Cond): rgb_cond (R,
// cond_w) bf16, cond_w 0..48; alpha_cond (R, 8) bf16 and alpha_w (8) bf16,
// or both null. The levels without a sheet (codes 3..8) write raw_t as
// (P, 16).
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
  if (lf::bad_conditions(rgb_cond, alpha_cond, alpha_w, cond_w) ||
      (warp_type >= 3 && (tmpl_scales != nullptr) != (warp_type >= 6)))
    return (int)cudaErrorInvalidValue;
  switch (warp_type) {
    case 0:
      return (tmpl_scales ? hn_level_fwd_anneal
                          : hn_level_fwd_trans)(HN_LEVEL_FWD_PASS);
    case 1:
      return (tmpl_scales ? hn_level_fwd_anneal_se3
                          : hn_level_fwd_se3)(HN_LEVEL_FWD_PASS);
    case 2:
      return (tmpl_scales ? hn_level_fwd_anneal_quat
                          : hn_level_fwd_quat)(HN_LEVEL_FWD_PASS);
    case 3:
      return hn_level_fwd_plane(HN_LEVEL_FWD_PASS);
    case 4:
      return hn_level_fwd_plane_se3(HN_LEVEL_FWD_PASS);
    case 5:
      return hn_level_fwd_plane_quat(HN_LEVEL_FWD_PASS);
    case 6:
      return hn_level_fwd_nerf_plane(HN_LEVEL_FWD_PASS);
    case 7:
      return hn_level_fwd_nerf_plane_se3(HN_LEVEL_FWD_PASS);
    case 8:
      return hn_level_fwd_nerf_plane_quat(HN_LEVEL_FWD_PASS);
  }
  return (int)cudaErrorInvalidValue;
}

// The fields backward's plan for table code `warp_type`: config[0:9] = rows
// of a block tile, consumer warpgroups, ring stages, bytes of a stage,
// dynamic shared memory, threads, slabs of the pool, spill slabs a block,
// copies of the gradient buffer;
// table[0:60] the sheet's buffer plan and table[60:120] the warp field's
// (a level without a sheet, codes 3..8: table[0:60] the warp field's), six
// ints per buffer (enc, h0..h5, T, skip, lo): forward slots (2), spill
// slab, the walk-back layer after which it is reloaded, reload slots (2);
// loads[3 i : 3 i + 3] = (layer, 64-column box of K, box rows) of the i-th
// weight load of one block tile. Returns the number of loads (written up
// to max_loads), or -1 for an unknown code.
extern "C" int hn_fused_fields_bwd_plan(int warp_type, int* config,
                                        int* table, int* loads,
                                        int max_loads) {
  if (warp_type < 0 || warp_type > 8) return -1;
  fb::plan_config(config);
  const int wf = warp_type % 3 == 0 ? fb::kTransWarp : fb::kSe3Warp;
  const int nw = fb::top(wf) + 1;
  if (warp_type >= 3) {  // the warp's layers alone
    fb::plan_table(wf, table);
    return wf == fb::kTransWarp
               ? fb::plan_loads<PlaneTable>(0, nw, loads, 0, max_loads)
               : fb::plan_loads<Se3PlaneTable>(0, nw, loads, 0, max_loads);
  }
  fb::plan_table(fb::kSheet, table);
  fb::plan_table(wf, table + 6 * fb::kBufs);
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

// warp_type: a table code; weights / biases in that table (pack_level's
// blobs; the kernel reads the field layers). warp_scales: null, or the 64
// fp32 window weights of the SE(3) / quaternion trunk's encoding. dx_t:
// (P, 8), or (P, 16) for a level without a sheet (codes 3..8). grads: [dW
// of the field layers | db of the field layers] (14 layers, 16, or without
// a sheet 7 or 9), in fb::kGradCopies copies one after the other (block b
// adds into copy b % fb::kGradCopies); grads and d_ray (R, 14) must be zero
// on entry. scratch: blocks x fb::kSpillSlabs x 16 KB of spill slabs.
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
      return hn_fields_bwd_trans(HN_FIELDS_BWD_PASS);
    case 1:
      return hn_fields_bwd_se3(HN_FIELDS_BWD_PASS);
    case 2:
      return hn_fields_bwd_quat(HN_FIELDS_BWD_PASS);
    case 3:
    case 6:
      return hn_fields_bwd_plane(HN_FIELDS_BWD_PASS);
    case 4:
    case 7:
      return hn_fields_bwd_plane_se3(HN_FIELDS_BWD_PASS);
    case 5:
    case 8:
      return hn_fields_bwd_plane_quat(HN_FIELDS_BWD_PASS);
  }
  return (int)cudaErrorInvalidValue;
}
