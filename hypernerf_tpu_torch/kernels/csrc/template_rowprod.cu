// Kernel A's row product for Hopper (sm_90a): one layer of the template at a
// time over a chunk of rows, as `wgmma` products on TMA-loaded tiles.
//
// Part of the template backward (kernel A), which replaces
// hypernerf_tpu/ops/pallas/fused_mlp.py `_bwd_call` (:736; the tile body
// `_backward_tile_gen` :426-534) and the template half of the level
// backward's schedules (fused_level.py :1260, :1397). The host side
// (kernels/fused_mlp.py `fused_template_bwd`) runs it twice per layer:
//   recompute  out = bf16([relu](A W^T + b [+ per-ray term]))   A: the stash
//   cotangent  out = bf16(mask(h_in > 0) (G W))                 A: g, W^T
// so it computes, for one 128-column tile of the output per block,
//   out[r, c] = epilogue(sum_j A[r, col(j)] W[w_row0 + c, j]),  j < NRED,
// with col(j) = a_col0 + j below a_w0 and a_col1 + (j - a_w0) above (a
// skip layer's input [h4 | enc] sits in two column ranges of the stash).
//
// Bound: one multiply-add per weight and row, against the A row read, the
// bf16 output row written and the mask row read: at 256 x 256 that is 85 to
// 128 FLOP a byte, under the card's 295, so the rows' traffic bounds a
// layer. Design: the block's weight tile (128 rows x NRED, up to
// 96 KB) is loaded once by TMA and stays in shared memory while the block
// walks row tiles of 64 (a persistent grid over the chunk); two warpgroups
// take alternate row tiles, each with its own ring of A stages (one TMA box
// of 64 x 64 per 64 reduction columns, completing on an mbarrier), issue
// the m64n128k16 products (both operands K-major, 128-byte swizzle) and run
// the epilogue from their registers, so one's epilogue overlaps the other's
// products and the next stages' loads.

#include "level_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kGroups = 2;      // warpgroups of a block, each its own rows
constexpr int kThreads = 128 * kGroups;
constexpr int kTileRows = 64;   // rows of a product tile
constexpr int kTileCols = 128;  // output columns of a block

template <int NRED>
struct RowCfg {
  static constexpr int KB = NRED / kBoxCols;  // boxes per 64-row A tile
  static constexpr int W_BYTES = KB * kTileCols * 128;
  static constexpr int A_BYTES = KB * kTileRows * 128;
  static constexpr int FIT = (200 * 1024 - W_BYTES) / (kGroups * A_BYTES);
  // Per warpgroup: 2 where they fit in 200 KB, else 1 (the plane layout's
  // skip layer, NRED 448: a 112 KB weight tile).
  static constexpr int STAGES = FIT > 2 ? 2 : FIT > 1 ? FIT : 1;
  static constexpr int SMEM = 1024 + W_BYTES + kGroups * STAGES * A_BYTES +
                              8 * (kGroups * STAGES + 1);
  static_assert(NRED % kBoxCols == 0 && SMEM <= 232448, "tile plan");
};

struct RowArgs {
  int a_col0, a_w0, a_col1;  // reduction index -> column of A
  int w_row0;                // W row of output column 0 of tile 0
  long long n_rows;
  bf16* out;
  long long out_ld;
  int out_col0;
  const bf16* bias;       // by W row, or null
  const float* ray_bias;  // [row / samples][ray_ld] by W row - w_row0, or null
  int ray_ld, samples, relu;
  const bf16* mask;  // zero the output where mask[r, mask_col0 + c] <= 0
  long long mask_ld;
  int mask_col0;
};

// Block (column tile, y): warpgroup g takes row tiles y kGroups + g, then
// every kGroups gridDim.y-th; the two warpgroups share the weight tile and
// overlap one's epilogue with the other's products.
template <int NRED>
__global__ void __launch_bounds__(kThreads, 1)
    tmpl_rowprod_kernel(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap w_map,
                   const RowArgs args) {
  using C = RowCfg<NRED>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* w_s = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x & 127, group = threadIdx.x >> 7;
  uint8_t* a_s = w_s + C::W_BYTES + group * C::STAGES * C::A_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(w_s + C::W_BYTES +
                                               kGroups * C::STAGES * C::A_BYTES);
  uint64_t* full = bars + group * C::STAGES;
  uint64_t* w_bar = bars + kGroups * C::STAGES;

  const int tile_c = blockIdx.x;
  const int w_row = args.w_row0 + tile_c * kTileCols;
  const int c_out = tile_c * kTileCols;  // column of this tile in out / mask
  const long long n_tiles = (args.n_rows + kTileRows - 1) / kTileRows;
  const long long first = (long long)blockIdx.y * kGroups + group;
  const long long step = (long long)gridDim.y * kGroups;

  auto load_a = [&](int stage, long long tile) {
    uint8_t* dst = a_s + stage * C::A_BYTES;
    mbar_expect(&full[stage], C::A_BYTES);
#pragma unroll
    for (int b = 0; b < C::KB; ++b) {
      const int j = b * kBoxCols;
      const int col =
          j < args.a_w0 ? args.a_col0 + j : args.a_col1 + (j - args.a_w0);
      tma_load(dst + b * kTileRows * 128, &a_map, &full[stage], col,
               (int)(tile * kTileRows));
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kGroups * C::STAGES + 1; ++s) mbar_init(&bars[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(w_bar, C::W_BYTES);
    for (int b = 0; b < C::KB; ++b)
      tma_load(w_s + b * kTileCols * 128, &w_map, w_bar, b * kBoxCols, w_row);
  }
  if (tid == 0)
    for (int s = 0; s < C::STAGES; ++s)
      if (first + s * step < n_tiles) load_a(s, first + s * step);

  // The bias of this thread's 32 output columns.
  float bias[32];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = fragment_col(tid, j);
    bias[2 * j] = args.bias ? __bfloat162float(args.bias[w_row + c]) : 0.f;
    bias[2 * j + 1] =
        args.bias ? __bfloat162float(args.bias[w_row + c + 1]) : 0.f;
  }
  mbar_wait(w_bar, 0);

  for (long long it = 0;; ++it) {
    const long long tile = first + it * step;
    if (tile >= n_tiles) break;
    const int stage = (int)(it % C::STAGES);
    mbar_wait(&full[stage], (int)((it / C::STAGES) & 1));
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    fence_fragment(d);
    wgmma_fence();
    const uint8_t* a = a_s + stage * C::A_BYTES;
#pragma unroll
    for (int kk = 0; kk < NRED / 16; ++kk) {
      const int b = kk / 4, o = (kk % 4) * 32;
      wgmma_m64n128k16<0, 0>(
          d, sw128_desc(a + b * kTileRows * 128 + o, 16, kAtomBytes),
          sw128_desc(w_s + b * kTileCols * 128 + o, 16, kAtomBytes));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_fragment(d);
    // Every warp of this warpgroup is done reading the stage.
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + group) : "memory");
    if (tid == 0 && tile + C::STAGES * step < n_tiles)
      load_a(stage, tile + C::STAGES * step);

#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const long long r = tile * kTileRows + fragment_row(tid, e);
      if (r >= args.n_rows) continue;
      // The mask first, all loads in flight before any store.
      uint32_t m[16];
      if (args.mask) {
        const bf16* mp = args.mask + r * args.mask_ld + args.mask_col0 + c_out;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          m[j] = __ldg(reinterpret_cast<const unsigned int*>(
              mp + fragment_col(tid, j)));
      }
      const float* rb =
          args.ray_bias
              ? args.ray_bias + (r / args.samples) * args.ray_ld + c_out
              : nullptr;
      bf16* o = args.out + r * args.out_ld + args.out_col0 + c_out;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = fragment_col(tid, j);
        float v0 = d[4 * j + e] + bias[2 * j];
        float v1 = d[4 * j + e + 1] + bias[2 * j + 1];
        if (rb) {
          v0 += rb[c];
          v1 += rb[c + 1];
        }
        if (args.relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        if (args.mask) {
          const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(
              &m[j]);
          if (!(__low2float(h) > 0.f)) v0 = 0.f;
          if (!(__high2float(h) > 0.f)) v1 = 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(o + c) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int NRED>
int launch_rowprod(const CUtensorMap& a_map, const CUtensorMap& w_map,
                   const RowArgs& args, int n_col_tiles,
                   cudaStream_t stream) {
  using C = RowCfg<NRED>;
  // The shared-memory attribute is set, and the occupancy asked, once per
  // device.
  static std::atomic<int> blocks_per_sm[kMaxDevices];
  int dev = 0, sms = 0;
  int status = current_device(&dev, &sms);
  if (status) return status;
  int per_sm = blocks_per_sm[dev].load(std::memory_order_relaxed);
  if (per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        tmpl_rowprod_kernel<NRED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tmpl_rowprod_kernel<NRED>, kThreads, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    blocks_per_sm[dev].store(per_sm, std::memory_order_relaxed);
  }
  const long long n_tiles = (args.n_rows + kTileRows - 1) / kTileRows;
  long long rows_grid = (long long)per_sm * sms / n_col_tiles;
  if (rows_grid * kGroups > n_tiles) rows_grid = (n_tiles + 1) / kGroups;
  if (rows_grid < 1) rows_grid = 1;
  tmpl_rowprod_kernel<NRED>
      <<<dim3(n_col_tiles, (unsigned)rows_grid), kThreads, C::SMEM, stream>>>(
          a_map, w_map, args);
  return (int)cudaGetLastError();
}

}  // namespace

// out[r, out_col0 + c] for c < 128 n_col_tiles, r < n_rows: the epilogue of
// sum_j A[r, col(j)] W[w_row0 + c, j] over j < n_red (128, 256 or 384; the
// plane layout's first layer and skip layer: 192, 448). A:
// bf16 (n_rows, a_ld) row-major; W: bf16 (w_rows, w_cols) row-major, rows
// past w_rows read as zero. bias, ray_bias and mask may be null. The output
// columns must not overlap A's.
extern "C" int hn_tmpl_rowprod(
    const void* a, long long n_rows, long long a_ld, int a_col0, int a_w0,
    int a_col1, const void* w, int w_rows, int w_cols, int n_red, int w_row0,
    int n_col_tiles, void* out, long long out_ld, int out_col0,
    const void* bias, const void* ray_bias, int ray_ld, int samples, int relu,
    const void* mask, long long mask_ld, int mask_col0, void* stream) {
  if (n_rows <= 0 || n_col_tiles <= 0 || samples <= 0 || n_red > w_cols)
    return (int)cudaErrorInvalidValue;
  CUtensorMap a_map, w_map;
  int err = cached_tensor_map(&a_map, a, n_rows, a_ld, a_ld, kTileRows);
  if (err) return err;
  err = cached_tensor_map(&w_map, w, w_rows, w_cols, w_cols, kTileCols);
  if (err) return err;
  RowArgs args{a_col0,
               a_w0,
               a_col1,
               w_row0,
               n_rows,
               static_cast<bf16*>(out),
               out_ld,
               out_col0,
               static_cast<const bf16*>(bias),
               static_cast<const float*>(ray_bias),
               ray_ld,
               samples,
               relu,
               static_cast<const bf16*>(mask),
               mask_ld,
               mask_col0};
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_red) {
    case 128: return launch_rowprod<128>(a_map, w_map, args, n_col_tiles, s);
    case 256: return launch_rowprod<256>(a_map, w_map, args, n_col_tiles, s);
    case 384: return launch_rowprod<384>(a_map, w_map, args, n_col_tiles, s);
    case 192: return launch_rowprod<192>(a_map, w_map, args, n_col_tiles, s);
    case 448: return launch_rowprod<448>(a_map, w_map, args, n_col_tiles, s);
  }
  return (int)cudaErrorInvalidValue;
}
