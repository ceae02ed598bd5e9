// Kernel A's weight gradient for Hopper (sm_90a): dW = G^T H of one
// template layer over a chunk of rows, as `wgmma` products on TMA-loaded
// tiles, with db = the column sum of G in the same pass.
//
// Part of the template backward (kernel A), which replaces
// hypernerf_tpu/ops/pallas/fused_mlp.py `_bwd_call` (:736). There the
// sequential grid keeps dW resident in VMEM across all tiles (the dW / db
// out_specs with index map (0, 0), :728-734); here a block owns one 64 x 128
// tile of dW, walks a long range of row tiles accumulating it in registers,
// and writes it once to its own slab (one fp32 slab per row range, summed
// later in a fixed order by `hn_tmpl_reduce`, so dW / db are deterministic).
//
// G: bf16 (n_rows, g_ld), the layer's output cotangent, already masked and
// rounded; H: bf16 (n_rows, h_ld), the stash, the layer's input at columns
// col(k) = h_col0 + k below h_w0 and h_col1 + (k - h_w0) above. The product
// runs over rows, so both operands are read MN-major: a TMA box of 64 rows x
// 64 features is 8 atoms of 8 rows x 128 bytes, a k16 step is 16 rows
// (2048 bytes), and the second 64-feature box of H sits 8 KB on (`lbo`).
//
// A layer whose input is not a whole number of 128-feature tiles (the plane
// layout's first layer, 192, and skip layer, 448) has a ragged last tile:
// its products run over the whole tile (H's columns past the input are the
// stash's next ones, finite) and its columns at k_pad and past are not
// written (kRagged).
//
// Bound: one multiply-add per weight and row, against G and H read once:
// operations bound it at the template's widths. The grid is (out / 64,
// in tiles of 128, splits): enough blocks to fill the card at every layer.

#include "level_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 4;
constexpr int kKinTile = 128;  // input features of a block's dW tile
constexpr int kA = 64 * 128;      // 64 rows x 64 features of G
constexpr int kB = 2 * 64 * 128;  // 64 rows x 128 features of H
constexpr int kSmem = 1024 + kStages * (kA + kB) + 8 * kStages +
                      sizeof(float) * kThreads;

struct DwArgs {
  int h_col0, h_w0, h_col1;
  long long n_rows;
  float* slab;  // [splits][slab_len]
  long long slab_len, w_off;
  int k_pad;
  long long b_off;  // < 0: no db
};

template <bool kRagged>
__global__ void __launch_bounds__(kThreads, 2)
    tmpl_dw_kernel(const __grid_constant__ CUtensorMap g_map,
              const __grid_constant__ CUtensorMap h_map, const DwArgs args) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_s = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* b_s = a_s + kStages * kA;
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + kStages * kB);
  float* red = reinterpret_cast<float*>(full + kStages);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * 64, kt = blockIdx.y, z = blockIdx.z;
  const int k0 = kt * kKinTile;
  const int h_col = k0 < args.h_w0 ? args.h_col0 + k0
                                   : args.h_col1 + (k0 - args.h_w0);
  const long long n_tiles = (args.n_rows + 63) / 64;
  const long long t0 = n_tiles * z / gridDim.z;
  const long long t1 = n_tiles * (z + 1) / gridDim.z;

  auto load = [&](int stage, long long tile) {
    mbar_expect(&full[stage], kA + kB);
    const int row = (int)(tile * 64);
    tma_load(a_s + stage * kA, &g_map, &full[stage], n0, row);
    tma_load(b_s + stage * kB, &h_map, &full[stage], h_col, row);
    tma_load(b_s + stage * kB + kA, &h_map, &full[stage], h_col + 64, row);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < kStages; ++s)
      if (t0 + s < t1) load(s, t0 + s);

  const bool want_db = args.b_off >= 0 && kt == 0;
  const int f = tid & 63, half = tid >> 6;
  float db = 0.f;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;

  for (long long it = 0; t0 + it < t1; ++it) {
    const int stage = (int)(it % kStages);
    mbar_wait(&full[stage], (int)((it / kStages) & 1));
    const uint8_t* a = a_s + stage * kA;
    const uint8_t* b = b_s + stage * kB;
    if (want_db) {  // G[r][f] of the swizzled box, rows of this half
      for (int r = half * 32; r < half * 32 + 32; ++r)
        db += __bfloat162float(*reinterpret_cast<const bf16*>(
            a + r * 128 + ((((f >> 3) ^ (r & 7))) << 4) + (f & 7) * 2));
    }
    fence_fragment(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16<1, 1>(d, sw128_desc(a + kk * 2048, kA, kAtomBytes),
                             sw128_desc(b + kk * 2048, kA, kAtomBytes));
    wgmma_commit();
    wgmma_wait_all();
    fence_fragment(d);
    __syncthreads();  // every warp is done reading this stage
    if (tid == 0 && t0 + it + kStages < t1) load(stage, t0 + it + kStages);
  }

  float* slab = args.slab + z * args.slab_len;
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    float* row = slab + args.w_off +
                 (long long)(n0 + fragment_row(tid, e)) * args.k_pad + k0;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (!kRagged || k0 + fragment_col(tid, j) < args.k_pad)
        *reinterpret_cast<float2*>(row + fragment_col(tid, j)) =
            make_float2(d[4 * j + e], d[4 * j + e + 1]);
  }
  if (want_db) {
    red[tid] = db;
    __syncthreads();
    if (tid < 64) slab[args.b_off + n0 + tid] = red[tid] + red[tid + 64];
  }
}

}  // namespace

// slab[z][w_off + n k_pad + k] = sum over the rows of split z of
// G[r][n] H[r][col(k)] for n < n_out (a multiple of 64), k < 128
// n_kin_tiles and k < k_pad; with b_off >= 0 also slab[z][b_off + n] = sum
// G[r][n]. Rows are cut into `splits` ranges of whole 64-row tiles, one per
// slab.
extern "C" int hn_tmpl_dw(const void* g, long long g_ld, const void* h,
                          long long h_ld, long long n_rows, int n_out,
                          int h_col0, int h_w0, int h_col1, int n_kin_tiles,
                          void* slab, long long slab_len, long long w_off,
                          int k_pad, long long b_off, int splits,
                          void* stream) {
  if (n_rows <= 0 || n_out % 64 || n_kin_tiles <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap g_map, h_map;
  int err = cached_tensor_map(&g_map, g, n_rows, g_ld, g_ld, 64);
  if (err) return err;
  err = cached_tensor_map(&h_map, h, n_rows, h_ld, h_ld, 64);
  if (err) return err;
  // The shared-memory attribute is set once per device.
  const bool ragged = 128 * n_kin_tiles > k_pad;
  static std::atomic<bool> ready[2][kMaxDevices];
  int dev = 0, sms = 0;
  err = current_device(&dev, &sms);
  if (err) return err;
  auto kernel = ragged ? tmpl_dw_kernel<true> : tmpl_dw_kernel<false>;
  if (!ready[ragged][dev].load(std::memory_order_relaxed)) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    ready[ragged][dev].store(true, std::memory_order_relaxed);
  }
  DwArgs args{h_col0, h_w0,     h_col1,
              n_rows, static_cast<float*>(slab), slab_len,
              w_off,  k_pad,    b_off};
  kernel<<<dim3(n_out / 64, n_kin_tiles, splits), kThreads, kSmem,
           (cudaStream_t)stream>>>(g_map, h_map, args);
  return (int)cudaGetLastError();
}
