// Building blocks of the cluster GRU kernels (gru_layer.cu,
// gru_layer_bwd.cu): H = 256; the tensor-core kernels' bf16 operands and
// fp32 sums, and (at the end) the fp32 kernel's decomposition.
//
// The decomposition both kernels share.  A thread-block cluster of
// kCluster = 4 blocks owns one tile of batch rows in one direction; rank c
// owns hidden units [64c, 64c + 64) and with them the r, z and n columns of
// those units: a (256 x 192) slice of W_hh^T, 98,304 bytes in bf16.  The
// slice never leaves the chip during a launch: it sits in registers as the
// B fragments of mma.sync.m16n8k16, 96 registers in each of 256 threads.
// Warp w of a rank owns units [64c + 8w, 64c + 8w + 8), and its three
// 8-column MMA tiles are the r, the z and the n columns of those eight
// units, so the thread that holds an accumulator element of unit j holds
// r, z and n of unit j for the same row: the gate math runs where the sums
// are, and h (or dh) stays in fp32 registers across steps.  tests/
// test_torch_gru_plan.py models these index maps in NumPy.
//
// Shared-memory tiles are rows of 16-byte chunks (8 bf16).  Rows are 128,
// 384 or 768 bytes long, all multiples of 128, so without care the eight
// rows of an ldmatrix would hit the same banks; chunk c of row r is stored
// at chunk c ^ (r & 7), which spreads any eight consecutive rows over all
// 32 banks and keeps groups of eight chunks together.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gru_mma {

constexpr int kHidden = 256;
constexpr int kGates = 3 * kHidden;
constexpr int kCluster = 4;                   // blocks per cluster
constexpr int kUnits = kHidden / kCluster;    // hidden units per rank
constexpr int kThreads = 256;                 // 8 warps, 8 units each
constexpr int kKTiles = kHidden / 16;         // k16 steps of h @ W

// Where the forward kernels (gru_layer.cu, every H) read gx and write ys,
// in elements: step t of direction d reads gx at d gx_dir + s gx_step +
// b gx_row + column and writes ys at d out_dir + s out_step + b out_row +
// unit, where s = time(d, t).  The JAX contract (ops/gru.py::gru_layer):
// contiguous (2, T, B, 3H) and (2, T, B, H), direction 1 already stored in
// reversed time, `reverse` 0.  The served layout (gru_layer_btc): the
// input GEMM's (B, T, 6H) with direction d at column 3H d, ys into
// (B, T, 2H) at column H d, both in forward time, so direction 1 runs from
// s = T - 1 down to 0 (`reverse` 1).  ops/gru.py::k2_strides makes them.
struct Strides {
  long long gx_dir, gx_step, gx_row;
  long long out_dir, out_step, out_row;
  int reverse;

  __device__ __forceinline__ int time(int dir, int t, int steps) const {
    return reverse && dir ? steps - 1 - t : t;
  }
  // where step t of direction `dir` starts in gx and in ys
  __device__ __forceinline__ long long gx_at(int dir, int t, int steps) const {
    return dir * gx_dir + time(dir, t, steps) * gx_step;
  }
  __device__ __forceinline__ long long ys_at(int dir, int t, int steps) const {
    return dir * out_dir + time(dir, t, steps) * out_step;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- the cluster ----

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// One barrier over every thread of the cluster, split in two: what a thread
// wrote (also to another rank's shared memory) before its arrive is visible
// to every thread after its wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The address of this block's shared-memory location `addr` in rank `rank`.
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster_16(uint32_t addr, uint4 v) {
  asm volatile("st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void st_cluster_4(uint32_t addr, float a) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" :: "r"(addr), "f"(a)
               : "memory");
}

__device__ __forceinline__ void st_cluster_8(uint32_t addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};"
               :: "r"(addr), "f"(a), "f"(b) : "memory");
}

// ---- asynchronous copies, 16 bytes each; `valid` false fills zeros ----

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// ---- tensor cores ----

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row) @ b (16 x 8, bf16, col).
// With g = lane / 4 and q = lane % 4 a thread holds a[0..3] = rows g, g + 8
// at k = 2q, 2q + 1 then rows g, g + 8 at k = 2q + 8, 2q + 9; b0, b1 =
// column g at k = 2q, 2q + 1 and k = 2q + 8, 2q + 9; d[0..3] = rows g
// (d[0], d[1]) and g + 8 (d[2], d[3]) at columns 2q, 2q + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// ---- gates: fp32, fast exponential and division (absolute error ~1e-7,
// far inside one bf16 step; the fp32 parity path keeps expf / tanhf) ----

__device__ __forceinline__ float sigmoid_fast(float v) {
  v = fminf(fmaxf(v, -30.f), 30.f);
  return __fdividef(1.f, 1.f + __expf(-v));
}

__device__ __forceinline__ float tanh_fast(float v) {
  v = fminf(fmaxf(v, -15.f), 15.f);
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * v));
}

// ---- tiles ----

// Byte offset of logical chunk `chunk` of row `row` in a tile whose rows
// hold `row_chunks` 16-byte chunks.
__device__ __forceinline__ int chunk_offset(int row, int chunk,
                                            int row_chunks) {
  return (row * row_chunks + (chunk ^ (row & 7))) * 16;
}

// An h tile (rows x 256 bf16) is four slabs, one per rank, each rows x 64:
// byte offset of chunk `chunk` (0..7) of row `row` in slab `slab`.
__device__ __forceinline__ int h_offset(int rows, int slab, int row,
                                        int chunk) {
  return slab * rows * 128 + chunk_offset(row, chunk, 8);
}

// This warp's slice of W_hh^T as B fragments: w[kt][gate] covers k in
// [16 kt, 16 kt + 16) and the columns gate * 256 + unit0 + (0..7), where
// unit0 = 64 rank + 8 warp.  `wd` is one direction's (256, 768) matrix.
__device__ __forceinline__ void load_w_fragments(
    uint32_t (&wf)[kKTiles][3][2], const __nv_bfloat16* __restrict__ wd,
    int unit0, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int kt = 0; kt < kKTiles; ++kt) {
#pragma unroll
    for (int gate = 0; gate < 3; ++gate) {
      const __nv_bfloat16* p =
          wd + static_cast<size_t>(kt * 16 + 2 * q) * kGates + gate * kHidden +
          unit0 + g;
      wf[kt][gate][0] = pack_bf16(p[0], p[kGates]);
      wf[kt][gate][1] = pack_bf16(p[8 * kGates], p[9 * kGates]);
    }
  }
}

// acc[i][gate] (+)= rows [16 (mt0 + i), 16 (mt0 + i) + 16) of the h tile at
// shared address `tile` (`rows` rows) times this warp's W fragments, for
// i < n (n <= G; a constant where the caller's loop is unrolled).
template <int G>
__device__ __forceinline__ void recurrent_product(
    float (&acc)[G][3][4], const uint32_t (&wf)[kKTiles][3][2], uint32_t tile,
    int rows, int mt0, int lane, int n = G) {
  // ldmatrix.x4: lanes 0-7 address rows 0-7 of the first k-chunk, 8-15 rows
  // 8-15 of it, 16-23 and 24-31 the same rows of the second k-chunk
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lchunk = lane >> 4;
#pragma unroll
  for (int kt = 0; kt < kKTiles; ++kt) {
    uint32_t a[G][4];
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (i < n)
        ldmatrix_x4(a[i], tile + h_offset(rows, kt >> 2, (mt0 + i) * 16 + lrow,
                                          (kt & 3) * 2 + lchunk));
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (i < n) {
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
          mma_bf16(acc[i][gate], a[i], wf[kt][gate][0], wf[kt][gate][1]);
      }
  }
}

// Start the copy of rank `rank`'s gx slice of one step (rows x 3 gates x 64
// units) into a rows x 384-byte tile; rows past the batch are zero-filled.
// `g_step` points at gx[dir, t, 0, 0]; batch row b starts `row_stride`
// elements after row b - 1.
__device__ __forceinline__ void load_gx_slice(
    uint32_t tile, const __nv_bfloat16* __restrict__ g_step, int rows,
    int row0, int batch, int rank, int tid, long long row_stride = kGates) {
  for (int i = tid; i < rows * 24; i += kThreads) {
    const int row = i / 24, c = i % 24, gate = c >> 3, chunk = c & 7;
    const bool valid = row0 + row < batch;
    const __nv_bfloat16* src =
        g_step + (valid ? (row0 + row) * row_stride + gate * kHidden +
                              rank * kUnits + chunk * 8
                        : 0);
    cp_async_16(tile + chunk_offset(row, gate * 8 + chunk, 24), src, valid);
  }
}

constexpr int kMaxDevices = 64;

// Launch with clusters of `Cluster` blocks along x.  `ready[device]`
// records that the kernel's shared-memory size is set on that device and
// that at least one cluster of this shape fits it; a card where none fits
// gets cudaErrorLaunchOutOfResources.
template <int Cluster = kCluster, typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, bool (&ready)[kMaxDevices],
                            dim3 grid, int smem, cudaStream_t stream,
                            Args... args) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool known = device < kMaxDevices && ready[device];
  if (!known) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = Cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (!known) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
    if (device < kMaxDevices) ready[device] = true;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// kernel_info.cuh's five numbers, then out[5] = blocks per cluster and
// out[6] = clusters of this shape resident on the card at once.
template <int Cluster = kCluster, typename Kernel>
int cluster_info(Kernel kernel, int smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Cluster * 64, 2);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = Cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes) + smem;
  out[3] = kThreads;
  out[4] = blocks;
  out[5] = Cluster;
  out[6] = clusters;
  return 0;
}

// ---- the fp32 kernel's decomposition (gru_layer.cu,
// gru_layer_cluster_kernel): fp32 operands at H = 256, fp32 FMAs on CUDA
// cores (the parity path: no TF32) ----
//
// A cluster of kF32Cluster = 8 blocks owns one tile of M batch rows in
// one direction.  Rank c owns the U = 32 hidden units [U c, U c + U) and
// the r, z and n columns of W_hh^T for them, a (256 x 3U) fp32 slice of
// 98,304 bytes.  Warp s of a rank sums over the k-slice [32 s, 32 s + 32)
// and lane l over unit l of the rank, so a thread holds
// W^T[k][gate * 256 + U c + l] for its 32 k and 3 gates, four consecutive
// k to a float4: 96 floats, which stay in its registers for the whole
// launch.
//
// A step: every warp multiplies the M rows of h_{t-1} (fp32, read as
// broadcast float4s of the rank's h tile) by its k-slice and leaves its
// partial sums at f32_partial_index; after a block barrier thread p gates
// the (row, unit) pairs p, p + 256, ... (row = pair / U, unit = pair % U),
// summing the eight partials in slice order, keeps h in an fp32 register
// and stores ys; the four lanes of a quad (four consecutive units of one
// row) gather their h_t as one float4, and lane 4 q + e stores it
// (st.shared::cluster) at the same place of the other h tile of ranks e
// and e + 4; one split cluster barrier a step orders that exchange
// against the next product.  tests/test_torch_gru_plan.py models these
// maps in NumPy.

constexpr int kF32Cluster = 8;                     // blocks a cluster
constexpr int kF32Units = kHidden / kF32Cluster;   // U, units a rank
constexpr int kF32Slices = kThreads / 32;          // k-slices, one a warp
constexpr int kF32SliceK = kHidden / kF32Slices;   // 32 k a slice

// Floats of the tile region: two h tiles of M x 256.
__host__ __device__ constexpr int f32_h_floats(int rows) {
  return 2 * rows * kHidden;
}

// Index (floats) of a partial sum in the region after the h tiles:
// [slice][row][gate][unit of the rank].
__host__ __device__ constexpr int f32_partial_index(int rows, int slice,
                                                    int row, int gate,
                                                    int unit) {
  return ((slice * rows + row) * 3 + gate) * kF32Units + unit;
}

// Dynamic shared memory of the fp32 kernel: the h tiles and the partial
// sums.
__host__ __device__ constexpr int f32_smem_bytes(int rows) {
  return 4 * (f32_h_floats(rows) + kF32Slices * rows * 3 * kF32Units);
}

// ---- the fp32 backward (gru_layer_bwd.cu, gru_layer_bwd_cluster_kernel) ----
//
// The same cluster of eight, the same (direction, tile of M rows) and the
// same slice of W^T in the same registers as the forward, for gh = h_prev W
// (h_prev is the stored ys[t - 1], copied into an h_prev tile by cp.async
// one step ahead), with its partial sums at f32_partial_index.  The gating
// thread of a (row, unit) pair keeps dh in fp32 registers and writes the
// row's dgh of the rank's 3U columns into a dgh tile.  dh_prev sums over
// all 3H columns, which the split by unit spreads over the ranks: thread k
// of rank c multiplies the dgh tile (broadcast float4s) by row k of a
// second copy of the rank's slice, kept in shared memory by rows of k
// (kF32WtStride floats a row, the 3U columns and 4 of padding, so that the
// eight 16-byte reads of a quarter warp fall on all 32 banks), which gives
// the rank's partial sum of dh_prev[:, k] for every row.  Warp s holds
// k in [32 s, 32 s + 32), the units of rank s: it stores its partial sums
// (st.shared::cluster) at f32_inbox_index(.., buffer t & 1, source c, row,
// lane) of rank s, and the owner adds the eight sources in rank order at
// the next step; one split cluster barrier a step.

constexpr int kF32WtStride = 3 * kF32Units + 4;   // floats a row of k

// Index (floats) of a partial sum of dh_prev in the inbox:
// [buffer][source rank][row][unit of the owner].
__host__ __device__ constexpr int f32_inbox_index(int rows, int buf, int src,
                                                  int row, int unit) {
  return ((buf * kF32Cluster + src) * rows + row) * kF32Units + unit;
}

// Dynamic shared memory of the fp32 backward: the slice by rows of k, two
// h_prev tiles, the gh partial sums, the dgh tile and the inbox.
__host__ __device__ constexpr int f32_bwd_smem_bytes(int rows) {
  return 4 * (kHidden * kF32WtStride + f32_h_floats(rows) +
              kF32Slices * rows * 3 * kF32Units + rows * 3 * kF32Units +
              2 * kF32Cluster * rows * kF32Units);
}

}  // namespace gru_mma
