// K2: one bidirectional GRU layer, both directions, all T steps in one launch.
//
// Replaces speech_intent_recognizer_tpu/ops/gru_pallas.py::_gru_layer_kernel.
// Same contract: gx (2, T, B, 3H) holds x @ W_ih^T + b_ih + b_hh[r, z] with
// direction 1 already in reversed time; w (2, H, 3H) is W_hh^T per
// direction; bn (2, H) f32 is the n-gate recurrent bias, kept inside
// r * (h W_hn + b_hn) (PyTorch double-bias semantics).  Output ys
// (2, T, B, H) in the operand type, direction 1 in reversed time.  The
// recurrent product runs on operands rounded to the operand type with fp32
// sums; h is carried in fp32 across steps and the gate math is fp32.
//
// Each kernel reads gx and writes ys through gru_mma.cuh's Strides, so one
// body serves that contract and the served layout (ops/gru.py::
// gru_layer_btc): gx as the input GEMM leaves it, (B, T, 6H) with both
// directions in forward time, and ys straight into the (B, T, 2H) that the
// next layer's GEMM and the head read.  No flip, stack or concatenation
// runs around the kernel there; a row still reads its r, z and n segments
// contiguously.
//
// Three kernels; ops/gru.py::gru_plan says which one a call takes.
//
// 1. gru_layer_mma_kernel: bf16, H = 256, the kernel that serves and
//    trains.  What bounds the recurrence on the H100 is the serial chain of
//    T steps, each a (rows x 256) @ (256 x 768) product followed by gate
//    math that the next step waits for; W_hh^T (393,216 bytes per direction
//    in bf16) fits no single SM.  The design (index maps in gru_mma.cuh):
//    * a cluster of 4 blocks shares one tile of 16 to 128 batch rows (any
//      multiple of 16: ops/gru.py picks the height that leaves the fewest
//      clusters waiting for a free set of SMs); each rank keeps the r, z
//      and n columns of its 64 hidden units in registers for the whole
//      launch (mma.sync B fragments, loaded once per block, never per step);
//    * the product runs on the tensor cores (mma.sync.m16n8k16, bf16
//      operands, fp32 sums), two 16-row tiles at a time, A fragments by
//      ldmatrix from the step's h tile in shared memory;
//    * the thread that holds the sums of a unit holds its r, z and n, so
//      the gates are computed in place and h stays in fp32 registers;
//    * each rank rounds its 64 units of the new h to bf16 into its slab of
//      the next step's h tile, then copies the slab with 16-byte stores
//      into the three other ranks' shared memory and to ys (tall tiles
//      store ys after the arrive at the cluster barrier); the h tile is
//      double-buffered, so one cluster barrier per step orders everything;
//    * the step's slice of gx (the kernel's only read from device memory)
//      is fetched one step ahead with cp.async into a two-stage ring.
// 2. gru_layer_cluster_kernel: fp32, H = 256, the parity path (the
//    streaming finalize, fp32 evaluation, the forward of an fp32 train
//    step).  TF32 tensor cores would break the 1e-5 bar that holds fp32
//    results to the JAX package, so the product stays on CUDA cores in
//    fp32 FMAs.  W_hh^T is 786,432 bytes a direction in fp32, and what
//    bounded the CUDA-core kernel below at small batches was streaming it
//    from L2 into one SM a direction at every step.  The design
//    (decomposition and index maps in gru_mma.cuh):
//    * a cluster of 8 blocks owns one tile of 1 to 32 batch rows; each
//      rank keeps the r, z and n columns of its 32 units (98,304 bytes) on
//      chip for the whole launch: 96 floats in each thread's registers;
//    * warp s multiplies the tile's h_{t-1} by k-slice s of that slice,
//      h read as broadcast float4s from the rank's h tile; the eight
//      partial sums of a (row, unit) meet in shared memory, and the thread
//      that gates the pair adds them in slice order (the same bits on every
//      launch) and keeps h in an fp32 register;
//    * a quad of lanes gathers its four units of h_t with shuffles, and
//      each lane of the quad stores them, 16 bytes, into two of the eight
//      ranks' other h tile (its own among them), so no block barrier
//      separates the gates from the exchange; one split cluster barrier a
//      step orders the exchange against the next product;
//    * gx of the next step is loaded into registers after the arrive, so
//      its latency hides behind the barrier.
// 3. gru_layer_kernel: fp32 or bf16 operands, any H that is a multiple of
//    32, fp32 FMAs on CUDA cores, one thread per hidden unit, W_hh streamed
//    from L2 at every step, tiles of 4 or 16 rows (ops/gru.py::tile_rows).
//    It serves bf16 and fp32 at any H other than 256.
//
// Times stand in PERF.md, each with the card's name and power limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "gru_mma.cuh"

namespace {

using gru_mma::Strides;

template <typename T>
struct Operand;

template <>
struct Operand<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Operand<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

template <typename T, int BT>
__global__ void gru_layer_kernel(const T* __restrict__ gx,
                                 const T* __restrict__ w,
                                 const float* __restrict__ bn,
                                 T* __restrict__ out, int steps, int batch,
                                 int hidden, const Strides layout) {
  extern __shared__ __align__(16) float hs[];  // [BT][hidden] h as operand
  using Op = Operand<T>;
  const int j = threadIdx.x;
  const int dir = blockIdx.y;
  const int row0 = blockIdx.x * BT;
  const int h3 = 3 * hidden;
  const T* wd = w + static_cast<size_t>(dir) * hidden * h3;
  const float bnj = bn[dir * hidden + j];

  float h[BT];
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    h[r] = 0.f;
    hs[r * hidden + j] = 0.f;
  }
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    float ar[BT], az[BT], an[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) ar[r] = az[r] = an[r] = 0.f;
    for (int k = 0; k < hidden; k += 4) {
      float wr[4], wz[4], wn[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const T* wk = wd + static_cast<size_t>(k + q) * h3 + j;
        wr[q] = Op::load(wk);
        wz[q] = Op::load(wk + hidden);
        wn[q] = Op::load(wk + 2 * hidden);
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(&hs[r * hidden + k]);
        ar[r] = fmaf(hv.x, wr[0], fmaf(hv.y, wr[1], fmaf(hv.z, wr[2], fmaf(hv.w, wr[3], ar[r]))));
        az[r] = fmaf(hv.x, wz[0], fmaf(hv.y, wz[1], fmaf(hv.z, wz[2], fmaf(hv.w, wz[3], az[r]))));
        an[r] = fmaf(hv.x, wn[0], fmaf(hv.y, wn[1], fmaf(hv.z, wn[2], fmaf(hv.w, wn[3], an[r]))));
      }
    }
    __syncthreads();  // every thread has read this step's h

    const T* g = gx + layout.gx_at(dir, t, steps);
    T* o = out + layout.ys_at(dir, t, steps);
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const int row = row0 + r;
      if (row < batch) {
        const T* gr = g + row * layout.gx_row;
        const float rg = sigmoid(Op::load(gr + j) + ar[r]);
        const float zg = sigmoid(Op::load(gr + hidden + j) + az[r]);
        const float ng = tanhf(Op::load(gr + 2 * hidden + j) + rg * (an[r] + bnj));
        h[r] = (1.f - zg) * ng + zg * h[r];
        o[row * layout.out_row + j] = Op::store(h[r]);
      }
      hs[r * hidden + j] = Op::round(h[r]);
    }
    __syncthreads();
  }
}

template <typename T, int BT>
cudaError_t launch_tile(const void* gx, const void* w, const float* bn,
                        void* out, int steps, int batch, int hidden,
                        const Strides& layout, cudaStream_t stream) {
  const int smem = BT * hidden * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      gru_layer_kernel<T, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + BT - 1) / BT, 2);
  gru_layer_kernel<T, BT><<<grid, hidden, smem, stream>>>(
      static_cast<const T*>(gx), static_cast<const T*>(w), bn,
      static_cast<T*>(out), steps, batch, hidden, layout);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* gx, const void* w, const float* bn, void* out,
           int steps, int batch, int hidden, int rows, const Strides& layout,
           void* stream) {
  if (steps < 0 || batch < 0 || hidden <= 0 || hidden % 32 || hidden > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (steps == 0 || batch == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 4:
      return static_cast<int>(
          launch_tile<T, 4>(gx, w, bn, out, steps, batch, hidden, layout, st));
    case 16:
      return static_cast<int>(
          launch_tile<T, 16>(gx, w, bn, out, steps, batch, hidden, layout, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---- the tensor-core kernel ----

using namespace gru_mma;

// Shared memory of the tensor-core kernel with 16 * MT rows a tile: two h
// tiles (rows x 512 bytes) and two gx stages (rows x 384 bytes).
constexpr int mma_smem_bytes(int mt) { return 16 * mt * (2 * 512 + 2 * 384); }

template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
gru_layer_mma_kernel(const __nv_bfloat16* __restrict__ gx,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bn,
                     __nv_bfloat16* __restrict__ out, int steps, int batch,
                     const Strides layout) {
  constexpr int M = 16 * MT;            // rows of the cluster's tile
  constexpr int G = MT < 2 ? MT : 2;    // 16-row tiles multiplied together
                                        // (an odd MT ends on a single one)
  // Tall tiles store ys after the arrive at the cluster barrier, so that
  // the other ranks wait for the exchange only; short ones before it, where
  // the stores overlap the wait (measured: PERF.md).
  constexpr bool kYsAfterArrive = MT >= 3;
  extern __shared__ __align__(128) unsigned char tile_mem[];
  const uint32_t h_tiles = smem_addr(tile_mem);                // 2 x (M x 512 B)
  const uint32_t gx_tiles = h_tiles + 2 * M * 512;         // 2 x (M x 384 B)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int rank = static_cast<int>(cluster_rank());
  const int dir = blockIdx.y;
  const int row0 = static_cast<int>(blockIdx.x / kCluster) * M;
  const int unit0 = rank * kUnits + warp * 8;   // this warp's eight units

  uint32_t wf[kKTiles][3][2];
  load_w_fragments(wf, w + static_cast<size_t>(dir) * kHidden * kGates, unit0,
                   lane);
  const float bn0 = bn[dir * kHidden + unit0 + 2 * q];
  const float bn1 = bn[dir * kHidden + unit0 + 2 * q + 1];

  // h_{-1} = 0 in tile 0; the other tile is written before it is read
  for (int i = tid; i < M * 32; i += kThreads)
    reinterpret_cast<uint4*>(tile_mem)[i] = make_uint4(0, 0, 0, 0);
  float h[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    h[mt][0] = h[mt][1] = h[mt][2] = h[mt][3] = 0.f;

  load_gx_slice(gx_tiles, gx + layout.gx_at(dir, 0, steps), M, row0, batch,
                rank, tid, layout.gx_row);
  cp_async_commit();
  __syncthreads();
  // no rank writes another's shared memory before every rank runs
  cluster_arrive();
  cluster_wait();

  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    if (t + 1 < steps)
      load_gx_slice(gx_tiles + nxt * M * 384,
                    gx + layout.gx_at(dir, t + 1, steps), M, row0, batch, rank,
                    tid, layout.gx_row);
    cp_async_commit();
    // every rank's slab of h_{t-1} has arrived in tile `cur`
    if (t > 0) cluster_wait();
    cp_async_wait<1>();   // this thread's part of gx_t has landed
    __syncthreads();      // ... and every other thread's

    const uint32_t h_cur = h_tiles + cur * M * 512;
    unsigned char* h_nxt = tile_mem + nxt * M * 512;
    const unsigned char* g_cur = tile_mem + 2 * M * 512 + cur * M * 384;
#pragma unroll
    for (int mt0 = 0; mt0 < MT; mt0 += G) {
      float acc[G][3][4];
#pragma unroll
      for (int i = 0; i < G; ++i)
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
          acc[i][gate][0] = acc[i][gate][1] = acc[i][gate][2] =
              acc[i][gate][3] = 0.f;
      const int n = MT - mt0 < G ? MT - mt0 : G;
      recurrent_product<G>(acc, wf, h_cur, M, mt0, lane, n);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (i >= n) break;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = (mt0 + i) * 16 + g + 8 * half;
          const unsigned char* gr = g_cur + 4 * q;
          const uint32_t xr = *reinterpret_cast<const uint32_t*>(
              gr + chunk_offset(row, warp, 24));
          const uint32_t xz = *reinterpret_cast<const uint32_t*>(
              gr + chunk_offset(row, 8 + warp, 24));
          const uint32_t xn = *reinterpret_cast<const uint32_t*>(
              gr + chunk_offset(row, 16 + warp, 24));
          float hn[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int a = 2 * half + e;
            const float rg = sigmoid_fast((e ? bf16_hi(xr) : bf16_lo(xr)) +
                                          acc[i][0][a]);
            const float zg = sigmoid_fast((e ? bf16_hi(xz) : bf16_lo(xz)) +
                                          acc[i][1][a]);
            const float ng = tanh_fast((e ? bf16_hi(xn) : bf16_lo(xn)) +
                                       rg * (acc[i][2][a] + (e ? bn1 : bn0)));
            hn[e] = (1.f - zg) * ng + zg * h[mt0 + i][a];
            h[mt0 + i][a] = hn[e];
          }
          *reinterpret_cast<uint32_t*>(h_nxt + h_offset(M, rank, row, warp) +
                                       4 * q) = pack_bf16(hn[0], hn[1]);
        }
      }
    }
    __syncthreads();   // this rank's slab of h_t is whole

    // the slab goes to the other ranks' tiles ...
    if (t + 1 < steps) {
      for (int i = tid; i < M * 8; i += kThreads) {
        const int off = rank * M * 128 + i * 16;
        const uint4 v = *reinterpret_cast<const uint4*>(h_nxt + off);
        const uint32_t mine = h_tiles + nxt * M * 512 + off;
#pragma unroll
        for (int r = 1; r < kCluster; ++r)
          st_cluster_16(map_to_rank(mine, (rank + r) % kCluster), v);
      }
    }
    // ... and, as ys[t], to device memory.  The slab is not rewritten before
    // two more block barriers, so the stores may follow the arrive.
    auto store_ys = [&]() {
      __nv_bfloat16* o = out + layout.ys_at(dir, t, steps) + rank * kUnits;
      for (int i = tid; i < M * 8; i += kThreads) {
        // i counts the slab's chunks as they lie; chunk is the logical one
        const int row = i >> 3, chunk = (i & 7) ^ (row & 7);
        if (row0 + row < batch)
          *reinterpret_cast<uint4*>(
              o + (row0 + row) * layout.out_row + chunk * 8) =
              *reinterpret_cast<const uint4*>(h_nxt + rank * M * 128 + i * 16);
      }
    };
    if (!kYsAfterArrive) store_ys();
    cluster_arrive();
    if (kYsAfterArrive) store_ys();
  }
  // no rank leaves while another may still write into it
  if (steps > 0) cluster_wait();
}

template <int MT>
int launch_mma(const void* gx, const void* w, const float* bn, void* out,
               int steps, int batch, const Strides& layout,
               cudaStream_t stream, int* out_info) {
  auto kernel = gru_layer_mma_kernel<MT>;
  const int smem = mma_smem_bytes(MT);
  if (out_info) return cluster_info(kernel, smem, out_info);
  static bool ready[kMaxDevices] = {};
  const int tiles = (batch + 16 * MT - 1) / (16 * MT);
  return static_cast<int>(launch_clusters(
      kernel, ready, dim3(kCluster * tiles, 2), smem, stream,
      static_cast<const __nv_bfloat16*>(gx),
      static_cast<const __nv_bfloat16*>(w), bn,
      static_cast<__nv_bfloat16*>(out), steps, batch, layout));
}

int dispatch_mma(const void* gx, const void* w, const float* bn, void* out,
                 int steps, int batch, int hidden, int rows,
                 const Strides& layout, cudaStream_t stream, int* out_info) {
  if (steps < 0 || batch < 0 || hidden != kHidden)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!out_info && (steps == 0 || batch == 0)) return 0;
  switch (rows) {
    case 16:
      return launch_mma<1>(gx, w, bn, out, steps, batch, layout, stream,
                           out_info);
    case 32:
      return launch_mma<2>(gx, w, bn, out, steps, batch, layout, stream,
                           out_info);
    case 48:
      return launch_mma<3>(gx, w, bn, out, steps, batch, layout, stream,
                           out_info);
    case 64:
      return launch_mma<4>(gx, w, bn, out, steps, batch, layout, stream,
                           out_info);
    case 80:
      return launch_mma<5>(gx, w, bn, out, steps, batch, layout, stream,
                           out_info);
    case 96:
      return launch_mma<6>(gx, w, bn, out, steps, batch, layout, stream,
                           out_info);
    case 112:
      return launch_mma<7>(gx, w, bn, out, steps, batch, layout, stream,
                           out_info);
    case 128:
      return launch_mma<8>(gx, w, bn, out, steps, batch, layout, stream,
                           out_info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- the fp32 cluster kernel ----

// gx of one step (`g_step`: gx[dir, t, 0, 0]; batch row b `row_stride`
// elements after row b - 1) for the (row, unit) pairs tid + 256 j of a tile
// of M rows and U units a rank (rows past the tile or the batch read as 0).
template <int M, int U, int P>
__device__ __forceinline__ void load_gx_pairs(
    float (&g)[P][3], const float* __restrict__ g_step, long long row_stride,
    int batch, int row0, int unit0, int unit) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int row = (static_cast<int>(threadIdx.x) + kThreads * j) / U;
    if (row < M && row0 + row < batch) {
      const float* src = g_step + (row0 + row) * row_stride + unit0 + unit;
      g[j][0] = __ldg(src);
      g[j][1] = __ldg(src + kHidden);
      g[j][2] = __ldg(src + 2 * kHidden);
    } else {
      g[j][0] = g[j][1] = g[j][2] = 0.f;
    }
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads, 1)
gru_layer_cluster_kernel(const float* __restrict__ gx,
                         const float* __restrict__ w,
                         const float* __restrict__ bn,
                         float* __restrict__ out, int steps, int batch,
                         const Strides layout) {
  constexpr int U = kF32Units;            // units a rank
  constexpr int UPL = U / 32;             // units a lane
  constexpr int KQ = kF32SliceK / 4;      // float4s of a k-slice
  constexpr int RB = M < 8 ? M : 8;       // rows multiplied together
  constexpr int P = (M * U + kThreads - 1) / kThreads;  // pairs a thread gates
  extern __shared__ __align__(16) float f32_mem[];
  float* const part = f32_mem + f32_h_floats(M);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = static_cast<int>(cluster_rank());
  const int dir = blockIdx.y;
  const int row0 = static_cast<int>(blockIdx.x / kF32Cluster) * M;
  const int unit0 = rank * U;
  const float* wd = w + static_cast<size_t>(dir) * kHidden * kGates;

  // the rank's slice of W^T, read from device memory once into registers
  float4 wr[KQ][3][UPL];
#pragma unroll
  for (int kq = 0; kq < KQ; ++kq)
#pragma unroll
    for (int gate = 0; gate < 3; ++gate)
#pragma unroll
      for (int i = 0; i < UPL; ++i) {
        const float* p = wd +
            static_cast<size_t>(kF32SliceK * warp + 4 * kq) * kGates +
            gate * kHidden + unit0 + lane + 32 * i;
        wr[kq][gate][i] =
            make_float4(p[0], p[kGates], p[2 * kGates], p[3 * kGates]);
      }

  // the (row, unit) pairs this thread gates: tid + 256 j, all of one unit
  // and, since U is a multiple of 32, a warp's pairs of one row
  const int unit = tid % U;
  const float bnj = bn[dir * kHidden + unit0 + unit];
  float h[P], g[P][3];
#pragma unroll
  for (int j = 0; j < P; ++j) h[j] = 0.f;
  // h_{-1} = 0 in tile 0; the other tile is written before it is read
  for (int i = tid; i < M * kHidden; i += kThreads) f32_mem[i] = 0.f;
  if (steps > 0)
    load_gx_pairs<M, U>(g, gx + layout.gx_at(dir, 0, steps), layout.gx_row,
                        batch, row0, unit0, unit);
  __syncthreads();
  // no rank writes another's shared memory before every rank runs
  cluster_arrive();
  cluster_wait();

  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    if (t > 0) cluster_wait();  // every rank's slab of h_{t-1} is in tile cur
    const float* hc = f32_mem + cur * M * kHidden;
    float* hn = f32_mem + nxt * M * kHidden;
    for (int r0 = 0; r0 < M; r0 += RB) {
      float acc[RB][3][UPL];
#pragma unroll
      for (int rb = 0; rb < RB; ++rb)
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
#pragma unroll
          for (int i = 0; i < UPL; ++i) acc[rb][gate][i] = 0.f;
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) {
        float4 hv[RB];
#pragma unroll
        for (int rb = 0; rb < RB; ++rb)
          hv[rb] = *reinterpret_cast<const float4*>(
              hc + (r0 + rb) * kHidden + kF32SliceK * warp + 4 * kq);
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
#pragma unroll
          for (int i = 0; i < UPL; ++i) {
            const float4 wv = wr[kq][gate][i];
#pragma unroll
            for (int rb = 0; rb < RB; ++rb)
              acc[rb][gate][i] = fmaf(hv[rb].w, wv.w, fmaf(hv[rb].z, wv.z,
                  fmaf(hv[rb].y, wv.y, fmaf(hv[rb].x, wv.x,
                                            acc[rb][gate][i]))));
          }
      }
#pragma unroll
      for (int rb = 0; rb < RB; ++rb)
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
#pragma unroll
          for (int i = 0; i < UPL; ++i)
            part[f32_partial_index(M, warp, r0 + rb, gate, lane + 32 * i)] =
                acc[rb][gate][i];
    }
    __syncthreads();  // every warp's partial sums are in

#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int row = (tid + kThreads * j) / U;
      if (row < M) {
        float s[3];
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          s[gate] = part[f32_partial_index(M, 0, row, gate, unit)];
#pragma unroll
          for (int sl = 1; sl < kF32Slices; ++sl)
            s[gate] += part[f32_partial_index(M, sl, row, gate, unit)];
        }
        const float rg = sigmoid(g[j][0] + s[0]);
        const float zg = sigmoid(g[j][1] + s[1]);
        const float ng = tanhf(g[j][2] + rg * (s[2] + bnj));
        h[j] = (1.f - zg) * ng + zg * h[j];
        if (row0 + row < batch)
          out[layout.ys_at(dir, t, steps) + (row0 + row) * layout.out_row +
              unit0 + unit] = h[j];
        // the exchange: the four units of a quad of lanes as one float4,
        // which lane 4 q + e stores into ranks e, e + 4 (its own among
        // them) at the same place of their tile `nxt`
        if (t + 1 < steps) {
          const int q0 = lane & ~3;
          const uint4 bits = make_uint4(
              __float_as_uint(__shfl_sync(0xffffffffu, h[j], q0)),
              __float_as_uint(__shfl_sync(0xffffffffu, h[j], q0 + 1)),
              __float_as_uint(__shfl_sync(0xffffffffu, h[j], q0 + 2)),
              __float_as_uint(__shfl_sync(0xffffffffu, h[j], q0 + 3)));
          const uint32_t at =
              smem_addr(hn + row * kHidden + unit0 + (unit & ~3));
          for (int r = lane & 3; r < kF32Cluster; r += 4)
            st_cluster_16(map_to_rank(at, r), bits);
        }
      }
    }
    cluster_arrive();  // h_t is on its way to every rank
    if (t + 1 < steps)
      load_gx_pairs<M, U>(g, gx + layout.gx_at(dir, t + 1, steps),
                          layout.gx_row, batch, row0, unit0, unit);
  }
  // no rank leaves while another may still write into it
  if (steps > 0) cluster_wait();  // the last step's arrive
}

template <int M>
int launch_cluster(const void* gx, const void* w, const float* bn, void* out,
                   int steps, int batch, const Strides& layout,
                   cudaStream_t stream, int* out_info) {
  auto kernel = gru_layer_cluster_kernel<M>;
  const int smem = f32_smem_bytes(M);
  if (out_info) return cluster_info<kF32Cluster>(kernel, smem, out_info);
  static bool ready[kMaxDevices] = {};
  const int tiles = (batch + M - 1) / M;
  return static_cast<int>(launch_clusters<kF32Cluster>(
      kernel, ready, dim3(kF32Cluster * tiles, 2), smem, stream,
      static_cast<const float*>(gx), static_cast<const float*>(w), bn,
      static_cast<float*>(out), steps, batch, layout));
}

int dispatch_cluster(const void* gx, const void* w, const float* bn,
                     void* out, int steps, int batch, int hidden, int rows,
                     const Strides& layout, cudaStream_t stream,
                     int* out_info) {
  if (steps < 0 || batch < 0 || hidden != kHidden)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!out_info && (steps == 0 || batch == 0)) return 0;
  switch (rows) {
    case 1:
      return launch_cluster<1>(gx, w, bn, out, steps, batch, layout, stream,
                               out_info);
    case 2:
      return launch_cluster<2>(gx, w, bn, out, steps, batch, layout, stream,
                               out_info);
    case 4:
      return launch_cluster<4>(gx, w, bn, out, steps, batch, layout, stream,
                               out_info);
    case 8:
      return launch_cluster<8>(gx, w, bn, out, steps, batch, layout, stream,
                               out_info);
    case 16:
      return launch_cluster<16>(gx, w, bn, out, steps, batch, layout, stream,
                                out_info);
    case 32:
      return launch_cluster<32>(gx, w, bn, out, steps, batch, layout, stream,
                                out_info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The forward kernels' entry points take K2's addressing (gru_mma.cuh's
// Strides, in elements) after the launch's shape.

extern "C" int sir_gru_layer_bf16(const void* gx, const void* w,
                                  const float* bn, void* out, int steps,
                                  int batch, int hidden, int rows,
                                  long long gx_dir, long long gx_step,
                                  long long gx_row, long long out_dir,
                                  long long out_step, long long out_row,
                                  int reverse, void* stream) {
  const Strides layout{gx_dir, gx_step, gx_row, out_dir, out_step, out_row,
                       reverse};
  return launch<__nv_bfloat16>(gx, w, bn, out, steps, batch, hidden, rows,
                               layout, stream);
}

extern "C" int sir_gru_layer_f32(const void* gx, const void* w,
                                 const float* bn, void* out, int steps,
                                 int batch, int hidden, int rows,
                                 long long gx_dir, long long gx_step,
                                 long long gx_row, long long out_dir,
                                 long long out_step, long long out_row,
                                 int reverse, void* stream) {
  const Strides layout{gx_dir, gx_step, gx_row, out_dir, out_step, out_row,
                       reverse};
  return launch<float>(gx, w, bn, out, steps, batch, hidden, rows, layout,
                       stream);
}

// The tensor-core kernel: bf16, hidden = 256, rows in {16, 32, ..., 128};
// gx, ys and their direction and row strides 16-byte aligned.
extern "C" int sir_gru_layer_mma(const void* gx, const void* w,
                                 const float* bn, void* out, int steps,
                                 int batch, int hidden, int rows,
                                 long long gx_dir, long long gx_step,
                                 long long gx_row, long long out_dir,
                                 long long out_step, long long out_row,
                                 int reverse, void* stream) {
  const Strides layout{gx_dir, gx_step, gx_row, out_dir, out_step, out_row,
                       reverse};
  return dispatch_mma(gx, w, bn, out, steps, batch, hidden, rows, layout,
                      static_cast<cudaStream_t>(stream), nullptr);
}

// out[0..6]: registers, local bytes, shared bytes, threads, blocks per SM,
// blocks per cluster, resident clusters per card of the tensor-core kernel
// with `rows`-row tiles as built (gru_mma.cuh::cluster_info).
extern "C" int sir_gru_layer_mma_info(int rows, int* out) {
  return dispatch_mma(nullptr, nullptr, nullptr, nullptr, 0, 0, kHidden, rows,
                      Strides{}, nullptr, out);
}

// The fp32 cluster kernel: fp32, hidden = 256, rows in {1, 2, 4, 8, 16, 32}.
extern "C" int sir_gru_layer_cluster(const void* gx, const void* w,
                                     const float* bn, void* out, int steps,
                                     int batch, int hidden, int rows,
                                     long long gx_dir, long long gx_step,
                                     long long gx_row, long long out_dir,
                                     long long out_step, long long out_row,
                                     int reverse, void* stream) {
  const Strides layout{gx_dir, gx_step, gx_row, out_dir, out_step, out_row,
                       reverse};
  return dispatch_cluster(gx, w, bn, out, steps, batch, hidden, rows, layout,
                          static_cast<cudaStream_t>(stream), nullptr);
}

// out[0..6] as sir_gru_layer_mma_info's, for the fp32 cluster kernel.
extern "C" int sir_gru_layer_cluster_info(int rows, int* out) {
  return dispatch_cluster(nullptr, nullptr, nullptr, nullptr, 0, 0, kHidden,
                          rows, Strides{}, nullptr, out);
}
