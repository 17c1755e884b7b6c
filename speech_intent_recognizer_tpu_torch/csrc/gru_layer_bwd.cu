// K2 backward: the adjoint recurrence of one bidirectional GRU layer, both
// directions, all T steps in reverse in one launch.
//
// Replaces speech_intent_recognizer_tpu/ops/gru_pallas.py::
// _gru_layer_diff_bwd (the custom-VJP backward of _gru_layer_kernel, a fused
// lax.scan in reversed time) and computes exactly what it computes:
//   * h_prev at step t is the STORED output ys[t - 1] (zeros at t = 0), the
//     operand-rounded value, not the fp32 h the forward carried;
//   * w and bn are upcast to fp32; gh = h_prev W is recomputed, all gate and
//     adjoint math is fp32;
//   * dgx_t = [da_r, da_z, da_n] is rounded to the operand type; the fp32
//     dgh_t = [da_r, da_z, da_n * r] goes to a workspace, from which the
//     caller forms dW = sum_{t,b} h_prev^T dgh (one batched fp32 GEMM) and
//     dbn = sum_{t,b} dgh[2H:] (ops/gru.py), deterministically.
//
// Inputs: gx (2, T, B, 3H) and ys, dys (2, T, B, H) in the operand type,
// direction 1 in reversed time as the forward kernel has them; w (2, H, 3H)
// = W_hh^T in the operand type; bn (2, H) f32.  The tensor-core kernel reads
// w in both orientations; the CUDA-core kernel also takes wt (2, 3H, H), its
// transpose, so that neighbouring threads read neighbouring addresses.
// Outputs: dgx (2, T, B, 3H) operand type, dgh (2, T, B, 3H) f32.  The
// workspace at B = 1024, T = 25, H = 256 is 2 * 25 * 1024 * 768 * 4 B =
// 157 MB.
//
// Three kernels; ops/gru.py::gru_plan says which one a call takes.
//
// 1. gru_layer_bwd_mma_kernel: bf16, H = 256, the kernel that trains.  What
//    bounds it on the H100 is the serial chain of T steps, each with two
//    products: gh = h_prev @ W (rows x 256 x 768), whose operands are
//    inputs and which therefore waits for nothing, and dh_prev = dgh @ W^T
//    (rows x 768 x 256), which the next step waits for.  W is needed in
//    both orientations and fits no single SM.  The design, on the machinery
//    of the forward kernel (gru_mma.cuh: a cluster of 4 blocks per tile of
//    16 or 32 rows, rank c owns the r, z, n columns of units [64c, 64c+64)):
//    * the slice W[:, columns of c] is on chip twice, loaded once per block:
//      as mma.sync B fragments in registers for gh (as in the forward), and
//      in shared memory (98,304 bytes, rows = unit, 16-byte chunks swizzled)
//      where ldmatrix reads the same bytes as the B fragments of the other
//      orientation.  No transposed copy of W is made on the host;
//    * gh, the gates and their adjoints are computed in the thread that
//      holds the sums (as in the forward); dh stays in fp32 registers;
//    * dh_prev sums over all 768 gate columns, which the split by unit
//      spreads over the ranks.  Each rank multiplies ITS 192 columns of dgh
//      by its slice, giving a partial sum for all 256 units, and sends each
//      rank the 64 units it owns (fp32, st.shared::cluster into a double-
//      buffered inbox); the owner adds the four partial sums in rank order.
//      The other way, publishing dgh to every rank as the forward publishes
//      h, would move 3x the bytes between SMs and make every warp read a
//      (rows x 768) hi + lo operand, 4x the shared-memory traffic.  No
//      atomics: two launches give the same bits;
//    * dgh is an fp32 operand in the JAX package.  It is fed to the tensor
//      cores as hi + lo bf16 halves (hi = bf16(v), lo = bf16(v - hi)), two
//      MMAs into one accumulator, which keeps ~16 bits of each value, so
//      the product matches the fp32 one to ~2^-17 relative;
//    * the step's h_prev tile, gx slice and dys slice are fetched with
//      cp.async while the dh product of the step before runs; one cluster
//      barrier per step.
// 2. gru_layer_bwd_cluster_kernel: fp32, H = 256, the fp32 parity path
//    (TF32 would break the per-element gradient bar that holds it to the
//    JAX package; expf / tanhf, fp32 FMAs on CUDA cores).  fp32 W_hh^T is
//    786,432 bytes a direction, which no SM holds, and a kernel that streams
//    it from L2 at every step spends ~18 us a step on it, twice in the
//    backward.  The design is the fp32 forward's (gru_mma.cuh, "the fp32
//    backward"): a cluster of 8 blocks per (direction, tile of rows), rank
//    c holding the r, z, n columns of units [32c, 32c + 32) in registers
//    for gh = h_prev W, and the same slice again in shared memory by rows
//    of k for dh_prev; each rank's partial sums of dh_prev go to their
//    owner ranks through distributed shared memory and are added there in
//    rank order: no atomics, the same bits every launch.  The h_prev tile
//    of the step before is copied by cp.async while a step runs, and the gh
//    product, which waits for no other rank, runs before the wait for the
//    partial sums.
// 3. gru_layer_bwd_kernel: fp32 or bf16 operands, any H that is a multiple
//    of 32, fp32 FMAs on CUDA cores, one thread per hidden unit, W streamed
//    from L2 twice a step (w for gh, wt for dh_prev).  It serves every H
//    other than 256.
//
// Times stand in PERF.md, each with the card's name and power limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "gru_mma.cuh"

namespace {

template <typename T>
struct Operand;

template <>
struct Operand<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Operand<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

template <typename T, int BT>
__global__ void gru_layer_bwd_kernel(const T* __restrict__ gx,
                                     const T* __restrict__ w,
                                     const T* __restrict__ wt,
                                     const float* __restrict__ bn,
                                     const T* __restrict__ ys,
                                     const T* __restrict__ dys,
                                     T* __restrict__ dgx,
                                     float* __restrict__ dgh, int steps,
                                     int batch, int hidden) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                  // [BT][hidden]   h_prev of the tile
  float* gs = smem + BT * hidden;    // [BT][3 hidden] dgh of the tile
  using Op = Operand<T>;
  const int j = threadIdx.x;
  const int dir = blockIdx.y;
  const int row0 = blockIdx.x * BT;
  const int h3 = 3 * hidden;
  const T* wd = w + static_cast<size_t>(dir) * hidden * h3;
  const T* wtd = wt + static_cast<size_t>(dir) * h3 * hidden;
  const float bnj = bn[dir * hidden + j];

  float dh[BT];
#pragma unroll
  for (int r = 0; r < BT; ++r) dh[r] = 0.f;

  for (int t = steps - 1; t >= 0; --t) {
    // h_prev = ys[t - 1] (zeros at t = 0) for the tile's rows
    const size_t prev = (static_cast<size_t>(dir) * steps + t - 1) * batch;
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const int row = row0 + r;
      hs[r * hidden + j] = (t > 0 && row < batch)
          ? Op::load(ys + (prev + row) * hidden + j) : 0.f;
    }
    __syncthreads();

    // gh = h_prev W for unit j of each gate
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

    // gates and adjoints of unit j
    const size_t base = (static_cast<size_t>(dir) * steps + t) * batch;
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const int row = row0 + r;
      float dar = 0.f, daz = 0.f, dghn = 0.f;
      if (row < batch) {
        const size_t g = (base + row) * h3;
        const float rg = sigmoid(Op::load(gx + g + j) + ar[r]);
        const float zg = sigmoid(Op::load(gx + g + hidden + j) + az[r]);
        const float ghn_b = an[r] + bnj;
        const float ng = tanhf(Op::load(gx + g + 2 * hidden + j) + rg * ghn_b);
        const float hp = hs[r * hidden + j];
        const float dh_tot = dh[r] + Op::load(dys + (base + row) * hidden + j);
        const float dn = dh_tot * (1.f - zg);
        const float dz = dh_tot * (hp - ng);
        const float dan = dn * (1.f - ng * ng);
        dar = dan * ghn_b * rg * (1.f - rg);
        daz = dz * zg * (1.f - zg);
        dghn = dan * rg;
        dh[r] = dh_tot * zg;
        dgx[g + j] = Op::store(dar);
        dgx[g + hidden + j] = Op::store(daz);
        dgx[g + 2 * hidden + j] = Op::store(dan);
        dgh[g + j] = dar;
        dgh[g + hidden + j] = daz;
        dgh[g + 2 * hidden + j] = dghn;
      }
      gs[r * h3 + j] = dar;
      gs[r * h3 + hidden + j] = daz;
      gs[r * h3 + 2 * hidden + j] = dghn;
    }
    __syncthreads();

    // dh_prev[j] += sum_k dgh[k] W[j, k], W[j, k] = wt[k, j]
    float acc[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) acc[r] = 0.f;
    for (int k = 0; k < h3; k += 4) {
      float wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wv[q] = Op::load(wtd + static_cast<size_t>(k + q) * hidden + j);
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float4 gv = *reinterpret_cast<const float4*>(&gs[r * h3 + k]);
        acc[r] = fmaf(gv.x, wv[0], fmaf(gv.y, wv[1], fmaf(gv.z, wv[2], fmaf(gv.w, wv[3], acc[r]))));
      }
    }
#pragma unroll
    for (int r = 0; r < BT; ++r) dh[r] += acc[r];
    // the next step's first writes (hs) are read by no thread still here,
    // and gs is rewritten only after the next step's first barrier
  }
}

template <typename T, int BT>
cudaError_t launch_tile(const void* gx, const void* w, const void* wt,
                        const float* bn, const void* ys, const void* dys,
                        void* dgx, float* dgh, int steps, int batch,
                        int hidden, cudaStream_t stream) {
  const int smem = BT * 4 * hidden * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      gru_layer_bwd_kernel<T, BT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + BT - 1) / BT, 2);
  gru_layer_bwd_kernel<T, BT><<<grid, hidden, smem, stream>>>(
      static_cast<const T*>(gx), static_cast<const T*>(w),
      static_cast<const T*>(wt), bn, static_cast<const T*>(ys),
      static_cast<const T*>(dys), static_cast<T*>(dgx), dgh, steps, batch,
      hidden);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* gx, const void* w, const void* wt, const float* bn,
           const void* ys, const void* dys, void* dgx, float* dgh, int steps,
           int batch, int hidden, int rows, void* stream) {
  if (steps < 0 || batch < 0 || hidden <= 0 || hidden % 32 || hidden > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (steps == 0 || batch == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 4:
      return static_cast<int>(launch_tile<T, 4>(
          gx, w, wt, bn, ys, dys, dgx, dgh, steps, batch, hidden, st));
    case 16:
      return static_cast<int>(launch_tile<T, 16>(
          gx, w, wt, bn, ys, dys, dgx, dgh, steps, batch, hidden, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---- the tensor-core kernel ----

using namespace gru_mma;

constexpr int kSliceBytes = kHidden * 3 * kUnits * 2;   // 98,304: W[:, rank]
constexpr int kSliceChunks = 3 * kUnits / 8;            // 24 chunks a row

// Shared memory with 16 * MT rows a tile: the W slice; the inbox (2 buffers
// x 4 source ranks x rows x 64 fp32); dgh of this rank's columns as bf16 hi
// | lo (rows x 768 bytes); the h_prev tile (rows x 512 bytes); the gx slice
// (rows x 384 bytes); the dys slice (rows x 128 bytes).
constexpr int bwd_mma_smem_bytes(int mt) {
  return kSliceBytes + 16 * mt * (2 * 4 * 256 + 768 + 512 + 384 + 128);
}

// Granule (8 bytes = 2 units) g of inbox row `row`, swizzled so that the
// eight rows a warp stores at once fall on different banks.
__device__ __forceinline__ int inbox_offset(int row, int granule) {
  return row * 256 + (granule ^ ((row & 7) << 2)) * 8;
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
gru_layer_bwd_mma_kernel(const __nv_bfloat16* __restrict__ gx,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ bn,
                         const __nv_bfloat16* __restrict__ ys,
                         const __nv_bfloat16* __restrict__ dys,
                         __nv_bfloat16* __restrict__ dgx,
                         float* __restrict__ dgh, int steps, int batch) {
  constexpr int M = 16 * MT;
  extern __shared__ __align__(128) unsigned char tile_mem[];
  unsigned char* wt = tile_mem;
  unsigned char* inbox = wt + kSliceBytes;
  unsigned char* dg = inbox + 2 * 4 * M * 256;
  unsigned char* hp = dg + M * 768;
  unsigned char* gxs = hp + M * 512;
  unsigned char* dyt = gxs + M * 384;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int rank = static_cast<int>(cluster_rank());
  const int dir = blockIdx.y;
  const int row0 = static_cast<int>(blockIdx.x / kCluster) * M;
  const int unit0 = rank * kUnits + warp * 8;

  const __nv_bfloat16* wd = w + static_cast<size_t>(dir) * kHidden * kGates;
  uint32_t wf[kKTiles][3][2];
  load_w_fragments(wf, wd, unit0, lane);
  const float bn0 = bn[dir * kHidden + unit0 + 2 * q];
  const float bn1 = bn[dir * kHidden + unit0 + 2 * q + 1];

  // the same slice by rows: row j holds w[j, gate * 256 + 64 rank + 8 o + u]
  // at chunk 3 o + gate, element u: the order in which warp o's dgh lies
  for (int i = tid; i < kHidden * kSliceChunks; i += kThreads) {
    const int j = i / kSliceChunks, c = i % kSliceChunks;
    cp_async_16(smem_addr(wt) + chunk_offset(j, c, kSliceChunks),
                wd + static_cast<size_t>(j) * kGates + (c % 3) * kHidden +
                    rank * kUnits + (c / 3) * 8,
                true);
  }

  const size_t dir_rows = static_cast<size_t>(dir) * steps * batch;
  const __nv_bfloat16* gxd = gx + dir_rows * kGates;
  const __nv_bfloat16* ysd = ys + dir_rows * kHidden;
  const __nv_bfloat16* dysd = dys + dir_rows * kHidden;

  // start the copies of step t's h_prev tile, gx slice and dys slice
  auto load_step = [&](int t) {
    for (int i = tid; i < M * 32; i += kThreads) {
      const int row = i >> 5, c = i & 31;
      const bool valid = t > 0 && row0 + row < batch;
      cp_async_16(smem_addr(hp) + h_offset(M, c >> 3, row, c & 7),
                  ysd + (valid ? (static_cast<size_t>(t - 1) * batch + row0 +
                                  row) * kHidden + c * 8
                               : 0),
                  valid);
    }
    load_gx_slice(smem_addr(gxs), gxd + static_cast<size_t>(t) * batch * kGates,
                  M, row0, batch, rank, tid);
    for (int i = tid; i < M * 8; i += kThreads) {
      const int row = i >> 3, c = i & 7;
      const bool valid = row0 + row < batch;
      cp_async_16(smem_addr(dyt) + chunk_offset(row, c, 8),
                  dysd + (valid ? (static_cast<size_t>(t) * batch + row0 +
                                   row) * kHidden + rank * kUnits + c * 8
                                : 0),
                  valid);
    }
  };

  float dhz[MT][4];   // dh_tot * z of the step after (in time) this one
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    dhz[mt][0] = dhz[mt][1] = dhz[mt][2] = dhz[mt][3] = 0.f;
  if (steps > 0) load_step(steps - 1);
  cp_async_commit();
  // no rank writes another's shared memory before every rank runs
  cluster_arrive();
  cluster_wait();

  for (int t = steps - 1; t >= 0; --t) {
    cp_async_wait<0>();
    __syncthreads();   // step t's tiles (and the W slice) are whole

    // gh = h_prev @ W for this warp's units: waits for no other rank
    float acc[MT][3][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int gate = 0; gate < 3; ++gate)
        acc[mt][gate][0] = acc[mt][gate][1] = acc[mt][gate][2] =
            acc[mt][gate][3] = 0.f;
    recurrent_product<MT>(acc, wf, smem_addr(hp), M, 0, lane);

    const bool last = t == steps - 1;   // the first step run: dh = 0
    // every rank's partial sums of step t + 1 are in inbox[(t + 1) & 1]
    if (!last) cluster_wait();
    const unsigned char* box_in = inbox + ((t + 1) & 1) * 4 * M * 256;
    const size_t step_row = dir_rows + static_cast<size_t>(t) * batch;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = mt * 16 + g + 8 * half;
        const uint32_t xr = *reinterpret_cast<const uint32_t*>(
            gxs + chunk_offset(row, warp, 24) + 4 * q);
        const uint32_t xz = *reinterpret_cast<const uint32_t*>(
            gxs + chunk_offset(row, 8 + warp, 24) + 4 * q);
        const uint32_t xn = *reinterpret_cast<const uint32_t*>(
            gxs + chunk_offset(row, 16 + warp, 24) + 4 * q);
        const uint32_t hp2 = *reinterpret_cast<const uint32_t*>(
            hp + h_offset(M, rank, row, warp) + 4 * q);
        const uint32_t dy2 = *reinterpret_cast<const uint32_t*>(
            dyt + chunk_offset(row, warp, 8) + 4 * q);
        float sum[2] = {0.f, 0.f};
        if (!last) {
#pragma unroll
          for (int src = 0; src < kCluster; ++src) {
            const float2 p = *reinterpret_cast<const float2*>(
                box_in + src * M * 256 + inbox_offset(row, 4 * warp + q));
            sum[0] += p.x;
            sum[1] += p.y;
          }
        }
        float dar[2], daz[2], dan[2], dgn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int a = 2 * half + e;
          const float rg = sigmoid_fast((e ? bf16_hi(xr) : bf16_lo(xr)) +
                                        acc[mt][0][a]);
          const float zg = sigmoid_fast((e ? bf16_hi(xz) : bf16_lo(xz)) +
                                        acc[mt][1][a]);
          const float ghn_b = acc[mt][2][a] + (e ? bn1 : bn0);
          const float ng = tanh_fast((e ? bf16_hi(xn) : bf16_lo(xn)) +
                                     rg * ghn_b);
          const float hpv = e ? bf16_hi(hp2) : bf16_lo(hp2);
          const float dh_tot = dhz[mt][a] + sum[e] +
                               (e ? bf16_hi(dy2) : bf16_lo(dy2));
          const float dn = dh_tot * (1.f - zg);
          const float dz = dh_tot * (hpv - ng);
          dan[e] = dn * (1.f - ng * ng);
          dar[e] = dan[e] * ghn_b * rg * (1.f - rg);
          daz[e] = dz * zg * (1.f - zg);
          dgn[e] = dan[e] * rg;
          dhz[mt][a] = dh_tot * zg;
        }
        const uint32_t hr = pack_bf16(dar[0], dar[1]);
        const uint32_t hz = pack_bf16(daz[0], daz[1]);
        const uint32_t hn = pack_bf16(dgn[0], dgn[1]);
        if (row0 + row < batch) {
          const size_t o = (step_row + row0 + row) * kGates + unit0 + 2 * q;
          *reinterpret_cast<uint32_t*>(dgx + o) = hr;
          *reinterpret_cast<uint32_t*>(dgx + o + kHidden) = hz;
          *reinterpret_cast<uint32_t*>(dgx + o + 2 * kHidden) =
              pack_bf16(dan[0], dan[1]);
          *reinterpret_cast<float2*>(dgh + o) = make_float2(dar[0], dar[1]);
          *reinterpret_cast<float2*>(dgh + o + kHidden) =
              make_float2(daz[0], daz[1]);
          *reinterpret_cast<float2*>(dgh + o + 2 * kHidden) =
              make_float2(dgn[0], dgn[1]);
        }
        // dgh of these two units as hi + lo halves, in warp `warp`'s chunks
        unsigned char* d = dg + 4 * q;
        *reinterpret_cast<uint32_t*>(d + chunk_offset(row, 3 * warp, 48)) = hr;
        *reinterpret_cast<uint32_t*>(d + chunk_offset(row, 3 * warp + 1, 48)) =
            hz;
        *reinterpret_cast<uint32_t*>(d + chunk_offset(row, 3 * warp + 2, 48)) =
            hn;
        *reinterpret_cast<uint32_t*>(
            d + chunk_offset(row, kSliceChunks + 3 * warp, 48)) =
            pack_bf16(dar[0] - bf16_lo(hr), dar[1] - bf16_hi(hr));
        *reinterpret_cast<uint32_t*>(
            d + chunk_offset(row, kSliceChunks + 3 * warp + 1, 48)) =
            pack_bf16(daz[0] - bf16_lo(hz), daz[1] - bf16_hi(hz));
        *reinterpret_cast<uint32_t*>(
            d + chunk_offset(row, kSliceChunks + 3 * warp + 2, 48)) =
            pack_bf16(dgn[0] - bf16_lo(hn), dgn[1] - bf16_hi(hn));
      }
    }
    __syncthreads();   // dgh of the tile is whole; the step's tiles are read

    if (t > 0) {
      load_step(t - 1);
      cp_async_commit();

      // partial dh_prev[:, 32 warp .. 32 warp + 32) over this rank's columns
      float acc2[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          acc2[mt][nt][0] = acc2[mt][nt][1] = acc2[mt][nt][2] =
              acc2[mt][nt][3] = 0.f;
      const int brow = 32 * warp + (lane & 7) + 8 * (lane >> 4);
      const int bchunk = (lane >> 3) & 1;
      const int arow = (lane & 7) + 8 * ((lane >> 3) & 1);
      const int achunk = lane >> 4;
#pragma unroll
      for (int kt = 0; kt < kSliceChunks / 2; ++kt) {
        uint32_t b[2][4];
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldmatrix_x4(b[np], smem_addr(wt) + chunk_offset(brow + 16 * np,
                                                          2 * kt + bchunk,
                                                          kSliceChunks));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t hi[4], lo[4];
          ldmatrix_x4(hi, smem_addr(dg) + chunk_offset(mt * 16 + arow,
                                                       2 * kt + achunk, 48));
          ldmatrix_x4(lo, smem_addr(dg) +
                              chunk_offset(mt * 16 + arow,
                                           kSliceChunks + 2 * kt + achunk,
                                           48));
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            mma_bf16(acc2[mt][nt], hi, b[nt >> 1][2 * (nt & 1)],
                     b[nt >> 1][2 * (nt & 1) + 1]);
            mma_bf16(acc2[mt][nt], lo, b[nt >> 1][2 * (nt & 1)],
                     b[nt >> 1][2 * (nt & 1) + 1]);
          }
        }
      }
      // units [32 warp, 32 warp + 32) belong to rank warp / 2
      const uint32_t box_out = map_to_rank(
          smem_addr(inbox) + ((t & 1) * 4 + rank) * M * 256, warp >> 1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            st_cluster_8(box_out + inbox_offset(mt * 16 + g + 8 * half,
                                                (warp & 1) * 16 + 4 * nt + q),
                         acc2[mt][nt][2 * half], acc2[mt][nt][2 * half + 1]);
    }
    cluster_arrive();
  }
  // no rank leaves while another may still write into it
  if (steps > 0) cluster_wait();
}

template <int MT>
int launch_mma(const void* gx, const void* w, const float* bn, const void* ys,
               const void* dys, void* dgx, float* dgh, int steps, int batch,
               cudaStream_t stream, int* out_info) {
  auto kernel = gru_layer_bwd_mma_kernel<MT>;
  const int smem = bwd_mma_smem_bytes(MT);
  if (out_info) return cluster_info(kernel, smem, out_info);
  static bool ready[kMaxDevices] = {};
  const int tiles = (batch + 16 * MT - 1) / (16 * MT);
  return static_cast<int>(launch_clusters(
      kernel, ready, dim3(kCluster * tiles, 2), smem, stream,
      static_cast<const __nv_bfloat16*>(gx),
      static_cast<const __nv_bfloat16*>(w), bn,
      static_cast<const __nv_bfloat16*>(ys),
      static_cast<const __nv_bfloat16*>(dys),
      static_cast<__nv_bfloat16*>(dgx), dgh, steps, batch));
}

int dispatch_mma(const void* gx, const void* w, const float* bn,
                 const void* ys, const void* dys, void* dgx, float* dgh,
                 int steps, int batch, int hidden, int rows,
                 cudaStream_t stream, int* out_info) {
  if (steps < 0 || batch < 0 || hidden != kHidden)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!out_info && (steps == 0 || batch == 0)) return 0;
  switch (rows) {
    case 16:
      return launch_mma<1>(gx, w, bn, ys, dys, dgx, dgh, steps, batch, stream,
                           out_info);
    case 32:
      return launch_mma<2>(gx, w, bn, ys, dys, dgx, dgh, steps, batch, stream,
                           out_info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---- the fp32 cluster kernel ----

// gx and dys of step t for the (row, unit) pairs tid + 256 j of a tile of M
// rows, unit = lane of rank unit0 / 32 (0 in rows past the tile or batch).
template <int M, int P>
__device__ __forceinline__ void load_bwd_pairs(float (&g)[P][3],
                                               float (&dy)[P],
                                               const float* __restrict__ gxd,
                                               const float* __restrict__ dysd,
                                               int t, int batch, int row0,
                                               int unit0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int row = (static_cast<int>(threadIdx.x) + kThreads * j) / 32;
    if (row < M && row0 + row < batch) {
      const size_t at = static_cast<size_t>(t) * batch + row0 + row;
      const float* src = gxd + at * kGates + unit0 + lane;
      g[j][0] = __ldg(src);
      g[j][1] = __ldg(src + kHidden);
      g[j][2] = __ldg(src + 2 * kHidden);
      dy[j] = __ldg(dysd + at * kHidden + unit0 + lane);
    } else {
      g[j][0] = g[j][1] = g[j][2] = dy[j] = 0.f;
    }
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads, 1)
gru_layer_bwd_cluster_kernel(const float* __restrict__ gx,
                             const float* __restrict__ w,
                             const float* __restrict__ bn,
                             const float* __restrict__ ys,
                             const float* __restrict__ dys,
                             float* __restrict__ dgx,
                             float* __restrict__ dgh, int steps, int batch) {
  constexpr int U = kF32Units;                 // units a rank, one a lane
  constexpr int C3 = 3 * U;                    // the rank's columns of W^T
  constexpr int KQ = kF32SliceK / 4;           // float4s of a k-slice
  constexpr int RB = M < 8 ? M : 8;            // rows multiplied together
  constexpr int P = (M * U + kThreads - 1) / kThreads;  // pairs a thread gates
  static_assert(U == 32, "a lane per unit of the rank");
  extern __shared__ __align__(16) float f32_mem[];
  float* const wts = f32_mem;                          // [k][kF32WtStride]
  float* const hp = wts + kHidden * kF32WtStride;      // [2][M][256]
  float* const part = hp + f32_h_floats(M);            // f32_partial_index
  float* const dg = part + kF32Slices * M * C3;        // [M][C3]
  float* const inbox = dg + M * C3;                    // f32_inbox_index
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = static_cast<int>(cluster_rank());
  const int dir = blockIdx.y;
  const int row0 = static_cast<int>(blockIdx.x / kF32Cluster) * M;
  const int unit0 = rank * U;
  const float* wd = w + static_cast<size_t>(dir) * kHidden * kGates;
  const size_t dir_rows = static_cast<size_t>(dir) * steps * batch;
  const float* gxd = gx + dir_rows * kGates;
  const float* ysd = ys + dir_rows * kHidden;
  const float* dysd = dys + dir_rows * kHidden;

  // the slice by rows of k, for dh_prev: chunk c of row k holds the
  // columns of gate c / 8, units 4 (c % 8) .. 4 (c % 8) + 3
  for (int i = tid; i < kHidden * C3 / 4; i += kThreads) {
    const int k = i / (C3 / 4), c = i % (C3 / 4);
    cp_async_16(smem_addr(wts + k * kF32WtStride + 4 * c),
                wd + static_cast<size_t>(k) * kGates + (c >> 3) * kHidden +
                    unit0 + 4 * (c & 7),
                true);
  }
  // the same slice in registers, for gh: the forward's float4s of k
  float4 wr[KQ][3];
#pragma unroll
  for (int kq = 0; kq < KQ; ++kq)
#pragma unroll
    for (int gate = 0; gate < 3; ++gate) {
      const float* p = wd +
          static_cast<size_t>(kF32SliceK * warp + 4 * kq) * kGates +
          gate * kHidden + unit0 + lane;
      wr[kq][gate] =
          make_float4(p[0], p[kGates], p[2 * kGates], p[3 * kGates]);
    }

  // start the copy of step t's h_prev tile: ys[t - 1], zeros at t = 0 and
  // in rows past the batch
  auto load_h = [&](int t) {
    float* dst = hp + (t & 1) * M * kHidden;
    for (int i = tid; i < M * kHidden / 4; i += kThreads) {
      const int row = i / (kHidden / 4), c = i % (kHidden / 4);
      const bool valid = t > 0 && row0 + row < batch;
      cp_async_16(smem_addr(dst + row * kHidden + 4 * c),
                  ysd + (valid ? (static_cast<size_t>(t - 1) * batch + row0 +
                                  row) * kHidden + 4 * c
                               : 0),
                  valid);
    }
  };

  // the (row, unit) pairs this thread gates: tid + 256 j, all of unit lane
  const float bnj = bn[dir * kHidden + unit0 + lane];
  float g[P][3], dy[P], dhz[P];
#pragma unroll
  for (int j = 0; j < P; ++j) dhz[j] = 0.f;   // dh_tot * z of step t + 1
  if (steps > 0) {
    load_h(steps - 1);
    load_bwd_pairs<M>(g, dy, gxd, dysd, steps - 1, batch, row0, unit0);
  }
  cp_async_commit();
  // no rank writes another's shared memory before every rank runs
  cluster_arrive();
  cluster_wait();

  for (int t = steps - 1; t >= 0; --t) {
    cp_async_wait<0>();
    __syncthreads();  // step t's h_prev tile (and the slice by rows) are whole
    if (t > 0) load_h(t - 1);
    cp_async_commit();
    const float* hc = hp + (t & 1) * M * kHidden;

    // gh = h_prev W over this warp's k-slice: waits for no other rank
    for (int r0 = 0; r0 < M; r0 += RB) {
      float acc[RB][3];
#pragma unroll
      for (int rb = 0; rb < RB; ++rb)
        acc[rb][0] = acc[rb][1] = acc[rb][2] = 0.f;
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) {
        float4 hv[RB];
#pragma unroll
        for (int rb = 0; rb < RB; ++rb)
          hv[rb] = *reinterpret_cast<const float4*>(
              hc + (r0 + rb) * kHidden + kF32SliceK * warp + 4 * kq);
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          const float4 wv = wr[kq][gate];
#pragma unroll
          for (int rb = 0; rb < RB; ++rb)
            acc[rb][gate] = fmaf(hv[rb].w, wv.w, fmaf(hv[rb].z, wv.z,
                fmaf(hv[rb].y, wv.y, fmaf(hv[rb].x, wv.x, acc[rb][gate]))));
        }
      }
#pragma unroll
      for (int rb = 0; rb < RB; ++rb)
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
          part[f32_partial_index(M, warp, r0 + rb, gate, lane)] =
              acc[rb][gate];
    }
    __syncthreads();  // every warp's partial sums are in

    const bool last = t == steps - 1;   // the first step run: dh = 0
    if (!last) cluster_wait();  // every rank's partial sums of step t + 1
    const float* box = inbox + f32_inbox_index(M, (t + 1) & 1, 0, 0, 0);
    const size_t step_row = dir_rows + static_cast<size_t>(t) * batch;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int row = (tid + kThreads * j) / U;
      if (row < M) {
        float s[3];
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          s[gate] = part[f32_partial_index(M, 0, row, gate, lane)];
#pragma unroll
          for (int sl = 1; sl < kF32Slices; ++sl)
            s[gate] += part[f32_partial_index(M, sl, row, gate, lane)];
        }
        float din = 0.f;
        if (!last) {
#pragma unroll
          for (int src = 0; src < kF32Cluster; ++src)
            din += box[f32_inbox_index(M, 0, src, row, lane)];
        }
        const bool valid = row0 + row < batch;
        const float rg = sigmoid(g[j][0] + s[0]);
        const float zg = sigmoid(g[j][1] + s[1]);
        const float ghn_b = s[2] + bnj;
        const float ng = tanhf(g[j][2] + rg * ghn_b);
        const float hpv = hc[row * kHidden + unit0 + lane];
        const float dh_tot = dhz[j] + din + dy[j];
        const float dn = dh_tot * (1.f - zg);
        const float dz = dh_tot * (hpv - ng);
        float dan = dn * (1.f - ng * ng);
        float dar = dan * ghn_b * rg * (1.f - rg);
        float daz = dz * zg * (1.f - zg);
        float dgn = dan * rg;
        dhz[j] = dh_tot * zg;
        if (valid) {
          const size_t o = (step_row + row0 + row) * kGates + unit0 + lane;
          dgx[o] = dar;
          dgx[o + kHidden] = daz;
          dgx[o + 2 * kHidden] = dan;
          dgh[o] = dar;
          dgh[o + kHidden] = daz;
          dgh[o + 2 * kHidden] = dgn;
        } else {
          dar = daz = dgn = 0.f;
        }
        dg[row * C3 + lane] = dar;
        dg[row * C3 + U + lane] = daz;
        dg[row * C3 + 2 * U + lane] = dgn;
      }
    }
    __syncthreads();  // the dgh tile is whole; the partial sums are read

    if (t > 0) {
      // this rank's part of dh_prev[:, k] for every row, k = tid: row k of
      // the slice times the dgh tile, over the rank's columns in order
      float acc[M];
#pragma unroll
      for (int r = 0; r < M; ++r) acc[r] = 0.f;
      const float* wk = wts + tid * kF32WtStride;
#pragma unroll 4
      for (int c = 0; c < C3; c += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(wk + c);
#pragma unroll
        for (int r = 0; r < M; ++r) {
          const float4 d = *reinterpret_cast<const float4*>(dg + r * C3 + c);
          acc[r] = fmaf(d.w, wv.w, fmaf(d.z, wv.z,
                   fmaf(d.y, wv.y, fmaf(d.x, wv.x, acc[r]))));
        }
      }
      // k = 32 warp + lane is unit `lane` of rank `warp`
      const uint32_t box_out = map_to_rank(
          smem_addr(inbox + f32_inbox_index(M, t & 1, rank, 0, lane)), warp);
#pragma unroll
      for (int r = 0; r < M; ++r) st_cluster_4(box_out + 4 * U * r, acc[r]);
    }
    cluster_arrive();  // the partial sums are on their way to their owners
    if (t > 0) load_bwd_pairs<M>(g, dy, gxd, dysd, t - 1, batch, row0, unit0);
  }
  // no rank leaves while another may still write into it
  if (steps > 0) cluster_wait();  // the last step's arrive
}

template <int M>
int launch_cluster(const void* gx, const void* w, const float* bn,
                   const void* ys, const void* dys, void* dgx, float* dgh,
                   int steps, int batch, cudaStream_t stream, int* out_info) {
  auto kernel = gru_layer_bwd_cluster_kernel<M>;
  const int smem = f32_bwd_smem_bytes(M);
  if (out_info) return cluster_info<kF32Cluster>(kernel, smem, out_info);
  static bool ready[kMaxDevices] = {};
  const int tiles = (batch + M - 1) / M;
  return static_cast<int>(launch_clusters<kF32Cluster>(
      kernel, ready, dim3(kF32Cluster * tiles, 2), smem, stream,
      static_cast<const float*>(gx), static_cast<const float*>(w), bn,
      static_cast<const float*>(ys), static_cast<const float*>(dys),
      static_cast<float*>(dgx), dgh, steps, batch));
}

int dispatch_cluster(const void* gx, const void* w, const float* bn,
                     const void* ys, const void* dys, void* dgx, float* dgh,
                     int steps, int batch, int hidden, int rows,
                     cudaStream_t stream, int* out_info) {
  if (steps < 0 || batch < 0 || hidden != kHidden)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!out_info && (steps == 0 || batch == 0)) return 0;
  switch (rows) {
    case 1:
      return launch_cluster<1>(gx, w, bn, ys, dys, dgx, dgh, steps, batch,
                               stream, out_info);
    case 2:
      return launch_cluster<2>(gx, w, bn, ys, dys, dgx, dgh, steps, batch,
                               stream, out_info);
    case 4:
      return launch_cluster<4>(gx, w, bn, ys, dys, dgx, dgh, steps, batch,
                               stream, out_info);
    case 8:
      return launch_cluster<8>(gx, w, bn, ys, dys, dgx, dgh, steps, batch,
                               stream, out_info);
    case 16:
      return launch_cluster<16>(gx, w, bn, ys, dys, dgx, dgh, steps, batch,
                                stream, out_info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int sir_gru_layer_bwd_bf16(const void* gx, const void* w,
                                      const void* wt, const float* bn,
                                      const void* ys, const void* dys,
                                      void* dgx, float* dgh, int steps,
                                      int batch, int hidden, int rows,
                                      void* stream) {
  return launch<__nv_bfloat16>(gx, w, wt, bn, ys, dys, dgx, dgh, steps,
                               batch, hidden, rows, stream);
}

extern "C" int sir_gru_layer_bwd_f32(const void* gx, const void* w,
                                     const void* wt, const float* bn,
                                     const void* ys, const void* dys,
                                     void* dgx, float* dgh, int steps,
                                     int batch, int hidden, int rows,
                                     void* stream) {
  return launch<float>(gx, w, wt, bn, ys, dys, dgx, dgh, steps, batch, hidden,
                       rows, stream);
}

// The tensor-core kernel: bf16, hidden = 256, rows in {16, 32}; it reads w
// in both orientations and takes no transposed copy.
extern "C" int sir_gru_layer_bwd_mma(const void* gx, const void* w,
                                     const float* bn, const void* ys,
                                     const void* dys, void* dgx, float* dgh,
                                     int steps, int batch, int hidden,
                                     int rows, void* stream) {
  return dispatch_mma(gx, w, bn, ys, dys, dgx, dgh, steps, batch, hidden,
                      rows, static_cast<cudaStream_t>(stream), nullptr);
}

// out[0..6]: registers, local bytes, shared bytes, threads, blocks per SM,
// blocks per cluster, resident clusters per card of the tensor-core kernel
// with `rows`-row tiles as built (gru_mma.cuh::cluster_info).
extern "C" int sir_gru_layer_bwd_mma_info(int rows, int* out) {
  return dispatch_mma(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      nullptr, 0, 0, kHidden, rows, nullptr, out);
}

// The fp32 cluster kernel: fp32, hidden = 256, rows in {1, 2, 4, 8, 16}; it
// takes no transposed copy of w.
extern "C" int sir_gru_layer_bwd_cluster(const void* gx, const void* w,
                                         const float* bn, const void* ys,
                                         const void* dys, void* dgx,
                                         float* dgh, int steps, int batch,
                                         int hidden, int rows, void* stream) {
  return dispatch_cluster(gx, w, bn, ys, dys, dgx, dgh, steps, batch, hidden,
                          rows, static_cast<cudaStream_t>(stream), nullptr);
}

// out[0..6] as sir_gru_layer_bwd_mma_info's, for the fp32 cluster kernel.
extern "C" int sir_gru_layer_bwd_cluster_info(int rows, int* out) {
  return dispatch_cluster(nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, nullptr, 0, 0, kHidden, rows, nullptr,
                          out);
}
