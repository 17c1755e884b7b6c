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
// Design: grid (batch tiles, 2 directions), one thread per hidden unit.
// Thread j owns unit j of every row of its tile, so the r/z/n gates of a
// unit are computed by the thread that accumulated them and h never leaves
// registers except as the operand-rounded copy in shared memory that the
// next step's product reads.  The time loop runs inside the block.
//
// What bounds it on the H100: W_hh is 256 x 768 per direction (384 KiB in
// bf16), more than one SM's shared memory, so every step streams it from L2
// (which holds it); each weight load feeds one FMA per row of the tile, so
// the tile height trades L2 traffic against the number of blocks in flight.
// Two heights are built, and the caller picks one (ops/gru.py::tile_rows)
// from the batch and the SM count: 16 rows where that still puts a block
// on every SM, 4 rows below.  On an H100 80GB HBM3 (700 W), one bf16 layer
// at B=2048 takes 1.71 ms with 16-row tiles and 2.14 ms with 4-row tiles;
// at B=256, 0.54 ms with 4-row tiles and 1.15 ms with 16-row tiles.
// The product runs on CUDA cores in fp32; tensor cores (wgmma), weight
// splitting across a cluster and keeping W_hh on chip are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

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
                                 int hidden) {
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

    const size_t base = (static_cast<size_t>(dir) * steps + t) * batch;
    const T* g = gx + base * h3;
    T* o = out + base * hidden;
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const int row = row0 + r;
      if (row < batch) {
        const T* gr = g + static_cast<size_t>(row) * h3;
        const float rg = sigmoid(Op::load(gr + j) + ar[r]);
        const float zg = sigmoid(Op::load(gr + hidden + j) + az[r]);
        const float ng = tanhf(Op::load(gr + 2 * hidden + j) + rg * (an[r] + bnj));
        h[r] = (1.f - zg) * ng + zg * h[r];
        o[static_cast<size_t>(row) * hidden + j] = Op::store(h[r]);
      }
      hs[r * hidden + j] = Op::round(h[r]);
    }
    __syncthreads();
  }
}

template <typename T, int BT>
cudaError_t launch_tile(const void* gx, const void* w, const float* bn,
                        void* out, int steps, int batch, int hidden,
                        cudaStream_t stream) {
  const int smem = BT * hidden * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      gru_layer_kernel<T, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + BT - 1) / BT, 2);
  gru_layer_kernel<T, BT><<<grid, hidden, smem, stream>>>(
      static_cast<const T*>(gx), static_cast<const T*>(w), bn,
      static_cast<T*>(out), steps, batch, hidden);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* gx, const void* w, const float* bn, void* out,
           int steps, int batch, int hidden, int rows, void* stream) {
  if (steps < 0 || batch < 0 || hidden <= 0 || hidden % 32 || hidden > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (steps == 0 || batch == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 4:
      return static_cast<int>(
          launch_tile<T, 4>(gx, w, bn, out, steps, batch, hidden, st));
    case 16:
      return static_cast<int>(
          launch_tile<T, 16>(gx, w, bn, out, steps, batch, hidden, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int sir_gru_layer_bf16(const void* gx, const void* w,
                                  const float* bn, void* out, int steps,
                                  int batch, int hidden, int rows,
                                  void* stream) {
  return launch<__nv_bfloat16>(gx, w, bn, out, steps, batch, hidden, rows,
                               stream);
}

extern "C" int sir_gru_layer_f32(const void* gx, const void* w,
                                 const float* bn, void* out, int steps,
                                 int batch, int hidden, int rows,
                                 void* stream) {
  return launch<float>(gx, w, bn, out, steps, batch, hidden, rows, stream);
}
