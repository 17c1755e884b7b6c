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
// = W_hh^T and wt (2, 3H, H) = W_hh (its transpose) in the operand type; bn
// (2, H) f32.  Outputs: dgx (2, T, B, 3H) operand type, dgh (2, T, B, 3H)
// f32.  The workspace at B = 1024, T = 25, H = 256 is 2 * 25 * 1024 * 768 *
// 4 B = 157 MB.
//
// Design: grid (batch tiles, 2 directions), one thread per hidden unit, the
// tile heights of the forward kernel (ops/gru.py::tile_rows).  Per step, in
// reverse: stage h_prev of the tile's rows in shared memory; thread j
// recomputes gh[:, j], gh[:, H + j], gh[:, 2H + j] streaming W from L2 (as
// the forward does); computes the gates and adjoints of unit j; writes
// dgx_t and dgh_t; stages dgh of the tile's rows in shared memory; after a
// barrier, dh_prev[j] = dh * z + sum_k dgh[k] W[j, k] reads W's row j as
// column j of W^T, so neighbouring threads read neighbouring addresses.
// dh is carried in fp32 registers across steps.
//
// What bounds it on the H100: the same as the forward, twice over: two
// (rows x H) x (H x 3H) products per step on CUDA cores, each streaming
// 384 KiB (bf16) of weights from L2 per block and step, behind two block
// barriers; tensor cores (wgmma) and keeping W on chip are later work.
// On an H100 80GB HBM3 (700 W), one bf16 layer takes 1.60 ms at B=256
// with 4-row tiles (2.98 ms with 16) and 4.11 ms at B=1024 with 4-row
// tiles (3.82 ms with 16, which the shared rule does not pick).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
