// K5: conv2 + conv3 of the CNN stack in one kernel, activations in shared
// memory between the stages.
//
// Replaces speech_intent_recognizer_tpu/ops/conv23_pallas.py::_conv23_kernel
// (wrapper conv23_pallas).  Same contract: K1's pooled conv1 output
// (B, T1, 1024) bf16, lane = m * 32 + c (32 mel rows, 32 channels), T1 a
// multiple of 4; conv2 (3x3 SAME, 32 -> 64) + bias + ReLU + 2x2 max-pool,
// its result rounded to bf16, conv3 (64 -> 128) the same; out
// (B, T1 / 4, 1024) bf16, lane = m * 128 + c (8 mel rows).  Operands bf16,
// sums fp32, biases fp32.
//
// Design.  A convolution over a channels-last tile is a sum of nine matrix
// products, one per tap: rows = 16 neighbouring mel positions of one time
// row (their channel vectors lie one position apart in memory, which is a
// row-major matrix with the position stride as its leading dimension),
// columns = output channels, depth = input channels.  They run on the tensor
// cores through nvcuda::wmma (16x16x16 bf16, fp32 accumulators); the SAME
// padding is a halo of zeros in the tile, and the pool is a maximum over
// the accumulators of two time rows staged through shared memory.  None of
// the TPU kernel's rolls, band matrices or selection products is needed.
//
// One block computes kRows (5) output time rows of one utterance: it needs
// 4*5+6 input rows (one row of halo per stage: three input rows each side),
// 24 conv2 rows and 12 pooled rows, so conv2 is computed 1.2 times.  Both
// weight sets do not fit beside the tiles (conv3's alone are 144 KB), so the
// block loads conv2's weights with the input tile, and conv3's over them once
// conv2 is done.  Row strides are padded (48, 80, 72, 136 elements) to
// spread the fragments' rows over the banks while every fragment stays
// 32-byte aligned.
//
// What bounds it on the H100: operations (236 MFLOP per utterance against
// 256 KB moved).  As built it is held by one block of twelve warps per SM,
// wmma's 16x16 fragments (no wgmma), and the reload of 184 KB of weights
// from L2 by every block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kM1 = 32, kC1 = 32, kC2 = 64, kC3 = 128;
constexpr int kM2 = kM1 / 2, kM3 = kM2 / 2;
constexpr int kRows = 5;                  // output time rows per block
constexpr int kInRows = 4 * kRows + 6;    // 26
constexpr int kInCols = kM1 + 2;          // 34, one zero column each side
constexpr int kInLd = 48;                 // channel stride of the input tile
constexpr int kPairs2 = 2 * kRows + 2;    // 12 conv2 row pairs = pooled rows
constexpr int kP1Cols = kM2 + 2;          // 18
constexpr int kP1Ld = 80;
constexpr int kW2Ld = 72, kW3Ld = 136;    // padded output-channel strides
constexpr int kWarps = 12;
constexpr int kThreads = kWarps * 32;

constexpr int kInElems = kInRows * kInCols * kInLd;
constexpr int kW2Elems = 9 * kC1 * kW2Ld;
constexpr int kW3Elems = 9 * kC2 * kW3Ld;
constexpr int kP1Elems = kPairs2 * kP1Cols * kP1Ld;
constexpr int kRegion0 = kW3Elems;        // holds tile + w2, then w3
static_assert(kInElems + kW2Elems <= kRegion0, "phase 1 must fit in region 0");
constexpr size_t kSmemBytes =
    sizeof(__nv_bfloat16) * (kRegion0 + kP1Elems) +
    sizeof(float) * kWarps * 512;
static_assert(kSmemBytes <= 232448, "shared memory of one block");
static_assert((kInElems * 2) % 32 == 0 && (kRegion0 * 2) % 32 == 0 &&
              (kP1Elems * 2) % 32 == 0, "32-byte aligned regions");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void copy16(void* dst, const void* src, int n16) {
  uint4* d = static_cast<uint4*>(dst);
  const uint4* s = static_cast<const uint4*>(src);
  for (int i = threadIdx.x; i < n16; i += kThreads) d[i] = __ldg(s + i);
}

// Nine taps of one stage for two time rows x 16 positions x 64 output
// channels.  `tile` points at the tap (0, 0) position of the first row;
// `row_ld` / `pos_ld` are the tile's strides in elements; `w` points at the
// first of the 64 output channels in the [tap][cin][cout] weights.
template <int kCin, int kWLd>
__device__ __forceinline__ void conv_rows(FragC (&acc)[2][4],
                                          const __nv_bfloat16* tile,
                                          int row_ld, int pos_ld,
                                          const __nv_bfloat16* w) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[r][j], 0.f);
  for (int kt = 0; kt < 3; ++kt) {
    for (int km = 0; km < 3; ++km) {
      const __nv_bfloat16* wt = w + (kt * 3 + km) * kCin * kWLd;
#pragma unroll
      for (int kk = 0; kk < kCin / 16; ++kk) {
        FragA a[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          wmma::load_matrix_sync(
              a[r], tile + (r + kt) * row_ld + km * pos_ld + kk * 16, pos_ld);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          FragB bf;
          wmma::load_matrix_sync(bf, wt + kk * 16 * kWLd + j * 16, kWLd);
#pragma unroll
          for (int r = 0; r < 2; ++r)
            wmma::mma_sync(acc[r][j], a[r], bf, acc[r][j]);
        }
      }
    }
  }
}

// relu(max over the 2x2 window + bias) for the 8 pooled positions x 16
// channels of accumulator pair j, four channels per lane; `stage` is this
// warp's 512-float scratch.
__device__ __forceinline__ void pool_pair(FragC& top, FragC& bottom,
                                          float* stage,
                                          const float* __restrict__ bias16,
                                          __nv_bfloat16 (&o)[4]) {
  wmma::store_matrix_sync(stage, top, 16, wmma::mem_row_major);
  wmma::store_matrix_sync(stage + 256, bottom, 16, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const int i = lane >> 2, c0 = (lane & 3) * 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = c0 + e;
    const float v = fmaxf(
        fmaxf(stage[(2 * i) * 16 + c], stage[(2 * i + 1) * 16 + c]),
        fmaxf(stage[256 + (2 * i) * 16 + c], stage[256 + (2 * i + 1) * 16 + c]));
    o[e] = __float2bfloat16_rn(fmaxf(v + __ldg(bias16 + c), 0.f));
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads, 1)
conv23_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ w2p,
              const float* __restrict__ b2,
              const __nv_bfloat16* __restrict__ w3p,
              const float* __restrict__ b3, __nv_bfloat16* __restrict__ out,
              int t1, int chunks) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* region0 = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* in = region0;
  __nv_bfloat16* w2s = region0 + kInElems;
  __nv_bfloat16* w3s = region0;
  __nv_bfloat16* p1 = region0 + kRegion0;
  float* stage_all = reinterpret_cast<float*>(p1 + kP1Elems);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / chunks;
  const int t3_0 = (blockIdx.x % chunks) * kRows;  // first output row
  const int t2n = t1 / 2, t3n = t1 / 4;
  float* stage = stage_all + warp * 512;

  // ---- phase 0: the input tile with its zero halo, conv2's weights, and a
  // zeroed pooled tile (its halo and the rows outside the utterance stay 0)
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * t1 * (kM1 * kC1);
  for (int idx = tid; idx < kInRows * kInCols * (kC1 / 8); idx += kThreads) {
    const int v = idx % (kC1 / 8);
    const int col = (idx / (kC1 / 8)) % kInCols;
    const int r = idx / ((kC1 / 8) * kInCols);
    const int gt = 4 * t3_0 - 3 + r, m = col - 1;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gt >= 0 && gt < t1 && m >= 0 && m < kM1)
      val = __ldg(reinterpret_cast<const uint4*>(
          xb + (static_cast<size_t>(gt) * kM1 + m) * kC1 + v * 8));
    *reinterpret_cast<uint4*>(in + (r * kInCols + col) * kInLd + v * 8) = val;
  }
  copy16(w2s, w2p, kW2Elems / 8);
  for (int i = tid; i < kP1Elems / 8; i += kThreads)
    reinterpret_cast<uint4*>(p1)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // ---- phase 1: conv2 + bias + ReLU + pool -> p1 (bf16)
  // 24 warp tiles: 12 row pairs x 2 halves of the 32 mel positions
  for (int tile = warp; tile < 2 * kPairs2; tile += kWarps) {
    const int pr = tile >> 1, mh = tile & 1;
    const int gp = 2 * t3_0 - 1 + pr;  // pooled row in the utterance
    if (gp < 0 || gp >= t2n) continue;
    FragC acc[2][4];
    conv_rows<kC1, kW2Ld>(
        acc, in + ((2 * pr) * kInCols + mh * 16) * kInLd, kInCols * kInLd,
        kInLd, w2s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      __nv_bfloat16 o[4];
      pool_pair(acc[0][j], acc[1][j], stage, b2 + j * 16, o);
      __nv_bfloat16* dst = p1 + (pr * kP1Cols + mh * 8 + (lane >> 2) + 1) * kP1Ld +
                           j * 16 + (lane & 3) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = o[e];
    }
  }
  __syncthreads();

  // ---- phase 2: conv3's weights over the input tile and conv2's weights
  copy16(w3s, w3p, kW3Elems / 8);
  __syncthreads();

  // 10 warp tiles: 5 row pairs (= output rows) x 2 halves of 128 channels
  if (warp < 2 * kRows) {
    const int rp = warp >> 1, nh = warp & 1;
    const int t3 = t3_0 + rp;
    if (t3 < t3n) {
      FragC acc[2][4];
      conv_rows<kC2, kW3Ld>(acc, p1 + (2 * rp) * kP1Cols * kP1Ld,
                            kP1Cols * kP1Ld, kP1Ld, w3s + nh * 64);
      __nv_bfloat16* ob =
          out + (static_cast<size_t>(b) * t3n + t3) * (kM3 * kC3);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        __nv_bfloat16 o[4];
        pool_pair(acc[0][j], acc[1][j], stage, b3 + nh * 64 + j * 16, o);
        __nv_bfloat16* dst =
            ob + (lane >> 2) * kC3 + nh * 64 + j * 16 + (lane & 3) * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = o[e];
      }
    }
  }
}

}  // namespace

// x (batch, t1, 1024) bf16; w2p (9, 32, 72) and w3p (9, 64, 136) bf16,
// [tap = kt * 3 + km][cin][cout padded]; b2 (64), b3 (128) f32;
// out (batch, t1 / 4, 1024) bf16.
extern "C" int sir_conv23(const void* x, const void* w2p, const float* b2,
                          const void* w3p, const float* b3, void* out,
                          int batch, int t1, void* stream) {
  if (batch < 0 || t1 <= 0 || t1 % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv23_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  const int chunks = (t1 / 4 + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(batch) * chunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  conv23_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w2p), b2,
      static_cast<const __nv_bfloat16*>(w3p), b3,
      static_cast<__nv_bfloat16*>(out), t1, chunks);
  return static_cast<int>(cudaGetLastError());
}
