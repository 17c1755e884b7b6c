// K1: fused log-mel front-end + conv1 (3x3, 1->32, BN-folded bias) + ReLU +
// 2x2 max-pool, one thread block per utterance.
//
// Replaces speech_intent_recognizer_tpu/ops/frontend_pallas.py::
// _fused_conv1_kernel (body: _frontend_core_impl).  Same contract: raw
// zero-padded waveform + true length in, pooled conv1 output
// (B, 100, 1024) bf16 out, lane = m_pooled * 32 + c.
//
// What the block computes, in three phases (1 and 2 are the core shared
// with K3, frontend_core.cuh):
//   1. One warp per frame, for every valid frame t < 1 + len // 512: the
//      frame's 1024 samples of the centre-padded signal as 512 (even, odd)
//      pairs in registers (left reflect reads the zero-padded buffer
//      x[512 - p]; the right reflect is x[max(len - 2 - k, 0)]), periodic
//      Hann window, a 512-point complex FFT in registers with two exchanges
//      through the warp's own shared-memory buffer (warp_rfft.cuh), the
//      untangle to |X|^2 for bins 0..512, the sparse HTK mel sums and
//      10*log10(max(., 1e-10)).  The (200, 64) f32 dB image stays in shared
//      memory.
//   2. Masked per-utterance mean and ddof=1 std over the valid frames (two
//      block reductions), normalise, zero the invalid and padded frames, and
//      round the image to bf16 (the conv operand type of the TPU kernel).
//   3. conv1 with SAME zero padding in mel and time (bf16 operands, fp32
//      sums), ReLU, 2x2 max-pool, bf16 store of 32 channels per thread.
//
// What bounds it on the H100: not HBM (one 320 KB waveform read and a 200 KB
// write per utterance) and not arithmetic, but the shared-memory traffic of
// phase 1 (exchanges and mel sums), which the resident warps overlap for each
// other.  The design answers with a real-input, register-radix transform that
// needs no block barrier (the block synchronises only where data crosses
// warps: after the tables are loaded, before the moments, before the bf16
// rounding and before conv1) and with as many warps as the 51 KB image leaves
// room for.  As built for sm_90a (cudaFuncGetAttributes and the occupancy
// query, printed by chip_smoke.py): 96 registers a thread, no spills, 256
// threads and 106,224 bytes of shared memory a block, two blocks (16 warps)
// an SM.  On an H100 80GB HBM3 (700 W), 81,920-sample buffers, lengths
// uniform in [1, 80000]: 0.165 ms at B=256 and 0.954 ms at B=2048, of which
// phase 3 is ~0.4 ms.  None of the TPU kernel's Mosaic workarounds (bf16
// hi/lo split GEMMs, packed twiddle operands, antidiagonal lane reversal,
// band-matrix conv, selection-dot pooling) is carried over: FP32 arithmetic
// and plain indexed loads do that work here.

#include "frontend_core.cuh"
#include "kernel_info.cuh"

namespace {

using namespace sir_frontend;

constexpr int kC1 = 32;               // conv1 output channels
constexpr int kTPool = kTout / 2;
constexpr int kMPool = kMels / 2;

struct Smem {
  CoreSmem core;
  float cw[kC1 * 9];                  // conv1 taps [c][dm][dt], bf16 values
  float cb[kC1];
};

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
frontend_conv1_kernel(const float* __restrict__ wav,
                      const int* __restrict__ lengths, int width,
                      const float* __restrict__ window,
                      const float2* __restrict__ twiddle,
                      const float* __restrict__ fb_packed,
                      const int* __restrict__ fb_off,
                      const int* __restrict__ fb_lo, int fb_nnz,
                      const __nv_bfloat16* __restrict__ conv_w,
                      const __nv_bfloat16* __restrict__ conv_b,
                      __nv_bfloat16* __restrict__ out, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  CoreSmem& s = sm.core;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const float* x = wav + static_cast<size_t>(b) * width;
  const int len = max(0, min(lengths[b], width));
  const int t_valid = min(1 + len / kHop, kTout);

  load_constants(s, window, twiddle, fb_packed, fb_off, fb_lo, fb_nnz);
  for (int i = tid; i < kC1 * 9; i += kThreads)
    sm.cw[i] = __bfloat162float(conv_w[i]);
  for (int i = tid; i < kC1; i += kThreads) sm.cb[i] = __bfloat162float(conv_b[i]);
  __syncthreads();

  // ---- phase 1: frames -> dB mel image ----
  log_mel_image(s, x, width, len, t_valid);

  // ---- phase 2: masked mean / ddof=1 std, normalise, zero padded frames,
  // round to bf16 (the conv operand type of the TPU kernel) ----
  const int n_valid = t_valid * kMels;
  const float2 ms = masked_moments(s, n_valid, eps);
  for (int i = tid; i < kTout * kMels; i += kThreads) {
    const float v = i < n_valid ? (s.img[i] - ms.x) * ms.y : 0.f;
    s.img[i] = __bfloat162float(__float2bfloat16_rn(v));
  }
  __syncthreads();

  // ---- phase 3: conv1 + bias + ReLU + 2x2 max-pool ----
  __nv_bfloat16* ob = out + static_cast<size_t>(b) * kTPool * kMPool * kC1;
  for (int i = tid; i < kTPool * kMPool; i += kThreads) {
    const int tp = i / kMPool, mp = i % kMPool;
    float pv[4][4];  // [time][mel] input patch of the four pooled positions
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = 2 * tp - 1 + a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = 2 * mp - 1 + c;
        pv[a][c] = (t >= 0 && t < kTout && m >= 0 && m < kMels)
                       ? s.img[t * kMels + m] : 0.f;
      }
    }
    uint32_t packed[kC1 / 2];
#pragma unroll
    for (int c = 0; c < kC1; c += 2) {
      float r[2];
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const float* w = &sm.cw[(c + cc) * 9];  // [dm][dt]
        float best = -INFINITY;
#pragma unroll
        for (int ot = 0; ot < 2; ++ot) {
#pragma unroll
          for (int om = 0; om < 2; ++om) {
            float acc = sm.cb[c + cc];
#pragma unroll
            for (int dm = 0; dm < 3; ++dm) {
#pragma unroll
              for (int dt = 0; dt < 3; ++dt)
                acc = fmaf(w[dm * 3 + dt], pv[ot + dt][om + dm], acc);
            }
            best = fmaxf(best, acc);
          }
        }
        r[cc] = fmaxf(best, 0.f);
      }
      __nv_bfloat162 h2 = __floats2bfloat162_rn(r[0], r[1]);
      packed[c / 2] = *reinterpret_cast<uint32_t*>(&h2);
    }
    uint4* dst = reinterpret_cast<uint4*>(
        ob + static_cast<size_t>(tp) * (kMPool * kC1) + mp * kC1);
#pragma unroll
    for (int q = 0; q < kC1 / 8; ++q)
      dst[q] = make_uint4(packed[4 * q], packed[4 * q + 1], packed[4 * q + 2],
                          packed[4 * q + 3]);
  }
}

}  // namespace

extern "C" int sir_frontend_conv1(const float* wav, const int* lengths,
                                  int batch, int width, const float* window,
                                  const float* twiddle, const float* fb_packed,
                                  const int* fb_off, const int* fb_lo,
                                  int fb_nnz, const void* conv_w,
                                  const void* conv_b, void* out, float eps,
                                  void* stream) {
  if (batch < 0 || width <= 0 || fb_nnz < 0 || fb_nnz > kMaxNnz)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      frontend_conv1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  frontend_conv1_kernel<<<batch, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      wav, lengths, width, window, reinterpret_cast<const float2*>(twiddle),
      fb_packed, fb_off, fb_lo, fb_nnz,
      static_cast<const __nv_bfloat16*>(conv_w),
      static_cast<const __nv_bfloat16*>(conv_b),
      static_cast<__nv_bfloat16*>(out), eps);
  return static_cast<int>(cudaGetLastError());
}

// Registers, local memory, shared memory, threads and resident blocks per SM
// of the kernel as built (kernel_info.cuh).
extern "C" int sir_frontend_conv1_info(int* out) {
  return sir_info::kernel_info(frontend_conv1_kernel, kThreads,
                               static_cast<int>(sizeof(Smem)), out);
}
