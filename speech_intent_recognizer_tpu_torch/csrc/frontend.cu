// K3: fused log-mel front-end, one thread block per utterance.
//
// Replaces speech_intent_recognizer_tpu/ops/frontend_pallas.py::
// _fused_kernel (body: _frontend_core_impl; wrapper fused_frontend_pallas),
// the kernel the feature precompute runs.  Same contract: raw zero-padded
// waveform rows (B, L) f32 + true lengths in, with 1 + L // 512 <= 200;
// (B, 64, 200) mel-major features out, f32 or bf16, normalized per
// utterance (or raw dB with normalize = 0), frames at or past
// 1 + len // 512 zero.
//
// What the block computes:
//   1. the dB image of the valid frames, one warp per frame
//      (frontend_core.cuh phase 1, as K1);
//   2. with normalize, the masked mean and ddof=1 std (phase 2, as K1);
//   3. the store: threads run along time, so each mel row of 200 values is
//      written contiguously (coalesced), reading the time-major image with
//      a stride of 64 floats.  FP32 throughout; the only rounding is the
//      final cast when the output is bf16.
//
// What bounds it on the H100: as for K1, the shared-memory traffic of the
// warps' exchanges and mel sums, not HBM (a 320 KB waveform read and a 51 KB
// f32 write per utterance) and not arithmetic. The design is K1's: the warp-
// resident real-input FFT of warp_rfft.cuh with no block barrier inside phase
// 1.  As built for sm_90a (cudaFuncGetAttributes and the occupancy query,
// printed by chip_smoke.py): 96 registers a thread, no spills, 256 threads
// and 104,944 bytes of shared memory a block, two blocks (16 warps) an SM.
// On an H100 80GB HBM3 (700 W), f32 out, 80,000-sample buffers: 0.120 ms at
// B=256 and 0.543 ms at B=2048 (the plain version: 2.42 / 18.3).  The store's
// strided shared-memory reads conflict on one bank per warp; they are 12,800
// reads per utterance, a few per cent of phase 1's traffic.

#include "frontend_core.cuh"
#include "kernel_info.cuh"

namespace {

using namespace sir_frontend;

template <typename OutT>
struct Store;

template <>
struct Store<float> {
  static __device__ __forceinline__ float cast(float v) { return v; }
};

template <>
struct Store<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 cast(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <typename OutT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
frontend_kernel(const float* __restrict__ wav, const int* __restrict__ lengths,
                int width, const float* __restrict__ window,
                const float2* __restrict__ twiddle,
                const float* __restrict__ fb_packed,
                const int* __restrict__ fb_off, const int* __restrict__ fb_lo,
                int fb_nnz, OutT* __restrict__ out, int normalize, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CoreSmem& s = *reinterpret_cast<CoreSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const float* x = wav + static_cast<size_t>(b) * width;
  const int len = max(0, min(lengths[b], width));
  const int t_valid = min(1 + len / kHop, kTout);

  load_constants(s, window, twiddle, fb_packed, fb_off, fb_lo, fb_nnz);
  __syncthreads();
  log_mel_image(s, x, width, len, t_valid);

  float2 ms = make_float2(0.f, 1.f);  // identity when not normalizing
  if (normalize) ms = masked_moments(s, t_valid * kMels, eps);

  OutT* ob = out + static_cast<size_t>(b) * kMels * kTout;
  for (int i = tid; i < kMels * kTout; i += kThreads) {
    const int m = i / kTout, t = i % kTout;
    const float v = t < t_valid ? (s.img[t * kMels + m] - ms.x) * ms.y : 0.f;
    ob[i] = Store<OutT>::cast(v);
  }
}

template <typename OutT>
int launch(const float* wav, const int* lengths, int batch, int width,
           const float* window, const float* twiddle, const float* fb_packed,
           const int* fb_off, const int* fb_lo, int fb_nnz, void* out,
           int normalize, float eps, void* stream) {
  if (batch < 0 || width <= 0 || 1 + width / kHop > kTout || fb_nnz < 0 ||
      fb_nnz > kMaxNnz)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(CoreSmem));
  cudaError_t err = cudaFuncSetAttribute(
      frontend_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  frontend_kernel<OutT><<<batch, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      wav, lengths, width, window, reinterpret_cast<const float2*>(twiddle),
      fb_packed, fb_off, fb_lo, fb_nnz, static_cast<OutT*>(out), normalize,
      eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sir_frontend_f32(const float* wav, const int* lengths,
                                int batch, int width, const float* window,
                                const float* twiddle, const float* fb_packed,
                                const int* fb_off, const int* fb_lo,
                                int fb_nnz, void* out, int normalize,
                                float eps, void* stream) {
  return launch<float>(wav, lengths, batch, width, window, twiddle, fb_packed,
                       fb_off, fb_lo, fb_nnz, out, normalize, eps, stream);
}

extern "C" int sir_frontend_bf16(const float* wav, const int* lengths,
                                 int batch, int width, const float* window,
                                 const float* twiddle, const float* fb_packed,
                                 const int* fb_off, const int* fb_lo,
                                 int fb_nnz, void* out, int normalize,
                                 float eps, void* stream) {
  return launch<__nv_bfloat16>(wav, lengths, batch, width, window, twiddle,
                               fb_packed, fb_off, fb_lo, fb_nnz, out,
                               normalize, eps, stream);
}

// Registers, local memory, shared memory, threads and resident blocks per SM
// of the kernel as built (kernel_info.cuh); bf16 picks the bf16-out build.
extern "C" int sir_frontend_info(int bf16, int* out) {
  const int smem = static_cast<int>(sizeof(CoreSmem));
  return bf16 ? sir_info::kernel_info(frontend_kernel<__nv_bfloat16>,
                                      kThreads, smem, out)
              : sir_info::kernel_info(frontend_kernel<float>, kThreads, smem,
                                      out);
}
