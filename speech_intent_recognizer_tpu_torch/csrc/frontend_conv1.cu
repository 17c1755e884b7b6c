// K1: fused log-mel front-end + conv1 (3x3, 1->32, BN-folded bias) + ReLU +
// 2x2 max-pool, one thread block per utterance.
//
// Replaces speech_intent_recognizer_tpu/ops/frontend_pallas.py::
// _fused_conv1_kernel (body: _frontend_core_impl).  Same contract: raw
// zero-padded waveform + true length in, pooled conv1 output
// (B, 100, 1024) bf16 out, lane = m_pooled * 32 + c.
//
// What the block computes, in three phases:
//   1. For every valid frame t < 1 + len // 512, four frames per pass: build
//      the 1024-sample frame of the centre-padded signal by direct indexing
//      (left reflect reads the zero-padded buffer x[512 - p]; the right
//      reflect is x[max(len - 2 - k, 0)]), apply the periodic Hann window,
//      run a radix-2 FP32 FFT in shared memory, take |X|^2 for bins 0..512,
//      project onto the sparse HTK filterbank and take 10*log10(max(., 1e-10)).
//      The (200, 64) f32 dB image stays in shared memory.
//   2. Masked per-utterance mean and ddof=1 std over the valid frames (two
//      block reductions), normalise, zero the invalid and padded frames, and
//      round the image to bf16 (the conv operand type of the TPU kernel).
//   3. conv1 with SAME zero padding in mel and time (bf16 operands, fp32
//      sums), ReLU, 2x2 max-pool, bf16 store of 32 channels per thread.
//
// What bounds it on the H100: not HBM (one 320 KB waveform read and a
// 200 KB write per utterance) but the shared-memory FFT: ten butterfly
// stages, each behind a block barrier, for every four frames.  The design
// keeps the whole chain in shared memory so nothing but the waveform and the
// pooled output touches device memory; a tensor-core DFT, warp-level FFTs
// and fewer barriers are left to later work.  None of the TPU kernel's
// Mosaic workarounds (bf16 hi/lo split GEMMs, packed twiddle operands,
// antidiagonal lane reversal, band-matrix conv, selection-dot pooling) is
// carried over: FP32 arithmetic and plain indexed loads do that work here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNfft = 1024;
constexpr int kPad = kNfft / 2;       // centre padding
constexpr int kHop = 512;
constexpr int kBins = kNfft / 2 + 1;  // 513
constexpr int kMels = 64;
constexpr int kTout = 200;            // mel_spec_length
constexpr int kC1 = 32;               // conv1 output channels
constexpr int kTPool = kTout / 2;
constexpr int kMPool = kMels / 2;
constexpr int kFrames = 4;            // frames transformed per pass
constexpr int kThreads = 256;
constexpr int kMaxNnz = 2 * kBins;    // an FFT bin feeds at most two triangles
constexpr int kBinsPad = 516;

struct Smem {
  float img[kTout * kMels];           // dB image, time-major
  float2 fft[kFrames][kNfft];
  float2 tw[kNfft / 2];               // e^{-2 pi i k / 1024}
  float win[kNfft];
  float pw[kFrames][kBinsPad];
  float fb[kMaxNnz];                  // filterbank weights, mel-major
  int fb_off[kMels + 1];
  int fb_lo[kMels];                   // first FFT bin of each triangle
  float cw[kC1 * 9];                  // conv1 taps [c][dm][dt], bf16 values
  float cb[kC1];
  float red[kThreads / 32];
};

// Sum over the block; every thread gets the same value.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(kThreads)
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
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const float* x = wav + static_cast<size_t>(b) * width;
  const int len = max(0, min(lengths[b], width));
  const int t_valid = min(1 + len / kHop, kTout);

  for (int i = tid; i < kNfft; i += kThreads) s.win[i] = window[i];
  for (int i = tid; i < kNfft / 2; i += kThreads) s.tw[i] = twiddle[i];
  for (int i = tid; i <= kMels; i += kThreads) s.fb_off[i] = fb_off[i];
  for (int i = tid; i < kMels; i += kThreads) s.fb_lo[i] = fb_lo[i];
  for (int i = tid; i < fb_nnz; i += kThreads) s.fb[i] = fb_packed[i];
  for (int i = tid; i < kC1 * 9; i += kThreads)
    s.cw[i] = __bfloat162float(conv_w[i]);
  for (int i = tid; i < kC1; i += kThreads) s.cb[i] = __bfloat162float(conv_b[i]);
  __syncthreads();

  // ---- phase 1: frames -> dB mel image ----
  for (int t0 = 0; t0 < t_valid; t0 += kFrames) {
    for (int i = tid; i < kFrames * kNfft; i += kThreads) {
      const int f = i / kNfft, n = i % kNfft, t = t0 + f;
      float v = 0.f;
      if (t < t_valid) {
        const int p = t * kHop + n;  // index into the centre-padded signal
        int src;
        if (p < kPad) {
          src = kPad - p;            // x[1:513][::-1] of the zero-padded buffer
        } else if (p - kPad < len) {
          src = p - kPad;
        } else {                     // k = p - pad - len: x[max(len - 2 - k, 0)]
          src = max(2 * len - 2 - (p - kPad), 0);
        }
        v = (src < width ? x[src] : 0.f) * s.win[n];
      }
      s.fft[f][__brev(n) >> 22] = make_float2(v, 0.f);  // bit-reversed order
    }
    __syncthreads();
    for (int half = 1; half < kNfft; half <<= 1) {
      const int stride = kNfft / (2 * half);
      for (int i = tid; i < kFrames * (kNfft / 2); i += kThreads) {
        const int f = i / (kNfft / 2), j = i % (kNfft / 2);
        const int pos = j & (half - 1);
        const int i0 = ((j - pos) << 1) + pos;
        const int i1 = i0 + half;
        const float2 w = s.tw[pos * stride];
        const float2 a = s.fft[f][i0];
        const float2 c = s.fft[f][i1];
        const float2 tc = make_float2(c.x * w.x - c.y * w.y,
                                      c.x * w.y + c.y * w.x);
        s.fft[f][i0] = make_float2(a.x + tc.x, a.y + tc.y);
        s.fft[f][i1] = make_float2(a.x - tc.x, a.y - tc.y);
      }
      __syncthreads();
    }
    for (int i = tid; i < kFrames * kBins; i += kThreads) {
      const int f = i / kBins, k = i % kBins;
      const float2 X = s.fft[f][k];
      s.pw[f][k] = X.x * X.x + X.y * X.y;
    }
    __syncthreads();
    for (int i = tid; i < kFrames * kMels; i += kThreads) {
      const int f = i / kMels, m = i % kMels, t = t0 + f;
      if (t < t_valid) {
        const int lo = s.fb_lo[m], o0 = s.fb_off[m], o1 = s.fb_off[m + 1];
        float acc = 0.f;
        for (int o = o0; o < o1; ++o) acc = fmaf(s.fb[o], s.pw[f][lo + o - o0], acc);
        s.img[t * kMels + m] = 10.f * log10f(fmaxf(acc, 1e-10f));
      }
    }
    __syncthreads();
  }

  // ---- phase 2: masked mean / ddof=1 std, normalise, zero padded frames ----
  const int n_valid = t_valid * kMels;
  float part = 0.f;
  for (int i = tid; i < n_valid; i += kThreads) part += s.img[i];
  const float cnt = static_cast<float>(n_valid);
  const float mean = block_sum(part, s.red) / cnt;
  part = 0.f;
  for (int i = tid; i < n_valid; i += kThreads) {
    const float d = s.img[i] - mean;
    part = fmaf(d, d, part);
  }
  const float var = block_sum(part, s.red) / fmaxf(cnt - 1.f, 1.f);
  const float scale = 1.f / (sqrtf(var) + eps);
  for (int i = tid; i < kTout * kMels; i += kThreads) {
    const float v = i < n_valid ? (s.img[i] - mean) * scale : 0.f;
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
        const float* w = &s.cw[(c + cc) * 9];  // [dm][dt]
        float best = -INFINITY;
#pragma unroll
        for (int ot = 0; ot < 2; ++ot) {
#pragma unroll
          for (int om = 0; om < 2; ++om) {
            float acc = s.cb[c + cc];
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
