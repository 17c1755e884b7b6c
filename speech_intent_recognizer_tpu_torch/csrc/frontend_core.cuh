// The log-mel core shared by K1 (frontend_conv1.cu) and K3 (frontend.cu):
// one thread block per utterance, the whole chain in shared memory.
//
// Counterpart of speech_intent_recognizer_tpu/ops/frontend_pallas.py::
// _frontend_core_impl.  Two phases, each a device function:
//   1. log_mel_image: for every valid frame t < 1 + len // 512, four frames
//      per pass, build the 1024-sample frame of the centre-padded signal by
//      direct indexing (left reflect reads the zero-padded buffer
//      x[512 - p]; the right reflect is x[max(len - 2 - k, 0)]; samples at
//      or past the buffer width read as zero), apply the periodic Hann
//      window, run a radix-2 FP32 FFT in shared memory, take |X|^2 for bins
//      0..512, project onto the sparse HTK filterbank and take
//      10*log10(max(., 1e-10)).  The (200, 64) f32 dB image stays in shared
//      memory, time-major (img[t * 64 + m]).
//   2. masked_moments: the per-utterance mean and 1 / (ddof=1 std + eps)
//      over the valid frames (two block reductions).
//
// What bounds it on the H100: the barrier-separated FFT stages (ten per
// four frames), not HBM; see frontend_conv1.cu for the measurement.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sir_frontend {

constexpr int kNfft = 1024;
constexpr int kPad = kNfft / 2;       // centre padding
constexpr int kHop = 512;
constexpr int kBins = kNfft / 2 + 1;  // 513
constexpr int kMels = 64;
constexpr int kTout = 200;            // mel_spec_length
constexpr int kFrames = 4;            // frames transformed per pass
constexpr int kThreads = 256;
constexpr int kMaxNnz = 2 * kBins;    // an FFT bin feeds at most two triangles
constexpr int kBinsPad = 516;

struct CoreSmem {
  float img[kTout * kMels];           // dB image, time-major
  float2 fft[kFrames][kNfft];
  float2 tw[kNfft / 2];               // e^{-2 pi i k / 1024}
  float win[kNfft];
  float pw[kFrames][kBinsPad];
  float fb[kMaxNnz];                  // filterbank weights, mel-major
  int fb_off[kMels + 1];
  int fb_lo[kMels];                   // first FFT bin of each triangle
  float red[kThreads / 32];
};

// Sum over the block; every thread gets the same value.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// Window, twiddles and the packed filterbank into shared memory.  The
// caller synchronises before phase 1.
__device__ __forceinline__ void load_constants(
    CoreSmem& s, const float* __restrict__ window,
    const float2* __restrict__ twiddle, const float* __restrict__ fb_packed,
    const int* __restrict__ fb_off, const int* __restrict__ fb_lo,
    int fb_nnz) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kNfft; i += kThreads) s.win[i] = window[i];
  for (int i = tid; i < kNfft / 2; i += kThreads) s.tw[i] = twiddle[i];
  for (int i = tid; i <= kMels; i += kThreads) s.fb_off[i] = fb_off[i];
  for (int i = tid; i < kMels; i += kThreads) s.fb_lo[i] = fb_lo[i];
  for (int i = tid; i < fb_nnz; i += kThreads) s.fb[i] = fb_packed[i];
}

// Phase 1: frames t < t_valid of the waveform x (width samples, true
// length len) -> s.img[t * kMels + m] in dB.  Ends synchronised.
__device__ __forceinline__ void log_mel_image(CoreSmem& s,
                                              const float* __restrict__ x,
                                              int width, int len,
                                              int t_valid) {
  const int tid = threadIdx.x;
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
}

// Phase 2: (mean, 1 / (sqrt(var) + eps)) over the n_valid = t_valid * kMels
// leading entries of the image, var with ddof=1 (max(cnt - 1, 1)).
__device__ __forceinline__ float2 masked_moments(CoreSmem& s, int n_valid,
                                                 float eps) {
  const int tid = threadIdx.x;
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
  return make_float2(mean, 1.f / (sqrtf(var) + eps));
}

}  // namespace sir_frontend
