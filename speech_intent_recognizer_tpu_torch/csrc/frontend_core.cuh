// The log-mel core shared by K1 (frontend_conv1.cu) and K3 (frontend.cu):
// one thread block per utterance, one warp per frame, the (200, 64) dB
// image in shared memory.
//
// Counterpart of speech_intent_recognizer_tpu/ops/frontend_pallas.py::
// _frontend_core_impl.  Two phases, each a device function:
//   1. log_mel_image: warp w takes frames t = w, w + kWarps, ... of the
//      valid frames t < 1 + len // 512.  It builds the frame's 1024 samples
//      of the centre-padded signal in registers, as 512 (even, odd) pairs,
//      16 per lane (left reflect reads the zero-padded buffer x[512 - p];
//      the right reflect is x[max(len - 2 - k, 0)]; samples at or past the
//      buffer width read as zero; a frame that touches neither edge is read
//      with 8-byte loads), applies the periodic Hann window, runs the
//      warp-resident real-input FFT of warp_rfft.cuh, and sums its mel
//      triangles over the power row (two mels per lane) into
//      10*log10(max(., 1e-10)).  The f32 dB image stays in shared memory,
//      time-major (img[t * 64 + m]).  Nothing in this phase crosses warps,
//      so it holds no block barrier but the one at its end.
//   2. masked_moments: the per-utterance mean and 1 / (ddof=1 std + eps)
//      over the valid frames (two block reductions).
//
// What bounds it on the H100: neither HBM (a 320 KB read per utterance) nor
// arithmetic (8 MFLOP per utterance), but the shared-memory traffic of each
// warp's exchanges and mel sums, overlapped by the other warps on the SM.  The 51 KB image caps that at two 8-warp blocks per SM
// (CoreSmem is 104,944 bytes; 96 registers a thread, no spills); see
// frontend_conv1.cu and frontend.cu for the times.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_rfft.cuh"

namespace sir_frontend {

constexpr int kLog2Nfft = 10;
constexpr int kNfft = 1 << kLog2Nfft;
constexpr int kPad = kNfft / 2;       // centre padding
constexpr int kHop = 512;
constexpr int kBins = kNfft / 2 + 1;  // 513
constexpr int kMels = 64;
constexpr int kTout = 200;            // mel_spec_length
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2;       // what the image leaves room for
constexpr int kMaxNnz = 2 * kBins;    // an FFT bin feeds at most two triangles

using Fft = sir_fft::Plan<kLog2Nfft>;

struct CoreSmem {
  float img[kTout * kMels];           // dB image, time-major
  sir_fft::Tables<kLog2Nfft> tb;      // window, untangle and pass twiddles
  float2 xbuf[kWarps][Fft::kXbuf];    // each warp's exchange buffer / power row
  float fb[kMaxNnz];                  // filterbank weights, mel-major
  int fb_off[kMels + 1];
  int fb_lo[kMels];                   // first FFT bin of each triangle
  float red[kWarps];
};

// Sum over the block; every thread gets the same value.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kWarps; ++w) s += red[w];
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
  sir_fft::load_tables<kLog2Nfft>(s.tb, window, twiddle, tid, kThreads);
  for (int i = tid; i <= kMels; i += kThreads) s.fb_off[i] = fb_off[i];
  for (int i = tid; i < kMels; i += kThreads) s.fb_lo[i] = fb_lo[i];
  for (int i = tid; i < fb_nnz; i += kThreads) s.fb[i] = fb_packed[i];
}

// Sample p of the centre-padded signal of x (width samples, true length len).
__device__ __forceinline__ float padded_sample(const float* __restrict__ x,
                                               int width, int len, int p) {
  int src;
  if (p < kPad) {
    src = kPad - p;              // x[1:513][::-1] of the zero-padded buffer
  } else if (p - kPad < len) {
    src = p - kPad;
  } else {                       // k = p - pad - len: x[max(len - 2 - k, 0)]
    src = max(2 * len - 2 - (p - kPad), 0);
  }
  return src < width ? x[src] : 0.f;
}

// Phase 1: frames t < t_valid of the waveform x (width samples, true
// length len) -> s.img[t * kMels + m] in dB.  Ends synchronised.
__device__ __forceinline__ void log_mel_image(CoreSmem& s,
                                              const float* __restrict__ x,
                                              int width, int len,
                                              int t_valid) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float2* xbuf = s.xbuf[warp];
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 7) == 0;
  for (int t = warp; t < t_valid; t += kWarps) {
    const int p0 = t * kHop;     // the frame's first index in the padded signal
    float2 v[Fft::kV];
    if (t >= 1 && p0 + kPad <= len) {  // no sample of the frame is reflected
      const float* f = x + (p0 - kPad);
#pragma unroll
      for (int r = 0; r < Fft::kV; ++r) {
        const int n = lane + 32 * r;
        v[r] = aligned ? reinterpret_cast<const float2*>(f)[n]
                       : make_float2(f[2 * n], f[2 * n + 1]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < Fft::kV; ++r) {
        const int p = p0 + 2 * (lane + 32 * r);
        v[r] = make_float2(padded_sample(x, width, len, p),
                           padded_sample(x, width, len, p + 1));
      }
    }
#pragma unroll
    for (int r = 0; r < Fft::kV; ++r) {
      const float2 w = s.tb.win2[lane + 32 * r];
      v[r] = make_float2(v[r].x * w.x, v[r].y * w.y);
    }
    sir_fft::warp_rfft_power<kLog2Nfft>(v, s.tb, xbuf, lane);
    float* row = s.img + t * kMels;
    sir_fft::warp_mel_db(reinterpret_cast<const float*>(xbuf), s.fb, s.fb_off,
                         s.fb_lo, kMels, lane,
                         [row](int m, float db) { row[m] = db; });
    __syncwarp();  // the power row is read before the next frame overwrites it
  }
  __syncthreads();
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
