// A warp-resident real-input FFT: one warp transforms one windowed frame of
// N = 2^LOG2N real samples (N = 512, 1024 or 2048) and leaves the power
// spectrum |X[k]|^2, k = 0..N/2, in its own row of shared memory.  It is the
// transform of K1 and K3 (frontend_core.cuh, N = 1024) and of K4
// (mel_db.cu, the three sizes).
//
// Why it looks like this on the H100.  A frame's transform is ~50 K fp32
// operations on 4 KB: far too little to be bound by arithmetic or by HBM,
// so what it costs is latency, shared-memory traffic and barriers.  The
// design removes those:
//   * Real input through a half-size complex transform.  The even and odd
//     windowed samples of ONE frame are packed as z[n] = x[2n] + i x[2n+1],
//     n < M = N/2; Z = DFT_M(z) is computed and untangled into
//         X[k] = (Z[k] + Z*[M-k]) / 2 - (i/2) W_N^k (Z[k] - Z*[M-k]),
//     k = 0..M (Z[M] = Z[0]; X[0] and X[M] come out real).  Two frames are
//     never packed into one transform: a silent frame would pick up rounding
//     noise of a loud one and leave the exact -100 dB floor.
//   * Butterflies in registers at radix 8 (and 4 / 16 in the last pass).
//     M = 8 * 8 * R3 with R3 = M/64.  A lane holds V = M/32 complex values,
//     before the first pass z[lane + 32 r] and after the last Z[lane + 32 r]
//     (r < V): input and output in natural order, no bit-reversal pass.
//     The twiddles inside a butterfly are literal constants.
//   * Two exchanges per transform, through the warp's own padded buffer in
//     shared memory, ordered by __syncwarp() only; no __syncthreads() inside
//     a transform.  The between-pass twiddles come from two small tables
//     laid out so that a warp reads consecutive (pass 1) or broadcast
//     (pass 2) entries.
//
// The decomposition (W_L = e^{-2 pi i / L}; M2 = M/8 = 8 R3):
//   pass 1  n = n1 M2 + n', k = k1 + 8 k':
//           y[k1][n'] = W_M^{n' k1} sum_{n1} z[n1 M2 + n'] W_8^{n1 k1}
//           (lane: n' = lane + 32 j, j < M2/32);
//   pass 2  n' = n2 R3 + n'', k' = k2 + 8 k'':
//           u[k1][k2][n''] = W_M2^{n'' k2} sum_{n2} y[k1][n2 R3 + n''] W_8^{n2 k2}
//           (lane: k1 = lane % 8, n'' = lane / 8 + 4 i, i < R3/4);
//   pass 3  Z[k1 + 8 k2 + 64 k''] = sum_{n''} u[k1][k2][n''] W_R3^{n'' k''}
//           (lane: k1 = lane % 8, k2 = lane / 8 + 4 i, i < 2, so the lane's
//           outputs are Z[lane + 32 (i + 2 k'')]).
// The exchange buffer holds y at k1 * (M2 + 2) + n' and then u at
// k1 + 8 n'' + (M2 + 8) k2.  A warp's 8-byte accesses are served one
// half-warp at a time from 16 bank pairs; with those strides (M2 + 2 = 2 and
// M2 + 8 = 8 mod 16) the 16 addresses of every half-warp access, write or
// read, fall on 16 different bank pairs.  The partner Z[M - k] of the
// untangle lies in lane (32 - lane) % 32 and comes by __shfl_sync.
//
// The only host operands are the window and twiddle[k] = W_N^k, k < M
// (ops/frontend.make_frontend_params, float64 rounded to float32); the pass
// tables are those same entries at other indices (W_M^t = W_N^{2t},
// W_M2^t = W_N^{16t}, W_N^{e + M} = -W_N^e), copied once per block.
// tests/test_torch_fft_plan.py runs this decomposition, with these address
// maps, in NumPy against numpy.fft.rfft.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sir_fft {

constexpr unsigned kFullMask = 0xffffffffu;

template <int LOG2N>
struct Plan {
  static_assert(LOG2N >= 9 && LOG2N <= 11, "N = 512, 1024 or 2048");
  static constexpr int kN = 1 << LOG2N;       // real samples in a frame
  static constexpr int kM = kN / 2;           // complex points transformed
  static constexpr int kV = kM / 32;          // complex values a lane holds
  static constexpr int kM2 = kM / 8;          // length left after pass 1
  static constexpr int kR3 = kM / 64;         // radix of pass 3: 4, 8 or 16
  static constexpr int kJ = kM2 / 32;         // radix-8 butterflies a lane does in pass 1
  static constexpr int kI2 = kR3 / 4;         // ... in pass 2
  static constexpr int kYStride = kM2 + 2;    // row stride of y[k1][n']
  static constexpr int kUStride = kM2 + 8;    // stride of k2 in u
  static constexpr int kXbuf = 8 * kUStride;  // float2 entries of a warp's buffer
  static constexpr int kBins = kM + 1;
  static_assert(8 * kYStride <= kXbuf && kBins <= 2 * kXbuf, "buffer too small");
};

// Per-block constant tables in shared memory.
template <int LOG2N>
struct Tables {
  float2 win2[Plan<LOG2N>::kM];         // (window[2n], window[2n+1])
  float2 tw[Plan<LOG2N>::kM];           // W_N^k: the untangle's factor
  float2 tw1[7 * Plan<LOG2N>::kM2];     // [(k1-1) M2 + n'] = W_M^{n' k1}
  float2 tw2[7 * Plan<LOG2N>::kR3];     // [(k2-1) R3 + n''] = W_M2^{n'' k2}
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// W_N^e for any e >= 0 from the host's half table twiddle[k] = W_N^k, k < M.
template <int LOG2N>
__device__ __forceinline__ float2 root_of(const float2* __restrict__ twiddle,
                                          int e) {
  e &= Plan<LOG2N>::kN - 1;
  if (e < Plan<LOG2N>::kM) return twiddle[e];
  const float2 w = twiddle[e - Plan<LOG2N>::kM];
  return make_float2(-w.x, -w.y);
}

// Fill the block's tables; the caller synchronises the block afterwards.
template <int LOG2N>
__device__ __forceinline__ void load_tables(Tables<LOG2N>& tb,
                                            const float* __restrict__ window,
                                            const float2* __restrict__ twiddle,
                                            int tid, int threads) {
  using P = Plan<LOG2N>;
  float* win = reinterpret_cast<float*>(tb.win2);
  for (int i = tid; i < P::kN; i += threads) win[i] = window[i];
  for (int i = tid; i < P::kM; i += threads) tb.tw[i] = twiddle[i];
  for (int i = tid; i < 7 * P::kM2; i += threads) {
    const int k1 = 1 + i / P::kM2, np = i % P::kM2;
    tb.tw1[i] = root_of<LOG2N>(twiddle, 2 * k1 * np);
  }
  for (int i = tid; i < 7 * P::kR3; i += threads) {
    const int k2 = 1 + i / P::kR3, npp = i % P::kR3;
    tb.tw2[i] = root_of<LOG2N>(twiddle, (P::kN / P::kM2) * k2 * npp);
  }
}

// v * e^{-2 pi i k / R} for 0 <= k < R/2, R in {4, 8, 16}; k is a constant
// after unrolling, so one case is left.
template <int R>
__device__ __forceinline__ float2 mul_root(float2 v, int k) {
  constexpr float kH = 0.70710678118654752440f;   // cos(pi/4)
  constexpr float kC = 0.92387953251128675613f;   // cos(pi/8)
  constexpr float kS = 0.38268343236508977173f;   // sin(pi/8)
  switch (k * (16 / R)) {
    case 0: return v;
    case 1: return cmul(v, make_float2(kC, -kS));
    case 2: return make_float2(kH * (v.x + v.y), kH * (v.y - v.x));
    case 3: return cmul(v, make_float2(kS, -kC));
    case 4: return make_float2(v.y, -v.x);
    case 5: return cmul(v, make_float2(-kS, -kC));
    case 6: return make_float2(kH * (v.y - v.x), -kH * (v.x + v.y));
    default: return cmul(v, make_float2(-kC, -kS));
  }
}

// In-register forward DFT of R = 2, 4, 8 or 16 points, natural order in and
// out (decimation in time: evens, odds, combine).
template <int R>
__device__ __forceinline__ void dft(float2 (&a)[R]) {
  if constexpr (R == 2) {
    const float2 t = a[1];
    a[1] = csub(a[0], t);
    a[0] = cadd(a[0], t);
  } else {
    float2 e[R / 2], o[R / 2];
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      e[i] = a[2 * i];
      o[i] = a[2 * i + 1];
    }
    dft<R / 2>(e);
    dft<R / 2>(o);
#pragma unroll
    for (int k = 0; k < R / 2; ++k) {
      const float2 t = mul_root<R>(o[k], k);
      a[k] = cadd(e[k], t);
      a[k + R / 2] = csub(e[k], t);
    }
  }
}

// One frame per warp.  In: v[r] = z[lane + 32 r], the packed windowed
// samples.  Out: the power spectrum pw[k] = |X[k]|^2, k = 0..M, as floats at
// the start of xbuf (which the transform used for its exchanges), visible to
// the whole warp.  The caller puts a __syncwarp() between its last read of
// pw and the next call.
template <int LOG2N>
__device__ __forceinline__ void warp_rfft_power(
    float2 (&v)[Plan<LOG2N>::kV], const Tables<LOG2N>& tb, float2* xbuf,
    int lane) {
  using P = Plan<LOG2N>;
  const int k1 = lane & 7, hi = lane >> 3;

  // pass 1: radix 8 over n1, twiddle, store y[k1][n']
#pragma unroll
  for (int j = 0; j < P::kJ; ++j) {
    float2 a[8];
#pragma unroll
    for (int n1 = 0; n1 < 8; ++n1) a[n1] = v[j + P::kJ * n1];
    dft<8>(a);
    const int np = lane + 32 * j;
    xbuf[np] = a[0];
#pragma unroll
    for (int q = 1; q < 8; ++q)
      xbuf[q * P::kYStride + np] = cmul(a[q], tb.tw1[(q - 1) * P::kM2 + np]);
  }
  __syncwarp();

  // pass 2: radix 8 over n2, twiddle, store u[k1][k2][n'']
#pragma unroll
  for (int i = 0; i < P::kI2; ++i) {
    const int npp = hi + 4 * i;
#pragma unroll
    for (int n2 = 0; n2 < 8; ++n2)
      v[8 * i + n2] = xbuf[k1 * P::kYStride + n2 * P::kR3 + npp];
  }
  __syncwarp();  // every y is read before a u overwrites it
#pragma unroll
  for (int i = 0; i < P::kI2; ++i) {
    const int npp = hi + 4 * i;
    float2 a[8];
#pragma unroll
    for (int n2 = 0; n2 < 8; ++n2) a[n2] = v[8 * i + n2];
    dft<8>(a);
    float2* u = xbuf + k1 + 8 * npp;
    u[0] = a[0];
#pragma unroll
    for (int q = 1; q < 8; ++q)
      u[q * P::kUStride] = cmul(a[q], tb.tw2[(q - 1) * P::kR3 + npp]);
  }
  __syncwarp();

  // pass 3: radix R3 over n''; v[r] = Z[lane + 32 r]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2* u = xbuf + k1 + (hi + 4 * i) * P::kUStride;
    float2 a[P::kR3];
#pragma unroll
    for (int npp = 0; npp < P::kR3; ++npp) a[npp] = u[8 * npp];
    dft<P::kR3>(a);
#pragma unroll
    for (int kpp = 0; kpp < P::kR3; ++kpp) v[i + 2 * kpp] = a[kpp];
  }
  __syncwarp();  // the buffer is free: the power row goes over it

  // untangle and power.  For k = lane + 32 r the partner Z[M - k] is value
  // V - 1 - r of lane 32 - lane (lane 0: its own value (V - r) % V).
  float* pw = reinterpret_cast<float*>(xbuf);
  const int src = (32 - lane) & 31;
#pragma unroll
  for (int r = 0; r < P::kV; ++r) {
    const float2 mine = lane == 0 ? v[(P::kV - r) % P::kV] : v[P::kV - 1 - r];
    const float px = __shfl_sync(kFullMask, mine.x, src);
    const float py = __shfl_sync(kFullMask, mine.y, src);
    const float2 z = v[r];
    const float2 w = tb.tw[lane + 32 * r];
    const float ar = 0.5f * (z.x + px), ai = 0.5f * (z.y - py);
    const float br = 0.5f * (z.x - px), bi = 0.5f * (z.y + py);
    const float xr = ar + (w.x * bi + w.y * br);
    const float xi = ai - (w.x * br - w.y * bi);
    pw[lane + 32 * r] = xr * xr + xi * xi;
  }
  if (lane == 0) {  // X[M] = Re Z[0] - Im Z[0]
    const float x = v[0].x - v[0].y;
    pw[P::kM] = x * x;
  }
  __syncwarp();
}

// The warp's share of the mel projection: lane l sums mels l, l + 32, ...
// over each triangle's packed run of bins and hands 10 log10(max(., 1e-10))
// to store(m, dB).  Every lane walks its own run, so a warp's reads of fb
// and pw fall on arbitrary banks; these sums take 40 % of K4's time at 1024
// points (bench_torch_fft_variants.py on an H100 80GB HBM3, 700 W: 1.56 ms
// with them, 0.94 ms without at 641 K frames).  Summing a lane's narrow and
// wide triangle together, four predicated terms of each per step, was
// slower (1.67 ms).
template <typename Store>
__device__ __forceinline__ void warp_mel_db(const float* pw, const float* fb,
                                            const int* fb_off,
                                            const int* fb_lo, int n_mels,
                                            int lane, Store store) {
  for (int m = lane; m < n_mels; m += 32) {
    const int o0 = fb_off[m], o1 = fb_off[m + 1];
    const float* p = pw + fb_lo[m] - o0;
    float acc = 0.f;
    for (int o = o0; o < o1; ++o) acc = fmaf(fb[o], p[o], acc);
    store(m, 10.f * log10f(fmaxf(acc, 1e-10f)));
  }
}

}  // namespace sir_fft
