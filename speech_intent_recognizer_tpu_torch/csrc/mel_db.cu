// K4: frames -> dB-mel rows, for any power-of-two n_fft and any n_mels.
//
// Replaces speech_intent_recognizer_tpu/ops/frontend_pallas.py::
// _mel_db_kernel (wrapper mel_db_pallas), the kernel the log-mel front-end
// runs off the fused kernels' geometry.  Same contract: (N, n_fft) f32 raw
// frames in; windowed DFT, power, mel projection and
// 10 * log10(max(., 1e-10)) in fp32; (N, n_mels) f32 out.
//
// The TPU kernel multiplies each tile of frames by dense cos / sin matrices
// with the window folded in, because a matrix unit is what that chip has.
// Here a frame is transformed by an FFT, n_fft * log2(n_fft) * 5 / 2
// operations where the dense products take n_fft * (n_fft + 2) * 2.
//
// What bounds it on the H100: by the shapes, HBM bytes: a frame is read once
// (4 KB at 1024 points) for ~30 K operations, and nothing else moves.  Two
// kernels:
//   * n_fft = 512, 1024, 2048: mel_db_warp_kernel.  One warp owns one frame:
//     it loads the frame as (even, odd) pairs with 8-byte loads, windows it,
//     runs the warp-resident real-input FFT of warp_rfft.cuh (radix-8
//     butterflies in registers, two exchanges through the warp's own
//     shared-memory buffer, no block barrier), and sums its mel triangles
//     from the packed filterbank, which the block copied to shared memory
//     once.  Warps are persistent: warp g of the grid takes frames g,
//     g + G, ..., and at 512 and 1024 points the next frame's loads are
//     started before the current one is transformed, so HBM reads overlap the
//     butterflies.  The grid is what the occupancy query says the card
//     holds.  As built for sm_90a (cudaFuncGetAttributes, printed by
//     chip_smoke.py), 64 mels: 1024 points 124 registers, no spills, 53,608
//     bytes of shared memory, two 256-thread blocks an SM; 512 points 76
//     registers, 29,112 bytes, three blocks; 2048 points 128 registers
//     (bounded, ~100 bytes spilled), 102,604 bytes, two blocks.  On an H100
//     80GB HBM3 (700 W), 641,024 frames of 1024 (2.6 GB): 1.58 ms, against
//     0.83 ms at the byte bound, 9.08 ms for torch.fft.rfft + matmul and
//     13.3 ms for the generic kernel below.  Without the mel sums it takes
//     0.94 ms, which is HBM's rate: the transform is hidden, and what is
//     left above the bound is the mel sums' shared-memory reads.
//   * every other power of two from 32 to 4096: mel_db_generic_kernel, a
//     radix-2 FFT of the zero-extended complex frame in shared memory with a
//     block barrier per stage, 4096 / n_fft frames per pass.  It is bound by
//     those barriers, and it is the slower of the two per point.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kernel_info.cuh"
#include "warp_rfft.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPoints = 4096;  // complex points the generic kernel transforms per pass
constexpr int kMinFft = 32;
constexpr int kMaxSmem = 227 * 1024;

// ---- n_fft = 512, 1024, 2048: one warp per frame ----

// the next frame's raw samples wait in registers while this one is
// transformed; at 2048 points a lane's 64 values leave no room for that
template <int LOG2N>
constexpr bool kPrefetch = LOG2N <= 10;
// Registers: 16 warps an SM is where the warp kernel is fastest on an H100
// 80GB HBM3 (700 W; bench_torch_fft_variants.py, 2.6 GB of frames).  At 512
// and 1024 points ptxas takes 76 and 124 registers without a bound; at 1024
// points a cap of 85 or 64 for a third or fourth block spills and takes
// 1.65-1.90 ms instead of 1.56.  At 2048 points it would take 222 and leave
// one 8-warp block an SM (1.97 ms); two blocks (128 registers, ~100 bytes
// spilled) take 1.91 ms.
template <int LOG2N>
constexpr int kMinBlocks = LOG2N == 11 ? 2 : 1;

template <int LOG2N>
size_t warp_smem_bytes(int n_mels, int fb_nnz) {
  return sizeof(sir_fft::Tables<LOG2N>) +
         sizeof(float2) * kWarps * sir_fft::Plan<LOG2N>::kXbuf +
         sizeof(float) * fb_nnz + sizeof(int) * (2 * n_mels + 1);
}

template <int LOG2N>
__device__ __forceinline__ void load_raw(
    float2 (&raw)[sir_fft::Plan<LOG2N>::kV], const float* __restrict__ f,
    int lane, bool aligned) {
#pragma unroll
  for (int r = 0; r < sir_fft::Plan<LOG2N>::kV; ++r) {
    const int n = lane + 32 * r;
    raw[r] = aligned ? reinterpret_cast<const float2*>(f)[n]
                     : make_float2(f[2 * n], f[2 * n + 1]);
  }
}

template <int LOG2N>
__global__ void __launch_bounds__(kThreads, kMinBlocks<LOG2N>)
mel_db_warp_kernel(const float* __restrict__ frames, long long n,
                   const float* __restrict__ window,
                   const float2* __restrict__ twiddle,
                   const float* __restrict__ fb_packed,
                   const int* __restrict__ fb_off,
                   const int* __restrict__ fb_lo, int fb_nnz,
                   float* __restrict__ out, int n_mels) {
  using P = sir_fft::Plan<LOG2N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  sir_fft::Tables<LOG2N>& tb =
      *reinterpret_cast<sir_fft::Tables<LOG2N>*>(smem_raw);
  float2* xbuf_all =
      reinterpret_cast<float2*>(smem_raw + sizeof(sir_fft::Tables<LOG2N>));
  float* fb = reinterpret_cast<float*>(xbuf_all + kWarps * P::kXbuf);
  int* off = reinterpret_cast<int*>(fb + fb_nnz);
  int* lo = off + n_mels + 1;
  const int tid = threadIdx.x;
  sir_fft::load_tables<LOG2N>(tb, window, twiddle, tid, kThreads);
  for (int i = tid; i < fb_nnz; i += kThreads) fb[i] = fb_packed[i];
  for (int i = tid; i <= n_mels; i += kThreads) off[i] = fb_off[i];
  for (int i = tid; i < n_mels; i += kThreads) lo[i] = fb_lo[i];
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  float2* xbuf = xbuf_all + warp * P::kXbuf;
  // 8-byte loads need an 8-byte aligned base (rows are n_fft floats apart)
  const bool aligned = (reinterpret_cast<uintptr_t>(frames) & 7) == 0;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long fr = static_cast<long long>(blockIdx.x) * kWarps + warp;
  float2 raw[P::kV];
  if (fr < n) load_raw<LOG2N>(raw, frames + fr * P::kN, lane, aligned);
  while (fr < n) {
    float2 v[P::kV];
#pragma unroll
    for (int r = 0; r < P::kV; ++r) {
      const float2 w = tb.win2[lane + 32 * r];
      v[r] = make_float2(raw[r].x * w.x, raw[r].y * w.y);
    }
    const long long next = fr + stride;
    if (kPrefetch<LOG2N> && next < n)
      load_raw<LOG2N>(raw, frames + next * P::kN, lane, aligned);
    sir_fft::warp_rfft_power<LOG2N>(v, tb, xbuf, lane);
    float* row = out + fr * n_mels;
    sir_fft::warp_mel_db(reinterpret_cast<const float*>(xbuf), fb, off, lo,
                         n_mels, lane,
                         [row](int m, float db) { row[m] = db; });
    __syncwarp();  // the power row is read before the next frame overwrites it
    if (!kPrefetch<LOG2N> && next < n)
      load_raw<LOG2N>(raw, frames + next * P::kN, lane, aligned);
    fr = next;
  }
}

// Launch (out_info null) or report resources (out_info set, nothing runs).
template <int LOG2N>
int warp_path(const float* frames, long long n, int n_mels,
              const float* window, const float* twiddle,
              const float* fb_packed, const int* fb_off, const int* fb_lo,
              int fb_nnz, float* out, cudaStream_t stream, int* out_info) {
  const int smem = static_cast<int>(warp_smem_bytes<LOG2N>(n_mels, fb_nnz));
  auto kernel = mel_db_warp_kernel<LOG2N>;
  if (out_info) return sir_info::kernel_info(kernel, kThreads, smem, out_info);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  long long blocks = (n + kWarps - 1) / kWarps;
  if (blocks > static_cast<long long>(per_sm) * sms) blocks = per_sm * sms;
  kernel<<<static_cast<int>(blocks), kThreads, smem, stream>>>(
      frames, n, window, reinterpret_cast<const float2*>(twiddle), fb_packed,
      fb_off, fb_lo, fb_nnz, out, n_mels);
  return static_cast<int>(cudaGetLastError());
}

// ---- the other sizes: radix-2 stages in shared memory ----

struct Layout {
  int frames;     // frames per pass
  int bins;       // n_fft / 2 + 1
  int bins_pad;   // row stride of the power tile
  size_t bytes;
};

Layout make_layout(int n_fft) {
  Layout l;
  l.frames = kPoints / n_fft;
  l.bins = n_fft / 2 + 1;
  l.bins_pad = l.bins + 3;
  l.bytes = sizeof(float2) * kPoints            // fft
            + sizeof(float2) * (n_fft / 2)      // twiddles
            + sizeof(float) * n_fft             // window
            + sizeof(float) * l.frames * l.bins_pad;
  return l;
}

__global__ void __launch_bounds__(kThreads)
mel_db_generic_kernel(const float* __restrict__ frames, long long n,
                      const float* __restrict__ window,
                      const float2* __restrict__ twiddle,
                      const float* __restrict__ fb_packed,
                      const int* __restrict__ fb_off,
                      const int* __restrict__ fb_lo, float* __restrict__ out,
                      int n_fft, int log2n, int n_mels, int per_pass, int bins,
                      int bins_pad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* fft = reinterpret_cast<float2*>(smem_raw);
  float2* tw = fft + kPoints;
  float* win = reinterpret_cast<float*>(tw + n_fft / 2);
  float* pw = win + n_fft;
  const int tid = threadIdx.x;
  const int half_n = n_fft >> 1;

  for (int i = tid; i < n_fft; i += kThreads) win[i] = window[i];
  for (int i = tid; i < half_n; i += kThreads) tw[i] = twiddle[i];
  __syncthreads();

  const long long tiles = (n + per_pass - 1) / per_pass;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long f0 = tile * per_pass;
    for (int i = tid; i < kPoints; i += kThreads) {
      const int f = i >> log2n, k = i & (n_fft - 1);
      const long long fr = f0 + f;
      const float v = fr < n ? frames[fr * n_fft + k] * win[k] : 0.f;
      // bit-reversed order
      fft[(f << log2n) + (__brev(k) >> (32 - log2n))] = make_float2(v, 0.f);
    }
    __syncthreads();
    for (int half = 1, lg = 0; half < n_fft; half <<= 1, ++lg) {
      const int stride_shift = log2n - 1 - lg;  // n_fft / (2 * half)
      for (int i = tid; i < kPoints / 2; i += kThreads) {
        const int f = i >> (log2n - 1), j = i & (half_n - 1);
        const int pos = j & (half - 1);
        const int i0 = (f << log2n) + ((j - pos) << 1) + pos;
        const int i1 = i0 + half;
        const float2 w = tw[pos << stride_shift];
        const float2 a = fft[i0];
        const float2 c = fft[i1];
        const float2 tc = make_float2(c.x * w.x - c.y * w.y,
                                      c.x * w.y + c.y * w.x);
        fft[i0] = make_float2(a.x + tc.x, a.y + tc.y);
        fft[i1] = make_float2(a.x - tc.x, a.y - tc.y);
      }
      __syncthreads();
    }
    for (int i = tid; i < per_pass * bins; i += kThreads) {
      const int f = i / bins, k = i - f * bins;
      const float2 X = fft[(f << log2n) + k];
      pw[f * bins_pad + k] = X.x * X.x + X.y * X.y;
    }
    __syncthreads();
    for (int i = tid; i < per_pass * n_mels; i += kThreads) {
      const int f = i / n_mels, m = i - f * n_mels;
      const long long fr = f0 + f;
      if (fr < n) {
        const int lo = __ldg(fb_lo + m), o0 = __ldg(fb_off + m),
                  o1 = __ldg(fb_off + m + 1);
        const float* p = pw + f * bins_pad + lo - o0;
        float acc = 0.f;
        for (int o = o0; o < o1; ++o) acc = fmaf(__ldg(fb_packed + o), p[o], acc);
        out[fr * n_mels + m] = 10.f * log10f(fmaxf(acc, 1e-10f));
      }
    }
    __syncthreads();
  }
}

int generic_path(const float* frames, long long n, int n_fft, int n_mels,
                 const float* window, const float* twiddle,
                 const float* fb_packed, const int* fb_off, const int* fb_lo,
                 float* out, cudaStream_t stream, int* out_info) {
  int log2n = 0;
  while ((1 << log2n) < n_fft) ++log2n;
  const Layout l = make_layout(n_fft);
  const int smem = static_cast<int>(l.bytes);
  if (out_info)
    return sir_info::kernel_info(mel_db_generic_kernel, kThreads, smem,
                                 out_info);
  cudaError_t err = cudaFuncSetAttribute(
      mel_db_generic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const long long tiles = (n + l.frames - 1) / l.frames;
  // a block walks over the frame tiles; four blocks fit on an SM at 1024
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  const long long blocks = tiles < 4LL * sms ? tiles : 4LL * sms;
  mel_db_generic_kernel<<<static_cast<int>(blocks), kThreads, l.bytes,
                          stream>>>(
      frames, n, window, reinterpret_cast<const float2*>(twiddle), fb_packed,
      fb_off, fb_lo, out, n_fft, log2n, n_mels, l.frames, l.bins, l.bins_pad);
  return static_cast<int>(cudaGetLastError());
}

// n_fft 512 / 1024 / 2048 take the warp kernel when its tables and the
// packed filterbank fit a block's shared memory (they do for any filterbank
// of triangles); everything else the generic one.
int dispatch(const float* frames, long long n, int n_fft, int n_mels,
             const float* window, const float* twiddle,
             const float* fb_packed, const int* fb_off, const int* fb_lo,
             int fb_nnz, float* out, void* stream, int* out_info) {
  if (n < 0 || n_mels <= 0 || fb_nnz < 0 || n_fft < kMinFft ||
      n_fft > kPoints || (n_fft & (n_fft - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SIR_WARP_PATH(LOG2N)                                                  \
  if (n_fft == (1 << LOG2N) &&                                                \
      warp_smem_bytes<LOG2N>(n_mels, fb_nnz) <= kMaxSmem)                     \
    return warp_path<LOG2N>(frames, n, n_mels, window, twiddle, fb_packed,    \
                            fb_off, fb_lo, fb_nnz, out, s, out_info);
  SIR_WARP_PATH(9)
  SIR_WARP_PATH(10)
  SIR_WARP_PATH(11)
#undef SIR_WARP_PATH
  return generic_path(frames, n, n_fft, n_mels, window, twiddle, fb_packed,
                      fb_off, fb_lo, out, s, out_info);
}

}  // namespace

// The grid is as many blocks as the frames need or the card holds at once,
// whichever is fewer.
extern "C" int sir_mel_db(const float* frames, long long n, int n_fft,
                          int n_mels, const float* window,
                          const float* twiddle, const float* fb_packed,
                          const int* fb_off, const int* fb_lo, int fb_nnz,
                          float* out, void* stream) {
  return dispatch(frames, n, n_fft, n_mels, window, twiddle, fb_packed, fb_off,
                  fb_lo, fb_nnz, out, stream, nullptr);
}

// Registers, local memory, shared memory, threads and resident blocks per SM
// (kernel_info.cuh) of the kernel that serves this n_fft, n_mels and
// filterbank size.
extern "C" int sir_mel_db_info(int n_fft, int n_mels, int fb_nnz, int* out) {
  return dispatch(nullptr, 0, n_fft, n_mels, nullptr, nullptr, nullptr,
                  nullptr, nullptr, fb_nnz, nullptr, nullptr, out);
}
