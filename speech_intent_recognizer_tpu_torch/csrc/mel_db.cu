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
// Here each frame is windowed and transformed by a radix-2 FFT in shared
// memory (the butterflies of csrc/frontend_core.cuh with n_fft a run-time
// power of two), 4096 / n_fft frames per pass, and the mel projection sums
// only each triangle's nonzero bins.  That is n_fft * log2(n_fft) * 5
// operations a frame where the dense products take n_fft * (n_fft + 2) * 2,
// 40 times fewer at 1024 points.
//
// What bounds it on the H100: by the shapes, HBM bytes (the frames are read
// once, 4 KB each at 1024 points, for 51 K operations); as built, the
// barrier-separated butterfly stages, as K1 and K3.  A block walks over the
// frame tiles with a stride of the grid, so the window and the twiddles are
// loaded once per block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPoints = 4096;  // complex points transformed per pass
constexpr int kMinFft = 32;

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
mel_db_kernel(const float* __restrict__ frames, long long n,
              const float* __restrict__ window,
              const float2* __restrict__ twiddle,
              const float* __restrict__ fb_packed,
              const int* __restrict__ fb_off, const int* __restrict__ fb_lo,
              float* __restrict__ out, int n_fft, int log2n, int n_mels,
              int per_pass, int bins, int bins_pad) {
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

}  // namespace

extern "C" int sir_mel_db(const float* frames, long long n, int n_fft,
                          int n_mels, const float* window,
                          const float* twiddle, const float* fb_packed,
                          const int* fb_off, const int* fb_lo, float* out,
                          int max_blocks, void* stream) {
  if (n < 0 || n_mels <= 0 || n_fft < kMinFft || n_fft > kPoints ||
      (n_fft & (n_fft - 1)) || max_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int log2n = 0;
  while ((1 << log2n) < n_fft) ++log2n;
  const Layout l = make_layout(n_fft);
  cudaError_t err = cudaFuncSetAttribute(
      mel_db_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const long long tiles = (n + l.frames - 1) / l.frames;
  const int blocks =
      static_cast<int>(tiles < max_blocks ? tiles : max_blocks);
  mel_db_kernel<<<blocks, kThreads, l.bytes,
                  static_cast<cudaStream_t>(stream)>>>(
      frames, n, window, reinterpret_cast<const float2*>(twiddle), fb_packed,
      fb_off, fb_lo, out, n_fft, log2n, n_mels, l.frames, l.bins, l.bins_pad);
  return static_cast<int>(cudaGetLastError());
}
