// K6: the conv epilogue, maxpool2x2(relu(y + bias)), one streaming pass.
//
// Replaces speech_intent_recognizer_tpu/ops/pool_epilogue_pallas.py::
// _pool_epilogue_kernel_f32 / _pool_epilogue_kernel_bf16 (wrapper
// bias_relu_pool2_pallas).  Same contract: the raw (pre-bias) output of a
// 3x3 convolution, (B, T, W, C) contiguous (channels innermost), f32 or
// bf16, T and W even; (B, T/2, W/2, C) out in the same type.
//
// What a thread computes: one vector of V consecutive channels of one output
// pixel.  It loads the four input pixels of the 2x2 window as 16-byte
// vectors (8 bf16 or 4 f32; plain indexed loads do what the TPU kernel's
// rolls, lane compaction and row-selection products did), adds the bias in
// fp32, rounds once to the working type (for bf16 the value of the bf16 add
// of the bf16-rounded bias), applies ReLU, takes the maximum and stores one
// vector.  ReLU maps -0.0 and every negative to +0.0; a NaN goes through
// ReLU and the maximum, as in torch.relu and max_pool2d.
//
// What bounds it on the H100: HBM bytes alone, each input read once and a
// quarter of them written; a warp reads whole 128-byte lines.  Channel
// counts that are no multiple of the vector width take the scalar
// instantiation (V = 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);  // exact: v is a bf16 value already
  }
};

__device__ __forceinline__ float relu_keep_nan(float v) {
  return v > 0.f ? v : (v != v ? v : 0.f);
}

__device__ __forceinline__ float max_keep_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// x (B, t, w, c); out (B, t/2, w/2, c); bias (c) in T.  n_out = number of
// output vectors = B * (t/2) * (w/2) * (c/V).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
pool_epilogue_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                     T* __restrict__ out, int t, int w, int c,
                     long long n_out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_out) return;
  const int cv = c / V, wo = w / 2, to = t / 2;
  const int ch = static_cast<int>(i % cv) * V;
  long long r = i / cv;
  const int xo = static_cast<int>(r % wo);
  r /= wo;
  const int yo = static_cast<int>(r % to);
  const long long b = r / to;
  const long long row = static_cast<long long>(w) * c;
  const T* p = x + ((b * t + 2 * yo) * w + 2 * xo) * c + ch;
  using VT = Vec<T, V>;
  const VT a00 = *reinterpret_cast<const VT*>(p);
  const VT a01 = *reinterpret_cast<const VT*>(p + c);
  const VT a10 = *reinterpret_cast<const VT*>(p + row);
  const VT a11 = *reinterpret_cast<const VT*>(p + row + c);
  const VT bv = *reinterpret_cast<const VT*>(bias + ch);
  VT o;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float bk = Elem<T>::load(bv.v[k]);
    const float v00 = relu_keep_nan(Elem<T>::round(Elem<T>::load(a00.v[k]) + bk));
    const float v01 = relu_keep_nan(Elem<T>::round(Elem<T>::load(a01.v[k]) + bk));
    const float v10 = relu_keep_nan(Elem<T>::round(Elem<T>::load(a10.v[k]) + bk));
    const float v11 = relu_keep_nan(Elem<T>::round(Elem<T>::load(a11.v[k]) + bk));
    o.v[k] = Elem<T>::store(
        max_keep_nan(max_keep_nan(v00, v01), max_keep_nan(v10, v11)));
  }
  *reinterpret_cast<VT*>(out + ((b * to + yo) * wo + xo) * c + ch) = o;
}

template <typename T>
int launch(const void* x, const void* bias, void* out, int batch, int t, int w,
           int c, void* stream) {
  if (batch < 0 || t <= 0 || w <= 0 || c <= 0 || (t & 1) || (w & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const bool vec = c % kVec == 0;
  const long long n_out = static_cast<long long>(batch) * (t / 2) * (w / 2) *
                          (vec ? c / kVec : c);
  if (n_out == 0) return 0;
  const long long blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(bias);
  T* op = static_cast<T*>(out);
  if (vec) {
    pool_epilogue_kernel<T, kVec><<<static_cast<unsigned>(blocks), kThreads, 0,
                                    st>>>(xp, bp, op, t, w, c, n_out);
  } else {
    pool_epilogue_kernel<T, 1><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 st>>>(xp, bp, op, t, w, c, n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sir_pool_epilogue_f32(const void* x, const void* bias,
                                     void* out, int batch, int t, int w, int c,
                                     void* stream) {
  return launch<float>(x, bias, out, batch, t, w, c, stream);
}

extern "C" int sir_pool_epilogue_bf16(const void* x, const void* bias,
                                      void* out, int batch, int t, int w,
                                      int c, void* stream) {
  return launch<__nv_bfloat16>(x, bias, out, batch, t, w, c, stream);
}
