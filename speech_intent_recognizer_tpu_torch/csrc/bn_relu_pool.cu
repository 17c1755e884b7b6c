// K7: the training conv stage's epilogue, BatchNorm on the batch's
// statistics, ReLU and 2x2 max-pool, forward and backward, on the bf16
// output of a 3x3 convolution.
//
// Replaces no TPU kernel: the JAX package leaves its training epilogue to
// XLA, and the port ran it as torch's BatchNorm, ReLU, cast and max-pool
// kernels on an fp32 channels-last copy of the conv output.  Same
// contract as that chain, rounding for rounding:
//
//   z   = (y - mean) * (invstd * w) + b           fp32, each op rounded
//   out = maxpool2x2(bf16(relu(z)))                ties: the first maximum
//                                                  in (row, column) order
//   dz  = dout at each window's argmax where z > 0, else 0
//   dy  = bf16(((dz - sum_dz / n) - (y - mean) * invstd^2 * sum_dz_xmu / n)
//              * (w * invstd))
//
// with mean and the biased variance the batch's, invstd = 1 / sqrt(var +
// eps), sum_dz and sum_dz_xmu = sum dz * (y - mean) per channel (the bias
// and, times invstd, the weight gradients).  y is (B, H, W, C) contiguous
// bf16 (a channels-last (B, C, H, W) tensor), H and W even, C a multiple
// of 8; out, the saved argmax values and dout are (B, H/2, W/2, C).
//
// What bounds it on the H100: HBM bytes.  At B = 1024 the three stages'
// conv outputs are 734 M values; torch's chain moves about 88 bytes a
// value over forward and backward, these kernels 10.5:
//
// * forward: a statistics pass reads y (2 B), an apply pass reads y again
//   (2 B) and writes the pooled output and the value of y at each window's
//   argmax (0.5 + 0.5 B);
// * backward: a reduce pass reads dout and those argmax values (0.5 + 0.5
//   B), since dz is non-zero at one value in four at most; a gradient pass
//   reads y and dout (2 + 0.5 B), finds each window's argmax again with the
//   forward's arithmetic, and writes dy (2 B).
//
// The design: every thread owns one 16-byte vector of 8 channels of a
// pixel, its per-channel coefficients in registers, and walks pixels with
// its block (persistent blocks, as many as fit on the card).  Per-channel
// statistics and sums are formed per thread (Welford's update for mean and
// M2), merged across the block through shared memory in slot order and
// across blocks by a second, one-block-per-channel launch in a fixed tree
// (Chan's formula): no float atomics, so a step gives the same bits every
// time on a card.  Each pass is one launch; a forward is three (statistics,
// their merge, apply), a backward three (reduce, merge, gradient).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "kernel_info.cuh"

namespace {

constexpr int kThreads = 256;   // at most, a block
constexpr int kVec = 8;         // bf16 channels in 16 bytes
// rows of per-block partials in the scratch (scratch_floats)
constexpr int kMaxBlocks = 1024;
constexpr int kMaxChannels = kThreads * kVec;

// A block's threads: g vectors of channels per pixel, ppi pixels side by
// side; a thread's vector of channels is fixed for the whole launch.
struct Geom {
  int g, ppi, threads;
};

__host__ __device__ __forceinline__ Geom geometry(int c) {
  Geom m;
  m.g = c / kVec;
  m.ppi = kThreads / m.g;
  m.threads = m.g * m.ppi;
  return m;
}

// bf16 <-> fp32 by bits: exact both ways for a bf16 value.
__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void unpack8(const uint4& v, float f[kVec]) {
  f[0] = lo(v.x); f[1] = hi(v.x); f[2] = lo(v.y); f[3] = hi(v.y);
  f[4] = lo(v.z); f[5] = hi(v.z); f[6] = lo(v.w); f[7] = hi(v.w);
}

// f[k] holds a bf16 value (or is rounded to one first by the caller)
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return (__float_as_uint(a) >> 16) | (__float_as_uint(b) & 0xffff0000u);
}

__device__ __forceinline__ uint4 pack8(const float f[kVec]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The BatchNorm output, each operation rounded as torch's separate
// elementwise kernels round it (and as the plain version computes it).
__device__ __forceinline__ float bn(float y, float mean, float scale,
                                    float bias) {
  return __fadd_rn(__fmul_rn(__fsub_rn(y, mean), scale), bias);
}

// torch.relu then the cast to bf16; NaN passes through.
__device__ __forceinline__ float relu_bf16(float z) {
  return round_bf16(z > 0.f ? z : (z != z ? z : 0.f));
}

// torch's max_pool2d rule over (0,0), (0,1), (1,0), (1,1): a value replaces
// the maximum when it is greater or NaN.
__device__ __forceinline__ int argmax4(float r0, float r1, float r2,
                                       float r3) {
  int k = 0;
  float best = r0;
  if (r1 > best || r1 != r1) { best = r1; k = 1; }
  if (r2 > best || r2 != r2) { best = r2; k = 2; }
  if (r3 > best || r3 != r3) { k = 3; }
  return k;
}

__device__ __forceinline__ float pick4(int k, float a, float b, float c,
                                       float d) {
  return k == 0 ? a : (k == 1 ? b : (k == 2 ? c : d));
}

// Chan's merge of (nb, mb, qb) into (n, m, q): count, mean, M2.
__device__ __forceinline__ void chan(float& n, float& m, float& q, float nb,
                                     float mb, float qb) {
  if (nb == 0.f) return;
  const float nn = __fadd_rn(n, nb);
  const float f = __fdiv_rn(nb, nn);
  const float d = __fsub_rn(mb, m);
  q = __fadd_rn(__fadd_rn(q, qb), __fmul_rn(__fmul_rn(__fmul_rn(d, d), n), f));
  m = __fmaf_rn(d, f, m);
  n = nn;
}

struct Coef {
  float mean[kVec], scale[kVec], bias[kVec];
};

__device__ __forceinline__ void load_coef(Coef& k, int ch0,
                                          const float* __restrict__ mean,
                                          const float* __restrict__ invstd,
                                          const float* __restrict__ weight,
                                          const float* __restrict__ bias) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    k.mean[j] = mean[ch0 + j];
    k.scale[j] = __fmul_rn(invstd[ch0 + j], weight[ch0 + j]);
    k.bias[j] = bias[ch0 + j];
  }
}

// ---------------------------------------------------------------- forward

// Per-block (count, mean, M2) of each channel over the block's contiguous
// range of pixels.  part: n[kMaxBlocks] | mean[kMaxBlocks][c] |
// m2[kMaxBlocks][c].
__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const uint4* __restrict__ y, long long pixels, int c,
                float* __restrict__ part) {
  const Geom gm = geometry(c);
  const int g = threadIdx.x % gm.g, slot = threadIdx.x / gm.g;
  const long long p0 = pixels * blockIdx.x / gridDim.x;
  const long long p1 = pixels * (blockIdx.x + 1) / gridDim.x;
  float n = 0.f, mean[kVec], m2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) mean[j] = m2[j] = 0.f;
  auto update = [&](const uint4& v) {
    float x[kVec];
    unpack8(v, x);
    n = __fadd_rn(n, 1.f);
    const float inv = __frcp_rn(n);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float d = __fsub_rn(x[j], mean[j]);
      mean[j] = __fmaf_rn(d, inv, mean[j]);
      m2[j] = __fmaf_rn(d, __fsub_rn(x[j], mean[j]), m2[j]);
    }
  };
  const long long step = gm.ppi;
  long long p = p0 + slot;
  for (; p + 3 * step < p1; p += 4 * step) {  // four loads in flight
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = y[(p + u * step) * gm.g + g];
#pragma unroll
    for (int u = 0; u < 4; ++u) update(v[u]);
  }
  for (; p < p1; p += step) update(y[p * gm.g + g]);

  __shared__ float s_n[kThreads];
  __shared__ float s_mean[kMaxChannels];
  __shared__ float s_m2[kMaxChannels];
  if (g == 0) s_n[slot] = n;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    s_mean[slot * c + g * kVec + j] = mean[j];
    s_m2[slot * c + g * kVec + j] = m2[j];
  }
  __syncthreads();
  float* pn = part;
  float* pm = part + kMaxBlocks;
  float* pq = pm + static_cast<long long>(kMaxBlocks) * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float bn_ = 0.f, bm = 0.f, bq = 0.f;
    for (int s = 0; s < gm.ppi; ++s)
      chan(bn_, bm, bq, s_n[s], s_mean[s * c + ch], s_m2[s * c + ch]);
    pm[blockIdx.x * c + ch] = bm;
    pq[blockIdx.x * c + ch] = bq;
    if (ch == 0) pn[blockIdx.x] = bn_;
  }
}

// One block per channel: the blocks' partials merged in a fixed tree; the
// mean, the biased variance and invstd = 1 / sqrt(var + eps).
__global__ void __launch_bounds__(kThreads)
bn_stats_merge_kernel(const float* __restrict__ part, int nblk, int c,
                      float eps, float* __restrict__ mean,
                      float* __restrict__ var, float* __restrict__ invstd) {
  const int ch = blockIdx.x, t = threadIdx.x;
  const float* pn = part;
  const float* pm = part + kMaxBlocks;
  const float* pq = pm + static_cast<long long>(kMaxBlocks) * c;
  float n = 0.f, m = 0.f, q = 0.f;
  for (int i = t; i < nblk; i += kThreads)
    chan(n, m, q, pn[i], pm[i * c + ch], pq[i * c + ch]);
  __shared__ float sn[kThreads], sm[kThreads], sq[kThreads];
  sn[t] = n;
  sm[t] = m;
  sq[t] = q;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) chan(sn[t], sm[t], sq[t], sn[t + s], sm[t + s], sq[t + s]);
    __syncthreads();
  }
  if (t == 0) {
    const float v = __fdiv_rn(sq[0], sn[0]);
    mean[ch] = sm[0];
    var[ch] = v;
    invstd[ch] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(v, eps)));
  }
}

// The pixel index of the top-left value of pooled pixel q's window (a
// launch has fewer than 2^31 pixels: 32-bit division).
__device__ __forceinline__ long long window(long long q, int h, int w) {
  const unsigned wo = static_cast<unsigned>(w) >> 1;
  const unsigned ho = static_cast<unsigned>(h) >> 1;
  const unsigned r = static_cast<unsigned>(q) / wo;
  const unsigned xo = static_cast<unsigned>(q) - r * wo;
  const unsigned b = r / ho, yo = r - b * ho;
  return (static_cast<long long>(b) * h + 2 * yo) * w + 2 * xo;
}

__global__ void __launch_bounds__(kThreads)
bn_pool_apply_kernel(const uint4* __restrict__ y,
                     const float* __restrict__ mean,
                     const float* __restrict__ invstd,
                     const float* __restrict__ weight,
                     const float* __restrict__ bias, uint4* __restrict__ out,
                     uint4* __restrict__ yarg, int h, int w, int c,
                     long long pooled) {
  const Geom gm = geometry(c);
  const int g = threadIdx.x % gm.g, slot = threadIdx.x / gm.g;
  Coef k;
  load_coef(k, g * kVec, mean, invstd, weight, bias);
  const long long row = static_cast<long long>(w) * gm.g;
  const long long stride = static_cast<long long>(gridDim.x) * gm.ppi;
  for (long long q = static_cast<long long>(blockIdx.x) * gm.ppi + slot;
       q < pooled; q += stride) {
    const uint4* src = y + window(q, h, w) * gm.g + g;
    const uint4 v0 = src[0], v1 = src[gm.g], v2 = src[row],
                v3 = src[row + gm.g];
    float x0[kVec], x1[kVec], x2[kVec], x3[kVec], o[kVec], a[kVec];
    unpack8(v0, x0);
    unpack8(v1, x1);
    unpack8(v2, x2);
    unpack8(v3, x3);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float m = k.mean[j], s = k.scale[j], b = k.bias[j];
      const float r0 = relu_bf16(bn(x0[j], m, s, b));
      const float r1 = relu_bf16(bn(x1[j], m, s, b));
      const float r2 = relu_bf16(bn(x2[j], m, s, b));
      const float r3 = relu_bf16(bn(x3[j], m, s, b));
      const int am = argmax4(r0, r1, r2, r3);
      o[j] = pick4(am, r0, r1, r2, r3);
      a[j] = pick4(am, x0[j], x1[j], x2[j], x3[j]);
    }
    out[q * gm.g + g] = pack8(o);
    yarg[q * gm.g + g] = pack8(a);
  }
}

// --------------------------------------------------------------- backward

// Per-block sums of dz and dz * (y - mean) over the block's contiguous
// range of pooled pixels, from dout and y at each argmax.  part:
// s1[kMaxBlocks][c] | s2[kMaxBlocks][c].
__global__ void __launch_bounds__(kThreads)
bn_pool_reduce_kernel(const uint4* __restrict__ dout,
                      const uint4* __restrict__ yarg,
                      const float* __restrict__ mean,
                      const float* __restrict__ invstd,
                      const float* __restrict__ weight,
                      const float* __restrict__ bias, long long pooled, int c,
                      float* __restrict__ part) {
  const Geom gm = geometry(c);
  const int g = threadIdx.x % gm.g, slot = threadIdx.x / gm.g;
  const long long q0 = pooled * blockIdx.x / gridDim.x;
  const long long q1 = pooled * (blockIdx.x + 1) / gridDim.x;
  Coef k;
  load_coef(k, g * kVec, mean, invstd, weight, bias);
  float s1[kVec], s2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) s1[j] = s2[j] = 0.f;
  auto update = [&](const uint4& dv, const uint4& av) {
    float d[kVec], a[kVec];
    unpack8(dv, d);
    unpack8(av, a);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float dz = bn(a[j], k.mean[j], k.scale[j], k.bias[j]) > 0.f
                           ? d[j] : 0.f;
      s1[j] = __fadd_rn(s1[j], dz);
      s2[j] = __fmaf_rn(dz, __fsub_rn(a[j], k.mean[j]), s2[j]);
    }
  };
  const long long step = gm.ppi;
  long long q = q0 + slot;
  for (; q + step < q1; q += 2 * step) {  // four loads in flight
    const uint4 d0 = dout[q * gm.g + g], a0 = yarg[q * gm.g + g];
    const uint4 d1 = dout[(q + step) * gm.g + g],
                a1 = yarg[(q + step) * gm.g + g];
    update(d0, a0);
    update(d1, a1);
  }
  for (; q < q1; q += step) update(dout[q * gm.g + g], yarg[q * gm.g + g]);
  __shared__ float s_1[kMaxChannels];
  __shared__ float s_2[kMaxChannels];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    s_1[slot * c + g * kVec + j] = s1[j];
    s_2[slot * c + g * kVec + j] = s2[j];
  }
  __syncthreads();
  float* p1 = part;
  float* p2 = part + static_cast<long long>(kMaxBlocks) * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int s = 0; s < gm.ppi; ++s) {
      a = __fadd_rn(a, s_1[s * c + ch]);
      b = __fadd_rn(b, s_2[s * c + ch]);
    }
    p1[blockIdx.x * c + ch] = a;
    p2[blockIdx.x * c + ch] = b;
  }
}

// One block per channel: the blocks' sums in a fixed tree; the weight and
// bias gradients and the gradient pass's coefficients (k1, k2, k3 at
// coef[0 / c / 2c + ch]), as torch's batch_norm_backward_elemt forms them.
__global__ void __launch_bounds__(kThreads)
bn_pool_reduce_merge_kernel(const float* __restrict__ part, int nblk, int c,
                            long long count, const float* __restrict__ invstd,
                            const float* __restrict__ weight,
                            float* __restrict__ dweight,
                            float* __restrict__ dbias,
                            float* __restrict__ coef) {
  const int ch = blockIdx.x, t = threadIdx.x;
  const float* p1 = part;
  const float* p2 = part + static_cast<long long>(kMaxBlocks) * c;
  float a = 0.f, b = 0.f;
  for (int i = t; i < nblk; i += kThreads) {
    a = __fadd_rn(a, p1[i * c + ch]);
    b = __fadd_rn(b, p2[i * c + ch]);
  }
  __shared__ float sa[kThreads], sb[kThreads];
  sa[t] = a;
  sb[t] = b;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      sa[t] = __fadd_rn(sa[t], sa[t + s]);
      sb[t] = __fadd_rn(sb[t], sb[t + s]);
    }
    __syncthreads();
  }
  if (t == 0) {
    const float sum_dy = sa[0], sum_dy_xmu = sb[0], is = invstd[ch];
    const float norm = __fdiv_rn(1.f, static_cast<float>(count));
    dweight[ch] = __fmul_rn(sum_dy_xmu, is);
    dbias[ch] = sum_dy;
    coef[ch] = __fmul_rn(sum_dy, norm);
    coef[c + ch] = __fmul_rn(__fmul_rn(__fmul_rn(is, is), sum_dy_xmu), norm);
    coef[2 * c + ch] = __fmul_rn(weight[ch], is);
  }
}

__global__ void __launch_bounds__(kThreads)
bn_pool_grad_kernel(const uint4* __restrict__ y,
                    const uint4* __restrict__ dout,
                    const float* __restrict__ mean,
                    const float* __restrict__ invstd,
                    const float* __restrict__ weight,
                    const float* __restrict__ bias,
                    const float* __restrict__ coef, uint4* __restrict__ dy,
                    int h, int w, int c, long long pooled) {
  const Geom gm = geometry(c);
  const int g = threadIdx.x % gm.g, slot = threadIdx.x / gm.g;
  Coef k;
  load_coef(k, g * kVec, mean, invstd, weight, bias);
  float k1[kVec], k2[kVec], k3[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    k1[j] = coef[g * kVec + j];
    k2[j] = coef[c + g * kVec + j];
    k3[j] = coef[2 * c + g * kVec + j];
  }
  const long long row = static_cast<long long>(w) * gm.g;
  const long long stride = static_cast<long long>(gridDim.x) * gm.ppi;
  for (long long q = static_cast<long long>(blockIdx.x) * gm.ppi + slot;
       q < pooled; q += stride) {
    const long long at = window(q, h, w) * gm.g + g;
    const uint4 dv = dout[q * gm.g + g];
    const uint4 v0 = y[at], v1 = y[at + gm.g], v2 = y[at + row],
                v3 = y[at + row + gm.g];
    float d[kVec], x0[kVec], x1[kVec], x2[kVec], x3[kVec];
    unpack8(dv, d);
    unpack8(v0, x0);
    unpack8(v1, x1);
    unpack8(v2, x2);
    unpack8(v3, x3);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float m = k.mean[j], s = k.scale[j], b = k.bias[j];
      const float z0 = bn(x0[j], m, s, b), z1 = bn(x1[j], m, s, b),
                  z2 = bn(x2[j], m, s, b), z3 = bn(x3[j], m, s, b);
      const int am = argmax4(relu_bf16(z0), relu_bf16(z1), relu_bf16(z2),
                             relu_bf16(z3));
      const float dz = pick4(am, z0, z1, z2, z3) > 0.f ? d[j] : 0.f;
      auto grad = [&](float x, int at_k) {
        const float gk = am == at_k ? dz : 0.f;
        return round_bf16(__fmul_rn(
            __fsub_rn(__fsub_rn(gk, k1[j]), __fmul_rn(__fsub_rn(x, m), k2[j])),
            k3[j]));
      };
      x0[j] = grad(x0[j], 0);
      x1[j] = grad(x1[j], 1);
      x2[j] = grad(x2[j], 2);
      x3[j] = grad(x3[j], 3);
    }
    dy[at] = pack8(x0);
    dy[at + gm.g] = pack8(x1);
    dy[at + row] = pack8(x2);
    dy[at + row + gm.g] = pack8(x3);
  }
}

constexpr int kMaxDevices = 64;
// blocks that fill a card once, by device, streaming kernel and block size
// (0: not asked yet)
std::atomic<int> g_full[kMaxDevices][4][kThreads + 1];

// Blocks of `kernel` (one of the four streaming kernels, `which`) that fill
// the card once, at most `cap`; asked of the runtime once per device and
// block size.
template <typename Kernel>
int fill_blocks(Kernel kernel, int which, int threads, long long cap,
                int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::atomic<int>* slot =
      dev < kMaxDevices ? &g_full[dev][which][threads] : nullptr;
  int full = slot ? slot->load(std::memory_order_relaxed) : 0;
  if (full == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    full = sms * (per_sm > 0 ? per_sm : 1);
    if (slot) slot->store(full, std::memory_order_relaxed);
  }
  const long long n = full < cap ? full : cap;
  *blocks = static_cast<int>(n < 1 ? 1 : n);
  return 0;
}

// Blocks for a pass over `items` pixels that merges per-block partials: at
// most kMaxBlocks, and a pixel for every slot of each block.
long long share(long long items, int ppi) {
  const long long n = items / ppi;
  return n < 1 ? 1 : (n > kMaxBlocks ? kMaxBlocks : n);
}

bool bad_channels(int c) { return c <= 0 || c % kVec || c > kMaxChannels; }

bool bad_shape(int batch, int h, int w, int c) {
  return batch <= 0 || h <= 0 || w <= 0 || (h & 1) || (w & 1) ||
         bad_channels(c) || static_cast<long long>(batch) * h * w > 0x7fffffffLL;
}

// The scratch at c channels, in floats: the per-block partials (forward:
// kMaxBlocks counts, then kMaxBlocks rows of c means and of c M2s;
// backward: kMaxBlocks rows of c sums of dz and of dz * (y - mean)), then
// the backward's 3 c coefficients.
long long coef_offset(int c) { return (2LL * c + 1) * kMaxBlocks; }
long long scratch_floats(int c) { return coef_offset(c) + 3LL * c; }

}  // namespace

// part: sir_bn_pool_scratch's floats of scratch.
extern "C" int sir_bn_pool_forward(const void* y, const void* weight,
                                   const void* bias, void* out, void* yarg,
                                   void* mean, void* var, void* invstd,
                                   void* part, int batch, int h, int w, int c,
                                   float eps, void* stream) {
  if (bad_shape(batch, h, w, c)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geom gm = geometry(c);
  const long long pixels = static_cast<long long>(batch) * h * w;
  const long long pooled = pixels / 4;
  int nblk = 0, grid = 0;
  int rc = fill_blocks(bn_stats_kernel, 0, gm.threads,
                       share(pixels, gm.ppi), &nblk);
  if (rc) return rc;
  rc = fill_blocks(bn_pool_apply_kernel, 1, gm.threads,
                   (pooled + gm.ppi - 1) / gm.ppi, &grid);
  if (rc) return rc;
  float* pf = static_cast<float*>(part);
  float* fm = static_cast<float*>(mean);
  float* fv = static_cast<float*>(var);
  float* fi = static_cast<float*>(invstd);
  const float* fw = static_cast<const float*>(weight);
  const float* fb = static_cast<const float*>(bias);
  bn_stats_kernel<<<nblk, gm.threads, 0, st>>>(static_cast<const uint4*>(y),
                                               pixels, c, pf);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_stats_merge_kernel<<<c, kThreads, 0, st>>>(pf, nblk, c, eps, fm, fv, fi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_pool_apply_kernel<<<grid, gm.threads, 0, st>>>(
      static_cast<const uint4*>(y), fm, fi, fw, fb, static_cast<uint4*>(out),
      static_cast<uint4*>(yarg), h, w, c, pooled);
  return static_cast<int>(cudaGetLastError());
}

// part: as sir_bn_pool_forward's.
extern "C" int sir_bn_pool_backward(const void* y, const void* yarg,
                                    const void* dout, const void* weight,
                                    const void* bias, const void* mean,
                                    const void* invstd, void* dy,
                                    void* dweight, void* dbias, void* part,
                                    int batch, int h, int w, int c,
                                    void* stream) {
  if (bad_shape(batch, h, w, c)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geom gm = geometry(c);
  const long long pixels = static_cast<long long>(batch) * h * w;
  const long long pooled = pixels / 4;
  int nblk = 0, grid = 0;
  int rc = fill_blocks(bn_pool_reduce_kernel, 2, gm.threads,
                       share(pooled, gm.ppi), &nblk);
  if (rc) return rc;
  rc = fill_blocks(bn_pool_grad_kernel, 3, gm.threads,
                   (pooled + gm.ppi - 1) / gm.ppi, &grid);
  if (rc) return rc;
  float* pf = static_cast<float*>(part);
  float* coef = pf + coef_offset(c);
  const float* fm = static_cast<const float*>(mean);
  const float* fi = static_cast<const float*>(invstd);
  const float* fw = static_cast<const float*>(weight);
  const float* fb = static_cast<const float*>(bias);
  bn_pool_reduce_kernel<<<nblk, gm.threads, 0, st>>>(
      static_cast<const uint4*>(dout), static_cast<const uint4*>(yarg), fm, fi,
      fw, fb, pooled, c, pf);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_pool_reduce_merge_kernel<<<c, kThreads, 0, st>>>(
      pf, nblk, c, pixels, fi, fw, static_cast<float*>(dweight),
      static_cast<float*>(dbias), coef);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_pool_grad_kernel<<<grid, gm.threads, 0, st>>>(
      static_cast<const uint4*>(y), static_cast<const uint4*>(dout), fm, fi,
      fw, fb, coef, static_cast<uint4*>(dy), h, w, c, pooled);
  return static_cast<int>(cudaGetLastError());
}

// Resources of the four streaming kernels at c channels (kernel 0 the
// statistics pass, 1 apply, 2 reduce, 3 gradient): kernel_info.cuh's
// out[0..4], then out[5] the blocks a launch takes (the card filled once).
extern "C" int sir_bn_pool_info(int kernel, int c, void* out) {
  if (bad_channels(c)) return static_cast<int>(cudaErrorInvalidValue);
  const Geom gm = geometry(c);
  int* o = static_cast<int*>(out);
  switch (kernel) {
    case 0: {
      const int rc = sir_info::kernel_info(bn_stats_kernel, gm.threads, 0, o);
      return rc ? rc : fill_blocks(bn_stats_kernel, 0, gm.threads, kMaxBlocks,
                                   o + 5);
    }
    case 1: {
      const int rc =
          sir_info::kernel_info(bn_pool_apply_kernel, gm.threads, 0, o);
      return rc ? rc : fill_blocks(bn_pool_apply_kernel, 1, gm.threads,
                                   1LL << 40, o + 5);
    }
    case 2: {
      const int rc =
          sir_info::kernel_info(bn_pool_reduce_kernel, gm.threads, 0, o);
      return rc ? rc : fill_blocks(bn_pool_reduce_kernel, 2, gm.threads,
                                   kMaxBlocks, o + 5);
    }
    case 3: {
      const int rc =
          sir_info::kernel_info(bn_pool_grad_kernel, gm.threads, 0, o);
      return rc ? rc : fill_blocks(bn_pool_grad_kernel, 3, gm.threads, 1LL << 40,
                                   o + 5);
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The floats of scratch (`part`) the forward and the backward take at c
// channels, into *out (a long long).
extern "C" int sir_bn_pool_scratch(int c, void* out) {
  if (bad_channels(c)) return static_cast<int>(cudaErrorInvalidValue);
  *static_cast<long long*>(out) = scratch_floats(c);
  return 0;
}
