// K5: conv2 + conv3 of the CNN stack in one kernel, stage 1's pooled rows
// in shared memory between the stages.
//
// Replaces speech_intent_recognizer_tpu/ops/conv23_pallas.py::_conv23_kernel
// (wrapper conv23_pallas).  Same contract: K1's pooled conv1 output
// (B, T1, 1024) bf16, lane = m * 32 + c (32 mel rows, 32 channels), T1 a
// multiple of 4; conv2 (3x3 SAME, 32 -> 64) + bias + ReLU + 2x2 max-pool,
// its result rounded to bf16, conv3 (64 -> 128) the same; out
// (B, T1 / 4, 1024) bf16, lane = m * 128 + c (8 mel rows).  Operands bf16,
// sums fp32, biases fp32.
//
// What bounds it on the H100: operations, 236 MFLOP per utterance against
// 256 KB moved (about 900 operations a byte, three times the card's
// balance).  The design keeps the tensor cores fed:
//
// * Persistent blocks, weights resident.  One block per SM (grid = min(work
//   items, SMs)) loads w2 and w3 (184,320 B) into shared memory once and
//   walks its work items: (utterance, range of output rows), the range
//   length picked on the host (ops/conv23.conv23_plan).
// * A sliding time window.  A block walks each range in time order.  One
//   loader warp keeps input rows in flight (cp.async into an 11-row ring,
//   completion on mbarriers; rows outside the utterance are zeros: SAME
//   padding in time).  Warpgroup 0 turns every four input rows into one
//   pooled conv2 row (conv2 computed once per row; two warm-up rows at the
//   start of a range) in a 10-row ring; warpgroup 1 turns six pooled rows
//   into two output rows.  The three roles meet only on the rings'
//   full / empty mbarriers: no block-wide barrier after the weights load.
//   Warpgroup 0 makes its rows in pairs that share every B tile.
// * Products on wgmma.  A convolution over a channels-last row is a sum of
//   nine tap products: rows = positions, columns = output channels, depth =
//   input channels.  A (positions) comes from registers, loaded by ldmatrix
//   from the ring at the tap's shifted positions; B (the weights) from
//   shared memory through descriptors, packed on the host in the no-swizzle
//   K-major core-matrix layout (8 output channels x 8 input channels, 128
//   contiguous bytes).  conv2: m64n64k16, 18 k-steps per pooled row;
//   conv3: m64n128k16, 36 k-steps per pair of output rows.
// * The epilogue in registers.  The M rows of a tile are ordered so that a
//   thread holds both time rows of its pool window and the lane 4 apart
//   the other mel position: bias + ReLU + 2x2 max + bf16 rounding take one
//   shuffle per value, and conv3's results leave in 16-byte stores after a
//   transpose across the four lanes of a row.
// * Zero columns and swizzles.  Ring rows carry a zero mel column on each
//   side (SAME padding in mel); 16-byte chunks are stored XOR-swizzled so
//   that every ldmatrix of eight consecutive positions is free of bank
//   conflicts.  tests/test_torch_conv23_plan.py models these index maps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gru_mma.cuh"
#include "kernel_info.cuh"

namespace {

using gru_mma::cp_async_16;
using gru_mma::ldmatrix_x4;
using gru_mma::pack_bf16;
using gru_mma::smem_addr;

constexpr int kM1 = 32, kC1 = 32, kC2 = 64, kC3 = 128;
constexpr int kM2 = kM1 / 2, kM3 = kM2 / 2;
constexpr int kInCols = kM1 + 2;             // one zero column each side
constexpr int kInRowBytes = kInCols * kC1 * 2;   // 2176
constexpr int kPCols = kM2 + 2;
constexpr int kPRowBytes = kPCols * kC2 * 2;     // 2304
constexpr int kInSlots = 11;                 // input ring rows
constexpr int kPSlots = 10;                  // pooled ring rows
// one k-step's B tile: N/8 core matrices along N (256 B apart), two along
// K (128 B apart), 8 rows of 16 B each
constexpr int kLbo = 128, kSbo = 256;
constexpr int kW2Tile = kC2 * 16 * 2;        // 2048
constexpr int kW3Tile = kC3 * 16 * 2;        // 4096
constexpr int kW2Bytes = 9 * (kC1 / 16) * kW2Tile;   // 36,864
constexpr int kW3Bytes = 9 * (kC2 / 16) * kW3Tile;   // 147,456
constexpr int kW3Off = kW2Bytes;
constexpr int kInOff = kW3Off + kW3Bytes;    // 184,320
constexpr int kPOff = kInOff + kInSlots * kInRowBytes;
constexpr int kBarOff = kPOff + kPSlots * kPRowBytes;
constexpr int kBars = 2 * (kInSlots + kPSlots);
constexpr int kSmemBytes = kBarOff + 8 * kBars;
static_assert(kSmemBytes <= 232448, "shared memory of one block");
static_assert(kBarOff % 8 == 0 && kInOff % 128 == 0, "aligned regions");
constexpr int kThreads = 288;                // 2 warpgroups + loader warp
constexpr int kLoaderWarp = 8;

// ---- mbarriers ----

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// Arrives once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(bar) : "memory");
}

// Waits until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void st_zero16(uint32_t addr) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};"
               :: "r"(addr), "r"(0), "r"(0), "r"(0), "r"(0) : "memory");
}

// ---- wgmma ----

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Descriptor of a B tile at shared address `addr`: no swizzle, K-major core
// matrices, kLbo between the two along K, kSbo between those along N.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kLbo >> 4) << 16) |
         (static_cast<uint64_t>(kSbo >> 4) << 32);
}

// d (64 x 64, fp32) += a (64 x 16, bf16, registers) @ b (16 x 64, bf16,
// shared memory through `desc`); scale_d 0 ignores d's old value.
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// d (64 x 128, fp32) += a (64 x 16, bf16, registers) @ b (16 x 128, bf16,
// shared memory through `desc`); scale_d 0 ignores d's old value.
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// ---- ring addresses (bytes from the row's start) ----

// chunk `chunk` (8 channels) of padded column `cc` of an input row: four
// chunks a column, stored at chunk ^ ((cc >> 1) & 3)
__device__ __forceinline__ uint32_t in_offset(int cc, int chunk) {
  return cc * (kC1 * 2) + ((chunk ^ ((cc >> 1) & 3)) << 4);
}

// the same in a pooled row: eight chunks a column, at chunk ^ (cc & 7)
__device__ __forceinline__ uint32_t p_offset(int cc, int chunk) {
  return cc * (kC2 * 2) + ((chunk ^ (cc & 7)) << 4);
}

// ---- work items ----

// Item `id`: utterance b, output rows [r0, r1), `steps` steps of two output
// rows; it reads input rows 4 r0 - 3 ... (8 steps + 6 of them) and makes
// pooled rows 2 r0 - 1 ... (4 steps + 2 of them).
struct Item {
  int b, r0, r1, steps;
};

__device__ __forceinline__ Item item_of(int id, int chunks, int rows,
                                        int t3n) {
  Item it;
  it.b = id / chunks;
  it.r0 = (id - it.b * chunks) * rows;
  it.r1 = min(it.r0 + rows, t3n);
  it.steps = (it.r1 - it.r0 + 1) >> 1;
  return it;
}

// Pool groups 2s and 2s + 1 (8 channels each) of an accumulator whose rows
// g and g + 8 are the two time rows of a window and whose lane ^ 4 holds
// the other mel position: max in the thread, then one exchange; the lane
// with odd g keeps group 2s + 1, the other group 2s.  Returns the two
// channels 2q, 2q + 1 of the kept group, before bias.
template <int NR>
__device__ __forceinline__ float2 pool_pair(const float (&d)[NR], int s,
                                            bool odd) {
  const int j0 = 2 * s, j1 = 2 * s + 1;
  const float a0 = fmaxf(d[4 * j0], d[4 * j0 + 2]);
  const float a1 = fmaxf(d[4 * j0 + 1], d[4 * j0 + 3]);
  const float c0 = fmaxf(d[4 * j1], d[4 * j1 + 2]);
  const float c1 = fmaxf(d[4 * j1 + 1], d[4 * j1 + 3]);
  const float s0 = odd ? a0 : c0, s1 = odd ? a1 : c1;
  const float k0 = odd ? c0 : a0, k1 = odd ? c1 : a1;
  const float r0 = __shfl_xor_sync(0xffffffffu, s0, 4);
  const float r1 = __shfl_xor_sync(0xffffffffu, s1, 4);
  return make_float2(fmaxf(k0, r0), fmaxf(k1, r1));
}

__device__ __forceinline__ uint32_t pick4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d, int i) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

__global__ void __launch_bounds__(kThreads, 1)
conv23_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ w2p,
              const float* __restrict__ b2,
              const __nv_bfloat16* __restrict__ w3p,
              const float* __restrict__ b3, __nv_bfloat16* __restrict__ out,
              int t1, int rows, int chunks, int items) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  const uint32_t w2s = base, w3s = base + kW3Off;
  const uint32_t in_ring = base + kInOff, p_ring = base + kPOff;
  const uint32_t in_full = base + kBarOff;
  const uint32_t in_empty = in_full + 8 * kInSlots;
  const uint32_t p_full = in_empty + 8 * kInSlots;
  const uint32_t p_empty = p_full + 8 * kPSlots;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t2n = t1 / 2, t3n = t1 / 4;

  // ---- once per launch: barriers, both weight sets, the zero columns ----
  if (tid == 0) {
    for (int i = 0; i < kInSlots; ++i) {
      mbar_init(in_full + 8 * i, 32);     // the loader's lanes
      mbar_init(in_empty + 8 * i, 128);   // warpgroup 0
    }
    for (int i = 0; i < kPSlots; ++i) {
      mbar_init(p_full + 8 * i, 128);     // warpgroup 0
      mbar_init(p_empty + 8 * i, 128);    // warpgroup 1
    }
  }
  for (int i = tid; i < kW2Bytes / 16; i += kThreads)
    cp_async_16(w2s + 16 * i, w2p + 8 * i, true);
  for (int i = tid; i < kW3Bytes / 16; i += kThreads)
    cp_async_16(w3s + 16 * i, w3p + 8 * i, true);
  for (int i = tid; i < kInSlots * 2 * 4; i += kThreads) {
    const int slot = i >> 3, side = (i >> 2) & 1, chunk = i & 3;
    const uint32_t a = in_ring + slot * kInRowBytes +
                       in_offset(side ? kInCols - 1 : 0, chunk);
    st_zero16(a);
  }
  for (int i = tid; i < kPSlots * 2 * 8; i += kThreads) {
    const int slot = i >> 4, side = (i >> 3) & 1, chunk = i & 7;
    const uint32_t a = p_ring + slot * kPRowBytes +
                       p_offset(side ? kPCols - 1 : 0, chunk);
    st_zero16(a);
  }
  gru_mma::cp_async_commit();
  gru_mma::cp_async_wait<0>();
  // the weights are read by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();

  if (warp == kLoaderWarp) {
    // ---- loader: the input rows of every item, in order ----
    uint32_t count = 0;
    for (int id = blockIdx.x; id < items; id += gridDim.x) {
      const Item it = item_of(id, chunks, rows, t3n);
      const int first = 4 * it.r0 - 3, n = 8 * it.steps + 6;
      const __nv_bfloat16* xb =
          x + static_cast<size_t>(it.b) * t1 * (kM1 * kC1);
      for (int k = 0; k < n; ++k, ++count) {
        const uint32_t slot = count % kInSlots, use = count / kInSlots;
        mbar_wait(in_empty + 8 * slot, (use & 1) ^ 1);
        const uint32_t row = in_ring + slot * kInRowBytes;
        const int t = first + k;
        if (t >= 0 && t < t1) {
          const __nv_bfloat16* src = xb + static_cast<size_t>(t) * (kM1 * kC1);
#pragma unroll
          for (int i = lane; i < kM1 * 4; i += 32)
            cp_async_16(row + in_offset((i >> 2) + 1, i & 3), src + 8 * i,
                        true);
          mbar_arrive_cp_async(in_full + 8 * slot);
        } else {
#pragma unroll
          for (int i = lane; i < kM1 * 4; i += 32)
            st_zero16(row + in_offset((i >> 2) + 1, i & 3));
          mbar_arrive(in_full + 8 * slot);
        }
      }
    }
    return;
  }

  // ldmatrix.x4: lane l addresses row (l & 7) + 8 ((l >> 3) & 1) of its
  // warp's 16 rows, k-chunk l >> 4 of the k16 slice.  Row r = 8 h + g of
  // warp w is the position (time row h of the pool window pair, mel
  // 8 w + g); the accumulator's rows g and g + 8 are then the two time rows
  // of one window and lane ^ 4 its other mel position.
  const int wg_warp = warp & 3;
  const int ld_g = lane & 7, ld_h = (lane >> 3) & 1, ld_chunk = lane >> 4;
  const int g = lane >> 2, q = lane & 3;
  const bool odd = g & 1;

  if (warp < 4) {
    // ---- warpgroup 0: pooled conv2 rows ----
    const int m_ld = 8 * wg_warp + ld_g;           // conv2 position of lane
    const int cc_out = 4 * wg_warp + (g >> 1) + 1;  // pooled column
    float bias[4][2];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bias[s][e] = __ldg(b2 + 8 * (2 * s + odd) + 2 * q + e);
    uint32_t in_base = 0, p_count = 0;
    for (int id = blockIdx.x; id < items; id += gridDim.x) {
      const Item it = item_of(id, chunks, rows, t3n);
      const int np = 4 * it.steps + 2;  // even: rows go in pairs
      for (int pi = 0; pi < np; pi += 2, p_count += 2) {
        // pooled rows p, p + 1 read input rows 2 p - 1 .. 2 p + 4: the
        // item's rows 2 pi .. 2 pi + 5
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          const uint32_t c = in_base + 2 * pi + r;
          mbar_wait(in_full + 8 * (c % kInSlots), (c / kInSlots) & 1);
        }
        __syncwarp();
        // both rows share every B tile; a row outside the utterance is
        // computed from zero rows and stored as zeros
        float acc[2][32];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[u][i] = 0.f;
        uint32_t a[2][2][2][4];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int kt = tap / 3, km = tap % 3;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const uint32_t row =
                in_ring + ((in_base + 2 * (pi + u) + ld_h + kt) % kInSlots) *
                              kInRowBytes;
#pragma unroll
            for (int kk = 0; kk < 2; ++kk)
              ldmatrix_x4(a[tap & 1][u][kk],
                          row + in_offset(m_ld + km, 2 * kk + ld_chunk));
          }
          wgmma_fence();
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int kk = 0; kk < 2; ++kk)
              wgmma_n64(acc[u], a[tap & 1][u][kk],
                        b_desc(w2s + (tap * 2 + kk) * kW2Tile), tap + kk > 0);
          wgmma_commit();
          wgmma_wait<1>();
        }
        wgmma_wait<0>();
        // rows 2 pi .. 2 pi + 3 are not read again (the item's last pair
        // also frees its final two)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          mbar_arrive(in_empty + 8 * ((in_base + 2 * pi + r) % kInSlots));
        if (pi + 2 == np) {
          mbar_arrive(in_empty + 8 * ((in_base + 2 * pi + 4) % kInSlots));
          mbar_arrive(in_empty + 8 * ((in_base + 2 * pi + 5) % kInSlots));
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int p = 2 * it.r0 - 1 + pi + u;
          const bool live = p >= 0 && p < t2n;
          const uint32_t c = p_count + u, slot = c % kPSlots;
          mbar_wait(p_empty + 8 * slot, ((c / kPSlots) & 1) ^ 1);
          __syncwarp();
          const uint32_t prow = p_ring + slot * kPRowBytes;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const float2 m = pool_pair(acc[u], s, odd);
            const uint32_t v =
                live ? pack_bf16(fmaxf(m.x + bias[s][0], 0.f),
                                 fmaxf(m.y + bias[s][1], 0.f))
                     : 0u;
            asm volatile("st.shared.b32 [%0], %1;"
                         :: "r"(prow + p_offset(cc_out, 2 * s + odd) + 4 * q),
                            "r"(v) : "memory");
          }
          mbar_arrive(p_full + 8 * slot);
        }
      }
      in_base += 8 * it.steps + 6;
    }
    return;
  }

  // ---- warpgroup 1: two output rows a step ----
  const int m_ld = 8 * (wg_warp & 1) + ld_g;       // pooled mel of lane
  const int jr_ld = 2 * (wg_warp >> 1) + ld_h;     // conv3 row in the step
  const int pm_out = 4 * (wg_warp & 1) + (g >> 1);
  const int pt = wg_warp >> 1;                     // output row in the step
  float bias[8][2];
#pragma unroll
  for (int s = 0; s < 8; ++s)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bias[s][e] = __ldg(b3 + 8 * (2 * s + odd) + 2 * q + e);
  uint32_t p_base = 0;
  for (int id = blockIdx.x; id < items; id += gridDim.x) {
    const Item it = item_of(id, chunks, rows, t3n);
    for (int k = 0; k < it.steps; ++k) {
      // pooled rows 2 (r0 + 2k) - 1 .. + 5 are the item's rows 4k .. 4k + 5
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        const uint32_t c = p_base + 4 * k + r;
        mbar_wait(p_full + 8 * (c % kPSlots), (c / kPSlots) & 1);
      }
      __syncwarp();
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      uint32_t a[2][4][4];
#pragma unroll
      for (int kt = 0; kt < 3; ++kt) {
        const uint32_t row =
            p_ring + ((p_base + 4 * k + jr_ld + kt) % kPSlots) * kPRowBytes;
#pragma unroll
        for (int km = 0; km < 3; ++km) {
          const int tap = kt * 3 + km;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            ldmatrix_x4(a[tap & 1][kk],
                        row + p_offset(m_ld + km, 2 * kk + ld_chunk));
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_n128(acc, a[tap & 1][kk],
                       b_desc(w3s + (tap * 4 + kk) * kW3Tile), tap + kk > 0);
          wgmma_commit();
          wgmma_wait<1>();
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < 4; ++r)
        mbar_arrive(p_empty + 8 * ((p_base + 4 * k + r) % kPSlots));
      if (k == it.steps - 1) {
        mbar_arrive(p_empty + 8 * ((p_base + 4 * k + 4) % kPSlots));
        mbar_arrive(p_empty + 8 * ((p_base + 4 * k + 5) % kPSlots));
      }
      uint32_t v[8];
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const float2 m = pool_pair(acc, s, odd);
        v[s] = pack_bf16(fmaxf(m.x + bias[s][0], 0.f),
                         fmaxf(m.y + bias[s][1], 0.f));
      }
      const int o = it.r0 + 2 * k + pt;
      __nv_bfloat16* orow =
          out + ((static_cast<size_t>(it.b) * t3n + o) * kM3 + pm_out) * kC3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // lane q gathers group 2 (4 h + q) + odd: word i from lane i
        uint32_t t[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) t[i] = 0;
        const uint32_t own = pick4(v[4 * h], v[4 * h + 1], v[4 * h + 2],
                                   v[4 * h + 3], q);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i == q) t[i] = own;
#pragma unroll
        for (int x1 = 1; x1 < 4; ++x1) {
          const uint32_t send = pick4(v[4 * h], v[4 * h + 1], v[4 * h + 2],
                                      v[4 * h + 3], q ^ x1);
          const uint32_t got = __shfl_xor_sync(0xffffffffu, send, x1);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (i == (q ^ x1)) t[i] = got;
        }
        if (o < it.r1)
          *reinterpret_cast<uint4*>(orow + 8 * (2 * (4 * h + q) + odd)) =
              make_uint4(t[0], t[1], t[2], t[3]);
      }
    }
    p_base += 4 * it.steps + 2;
  }
}

}  // namespace

// x (batch, t1, 1024) bf16; w2p / w3p bf16 in the kernel's B layout
// (ops/conv23.conv23_operands: [tap][k16 slice][8-channel column group]
// [k half][8 output channels][8 input channels]); b2 (64), b3 (128) f32;
// out (batch, t1 / 4, 1024) bf16.  A work item is `rows` output rows of
// one utterance; `grid` blocks (at most one per SM is useful) walk them.
extern "C" int sir_conv23(const void* x, const void* w2p, const float* b2,
                          const void* w3p, const float* b3, void* out,
                          int batch, int t1, int rows, int grid,
                          void* stream) {
  if (batch < 0 || t1 <= 0 || t1 % 4 || rows <= 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv23_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  const int chunks = (t1 / 4 + rows - 1) / rows;
  const long long items = static_cast<long long>(batch) * chunks;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>(items < grid ? items : grid);
  conv23_kernel<<<blocks, kThreads, kSmemBytes,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w2p), b2,
      static_cast<const __nv_bfloat16*>(w3p), b3,
      static_cast<__nv_bfloat16*>(out), t1, rows, chunks,
      static_cast<int>(items));
  return static_cast<int>(cudaGetLastError());
}

// kernel_info.cuh's five numbers for the built kernel.
extern "C" int sir_conv23_info(int* out) {
  return sir_info::kernel_info(conv23_kernel, kThreads, kSmemBytes, out);
}
