#!/usr/bin/env python
"""Where the time of K5 (conv2 + conv3 in one kernel) goes: builds
variants of ``speech_intent_recognizer_tpu_torch/csrc/conv23.cu`` with
parts cut out, and the first K5 it replaced, and times the kernels alone
(the C entry point, without the wrapper's PyTorch work) side by side on
one NVIDIA GPU, in one process, with CUDA events.

Each variant is a copy of a source with a few lines replaced (a
replacement that no longer matches the source fails), compiled by its own
``nvcc`` with ``-Xptxas -v`` and loaded with ctypes.  A variant with a part
cut out computes wrong values; only its time is read.  Two sources:

* K5 as committed (persistent blocks, both weight sets resident, a loader
  warp and two warpgroups on rings of rows, ``wgmma``): as committed; with
  the products on ``mma.sync.m16n8k16`` (B fragments by ``ldmatrix`` from
  the same resident layout, each warp its own 16 rows); without warpgroup
  0's products (conv2); without warpgroup 1's products (conv3); without
  the input loads (the loader zero-fills every row); without the output
  stores; at every range length the plan can pick below whole utterances
  (2, 4, 8, 12) beside the plan's own;
* the first K5 (``PR3_SOURCE`` below: one 12-warp block per five output
  rows, ``nvcuda::wmma``, both weight sets reloaded by every block): as it
  was; without the weight copies; without the input tile's load; with the
  2x2 pool taken from the accumulators in registers instead of staged
  through shared memory; without phase 2 (conv3's products); and with the
  products alone;

each at B=256 and 2048, T1=100.  Prints the card's name and power limit, each
kernel's registers and spills as ptxas reports them, and least / median /
most of five timed blocks in ms.  Needs one card and nvcc; imports nothing
of JAX.

    python3 bench_torch_conv23_variants.py
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import tempfile

import torch

from bench_torch_fft_variants import CSRC, blocks_ms, replace_once
from speech_intent_recognizer_tpu_torch import _build
from speech_intent_recognizer_tpu_torch.ops.conv23 import (
    conv23_operands, conv23_plan)
from speech_intent_recognizer_tpu_torch.utils.device import (
    gpu_label, require_cuda)

# The first K5, as built before the persistent design replaced it: operands
# w2 (9, 32, 72) and w3 (9, 64, 136), the output-channel strides padded.
PR3_SOURCE = r'''// K5: conv2 + conv3 of the CNN stack in one kernel, activations in shared
// memory between the stages.
//
// Replaces speech_intent_recognizer_tpu/ops/conv23_pallas.py::_conv23_kernel
// (wrapper conv23_pallas).  Same contract: K1's pooled conv1 output
// (B, T1, 1024) bf16, lane = m * 32 + c (32 mel rows, 32 channels), T1 a
// multiple of 4; conv2 (3x3 SAME, 32 -> 64) + bias + ReLU + 2x2 max-pool,
// its result rounded to bf16, conv3 (64 -> 128) the same; out
// (B, T1 / 4, 1024) bf16, lane = m * 128 + c (8 mel rows).  Operands bf16,
// sums fp32, biases fp32.
//
// Design.  A convolution over a channels-last tile is a sum of nine matrix
// products, one per tap: rows = 16 neighbouring mel positions of one time
// row (their channel vectors lie one position apart in memory, which is a
// row-major matrix with the position stride as its leading dimension),
// columns = output channels, depth = input channels.  They run on the tensor
// cores through nvcuda::wmma (16x16x16 bf16, fp32 accumulators); the SAME
// padding is a halo of zeros in the tile, and the pool is a maximum over
// the accumulators of two time rows staged through shared memory.  None of
// the TPU kernel's rolls, band matrices or selection products is needed.
//
// One block computes kRows (5) output time rows of one utterance: it needs
// 4*5+6 input rows (one row of halo per stage: three input rows each side),
// 24 conv2 rows and 12 pooled rows, so conv2 is computed 1.2 times.  Both
// weight sets do not fit beside the tiles (conv3's alone are 144 KB), so the
// block loads conv2's weights with the input tile, and conv3's over them once
// conv2 is done.  Row strides are padded (48, 80, 72, 136 elements) to
// spread the fragments' rows over the banks while every fragment stays
// 32-byte aligned.
//
// What bounds it on the H100: operations (236 MFLOP per utterance against
// 256 KB moved).  As built it is held by one block of twelve warps per SM,
// wmma's 16x16 fragments (no wgmma), and the reload of 184 KB of weights
// from L2 by every block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kM1 = 32, kC1 = 32, kC2 = 64, kC3 = 128;
constexpr int kM2 = kM1 / 2, kM3 = kM2 / 2;
constexpr int kRows = 5;                  // output time rows per block
constexpr int kInRows = 4 * kRows + 6;    // 26
constexpr int kInCols = kM1 + 2;          // 34, one zero column each side
constexpr int kInLd = 48;                 // channel stride of the input tile
constexpr int kPairs2 = 2 * kRows + 2;    // 12 conv2 row pairs = pooled rows
constexpr int kP1Cols = kM2 + 2;          // 18
constexpr int kP1Ld = 80;
constexpr int kW2Ld = 72, kW3Ld = 136;    // padded output-channel strides
constexpr int kWarps = 12;
constexpr int kThreads = kWarps * 32;

constexpr int kInElems = kInRows * kInCols * kInLd;
constexpr int kW2Elems = 9 * kC1 * kW2Ld;
constexpr int kW3Elems = 9 * kC2 * kW3Ld;
constexpr int kP1Elems = kPairs2 * kP1Cols * kP1Ld;
constexpr int kRegion0 = kW3Elems;        // holds tile + w2, then w3
static_assert(kInElems + kW2Elems <= kRegion0, "phase 1 must fit in region 0");
constexpr size_t kSmemBytes =
    sizeof(__nv_bfloat16) * (kRegion0 + kP1Elems) +
    sizeof(float) * kWarps * 512;
static_assert(kSmemBytes <= 232448, "shared memory of one block");
static_assert((kInElems * 2) % 32 == 0 && (kRegion0 * 2) % 32 == 0 &&
              (kP1Elems * 2) % 32 == 0, "32-byte aligned regions");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void copy16(void* dst, const void* src, int n16) {
  uint4* d = static_cast<uint4*>(dst);
  const uint4* s = static_cast<const uint4*>(src);
  for (int i = threadIdx.x; i < n16; i += kThreads) d[i] = __ldg(s + i);
}

// Nine taps of one stage for two time rows x 16 positions x 64 output
// channels.  `tile` points at the tap (0, 0) position of the first row;
// `row_ld` / `pos_ld` are the tile's strides in elements; `w` points at the
// first of the 64 output channels in the [tap][cin][cout] weights.
template <int kCin, int kWLd>
__device__ __forceinline__ void conv_rows(FragC (&acc)[2][4],
                                          const __nv_bfloat16* tile,
                                          int row_ld, int pos_ld,
                                          const __nv_bfloat16* w) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[r][j], 0.f);
  for (int kt = 0; kt < 3; ++kt) {
    for (int km = 0; km < 3; ++km) {
      const __nv_bfloat16* wt = w + (kt * 3 + km) * kCin * kWLd;
#pragma unroll
      for (int kk = 0; kk < kCin / 16; ++kk) {
        FragA a[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          wmma::load_matrix_sync(
              a[r], tile + (r + kt) * row_ld + km * pos_ld + kk * 16, pos_ld);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          FragB bf;
          wmma::load_matrix_sync(bf, wt + kk * 16 * kWLd + j * 16, kWLd);
#pragma unroll
          for (int r = 0; r < 2; ++r)
            wmma::mma_sync(acc[r][j], a[r], bf, acc[r][j]);
        }
      }
    }
  }
}

// relu(max over the 2x2 window + bias) for the 8 pooled positions x 16
// channels of accumulator pair j, four channels per lane; `stage` is this
// warp's 512-float scratch.
__device__ __forceinline__ void pool_pair(FragC& top, FragC& bottom,
                                          float* stage,
                                          const float* __restrict__ bias16,
                                          __nv_bfloat16 (&o)[4]) {
  wmma::store_matrix_sync(stage, top, 16, wmma::mem_row_major);
  wmma::store_matrix_sync(stage + 256, bottom, 16, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const int i = lane >> 2, c0 = (lane & 3) * 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = c0 + e;
    const float v = fmaxf(
        fmaxf(stage[(2 * i) * 16 + c], stage[(2 * i + 1) * 16 + c]),
        fmaxf(stage[256 + (2 * i) * 16 + c], stage[256 + (2 * i + 1) * 16 + c]));
    o[e] = __float2bfloat16_rn(fmaxf(v + __ldg(bias16 + c), 0.f));
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads, 1)
conv23_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ w2p,
              const float* __restrict__ b2,
              const __nv_bfloat16* __restrict__ w3p,
              const float* __restrict__ b3, __nv_bfloat16* __restrict__ out,
              int t1, int chunks) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* region0 = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* in = region0;
  __nv_bfloat16* w2s = region0 + kInElems;
  __nv_bfloat16* w3s = region0;
  __nv_bfloat16* p1 = region0 + kRegion0;
  float* stage_all = reinterpret_cast<float*>(p1 + kP1Elems);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / chunks;
  const int t3_0 = (blockIdx.x % chunks) * kRows;  // first output row
  const int t2n = t1 / 2, t3n = t1 / 4;
  float* stage = stage_all + warp * 512;

  // ---- phase 0: the input tile with its zero halo, conv2's weights, and a
  // zeroed pooled tile (its halo and the rows outside the utterance stay 0)
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * t1 * (kM1 * kC1);
  for (int idx = tid; idx < kInRows * kInCols * (kC1 / 8); idx += kThreads) {
    const int v = idx % (kC1 / 8);
    const int col = (idx / (kC1 / 8)) % kInCols;
    const int r = idx / ((kC1 / 8) * kInCols);
    const int gt = 4 * t3_0 - 3 + r, m = col - 1;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gt >= 0 && gt < t1 && m >= 0 && m < kM1)
      val = __ldg(reinterpret_cast<const uint4*>(
          xb + (static_cast<size_t>(gt) * kM1 + m) * kC1 + v * 8));
    *reinterpret_cast<uint4*>(in + (r * kInCols + col) * kInLd + v * 8) = val;
  }
  copy16(w2s, w2p, kW2Elems / 8);
  for (int i = tid; i < kP1Elems / 8; i += kThreads)
    reinterpret_cast<uint4*>(p1)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // ---- phase 1: conv2 + bias + ReLU + pool -> p1 (bf16)
  // 24 warp tiles: 12 row pairs x 2 halves of the 32 mel positions
  for (int tile = warp; tile < 2 * kPairs2; tile += kWarps) {
    const int pr = tile >> 1, mh = tile & 1;
    const int gp = 2 * t3_0 - 1 + pr;  // pooled row in the utterance
    if (gp < 0 || gp >= t2n) continue;
    FragC acc[2][4];
    conv_rows<kC1, kW2Ld>(
        acc, in + ((2 * pr) * kInCols + mh * 16) * kInLd, kInCols * kInLd,
        kInLd, w2s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      __nv_bfloat16 o[4];
      pool_pair(acc[0][j], acc[1][j], stage, b2 + j * 16, o);
      __nv_bfloat16* dst = p1 + (pr * kP1Cols + mh * 8 + (lane >> 2) + 1) * kP1Ld +
                           j * 16 + (lane & 3) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = o[e];
    }
  }
  __syncthreads();

  // ---- phase 2: conv3's weights over the input tile and conv2's weights
  copy16(w3s, w3p, kW3Elems / 8);
  __syncthreads();

  // 10 warp tiles: 5 row pairs (= output rows) x 2 halves of 128 channels
  if (warp < 2 * kRows) {
    const int rp = warp >> 1, nh = warp & 1;
    const int t3 = t3_0 + rp;
    if (t3 < t3n) {
      FragC acc[2][4];
      conv_rows<kC2, kW3Ld>(acc, p1 + (2 * rp) * kP1Cols * kP1Ld,
                            kP1Cols * kP1Ld, kP1Ld, w3s + nh * 64);
      __nv_bfloat16* ob =
          out + (static_cast<size_t>(b) * t3n + t3) * (kM3 * kC3);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        __nv_bfloat16 o[4];
        pool_pair(acc[0][j], acc[1][j], stage, b3 + nh * 64 + j * 16, o);
        __nv_bfloat16* dst =
            ob + (lane >> 2) * kC3 + nh * 64 + j * 16 + (lane & 3) * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = o[e];
      }
    }
  }
}

}  // namespace

// x (batch, t1, 1024) bf16; w2p (9, 32, 72) and w3p (9, 64, 136) bf16,
// [tap = kt * 3 + km][cin][cout padded]; b2 (64), b3 (128) f32;
// out (batch, t1 / 4, 1024) bf16.
extern "C" int sir_conv23(const void* x, const void* w2p, const float* b2,
                          const void* w3p, const float* b3, void* out,
                          int batch, int t1, void* stream) {
  if (batch < 0 || t1 <= 0 || t1 % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv23_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  const int chunks = (t1 / 4 + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(batch) * chunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  conv23_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w2p), b2,
      static_cast<const __nv_bfloat16*>(w3p), b3,
      static_cast<__nv_bfloat16*>(out), t1, chunks);
  return static_cast<int>(cudaGetLastError());
}
'''

PR3 = "conv23_pr3.cu"
NO_WEIGHT_COPIES = [(PR3, "  copy16(w2s, w2p, kW2Elems / 8);\n", ""),
                    (PR3, "  copy16(w3s, w3p, kW3Elems / 8);\n", "")]
NO_TILE_LOAD = (PR3, re.compile(
    r"  for \(int idx = tid; idx < kInRows \* kInCols.*?\n  \}\n", re.S), "")
NO_POOL_STAGING = (PR3, re.compile(
    r"  wmma::store_matrix_sync\(stage, top.*?  __syncwarp\(\);\n\}\n",
    re.S), """  const int c0 = (threadIdx.x & 3) * 4;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    o[e] = __float2bfloat16_rn(fmaxf(
        fmaxf(fmaxf(top.x[e], top.x[e + 4]), bottom.x[e]) +
            __ldg(bias16 + c0 + e), 0.f));
}
""")
NO_PHASE2 = (PR3, re.compile(
    r"      conv_rows<kC2, kW3Ld>\(acc, .*?w3s \+ nh \* 64\);\n", re.S),
    """#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[r][j], 0.f);
""")

NEW = "conv23.cu"
MMA_SYNC = (NEW, re.compile(
    r"__device__ __forceinline__ void wgmma_n64\(.*?\n}\n", re.S), """
// one warp's 16 rows of the tile on mma.sync.m16n8k16: the accumulator
// layout is wgmma's per-warp slice; B fragments by ldmatrix from the core
// matrices the descriptor points at
template <int NR>
__device__ __forceinline__ void mma_tile(float (&d)[NR],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  const uint32_t addr = static_cast<uint32_t>(desc & 0x3FFF) << 4;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NR / 4; j += 2) {
    uint32_t b[4];
    ldmatrix_x4(b, addr + (j + (lane >> 4)) * kSbo +
                       ((lane >> 3) & 1) * kLbo + (lane & 7) * 16);
#pragma unroll
    for (int u = 0; u < 2; ++u)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(d[4 * (j + u)]), "+f"(d[4 * (j + u) + 1]),
            "+f"(d[4 * (j + u) + 2]), "+f"(d[4 * (j + u) + 3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[2 * u]),
            "r"(b[2 * u + 1]));
  }
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int) {
  mma_tile(d, a, desc);
}
""")
MMA_SYNC_128 = (NEW, re.compile(
    r"__device__ __forceinline__ void wgmma_n128\(.*?\n}\n", re.S), """
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int) {
  mma_tile(d, a, desc);
}
""")
NO_CONV2_PRODUCTS = (NEW, re.compile(
    r"              wgmma_n64\(acc\[u\], a\[tap & 1\].*?;\n", re.S), "")
NO_CONV3_PRODUCTS = (NEW, re.compile(
    r"            wgmma_n128\(acc, a\[tap & 1\].*?;\n", re.S), "")
NO_INPUT_LOADS = (NEW, "        if (t >= 0 && t < t1) {",
                  "        if (false) {")
NO_OUTPUT_STORES = (NEW, "        if (o < it.r1)\n", "        if (false)\n")

# name -> (source file, edits, forced range lengths or None for the plan's)
VARIANTS = {
    "K5 as committed": (NEW, []),
    "K5 on mma.sync.m16n8k16": (NEW, [MMA_SYNC, MMA_SYNC_128]),
    "K5 without warpgroup 0's products (conv2)": (NEW, [NO_CONV2_PRODUCTS]),
    "K5 without warpgroup 1's products (conv3)": (NEW, [NO_CONV3_PRODUCTS]),
    "K5 without the input loads": (NEW, [NO_INPUT_LOADS]),
    "K5 without the output stores": (NEW, [NO_OUTPUT_STORES]),
    "PR 3 K5 as it was": (PR3, []),
    "PR 3 K5 without the weight copies": (PR3, NO_WEIGHT_COPIES),
    "PR 3 K5 without the input tile's load": (PR3, [NO_TILE_LOAD]),
    "PR 3 K5 with the pool in registers": (PR3, [NO_POOL_STAGING]),
    "PR 3 K5 without phase 2 (conv3)": (PR3, [NO_PHASE2]),
    "PR 3 K5, products only (no copies, no tile load, pool in registers)": (
        PR3, [*NO_WEIGHT_COPIES, NO_TILE_LOAD, NO_POOL_STAGING]),
}
RANGE_LENGTHS = (2, 4, 8, 12)


def write_sources(root: str) -> None:
    """The package's sources and the first K5 into ``root``."""
    for name in os.listdir(CSRC):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name)) as f, \
                    open(os.path.join(root, name), "w") as g:
                g.write(f.read())
    with open(os.path.join(root, PR3), "w") as f:
        f.write(PR3_SOURCE)


def apply_edits(name: str, src: str) -> None:
    replace_once(VARIANTS[name][1], src, name)


def build_all(root: str) -> dict:
    """Copy, edit and compile every variant (all nvcc at once); returns
    name -> (ctypes library, ptxas lines of its kernels)."""
    procs = {}
    for i, (name, (unit, _)) in enumerate(VARIANTS.items()):
        src = os.path.join(root, f"v{i}")
        os.makedirs(src)
        write_sources(src)
        apply_edits(name, src)
        so = os.path.join(src, "variant.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
             "-o", so, os.path.join(src, unit)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        unit = VARIANTS[name][0]
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name!r}:\n{err[-3000:]}")
        lines = err.splitlines()
        used = [f"{m.group(1)}: "
                f"{lines[k + 2].split(': ', 1)[-1]}; {lines[k + 1].strip()}"
                for k, line in enumerate(lines) if (m := re.search(
                    r"Function properties for \S*?(conv23\w*kernel\w*)",
                    line))]
        lib = ctypes.CDLL(so)
        lib.sir_conv23.argtypes = (_build._SIGNATURES["sir_conv23"]
                                   if unit == NEW else [ctypes.c_void_p] * 6
                                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.sir_conv23.restype = ctypes.c_int
        libs[name] = (lib, used)
    return libs


def pr3_operands(w2, w3):
    """The first K5's weights: [tap][cin][cout], cout padded to 72 / 136."""
    out = []
    for w, ld in ((w2, 72), (w3, 136)):
        o, i = w.shape[:2]
        p = torch.zeros((9, i, ld), dtype=torch.bfloat16, device=w.device)
        p[:, :, :o] = w.permute(3, 2, 1, 0).reshape(9, i, o)
        out.append(p)
    return out


def main() -> int:
    dev = require_cuda()
    print(gpu_label(), flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with tempfile.TemporaryDirectory() as root:
        libs = build_all(root)
        for name, (_, used) in libs.items():
            for line in used:
                print(f"ptxas, {name}: {line}", flush=True)
        g = torch.Generator(device=dev).manual_seed(6)
        w2 = (torch.rand((64, 32, 3, 3), device=dev, generator=g) * 2 - 1) / 17
        w3 = (torch.rand((128, 64, 3, 3), device=dev, generator=g) * 2 - 1) / 24
        b2 = 0.1 * torch.randn(64, device=dev, generator=g)
        b3 = 0.1 * torch.randn(128, device=dev, generator=g)
        ops = conv23_operands(w2, b2, w3, b3)
        p2, p3 = pr3_operands(w2, w3)
        operands = {NEW: [o.data_ptr() for o in ops],
                    PR3: [p2.data_ptr(), b2.data_ptr(), p3.data_ptr(),
                          b3.data_ptr()]}
        for batch in (256, 2048):
            t1 = 100
            x = (2 * torch.rand((batch, t1, 1024), device=dev, generator=g)
                 ).to(torch.bfloat16)
            out = torch.empty((batch, t1 // 4, 1024), device=dev,
                              dtype=torch.bfloat16)
            plan = conv23_plan(batch, t1, sms)
            for name, (lib, _) in libs.items():
                unit = VARIANTS[name][0]
                lengths = [None] + (list(RANGE_LENGTHS)
                                    if name == "K5 as committed" else [])
                for rows in lengths:
                    def call(lib=lib, name=name, unit=unit, rows=rows):
                        extra = [] if unit == PR3 else [
                            plan.rows if rows is None else rows, sms]
                        rc = lib.sir_conv23(x.data_ptr(), *operands[unit],
                                            out.data_ptr(), batch, t1,
                                            *extra, stream)
                        if rc:
                            raise RuntimeError(f"{name}: CUDA error {rc}")
                    what = "" if unit == PR3 else (
                        f", {plan.rows if rows is None else rows}-row ranges"
                        + (" (the plan's)" if rows is None else ""))
                    print(f"{name}, B={batch}{what}: "
                          + blocks_ms(call, 20 if batch <= 256 else 5)
                          + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
