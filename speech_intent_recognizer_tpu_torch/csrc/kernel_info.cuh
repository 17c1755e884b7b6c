// What a built kernel takes on the card it is loaded on, for the *_info
// entry points: out[0] registers per thread, out[1] bytes of local memory
// per thread (spills and local arrays), out[2] shared memory per block
// (static + the dynamic size the launch asks for), out[3] threads per
// block, out[4] blocks of that shape resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).

#pragma once

#include <cuda_runtime.h>

namespace sir_info {

template <typename Kernel>
int kernel_info(Kernel kernel, int threads, int dynamic_smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                      dynamic_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes) + dynamic_smem;
  out[3] = threads;
  out[4] = blocks;
  return 0;
}

}  // namespace sir_info
