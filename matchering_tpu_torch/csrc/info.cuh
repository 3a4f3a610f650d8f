// What a kernel's launch rests on, for the kernels' `mtpu_*_info` queries
// (chip_smoke.py reports them beside each kernel's time).

#pragma once

#include <cuda_runtime.h>

constexpr int kInfoWords = 6;

// out: registers a thread, static and dynamic shared memory (bytes),
// resident blocks per SM at `threads` threads and `dynamic` bytes, threads
// a block, local memory a thread (bytes; spills show here)
template <typename Kernel>
int kernel_info(Kernel kernel, int threads, size_t dynamic, long long* out) {
  cudaFuncAttributes attributes;
  cudaError_t err = cudaFuncGetAttributes(&attributes, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, dynamic);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attributes.numRegs;
  out[1] = static_cast<long long>(attributes.sharedSizeBytes);
  out[2] = static_cast<long long>(dynamic);
  out[3] = blocks;
  out[4] = threads;
  out[5] = static_cast<long long>(attributes.localSizeBytes);
  return 0;
}
