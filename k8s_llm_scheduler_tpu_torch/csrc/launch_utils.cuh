// Launch helpers shared by the kernels of csrc/.

#pragma once

#include <cuda_runtime.h>

// Raises `Kernel`'s dynamic shared-memory cap to `bytes` the first time a
// launch on this device needs it; the attribute persists, so later launches
// make no extra driver call (and can be captured in a CUDA graph).
template <auto Kernel>
inline cudaError_t allow_smem_once(int bytes) {
  constexpr int kMaxDevices = 64;
  static int cap[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cap[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) cap[dev] = bytes;
  return err;
}
