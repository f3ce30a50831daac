// A kernel's dynamic shared memory limit, for the kernels of this directory
// that take more than the default 48 KB a block.
#pragma once

#include <cuda_runtime.h>

namespace {

// Raises `kernel`'s dynamic shared memory limit on the current device to at
// least `bytes` (a call of at most 48 KB sets nothing).  The limits set are
// remembered for up to 64 (kernel, device) pairs, so that a call sets one
// only where its kernel on its device was given less.
inline cudaError_t smem_attribute(const void* kernel, int bytes) {
  static const void* kern[64] = {};
  static int on[64] = {};
  static int given[64] = {};
  static int used = 0;
  if (bytes <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int i = 0;
  while (i < used && !(kern[i] == kernel && on[i] == device)) ++i;
  if (i < used && given[i] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  if (i < used) {
    given[i] = bytes;
  } else if (used < 64) {
    kern[used] = kernel;
    on[used] = device;
    given[used++] = bytes;
  }
  return cudaSuccess;
}

}  // namespace
