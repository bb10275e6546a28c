// Shared-memory limit of a kernel, shared by yolo_head.cu, nms.cu and
// dwsep.cu: each keeps a tile or a row in dynamic shared memory and sizes it
// against this limit.

#pragma once

#include <cuda_runtime.h>

// The most dynamic shared memory a block of `kernel` may ask for on the
// current device: the opt-in limit less the kernel's static shared memory.
// Returns the cudaError_t of the queries.
template <typename Kernel>
int max_dynamic_smem(Kernel kernel, int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *bytes = optin - (int)attr.sharedSizeBytes;
  return 0;
}
