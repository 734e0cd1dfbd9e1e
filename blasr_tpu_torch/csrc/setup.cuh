// Host helper shared by the kernels' set-up entries (blasr_<source>_setup,
// gathered by setup.cu's blasr_setup_kernels).
#pragma once

#include <cuda_runtime.h>

namespace blasr {

// Let `fn` take all the dynamic shared memory a block can opt into on the
// current device beside the kernel's own static arrays.
inline cudaError_t opt_in_max(const void* fn) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              optin - (int)fa.sharedSizeBytes);
}

}  // namespace blasr
