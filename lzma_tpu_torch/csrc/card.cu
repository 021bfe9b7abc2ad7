// What the kernels' wrappers ask of the card before a launch.

#include <cuda_runtime.h>

// The opt-in shared memory one block may use on `device`, in bytes, or
// a negative CUDA error.
extern "C" int lzt_smem_limit(int device) {
  int v = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? v : -static_cast<int>(err);
}
