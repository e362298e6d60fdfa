// empty_kernel: a kernel that does nothing, the floor under every launch.
//
// Replaces no TPU kernel: it measures what a launch costs on the card
// before any work (tools/kernel_times.py times it through its registered
// op, deepfusion_torch::empty_launches in torch_ops.cpp, once per call and
// in one loop of launches from C++). One block of 32 threads.
#include <cuda_runtime.h>

#include "empty.h"

namespace {

__global__ void empty_kernel() {}

}  // namespace

cudaError_t empty_launch(int calls, cudaStream_t stream) {
  if (calls < 0) return cudaErrorInvalidValue;
  for (int i = 0; i < calls; ++i) {
    empty_kernel<<<1, 32, 0, stream>>>();
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}
