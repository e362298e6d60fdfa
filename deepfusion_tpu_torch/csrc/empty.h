// The launcher of empty_kernel (empty.cu): a plain C++ function that the
// registered op deepfusion_torch::empty_launches (torch_ops.cpp) calls.
#pragma once

#include <cuda_runtime_api.h>

// Launches empty_kernel `calls` times on `stream`, back to back, and
// returns cudaGetLastError() after the last (cudaErrorInvalidValue for a
// negative count).
cudaError_t empty_launch(int calls, cudaStream_t stream);
