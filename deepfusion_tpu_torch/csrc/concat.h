// The launcher of concat_relu_kernel (concat.cu): a plain C++ function that
// the registered op deepfusion_torch::concat_relu (torch_ops.cpp) calls.
// Neither side of it includes a PyTorch header in the other.
#pragma once

#include <cuda_runtime_api.h>

#include "dtypes.h"

constexpr int CONCAT_MAX_IN = 16;

// srcs, row_bytes: host arrays of n_in device pointers (16-byte aligned,
// rows contiguous) and of their pixel rows' widths in bytes (multiples of
// 16); dst: pixels rows of sum(row_bytes) bytes; dt: a DT_* code. Launches
// on `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments the kernel does not take.
cudaError_t concat_relu_launch(const void* const* srcs, const int* row_bytes,
                               int n_in, void* dst, long long pixels,
                               bool relu, int dt, cudaStream_t stream);
